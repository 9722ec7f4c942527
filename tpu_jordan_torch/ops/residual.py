"""Residual verification: ‖A·A⁻¹ − I‖∞ of an inverse, ‖A·X − B‖∞ of a
solve.

The reference's integration test (main.cpp:490-513): multiply, subtract
I (minus_i, main.cpp:1206-1224), take the ∞-norm.  Single-device version;
complex input gives real values (the norms of |z|).
"""

from __future__ import annotations

import torch

from .norms import inf_norm


def residual_inf_norm(a: torch.Tensor, a_inv: torch.Tensor) -> torch.Tensor:
    """‖A·A⁻¹ − I‖∞ (main.cpp:501-507: mult, minus_i, norm)."""
    prod = a @ a_inv
    prod.diagonal().sub_(1)
    return inf_norm(prod)


def solve_residual_stats(a, x, b):
    """(‖A·X − B‖∞, ‖A‖∞, ‖X‖∞, ‖B‖∞) as floats, in the wider of A's and
    X's dtypes: a solve's verification against the caller's A and B, never
    the algorithm's state."""
    work = torch.promote_types(a.dtype, x.dtype)
    a, x, b = a.to(work), x.to(work), b.to(work)
    return (float(inf_norm(a @ x - b)), float(inf_norm(a)),
            float(inf_norm(x)), float(inf_norm(b)))
