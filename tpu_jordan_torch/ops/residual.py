"""Residual verification ‖A·A⁻¹ − I‖∞.

The reference's integration test (main.cpp:490-513): multiply, subtract
I (minus_i, main.cpp:1206-1224), take the ∞-norm.  Single-device version.
"""

from __future__ import annotations

import torch

from .norms import inf_norm


def residual_inf_norm(a: torch.Tensor, a_inv: torch.Tensor) -> torch.Tensor:
    """‖A·A⁻¹ − I‖∞ (main.cpp:501-507: mult, minus_i, norm)."""
    prod = a @ a_inv
    prod.diagonal().sub_(1)
    return inf_norm(prod)
