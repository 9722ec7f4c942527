"""Newton–Schulz iterative refinement of an approximate inverse.

``X ← X + X(I − AX)`` roughly squares the residual per step at the cost of
two GEMMs, real or complex.  Convergence requires ‖I − AX₀‖ < 1 in some
operator norm.
"""

from __future__ import annotations

import torch

from ..errors import UsageError


def resolve_precision(precision: str, refine: int):
    """Resolve a precision policy to (sweep_precision, refine_steps).

    Only "highest" exists here: every product is true fp32 (TF32 off) or
    fp64.  The JAX package's "high" runs bf16×3 products, which have no
    exact PyTorch counterpart (TF32 is not the same arithmetic), and
    "mixed" builds on "high", so both are refused rather than aliased."""
    if precision == "highest":
        return precision, refine
    if precision in ("high", "mixed", "default"):
        raise UsageError(
            f"precision={precision!r} has no exact PyTorch counterpart "
            f"(bf16x3 products; TF32 is other arithmetic); use 'highest'")
    raise UsageError(f"unknown precision {precision!r}")


def newton_schulz(a: torch.Tensor, x: torch.Tensor,
                  steps: int) -> torch.Tensor:
    """Refine ``x ≈ a⁻¹`` with ``steps`` Newton–Schulz iterations."""
    if steps <= 0:
        return x
    n = a.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    for _ in range(steps):
        r = eye - a @ x
        x = x + x @ r
    return x
