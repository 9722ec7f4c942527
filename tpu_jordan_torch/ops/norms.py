"""Infinity norms (norm main.cpp:643-667, block_norm main.cpp:669-683).

The reference uses the max-abs-row-sum norm everywhere: as the relative
singularity scale, as the pivot-quality metric (norm of the inverse block),
and for the final residual.  Of a complex matrix it is the row sums of |z|,
in the real (component) dtype.
"""

from __future__ import annotations

import torch


def inf_norm(a: torch.Tensor) -> torch.Tensor:
    """‖A‖∞ = max_i Σ_j |a_ij| for a 2D matrix (norm, main.cpp:643-667)."""
    return a.abs().sum(dim=-1).amax(dim=-1)


def block_inf_norms(blocks: torch.Tensor) -> torch.Tensor:
    """‖·‖∞ of each block in a (..., m, m) stack (block_norm,
    main.cpp:669-683)."""
    return blocks.abs().sum(dim=-1).amax(dim=-1)


def condition_inf(a: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """κ∞(A) = ‖A‖∞·‖A⁻¹‖∞, evaluated with the computed inverse.  The
    expected relative residual of a backward-stable elimination is
    ≈ eps·n·κ∞, which is what the accuracy gates are scaled by."""
    return inf_norm(a) * inf_norm(inv)
