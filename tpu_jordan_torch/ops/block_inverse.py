"""Small-block Gauss–Jordan inverse with scalar partial pivoting: the plain
PyTorch version of the pivot-candidate probe.

Rebuild of ``inverse_block`` (main.cpp:746-820): invert an m x m block by
Gauss–Jordan with column partial pivoting, declaring the block singular
when a pivot falls below ``eps * scale`` (relative threshold,
main.cpp:782), when the scale itself vanishes (``scale < eps``), or when the
input holds a non-finite value.  The scale is ‖block‖∞ unless given.

Complex blocks follow the JAX package's ``gauss_jordan_inverse``: the pivot
key is |z| in the real dtype (argmax: the lowest row on ties, NaN highest),
the threshold eps·|scale| is real, and eps is the component dtype's.

The whole candidate stack is inverted at once: every operation carries a
leading batch dimension, and a singular block does not stop the others (its
inverse is garbage, its flag True).  This is the oracle for the CUDA probe
kernel (``ops/gj_probe.py``) and what that wrapper runs on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..config import eps_for
from .norms import block_inf_norms


def gauss_jordan_inverse(
    a: torch.Tensor,
    scale_norm: torch.Tensor | float | None = None,
    eps: float | None = None,
):
    """Invert one m x m block.  ``scale_norm`` is the relative scale of the
    singularity threshold (the reference passes the ∞-norm of the whole
    local strip, main.cpp:972/1046); it defaults to ‖a‖∞.  Returns
    (inverse, singular) with ``singular`` a 0-d bool tensor."""
    inv, sing = batched_block_inverse(a[None], scale_norm, eps)
    return inv[0], sing[0]


def batched_block_inverse(
    blocks: torch.Tensor,
    scale_norm: torch.Tensor | float | None = None,
    eps: float | None = None,
):
    """Invert a (..., m, m) stack of blocks.  Returns (inverses,
    singular_flags) of shapes (..., m, m) and (...)."""
    batch_shape = blocks.shape[:-2]
    m = blocks.shape[-1]
    a = blocks.reshape(-1, m, m)
    B = a.shape[0]
    dtype = a.dtype
    if eps is None:
        eps = eps_for(dtype)
    if scale_norm is None:
        scale = block_inf_norms(a)
    else:
        scale = torch.as_tensor(scale_norm, dtype=dtype,
                                device=a.device).abs().expand(B)
    thresh = eps * scale

    rows = torch.arange(B, device=a.device)
    eye = torch.eye(m, dtype=dtype, device=a.device).expand(B, m, m)
    w = torch.cat([a, eye], dim=2)                           # (B, m, 2m)
    singular = ~torch.isfinite(a).all(dim=2).all(dim=1)
    singular |= scale < eps
    for k in range(m):
        # column partial pivot: argmax |w[i,k]| over i >= k, first on ties
        # (main.cpp:756-763)
        r = k + w[:, k:, k].abs().argmax(dim=1)
        row_r = w[rows, r]                                    # (B, 2m)
        w[rows, r] = w[:, k].clone()
        w[:, k] = row_r
        piv = row_r[:, k]
        singular |= piv.abs() < thresh
        safe_piv = torch.where(piv == 0, torch.ones_like(piv), piv)
        prow = row_r / safe_piv[:, None]
        # eliminate above and below (main.cpp:794-817) as one rank-1 update
        factors = w[:, :, k].clone()
        factors[:, k] = 0
        w -= factors[:, :, None] * prow[:, None, :]
        w[:, k] = prow
    inv = w[:, :, m:].reshape(batch_shape + (m, m))
    return inv, singular.reshape(batch_shape)


def probe_blocks(cands: torch.Tensor, eps: float | None = None,
                 scale=None):
    """The pivot-candidate probe shared by the elimination engines: the
    CUDA kernel on a card, the plain version on the CPU (the wrapper
    decides by the tensor's device).  ``scale``: the singularity scale of
    every block in place of its own ‖block‖∞ (the augmented engine's
    global scale).  Returns (inverses, singular_flags)."""
    from .gj_probe import gj_probe

    return gj_probe(cands, eps, scale)
