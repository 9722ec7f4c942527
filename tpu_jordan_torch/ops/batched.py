"""Batched inversion: a (..., n, n) stack through one batch-first engine.

Counterpart of the JAX package's ``ops/batched.py::batched_jordan_invert``
(the north-star batch capability, BASELINE.md:45) written as its
``_batched_smalln`` is: explicit batch axes, the working stack kept in the
block view (B, Nr, m, N), the in-place 2N³ algebra of
``jordan_inplace.block_jordan_invert_inplace`` element for element:

  * probe: every element's live window (rows ≥ t) in ONE call on a
    (B·nc, m, m) stack, the batch folded into the candidate axis as the
    JAX probe's ``custom_vmap`` rule folds it; on the card that is one
    kernel launch a superstep for the whole batch;
  * select per element (argmin ‖inv‖∞, lowest row on ties), H and the
    pivot row by gather, the swap by one indexed write;
  * normalize with one batched product, eliminate with one ``baddbmm_``
    in place (no second (B, N, N) tensor);
  * unscramble per element at the end, the swap history read back once.

The JAX package splits the batch over three routes (smalln, the vmapped
unrolled engine, the vmapped fori engine) only for XLA's compile cost (its
"compile lottery", ``batched.py:168-187``); eager PyTorch compiles nothing,
and the JAX docstrings state that all three pick the pivots of the single
in-place engine.  So one engine serves every (B, Nr) here.
"""

from __future__ import annotations

import torch

from ..config import default_block_size, eps_for
from .block_inverse import probe_blocks
from .jordan_inplace import _SUB_FP32, compose_swap_perm
from .norms import block_inf_norms
from .padding import pad_with_identity
from .refine import newton_schulz


def batched_jordan_invert(
    a: torch.Tensor,
    block_size: int | None = None,
    eps: float | None = None,
    refine: int = 0,
    probe=probe_blocks,
):
    """Invert a (..., n, n) stack; returns (inverses, singular_flags), the
    flags shaped like the batch.  Each element gets its own pivoting and
    its own flag.  ``probe(cands, eps)`` inverts the folded (B·nc, m, m)
    candidate stack of a superstep (default :func:`probe_blocks`).
    Sub-fp32 input is inverted in fp32 and rounded once at the end."""
    batch_shape = a.shape[:-2]
    n = a.shape[-1]
    flat = a.reshape((-1, n, n))
    if a.dtype in _SUB_FP32:
        x, singular = _batched(flat.float(), block_size, eps, refine, probe)
        x = x.to(a.dtype)
    else:
        x, singular = _batched(flat, block_size, eps, refine, probe)
    return x.reshape(batch_shape + (n, n)), singular.reshape(batch_shape)


def _batched(a, block_size, eps, refine, probe):
    B, n, _ = a.shape
    if block_size is None:
        block_size = default_block_size(n)
    m = min(block_size, n)
    if eps is None:
        eps = eps_for(a.dtype)
    Nr = -(-n // m)
    N = Nr * m
    V = pad_with_identity(a, N)
    if V is a:
        V = a.clone()
    Vb = V.view(B, Nr, m, N)
    elems = torch.arange(B, device=a.device)
    singular = torch.zeros(B, dtype=torch.bool, device=a.device)
    swaps = []
    for t in range(Nr):
        nc = Nr - t
        s = slice(t * m, (t + 1) * m)
        # --- PROBE every element's live window in one call.
        cands = Vb[:, t:, :, s].reshape(B * nc, m, m).contiguous()
        invs, sing = probe(cands, eps)
        invs = invs.view(B, nc, m, m)
        sing = sing.view(B, nc)
        key = torch.where(sing, float("inf"), block_inf_norms(invs))
        rel = torch.argmin(key, dim=1)                        # (B,)
        singular |= sing.all(dim=1)
        H = invs[elems, rel]                                  # (B, m, m)
        piv = rel + t

        # --- SWAP block rows t <-> piv of each element (row t is
        # rewritten below), NORMALIZE the pivot row.
        rows_t = Vb[:, t].clone()
        rows_p = Vb[elems, piv]                               # (B, m, N)
        Vb[elems, piv] = rows_t
        prow = torch.bmm(H, rows_p)                           # (B, m, N)
        prow[:, :, s] = H

        # --- ELIMINATE in place: column t zeroed first, so the product
        # leaves −E·H there.
        E = V[:, :, s].clone()                                # (B, N, m)
        E[:, s] = 0
        V[:, :, s] = 0
        V.baddbmm_(E, prow, alpha=-1)
        Vb[:, t] = prow
        swaps.append(piv)

    # --- UNSCRAMBLE per element: the composed swap permutation of block
    # columns, one gather over the stack.
    history = torch.stack(swaps, dim=1).tolist()
    cols = torch.tensor([compose_swap_perm(h, Nr) for h in history],
                        dtype=torch.long, device=a.device)
    idx = cols.view(B, 1, Nr, 1).expand(B, N, Nr, m)
    V = torch.gather(V.view(B, N, Nr, m), 2, idx).view(B, N, N)
    x = V[:, :n, :n].contiguous()
    return newton_schulz(a, x, refine), singular
