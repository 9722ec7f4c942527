"""The plain reference: what decides ``correct``, and the control.

Plain PyTorch only; it imports nothing of the program and takes nothing
the program made.  It draws the inputs again from the seed
(``inputs.matrix``) and reads the program's answers only to judge them.

- :func:`invert`: the paper's block Gauss–Jordan (main.cpp:953-1204) in
  plain torch: at step t every candidate block of block column t at or
  below row block t is inverted by the paper's scalar Gauss–Jordan
  (:func:`block_inverses`), the candidate whose inverse has the least
  ∞-norm is the pivot (the lowest row on a tie; a singular candidate, or
  one whose inverse is not finite, cannot be), its block row is swapped
  into place and normalized,
  and the block column is eliminated from every other row; the column
  swaps are undone at the end.  A ragged n is embedded in an identity of
  ⌈n/m⌉·m.  Arithmetic: "float64", "float32", or "tf32" (float32 storage,
  every product's operands rounded to TF32's 10-bit mantissa, as the
  card's TF32 mode does).
- :func:`residuals`: the normalized residual ‖A·X − I‖∞ / (‖A‖∞·‖X‖∞)
  of an answer X, in float64, in blocks of rows (the paper's check,
  main.cpp:490-513).
- The number judged is, over the judged matrices, the median of each
  answer's residual over the residual of the reference's own inverse of
  the same matrix in the configuration's arithmetic: both follow the same
  pivot rule, so the conditioning of the pivot blocks, which moves either
  residual by orders of magnitude from one matrix to another, cancels.
  A sound answer reads about 1 (more where a near tie sends the two down
  different pivot paths, hence the median); the reference in the
  next-lower arithmetic (the control) reads ~1e2 (TF32 for float32) to
  ~1e9 (float32 for float64); a wrong, stale or partial inverse more.
"""

from __future__ import annotations

import math

import numpy as np
import torch

def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _operands(x: torch.Tensor, y: torch.Tensor, arith: str):
    """A product's operands as ``arith`` reads them."""
    if arith == "tf32":
        return to_tf32(x), to_tf32(y)
    return x, y


def _inf_norms(x: torch.Tensor) -> torch.Tensor:
    return x.abs().sum(dim=-1).amax(dim=-1)


def block_inverses(c: torch.Tensor, eps: float):
    """The paper's ``inverse_block`` (main.cpp:746-820) on a (B, m, m)
    stack: Gauss–Jordan on [C | I] with partial pivoting in each column
    (the largest |entry| at or below the diagonal, the first on a tie).
    Returns (inverses, rho): rho is each block's smallest |pivot| over
    ‖C‖∞, 0 where ‖C‖∞ is under ``eps`` or not finite; the paper holds a
    block singular where rho < eps (:782)."""
    n_blocks, m, _ = c.shape
    scale = _inf_norms(c)
    rho = torch.full_like(scale, math.inf)
    w = torch.cat([c, torch.eye(m, dtype=c.dtype, device=c.device)
                   .expand(n_blocks, m, m)], dim=2)
    at = torch.arange(n_blocks, device=c.device)
    for k in range(m):
        p = k + w[:, k:, k].abs().argmax(dim=1)
        row_p = w[at, p].clone()
        w[at, p] = w[:, k].clone()
        piv = row_p[:, k]
        rho = torch.minimum(rho, piv.abs() / scale)
        row_p /= torch.where(piv == 0, torch.ones_like(piv), piv)[:, None]
        col = w[:, :, k].clone()
        col[:, k] = 0
        w.baddbmm_(col[:, :, None], row_p[:, None, :], alpha=-1)
        w[:, k] = row_p
    ok = torch.isfinite(scale) & (scale >= eps)
    rho = torch.where(ok, rho.nan_to_num(nan=0.0), torch.zeros_like(rho))
    return w[:, :, m:], rho


def _unscramble(piv: np.ndarray, nr: int) -> np.ndarray:
    """Block-column order (b, nr) of the inverse: the column swaps that
    undo the row swaps ``piv`` (b, nr), last step first."""
    b = piv.shape[0]
    cols = np.tile(np.arange(nr), (b, 1))
    at = np.arange(b)
    for t in reversed(range(nr)):
        p = piv[:, t]
        keep = cols[:, t].copy()
        cols[:, t] = cols[at, p]
        cols[at, p] = keep
    return cols


def invert(a: torch.Tensor, m: int, arith: str, eps: float):
    """Inverse of each matrix of the (b, n, n) stack ``a`` by the paper's
    block Gauss–Jordan with block size ``m`` in ``arith`` and the
    singularity threshold ``eps`` (the configuration's).  Returns
    ``(x, margin)``: x (b, n, n) in the arithmetic's storage dtype, and
    for each matrix, over its steps, the least of the step's best
    candidate's rho / eps (``block_inverses``): the matrix is singular
    (some step has no candidate that can pivot) where the margin is
    under 1."""
    dt = torch.float64 if arith == "float64" else torch.float32
    b, n, _ = a.shape
    m = min(m, n)
    nr = -(-n // m)
    big = nr * m
    dev = a.device
    v = torch.eye(big, dtype=dt, device=dev).repeat(b, 1, 1)
    v[:, :n, :n] = a.to(dt)
    vb = v.view(b, nr, m, big)
    at = torch.arange(b, device=dev)
    margin = torch.full((b,), math.inf, dtype=dt, device=dev)
    pivots = []
    for t in range(nr):
        s = slice(t * m, (t + 1) * m)
        cands = vb[:, t:, :, s]                              # (b, nc, m, m)
        nc = nr - t
        inv, rho = block_inverses(cands.reshape(b * nc, m, m), eps)
        inv, rho = inv.view(b, nc, m, m), rho.view(b, nc)
        key = _inf_norms(inv)
        bad = ~(rho >= eps) | ~torch.isfinite(key)
        key = torch.where(bad, torch.full_like(key, math.inf), key)
        rel = torch.argmin(key, dim=1)
        best = torch.where(bad, torch.zeros_like(rho), rho).amax(dim=1)
        margin = torch.minimum(margin, best / eps)
        piv = rel + t
        h = inv[at, rel]                                     # (b, m, m)
        rows_p = vb[at, piv].clone()
        vb[at, piv] = vb[:, t].clone()
        prow = torch.bmm(*_operands(h, rows_p, arith))       # (b, m, big)
        prow[:, :, s] = h
        e = v[:, :, s].clone()
        e[:, s] = 0
        v[:, :, s] = 0
        v.baddbmm_(*_operands(e, prow, arith), alpha=-1)
        vb[:, t] = prow
        pivots.append(piv)
    cols = _unscramble(torch.stack(pivots, 1).cpu().numpy(), nr)
    idx = torch.from_numpy(cols).to(dev)
    x = torch.gather(v.view(b, big, nr, m), 2,
                     idx.view(b, 1, nr, 1).expand(b, big, nr, m))
    return x.reshape(b, big, big)[:, :n, :n].contiguous(), margin


def _row_blocks(n: int, rows: int):
    for r0 in range(0, n, rows):
        yield r0, min(n, r0 + rows)


def residuals(a: torch.Tensor, x: torch.Tensor,
              rows: int = 2048) -> torch.Tensor:
    """Normalized residual of each (n, n) pair of the stacks ``a`` and
    ``x`` (shape (b, n, n)), in float64: a (b,) float64 tensor.  A
    non-finite answer reads inf."""
    b, n, _ = a.shape
    out = torch.empty(b, dtype=torch.float64, device=a.device)
    for i in range(b):
        ai = a[i].to(torch.float64)
        xi = x[i].to(torch.float64)
        if not bool(torch.isfinite(xi).all()):
            out[i] = math.inf
            continue
        worst = torch.zeros((), dtype=torch.float64, device=a.device)
        for r0, r1 in _row_blocks(n, rows):
            r = ai[r0:r1] @ xi
            r[:, r0:r1].diagonal().sub_(1.0)
            worst = torch.maximum(worst, r.abs().sum(dim=1).max())
        out[i] = worst / (_inf_norms(ai) * _inf_norms(xi))
    return out
