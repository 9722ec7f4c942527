"""Gauss–Jordan on [A | B]: X = A⁻¹B with no inverse formed.

The same condition-pivoted block elimination as the invert engines, run
until the A half is the identity; the B half is then the solution.  At
superstep t only the live columns ``A[:, t·m:]`` and the right-hand sides
are updated (the normalized pivot row is zero in every eliminated column),
~n³(1 + k/n) flops for k right-hand sides against the inversion's 2n³.

  * **Pivoting path**: the probe (``ops.block_inverse.probe_blocks``: the
    dispatch kernels on the card) inverts the Nr − t live candidates of
    column t; the pivot is the one whose inverse has the smallest ‖·‖∞,
    lowest row on ties, so on a shared fixture the pivot sequence is the
    in-place invert engine's.  Rows are swapped by copy: the live columns
    of A and the rows of X.
  * **Pivot-free SPD path** (``spd=True``): the caller's promise that A is
    symmetric positive definite makes every diagonal block of every Schur
    complement invertible, so the probe inverts the diagonal candidate
    alone (a stack of one) and no row moves.

Padding follows ``ops/padding.py``: A embeds into [[A, 0], [0, I]] and B's
rows pad with zeros, so the returned ``X[:n]`` does not depend on the
padding.  Sub-fp32 storage computes in fp32 and rounds once at the end.
Complex dtypes flow through unchanged: the probe's keys and thresholds are
real (|z|), the sweeps dtype-generic; ``spd`` then promises a Hermitian
positive definite A.  Counterpart of the JAX package's
``linalg/engine.py``.
"""

from __future__ import annotations

import torch

from ..config import MAX_UNROLL_NR, default_block_size, eps_for
from ..errors import UsageError
from ..ops.block_inverse import probe_blocks
from ..ops.jordan_inplace import _select, _StepStats, _swap_rows
from ..ops.padding import pad_with_identity

_SUB_FP32 = (torch.float16, torch.bfloat16)


def block_jordan_solve(
    a: torch.Tensor,
    b: torch.Tensor,
    block_size: int | None = None,
    eps: float | None = None,
    spd: bool = False,
    collect_stats: bool = False,
    probe=probe_blocks,
):
    """Solve A·X = B by blocked Gauss–Jordan on [A | B].

    ``a`` is (n, n), ``b`` (n, k) (cast to ``a``'s dtype).  ``spd=True``
    promises A symmetric positive definite and takes the pivot-free path
    (unsound on a general matrix: the per-block singularity threshold still
    catches hard zeros, and the residual gate of ``linalg.solve_system``
    with a policy is the safety net).  ``collect_stats=True`` returns
    ``(x, singular, stats)`` with the invert engines' per-superstep record
    over [A_live | X] (pivoting path only).  ``probe(cands, eps)`` inverts
    the candidate stack (``chip_smoke.py`` passes the plain version to hold
    the kernels' run against it).  Nr > MAX_UNROLL_NR is refused, as the
    JAX package's unrolled engine refuses it; :func:`block_jordan_solve_fori`
    takes any Nr.  Returns ``(x, singular)``: X = A⁻¹B (garbage if
    singular) and a bool tensor."""
    n = a.shape[-1]
    m = min(block_size or default_block_size(n), n)
    Nr = -(-n // m)
    if Nr > MAX_UNROLL_NR:
        raise UsageError(
            f"block_jordan_solve is the UNROLLED engine (the live-column "
            f"window shrinks statically — the FLOP-cheap flavor) and "
            f"Nr={Nr} exceeds MAX_UNROLL_NR={MAX_UNROLL_NR}; use "
            f"block_jordan_solve_fori (engine='solve_fori', any Nr) or "
            f"a larger block_size")
    return _solve(a, b, m, eps, spd, collect_stats, probe)


def block_jordan_solve_fori(
    a: torch.Tensor,
    b: torch.Tensor,
    block_size: int | None = None,
    eps: float | None = None,
    spd: bool = False,
    probe=probe_blocks,
):
    """:func:`block_jordan_solve` for any Nr, with no ``collect_stats``.

    The JAX package's fori engine runs full-width updates, the price of
    traced offsets in a ``lax.fori_loop``; eager PyTorch slices every
    offset for free, so the port runs the same live-window loop here (same
    pivots, same X as :func:`block_jordan_solve`, ~n³(1 + k/n) flops, not
    the JAX engine's ~2n³).  Returns ``(x, singular)``."""
    n = a.shape[-1]
    m = min(block_size or default_block_size(n), n)
    return _solve(a, b, m, eps, spd, False, probe)


def _solve(a, b, m, eps, spd, collect_stats, probe):
    if collect_stats and spd:
        raise ValueError(
            "collect_stats traces the condition-based pivot probe; the "
            "spd fast path has no probe to trace (linalg/api.py types "
            "this refusal for callers)")
    if a.dtype in _SUB_FP32:
        out = _solve(a.float(), b.float(), m, eps, spd, collect_stats, probe)
        return (out[0].to(a.dtype),) + tuple(out[1:])
    n, k = a.shape[-1], b.shape[-1]
    if eps is None:
        eps = eps_for(a.dtype)
    Nr = -(-n // m)
    N = Nr * m
    A = pad_with_identity(a, N)
    if A is a:
        A = a.clone()
    X = A.new_zeros((N, k))
    X[:n] = b
    singular = torch.zeros((), dtype=torch.bool, device=a.device)
    stats = _StepStats() if collect_stats else None
    _solve_steps(A, X, singular, 0, Nr, Nr=Nr, m=m, eps=eps, spd=spd,
                 probe=probe, stats=stats)
    if stats is not None:
        return X[:n], singular, stats.stacked()
    return X[:n], singular


def solve_segment(A, X, singular, *, t0: int, t1: int, Nr: int, m: int,
                  eps):
    """Supersteps [t0, t1) of the pivoting solve on its closed state: the
    identity-padded (N, N) ``A``, the zero-padded (N, k) ``X`` and the 0-d
    bool ``singular``, updated in place and returned.  The loop body is
    :func:`block_jordan_solve`'s own, so the segments' ``X[:n]`` is that
    engine's.  Counterpart of the JAX package's ``solve_segment`` (and
    ``solve_segment_fori``)."""
    _solve_steps(A, X, singular, t0, t1, Nr=Nr, m=m, eps=eps, spd=False,
                 probe=probe_blocks)
    return A, X, singular


def _solve_steps(A, X, singular, t_start, t_end, *, Nr, m, eps, spd, probe,
                 stats=None):
    """Supersteps [t_start, t_end) of the [A | B] elimination, in place on
    ``A``, ``X`` and ``singular``."""
    N, k = Nr * m, X.shape[-1]
    Xb = X.view(Nr, m, k)
    for t in range(t_start, t_end):
        lo = t * m
        s = slice(lo, lo + m)
        # --- PIVOT: probe the live candidates of column block t (the
        # diagonal one alone under the spd promise).
        if spd:
            invs, sing = probe(A[s, s].unsqueeze(0).contiguous(), eps)
            singular |= sing[0]
            H = invs[0]
            rows_p_A, rows_p_X = A[s, lo:], X[s]
        else:
            invs, sing = probe(A[lo:, s].reshape(Nr - t, m, m).contiguous(),
                               eps)
            H, piv, key = _select(invs, sing, t)
            singular |= sing.all()
            if stats is not None:
                stats.probe(piv, key, sing)
            # Swap-by-copy (main.cpp:1093-1131) of the live columns and
            # of X: the pivot rows are read before slot t is written into
            # the pivot slot; slot t is rewritten from the normalized row.
            rows_p_A = _swap_rows(A[:, lo:].view(Nr, m, N - lo), t, piv)
            rows_p_X = _swap_rows(Xb, t, piv)

        # --- NORMALIZE the pivot row (main.cpp:1133-1159).
        prow_A = H @ rows_p_A                             # (m, N - lo)
        prow_X = H @ rows_p_X                             # (m, k)

        # --- ELIMINATE the live columns and X (main.cpp:1165-1193).  E is
        # a copy: the update writes the columns it is read from.
        E = A[:, s].clone()
        E[s] = 0
        A[:, lo:].addmm_(E, prow_A, alpha=-1)
        X.addmm_(E, prow_X, alpha=-1)
        A[s, lo:] = prow_A
        X[s] = prow_X
        if stats is not None:
            stats.sample_growth(A[:, lo:], X)


def solve_batch_metrics(a, x, b, n_real=None) -> dict:
    """Per-element accuracy of batched solves: ``a`` (B, N, N), ``x`` and
    ``b`` (B, N, K).  Returns (B,) tensors ``residual`` ‖A·X − B‖∞, the
    norms ``norm_a``, ``norm_x``, ``norm_b``, the normwise backward error
    ``rel_residual`` = residual / (‖A‖∞‖X‖∞ + ‖B‖∞) and ``kappa_est`` =
    ‖A‖∞‖X‖∞/‖B‖∞, a lower bound of κ∞(A) that forms no A⁻¹.  ``n_real``
    masks the norms to each element's real rows under identity padding (an
    all-masked element reports 0, not NaN).  Counterpart of the JAX
    package's ``solve_batch_metrics``."""
    r_sums = (a @ x - b).abs().sum(dim=-1)
    a_sums = a.abs().sum(dim=-1)
    x_sums = x.abs().sum(dim=-1)
    b_sums = b.abs().sum(dim=-1)
    if n_real is not None:
        rows = torch.arange(a.shape[-1], device=a.device)
        mask = rows[None, :] < torch.as_tensor(n_real,
                                               device=a.device)[:, None]
        r_sums, a_sums, x_sums, b_sums = (
            torch.where(mask, v, 0) for v in (r_sums, a_sums, x_sums,
                                              b_sums))
    residual = r_sums.amax(dim=-1)
    norm_a = a_sums.amax(dim=-1)
    norm_x = x_sums.amax(dim=-1)
    norm_b = b_sums.amax(dim=-1)
    denom = norm_a * norm_x + norm_b
    return {
        "residual": residual,
        "norm_a": norm_a,
        "norm_x": norm_x,
        "norm_b": norm_b,
        "rel_residual": torch.where(
            denom > 0, residual / torch.where(denom > 0, denom, 1),
            residual),
        "kappa_est": torch.where(
            norm_b > 0, norm_a * norm_x / torch.where(norm_b > 0, norm_b, 1),
            norm_a * norm_x),
    }
