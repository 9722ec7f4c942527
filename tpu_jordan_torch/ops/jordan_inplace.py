"""In-place blocked Gauss–Jordan inversion: the single-device engines.

The condition-based block pivoting of the reference's ``Jordan``
(main.cpp:953-1204) on the N×N working matrix alone:

  * at step t the eliminated column block is *replaced* by the
    inverse-building column (``V[:,t] ← −E·H``, ``V[t,t] ← H``), so no
    augmented B half exists: ~2N³ flops;
  * the probe at step t inverts only the ``Nr − t`` live candidate blocks of
    column t (the reference's window, main.cpp:1039); the pivot is the
    candidate whose inverse has the smallest ‖·‖∞, lowest row on ties;
  * row pivoting is physical block-row swaps; the final inverse replays the
    swap history as one composed block-column permutation.

Every step is eager PyTorch.  The pivot index stays on the device (a 0-d
tensor driving ``index_select``/``index_copy_``), so the host never waits
for the probe; the swap history is read back once, after the last step.
The working matrix is updated in place; the caller's ``a`` is not touched.
Products are ``torch.matmul``/``addmm_`` (cuBLAS on the card, in full fp32:
the driver keeps TF32 off); the probe is ``block_inverse.probe_blocks``.  The
``grouped_pallas`` engine closes each group with one call of
``fused_update.fused_normalize_eliminate`` (a CUDA kernel on the card)
instead of the group-end ``addmm_``.

The loops run a step range on a carried state (V, the ``singular`` flag
and the (Nr,) int64 swap record), so the segment entries
(:func:`invert_segment`, :func:`invert_segment_grouped`, then
:func:`invert_finalize`), which ``resilience/checkpoint.py`` runs between
checkpoints, are the monolithic engines' own per-step code.

The probe-ahead (``lookahead``) twins launch step t+1's probe before step
t's trailing eliminate.  On the card that probe runs on a side CUDA stream
of high priority (:class:`_ProbeAhead`), so it overlaps the GEMMs that
follow it on the main stream; on the CPU the same schedule runs in order.
"""

from __future__ import annotations

import torch

from ..config import default_block_size, eps_for
from .block_inverse import probe_blocks
from .fused_update import MODES, fused_normalize_eliminate
from .norms import block_inf_norms
from .padding import pad_with_identity, unpad
from .refine import newton_schulz

_SUB_FP32 = (torch.float16, torch.bfloat16)


class _StepStats:
    """Per-superstep health record of an engine run with
    ``collect_stats=True``: the chosen pivot block, the ∞-norm of its
    inverse (the step's key minimum), the worst finite candidate norm, the
    probe's singular-candidate count, and the running element-growth
    watermark ``max|V|``.  Same keys as the JAX package's record."""

    def __init__(self):
        self.pivot_block, self.pivot_inv_norm = [], []
        self.cand_norm_max, self.singular_candidates = [], []
        self.growth = []
        self._watermark = None

    def probe(self, piv, key, sing):
        finite = torch.isfinite(key)
        self.pivot_block.append(piv.to(torch.int32))
        self.pivot_inv_norm.append(key.min())
        self.cand_norm_max.append(
            torch.where(finite, key, float("-inf")).max())
        self.singular_candidates.append(sing.sum().to(torch.int32))

    @staticmethod
    def _max_abs(arrays):
        # One read of each array, no |x| temporary (max|x| is exact).
        return torch.stack([torch.linalg.vector_norm(x, float("inf"))
                            for x in arrays]).max()

    def sample_growth(self, *arrays):
        """One per-step watermark sample over the live working state (the
        grouped engine passes V and the pending panel U)."""
        w = self._max_abs(arrays)
        self._watermark = (w if self._watermark is None
                           else torch.maximum(self._watermark, w))
        self.growth.append(self._watermark)

    def refresh(self, *arrays):
        """Fold a group-end state into the last recorded step's watermark."""
        self._watermark = torch.maximum(self._watermark,
                                        self._max_abs(arrays))
        self.growth[-1] = self._watermark

    def sample_before_close(self, V, U, H, rows_p, t: int, m: int):
        """The closing step's watermark sample of a fused group close: the
        state the plain grouped engine samples there, V with its pivot
        column block zeroed and its pivot row block normalized (and the
        pending panel U), read from its parts before the close writes
        them."""
        lo, hi = t * m, (t + 1) * m
        prow = H @ rows_p
        prow[:, lo:hi] = H
        parts = [V[r, c] for r in (slice(0, lo), slice(hi, None))
                 for c in (slice(0, lo), slice(hi, None))]
        self.sample_growth(*[x for x in parts if x.numel()], prow, U)

    def stacked(self) -> dict:
        return {
            "pivot_block": torch.stack(self.pivot_block),
            "pivot_inv_norm": torch.stack(self.pivot_inv_norm),
            "cand_norm_max": torch.stack(self.cand_norm_max),
            "singular_candidates": torch.stack(self.singular_candidates),
            "growth": torch.stack(self.growth),
        }


def compose_swap_perm(swaps, Nr: int) -> list[int]:
    """Fold the row-swap history into ONE block-column permutation: the
    reversed transpositions simulated on an index vector.  Output
    block-column j is input block-column ``cols[j]``."""
    cols = list(range(Nr))
    for t in reversed(range(Nr)):
        p = int(swaps[t])
        cols[t], cols[p] = cols[p], cols[t]
    return cols


def apply_col_perm(V: torch.Tensor, cols, m: int) -> torch.Tensor:
    """Apply a block-column permutation to the last axis with one blocked
    gather: out[..., j·m:(j+1)·m] = V[..., cols[j]·m:(cols[j]+1)·m]."""
    N = V.shape[-1]
    lead = V.shape[:-1]
    idx = torch.as_tensor(cols, dtype=torch.long, device=V.device)
    out = V.reshape(lead + (N // m, m)).index_select(len(lead), idx)
    return out.reshape(lead + (N,))


def _setup(a, block_size, eps):
    n = a.shape[-1]
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
    return n, m, eps, Nr, N, V


def _select(invs, sing, t, out=None):
    """The step's pivot decision: key = ‖inv‖∞ (inf where singular),
    argmin with ties to the lowest row.  Returns (H, piv, key); with
    ``out`` (a 0-d int64 tensor, the swap record's slot t) ``piv`` is
    written there and is that slot."""
    key = torch.where(sing, float("inf"), block_inf_norms(invs))
    rel = torch.argmin(key)
    H = invs.index_select(0, rel.view(1))[0]
    return H, torch.add(rel, t, out=out), key


class _ProbeAhead:
    """One engine call's probe-ahead: :meth:`launch` probes a candidate
    stack and selects the pivot, :meth:`take` hands the decision to the
    main stream.

    On a CUDA device the probe and the selection run on a side stream of
    high priority (made once per engine call) after everything queued so
    far on the main stream, so the kernels the caller queues after
    :meth:`launch` (the trailing GEMMs) overlap them; :meth:`take` makes
    the main stream wait for the side stream.  The stack must be a tensor
    the main stream does not write before :meth:`take`.  Tensors cross the
    streams with ``record_stream``, so the caching allocator does not hand
    their memory out while the other stream may still use it.  On the CPU
    :meth:`launch` runs in order and :meth:`take` only returns."""

    def __init__(self, device, probe, eps):
        self.probe, self.eps = probe, eps
        self.main = self.side = None
        if device.type == "cuda":
            self.main = torch.cuda.current_stream(device)
            self.side = torch.cuda.Stream(device, priority=-1)
        self._out = None

    def _run(self, cands, t):
        invs, sing = self.probe(cands, self.eps)
        H, piv, key = _select(invs, sing, t)
        return H, piv, key, sing

    def launch(self, cands, t: int) -> None:
        """Probe ``cands`` (the (nc, m, m) live window of step t)."""
        if self.side is None:
            self._out = self._run(cands, t)
            return
        self.side.wait_stream(self.main)
        cands.record_stream(self.side)
        with torch.cuda.stream(self.side):
            self._out = self._run(cands, t)
        for x in self._out:
            x.record_stream(self.main)

    def take(self):
        """The launched step's (H, piv, key, sing)."""
        if self.side is not None:
            self.main.wait_stream(self.side)
        out, self._out = self._out, None
        return out


def _swap_rows(Xb, t: int, piv):
    """Swap-by-copy of block rows t <-> piv in the (Nr, m, ·) view ``Xb``;
    returns the old block row piv.  Row t is left for the caller."""
    pv = piv.view(1)
    rows_t = Xb[t].clone()
    rows_p = Xb.index_select(0, pv)[0]
    Xb.index_copy_(0, pv, rows_t.unsqueeze(0))
    return rows_p


def _carry(Nr: int, device):
    """A fresh run's ``singular`` flag and (Nr,) int64 swap record."""
    return (torch.zeros((), dtype=torch.bool, device=device),
            torch.zeros((Nr,), dtype=torch.int64, device=device))


def invert_finalize(V, swaps, *, n: int, Nr: int, m: int):
    """The in-place engines' epilogue: compose the swap record (read back
    once) into one block-column permutation, apply it as one blocked
    gather, strip the identity padding.  Runs once, after the last
    superstep (or segment).  Counterpart of the JAX package's
    ``invert_finalize``."""
    V = apply_col_perm(V, compose_swap_perm(swaps.tolist(), Nr), m)
    return unpad(V, n).contiguous()


def _finish(V, swaps, Nr, n, m, a, refine, stats, singular):
    x = newton_schulz(a, invert_finalize(V, swaps, n=n, Nr=Nr, m=m), refine)
    if stats is not None:
        return x, singular, stats.stacked()
    return x, singular


def _upcast_call(engine, a, *args):
    """Sub-fp32 policy: fp32 compute, one final rounding back."""
    out = engine(a.float(), *args)
    return (out[0].to(a.dtype),) + tuple(out[1:])


def block_jordan_invert_inplace(
    a: torch.Tensor,
    block_size: int | None = None,
    eps: float | None = None,
    refine: int = 0,
    collect_stats: bool = False,
    probe=probe_blocks,
):
    """Invert ``a`` by in-place blocked Gauss–Jordan with condition-based
    pivoting.  Returns ``(x, singular)``, or ``(x, singular, stats)`` with
    ``collect_stats=True`` (:class:`_StepStats`).  ``singular`` is a bool
    tensor on ``a``'s device.  ``probe(cands, eps)`` inverts the candidate
    stack (default :func:`probe_blocks`; ``chip_smoke.py`` passes the plain
    version to hold the kernel's run against it).  Counterpart of the JAX package's
    ``block_jordan_invert_inplace`` and its ``_fori`` twin (eager PyTorch
    needs no split)."""
    if a.dtype in _SUB_FP32:
        return _upcast_call(block_jordan_invert_inplace, a, block_size, eps,
                            refine, collect_stats, probe)
    stats = _StepStats() if collect_stats else None
    return _inplace(a, block_size, eps, refine, probe, stats, lookahead=False)


def block_jordan_invert_inplace_lookahead(
    a: torch.Tensor,
    block_size: int | None = None,
    eps: float | None = None,
    refine: int = 0,
    collect_stats: bool = False,
    probe=probe_blocks,
):
    """The in-place engine with PROBE-AHEAD scheduling: each superstep's
    eliminate is split into the critical panel (the column block that is
    step t+1's candidate column) and the trailing update of the other
    columns.  The panel is updated first, step t+1's probe and pivot
    selection are launched on it (:class:`_ProbeAhead`: a side CUDA stream
    on the card), and only then the trailing ``addmm_`` on the left and
    right column views, so the probe overlaps them.

    The panel is the column slice of the plain engine's product, so the
    pivot rule and the arithmetic are the plain engine's; a column-sliced
    GEMM need not sum like the full one, so the inverse is held to the
    plain engine's within rounding, and the pivot sequence exactly.
    Returns what :func:`block_jordan_invert_inplace` returns.
    Counterpart of the JAX package's
    ``block_jordan_invert_inplace_lookahead``."""
    if a.dtype in _SUB_FP32:
        return _upcast_call(block_jordan_invert_inplace_lookahead, a,
                            block_size, eps, refine, collect_stats, probe)
    stats = _StepStats() if collect_stats else None
    return _inplace(a, block_size, eps, refine, probe, stats, lookahead=True)


def _inplace(a, block_size, eps, refine, probe, stats, lookahead):
    """Both in-place engines: the supersteps of :func:`_inplace_steps`
    over the whole range, then :func:`_finish`."""
    n, m, eps, Nr, N, V = _setup(a, block_size, eps)
    singular, swaps = _carry(Nr, a.device)
    _inplace_steps(V, singular, swaps, 0, Nr, Nr=Nr, m=m, eps=eps,
                   probe=probe, stats=stats, lookahead=lookahead)
    return _finish(V, swaps, Nr, n, m, a, refine, stats, singular)


def _inplace_steps(V, singular, swaps, t_start, t_end, *, Nr, m, eps,
                   probe, stats=None, lookahead=False):
    """Supersteps [t_start, t_end) of the in-place loop, in place on the
    (N, N) working matrix ``V``, the 0-d ``singular`` flag and the (Nr,)
    swap record ``swaps``.  ``lookahead`` splits each eliminate around the
    launch of the next step's probe (:class:`_ProbeAhead`)."""
    N = Nr * m
    Vb = V.view(Nr, m, N)
    ahead = _ProbeAhead(V.device, probe, eps) if lookahead else None
    if ahead is not None:
        # --- PROLOGUE: the first step's probe on its untouched column.
        t, c = t_start, slice(t_start * m, (t_start + 1) * m)
        ahead.launch(V[t * m:, c].reshape(Nr - t, m, m).contiguous(), t)
    for t in range(t_start, t_end):
        s = slice(t * m, (t + 1) * m)
        if ahead is None:
            # --- PROBE the live candidate blocks of column t
            # (main.cpp:1039).
            cands = V[t * m:, s].reshape(Nr - t, m, m).contiguous()
            invs, sing = probe(cands, eps)
            H, piv, key = _select(invs, sing, t, out=swaps[t])
        else:
            # --- PROBE-AHEAD: launched before the previous trailing
            # eliminate.
            H, piv, key, sing = ahead.take()
            swaps[t] = piv
        singular |= sing.all()
        if stats is not None:
            stats.probe(piv, key, sing)

        # --- SWAP block rows t <-> piv (main.cpp:1093-1131).
        rows_p = _swap_rows(Vb, t, piv)

        # --- NORMALIZE + ELIMINATE, in place: prow's t-block is H and V's
        # t-column is zeroed first, so the one product leaves −E·H there.
        prow = H @ rows_p                                     # (m, N)
        prow[:, s] = H
        E = V[:, s].clone()                                   # (N, m)
        E[s] = 0
        V[:, s] = 0
        c0 = (t + 1) * m
        if ahead is not None and t < t_end - 1:
            # --- CRITICAL PANEL first, then step t+1's probe on its live
            # window (rows below the pivot-row write), copied so that the
            # probe reads no column the trailing update writes; the
            # TRAILING ELIMINATE is launched after the probe.
            V[:, c0:c0 + m].addmm_(E, prow[:, c0:c0 + m], alpha=-1)
            ahead.launch(V[c0:, c0:c0 + m].reshape(Nr - t - 1, m, m)
                         .contiguous(), t + 1)
            V[:, :c0].addmm_(E, prow[:, :c0], alpha=-1)
            if c0 + m < N:
                V[:, c0 + m:].addmm_(E, prow[:, c0 + m:], alpha=-1)
        else:
            V.addmm_(E, prow, alpha=-1)
        V[s] = prow
        if stats is not None:
            stats.sample_growth(V)


def invert_segment(V, singular, swaps, *, t0: int, t1: int, Nr: int,
                   m: int, eps):
    """Supersteps [t0, t1) of the in-place engine on its closed state: the
    identity-padded (N, N) working matrix ``V``, the 0-d bool ``singular``
    and the (Nr,) int64 swap record ``swaps``, all updated in place and
    returned.  The loop body is :func:`block_jordan_invert_inplace`'s own,
    so segments [0, t1), [t1, t2), … then :func:`invert_finalize` give
    that engine's bits.  Counterpart of the JAX package's
    ``invert_segment`` (and ``invert_segment_fori``: the port has one loop
    for every Nr)."""
    _inplace_steps(V, singular, swaps, t0, t1, Nr=Nr, m=m, eps=eps,
                   probe=probe_blocks)
    return V, singular, swaps


def block_jordan_invert_inplace_grouped(
    a: torch.Tensor,
    block_size: int | None = None,
    eps: float | None = None,
    refine: int = 0,
    group: int = 4,
    collect_stats: bool = False,
    probe=probe_blocks,
):
    """In-place blocked Gauss–Jordan with DELAYED GROUP UPDATES: ``group=k``
    consecutive elimination panels are accumulated into U (N, k·m) and
    P (k·m, N) and applied as one (N, k·m)×(k·m, N) product per group, while
    the probed column and the pivot row are brought up to date eagerly with
    the pending panels, so the pivot choice is the plain engine's.

    Bookkeeping invariants (why the eager formulas are exact):
      * V's group columns are zeroed at their elimination step, so the
        eager value of any group column is V − U·P;
      * a finalized pivot row is written into V at once and its U row
        zeroed, so the group-end subtract leaves it alone;
      * row swaps move U rows with V rows.
    ``probe`` is as in :func:`block_jordan_invert_inplace`.  Counterpart
    of the JAX package's ``block_jordan_invert_inplace_grouped`` and its
    ``_grouped_fori`` twin."""
    if a.dtype in _SUB_FP32:
        return _upcast_call(block_jordan_invert_inplace_grouped, a,
                            block_size, eps, refine, group, collect_stats,
                            probe)
    stats = _StepStats() if collect_stats else None
    return _grouped(a, block_size, eps, refine, group, probe, stats, None)


def block_jordan_invert_inplace_grouped_lookahead(
    a: torch.Tensor,
    block_size: int | None = None,
    eps: float | None = None,
    refine: int = 0,
    group: int = 4,
    collect_stats: bool = False,
    probe=probe_blocks,
):
    """The delayed-group-update engine with PROBE-AHEAD scheduling at the
    group boundary: the next group's first eager candidate column
    ``V[:, tn] − U·P[:, tn]`` (the column slice of the group-end product)
    and its probe are hoisted above the group-end ``V −= U·P``, so that
    probe (on a side CUDA stream on the card, :class:`_ProbeAhead`)
    overlaps the group-end GEMM.  The in-group steps are
    :func:`block_jordan_invert_inplace_grouped`'s own, so the pivot
    sequence is that engine's; the inverse agrees with it within rounding.
    Counterpart of the JAX package's
    ``block_jordan_invert_inplace_grouped_lookahead``."""
    if a.dtype in _SUB_FP32:
        return _upcast_call(block_jordan_invert_inplace_grouped_lookahead,
                            a, block_size, eps, refine, group,
                            collect_stats, probe)
    stats = _StepStats() if collect_stats else None
    return _grouped(a, block_size, eps, refine, group, probe, stats, None,
                    lookahead=True)


def block_jordan_invert_inplace_grouped_pallas(
    a: torch.Tensor,
    block_size: int | None = None,
    eps: float | None = None,
    refine: int = 0,
    group: int = 4,
    mode: str = "fp32",
    probe=probe_blocks,
    update=fused_normalize_eliminate,
    collect_stats: bool = False,
):
    """The delayed-group-update engine with its group-closing step (the
    pivot-row normalize, the pivot-column zeroing, the pivot-row write-back
    and the group-end ``V − U·P``) done by one call of ``update``, by
    default :func:`fused_update.fused_normalize_eliminate` (the CUDA kernel
    on the card).  The probe, swaps, eager column and row and the
    non-closing steps are :func:`block_jordan_invert_inplace_grouped`'s own
    code, so the pivot choices are that engine's.

    ``mode="bf16"`` rounds the update's operands to bf16 with fp32
    accumulation; the probe and the eager side-updates stay fp32.  A bf16
    inverse is bf16-grade: ``driver.solve`` guards this engine with the
    residual-gate ladder.  ``update(V, U, P, H, rows_p, *, t, j, m, mode)``
    must update V in place (``chip_smoke.py`` passes the plain version to
    hold the kernel's run against it).  ``collect_stats=True`` returns the
    per-superstep record as the other engines do: the engine instruments
    itself (its sums are not cuBLAS's, so no other engine's record would
    be its own), sampling each closing step's watermark from the state's
    parts before the close (:meth:`_StepStats.sample_before_close`).
    Computes in fp32: sub-fp32 input is upcast, float64 is refused.
    Counterpart of the JAX package's
    ``block_jordan_invert_inplace_grouped_pallas``."""
    if a.dtype in _SUB_FP32:
        return _upcast_call(block_jordan_invert_inplace_grouped_pallas, a,
                            block_size, eps, refine, group, mode, probe,
                            update, collect_stats)
    if a.dtype != torch.float32:
        raise ValueError(
            f"the grouped_pallas engines compute in fp32 (the fused update "
            f"kernel is fp32-only), got {a.dtype}; use engine='grouped' "
            f"for float64")
    if mode not in MODES:
        raise ValueError(f"unknown kernel precision mode {mode!r}")

    stats = _StepStats() if collect_stats else None

    def close(V, U, P, H, rows_p, t, j, m):
        if stats is not None:
            stats.sample_before_close(V, U, H, rows_p, t, m)
        update(V, U, P, H, rows_p, t=t, j=j, m=m, mode=mode)
        if stats is not None:
            stats.refresh(V)

    return _grouped(a, block_size, eps, refine, group, probe, stats, close)


def _grouped(a, block_size, eps, refine, group, probe, stats, close,
             lookahead=False):
    """The delayed-group-update loop of the grouped engines.  ``close``
    is None for the plain engine (the closing step is an ordinary step
    and the group ends with one ``addmm_``), else the group-closing update
    ``close(V, U, P, H, rows_p, t, j, m)``, called with P's slot j zero
    and V's pivot column and pivot row not yet written.  ``lookahead``
    (with ``close`` None) launches each group's first probe before the
    previous group-end ``addmm_`` (:class:`_ProbeAhead`)."""
    n, m, eps, Nr, N, V = _setup(a, block_size, eps)
    singular, swaps = _carry(Nr, a.device)
    _grouped_steps(V, singular, swaps, 0, Nr, Nr=Nr, m=m, group=group,
                   eps=eps, probe=probe, stats=stats, close=close,
                   lookahead=lookahead)
    return _finish(V, swaps, Nr, n, m, a, refine, stats, singular)


def _grouped_steps(V, singular, swaps, t_start, t_end, *, Nr, m, group,
                   eps, probe, stats=None, close=None, lookahead=False):
    """The groups of supersteps [t_start, t_end) of the delayed-group-update
    loop, in place on ``V``, ``singular`` and ``swaps`` (as
    :func:`_inplace_steps`).  Both ends sit on the group grid (``t_end``
    may be Nr): the panels U and P live within a group, so between groups
    the state is (V, singular, swaps) alone."""
    N = Nr * m
    k = max(1, min(group, Nr))
    if t_start % k or (t_end % k and t_end != Nr):
        raise ValueError(
            f"grouped segment bounds must sit on group boundaries: "
            f"[{t_start}, {t_end}) with group={k}")
    Vb = V.view(Nr, m, N)
    ahead = None
    if lookahead:
        ahead = _ProbeAhead(V.device, probe, eps)
        # --- PROLOGUE: the first group's first probe on its untouched
        # column.
        col_ahead = V[:, t_start * m:(t_start + 1) * m].clone()
        ahead.launch(col_ahead[t_start * m:].view(Nr - t_start, m, m),
                     t_start)
    for t0 in range(t_start, t_end, k):
        kg = min(k, Nr - t0)                   # this group's width
        U = V.new_zeros((N, kg * m))
        P = V.new_zeros((kg * m, N))
        Ub = U.view(Nr, m, kg * m)
        for j in range(kg):
            t = t0 + j
            s = slice(t * m, (t + 1) * m)
            if ahead is not None and j == 0:
                # --- PROBE-AHEAD: this group's first decision was
                # launched before the previous group-end update.
                H, piv, key, sing = ahead.take()
                swaps[t] = piv
                col = col_ahead
            else:
                # --- EAGER CANDIDATE COLUMN: V[:, t] minus pending
                # panels.
                col = V[:, s].clone()
                if j:
                    col.addmm_(U[:, :j * m], P[:j * m, s], alpha=-1)
                # --- PROBE the live window (main.cpp:1039).
                invs, sing = probe(col[t * m:].view(Nr - t, m, m), eps)
                H, piv, key = _select(invs, sing, t, out=swaps[t])
            singular |= sing.all()
            if stats is not None:
                stats.probe(piv, key, sing)

            # --- SWAP rows t <-> piv in V and U (pending panel
            # contributions follow the physical row).
            rows_p = _swap_rows(Vb, t, piv)
            u_p = _swap_rows(Ub, t, piv)

            # --- EAGER PIVOT ROW: old piv row minus pending panels.
            if j:
                rows_p.addmm_(u_p[:, :j * m], P[:j * m], alpha=-1)

            # --- RECORD the panel: E = eager column, blocks t/piv
            # exchanged, pivot-row block zeroed.
            colb = col.view(Nr, m, m)
            colb.index_copy_(0, piv.view(1), colb[t:t + 1].clone())
            colb[t] = 0
            # --- BOOKKEEPING WRITES (the invariants above).  Zeroing V's
            # column t also cancels the pending panels' contributions.
            if j:
                P[:j * m, s] = 0
            U[s] = 0
            U[:, j * m:(j + 1) * m] = col
            if close is not None and j == kg - 1:
                # --- GROUP-CLOSING STEP: normalize, zero the pivot
                # column, write the pivot row and retire the group.
                close(V, U, P, H, rows_p, t, j, m)
                continue
            prow = H @ rows_p                                 # (m, N)
            prow[:, s] = H
            V[:, s] = 0
            V[s] = prow
            P[j * m:(j + 1) * m] = prow
            if stats is not None:
                stats.sample_growth(V, U)

        tn = t0 + kg
        if ahead is not None and tn < t_end:
            # --- CRITICAL PANEL + PROBE-AHEAD: the next group's first
            # eager column is the column slice of the group-end product;
            # its probe is launched before that product.
            sn = slice(tn * m, (tn + 1) * m)
            col_ahead = V[:, sn].clone()
            col_ahead.addmm_(U, P[:, sn], alpha=-1)
            ahead.launch(col_ahead[tn * m:].view(Nr - tn, m, m), tn)
        if close is None:
            # --- GROUP-END TRAILING UPDATE: one fat product.
            V.addmm_(U, P, alpha=-1)
            if stats is not None:
                stats.refresh(V)


def invert_segment_grouped(V, singular, swaps, *, t0: int, t1: int, Nr: int,
                           m: int, group: int, eps):
    """Supersteps [t0, t1) of the delayed-group-update engine
    (:func:`block_jordan_invert_inplace_grouped`'s loop body) on the state
    of :func:`invert_segment`, updated in place and returned.  ``t0`` and
    ``t1`` sit on the group grid (``t1`` may be Nr), the only points where
    the state is closed; other bounds raise ValueError.  Counterpart of the
    JAX package's ``invert_segment_grouped``."""
    _grouped_steps(V, singular, swaps, t0, t1, Nr=Nr, m=m, group=group,
                   eps=eps, probe=probe_blocks)
    return V, singular, swaps
