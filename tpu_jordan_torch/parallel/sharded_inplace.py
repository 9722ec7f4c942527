"""The 1D row-block-cyclic in-place engines, one process per rank.
Counterpart of the JAX package's ``parallel/sharded_inplace.py``: the
invert family (``compile_sharded_jordan_inplace``: the plain engine and its
fori twin, the probe-ahead, grouped and swap-free engines), the [A | B]
solves (``compile_sharded_jordan_solve``: ``solve_sharded`` and its
probe-ahead twin ``solve_lookahead``) and the segment entries of the
checkpointed runs, over ``torch.distributed`` instead of ``shard_map``.

Each rank holds its (bpw, m, N) blocks of the identity-padded matrix:
global block row ``s·p + k`` at slot s of rank k, columns whole
(main.cpp:95-123).  A superstep t:

  * **probe** (main.cpp:1026-1074): the rank inverts its live candidates of
    column block t, the slots holding rows ≥ t (slots ``[t//p, bpw)`` less
    the one stale slot), on ``ops.block_inverse.probe_blocks``: the panel
    kernel or ``gj_probe.cu`` on the card.  A rank with no live candidate
    launches nothing and offers an infinite key;
  * **pivot reduction**: ``all_reduce(MIN)`` of the key, then of the global
    row among the ranks that hold it: the two-stage composite key of the
    reference's custom MPI op (main.cpp:729-744, 1074), ties to the lowest
    global row.  The winning row ``g_piv`` is read to the host, so every
    rank knows its owner ``g_piv % p``; an all-singular window sets
    ``singular`` on every rank (main.cpp:1075-1083);
  * **broadcasts** (main.cpp:1093-1131): the owner broadcasts the pivot row
    with its block's inverse H, the owner of row t broadcasts row t (not
    when the pivot is row t itself, which every rank knows); the JAX
    package's one-hot ``psum``s, which are broadcasts (MPI_Bcast's own
    shape, main.cpp:1097), bit for bit;
  * **swap-by-copy, normalize, eliminate**: the pivot's owner stores row t
    in the pivot's slot; prow = H·row_piv with its t-block H; every local
    row but row t takes ``−E·prow`` in one ``addmm_`` on the (bpw·m, N)
    strip; row t's owner writes prow.

The swap record is replayed after the loop as one block-column
permutation, rank-locally (columns are whole on every rank).

Engines: ``inplace`` (the JAX unrolled and fori engines are one eager loop
here); ``lookahead``: the critical panel (column block t+1) first, step
t+1's probe on a side CUDA stream of high priority, then the trailing
``addmm_``s, and the reduction at the top of step t+1, after the host has
queued those GEMMs (the side stream is joined by ``wait_stream`` before a
collective reads the probe's output); ``grouped`` (k): delayed group
updates, the eager column and pivot row brought up to date with the
pending panels, the group closed by one GEMM (no fused-update kernel here,
as in the JAX 1D engine); ``swapfree``: rows never move, the pivot
permutation is tracked on the host (``pos``/``ipos``, ties by swap
coordinate), one pivot-row broadcast a step, and one point-to-point row
permutation after the loop (``permute.py``).

The solve (:func:`solve_blocks`) runs the same superstep on [A | B]: only
A's live columns [t·m, N) and the rank's rows of X move, the pivot row
and row t each go out as one stacked [A_live | X] row, prow_A and prow_X
are separate products, and there is no unscramble.  The segment entries
(:func:`inplace_segment_1d`, :func:`solve_segment_1d`,
:func:`inplace_finalize_1d`) run supersteps [t0, t1) with the same step
code as the monolithic loops, so a segmented run gives their bits.

Every rank issues the same collectives in the same order on every path.
The probe launches of a rank equal the steps at which it held a live
candidate; the entries return those steps.  Every GEMM of the engines goes
through :func:`_matmul` or :func:`_addmm_`, which count its FLOPs into the
recording point's log (``group.tally_gemm``: the work observatory's pin;
one thread-local read with no log).
"""

from __future__ import annotations

import torch

from ..config import eps_for
from ..ops.block_inverse import probe_blocks
from ..ops.jordan_inplace import apply_col_perm, compose_swap_perm
from ..ops.norms import block_inf_norms
from .group import tally_gemm
from .layout import CyclicLayout
from .upcast import upcast_sub_fp32

#: The 1D engines of ``invert_blocks``.
ENGINES_1D = ("inplace", "lookahead", "grouped", "swapfree")


class _Decision:
    """A rank's local pivot candidate for one step, before the reduction:
    its key (inf without a live candidate), its global row (``Nr`` without
    one), and the probed inverses with the slot of the first of them."""

    def __init__(self, key, g_cand, invs, s_live):
        self.key, self.g_cand = key, g_cand
        self.invs, self.s_live = invs, s_live


def _live_start(t: int, p: int, k: int) -> int:
    """The first slot of rank k holding a global row ≥ t."""
    return -(-(t - k) // p) if t > k else 0


def _probe(cands, t: int, lay: CyclicLayout, rank: int, s_live: int, eps,
           probe, steps: list) -> _Decision:
    """Probe ``cands`` (the live (nc, m, m) stack from slot ``s_live``)
    and pick this rank's candidate: smallest ‖inv‖∞, lowest row on ties."""
    p, Nr = lay.p, lay.Nr
    if cands.shape[0] == 0:
        dev = cands.device
        key = torch.full((1,), float("inf"), dtype=cands.dtype, device=dev)
        return _Decision(key, torch.full((1,), Nr, dtype=torch.long,
                                         device=dev), None, s_live)
    steps.append(t)
    invs, sing = probe(cands, eps)
    key = torch.where(sing, float("inf"), block_inf_norms(invs))
    rel = torch.argmin(key)
    g_cand = (rel + s_live) * p + rank
    return _Decision(key[rel].reshape(1), g_cand.reshape(1), invs, s_live)


def _reduce(dec: _Decision, group, Nr: int):
    """The pivot reduction: (g_piv on the host, kmin on the device)."""
    kmin = group.all_reduce(dec.key.clone(), "min")
    cand = torch.where(dec.key == kmin, dec.g_cand,
                       torch.full_like(dec.g_cand, Nr))
    group.all_reduce(cand, "min")
    return int(cand.item()), kmin


def _pivot_broadcast(Wloc, dec: _Decision, g_piv: int, group, lay,
                     extra=None):
    """The owner's [pivot row | extra row | H] broadcast; returns the
    received (row_piv, extra_row, H)."""
    p, m, N = lay.p, lay.m, lay.N
    owner, slot = g_piv % p, g_piv // p
    we = 0 if extra is None else extra.shape[-1]
    buf = Wloc.new_empty((m, N + we + m))
    if group.rank == owner:
        buf[:, :N] = Wloc[slot]
        if extra is not None:
            buf[:, N:N + we] = extra[slot]
        buf[:, N + we:] = dec.invs[slot - dec.s_live]
    group.broadcast(buf, owner)
    return buf[:, :N], buf[:, N:N + we], buf[:, N + we:]


def _row_broadcast(rows, t: int, group, lay):
    """Row t of each tensor in ``rows`` (each (bpw, m, w)), broadcast from
    its owner as one (m, Σw) buffer; returns the rows, split."""
    p = lay.p
    widths = [r.shape[-1] for r in rows]
    buf = rows[0].new_empty((lay.m, sum(widths)))
    if group.rank == t % p:
        torch.cat([r[t // p] for r in rows], dim=1, out=buf)
    group.broadcast(buf, t % p)
    return torch.split(buf, widths, dim=1)


class _SideProbe:
    """The lookahead engine's probe on a side CUDA stream of high priority
    (the single-device ``_ProbeAhead``'s discipline): launched after the
    critical panel, taken (the main stream waits for it) before the
    reduction reads its output.  On the CPU it runs in order."""

    def __init__(self, device):
        self.main = self.side = None
        if device.type == "cuda":
            self.main = torch.cuda.current_stream(device)
            self.side = torch.cuda.Stream(device, priority=-1)

    def launch(self, fn, cands):
        if self.side is None:
            return fn(cands)
        self.side.wait_stream(self.main)
        cands.record_stream(self.side)
        with torch.cuda.stream(self.side):
            dec = fn(cands)
        for x in (dec.key, dec.g_cand, dec.invs):
            if x is not None:
                x.record_stream(self.main)
        return dec

    def take(self, dec):
        if self.side is not None:
            self.main.wait_stream(self.side)
        return dec


def _matmul(a, b):
    """a @ b, counted (module docstring)."""
    tally_gemm(a.shape[0], a.shape[1], b.shape[1])
    return a @ b


def _addmm_(out, a, b):
    """out -= a @ b in place, counted (module docstring)."""
    tally_gemm(a.shape[0], a.shape[1], b.shape[1])
    return out.addmm_(a, b, alpha=-1)


def _eliminate(Wloc, E, prow, cols=None):
    """Wloc[:, :, cols] -= E·prow[:, cols] on the (bpw·m, ·) strip."""
    bpw, m, N = Wloc.shape
    W2 = Wloc.view(bpw * m, N)
    E2 = E.reshape(bpw * m, m)
    if cols is None:
        _addmm_(W2, E2, prow)
    else:
        _addmm_(W2[:, cols], E2, prow[:, cols])


def _inplace_step(Wloc, t: int, dec: _Decision, group, lay, singular,
                  pivots: list, ahead=None):
    """Superstep t of the in-place loop on this rank's blocks, from step
    t's probe decision ``dec``: the reduction, the broadcasts, swap-by-copy,
    normalize and eliminate, in place.  ``ahead(t + 1, cols)`` (the
    lookahead engine) runs after the critical panel and its decision is
    returned; without it the step returns None."""
    p, m, N, Nr = lay.p, lay.m, lay.N, lay.Nr
    k = group.rank
    cs = slice(t * m, (t + 1) * m)
    g_piv, kmin = _reduce(dec, group, Nr)
    singular |= ~torch.isfinite(kmin)
    pivots.append(g_piv)
    row_piv, _, H = _pivot_broadcast(Wloc, dec, g_piv, group, lay)
    row_t = (row_piv if g_piv == t
             else _row_broadcast([Wloc], t, group, lay)[0])
    if k == g_piv % p:
        Wloc[g_piv // p] = row_t                    # swap-by-copy
    prow = _matmul(H, row_piv)
    prow[:, cs] = H
    own_t = k == t % p
    E = Wloc[:, :, cs].clone()
    if own_t:
        E[t // p] = 0
    Wloc[:, :, cs] = 0
    nxt = None
    if ahead is not None and t < Nr - 1:
        c0 = (t + 1) * m
        _eliminate(Wloc, E, prow, slice(c0, c0 + m))    # critical panel
        nxt = ahead(t + 1, slice(c0, c0 + m))
        _eliminate(Wloc, E, prow, slice(0, c0))         # trailing
        if c0 + m < N:
            _eliminate(Wloc, E, prow, slice(c0 + m, N))
    else:
        _eliminate(Wloc, E, prow)
    if own_t:
        Wloc[t // p] = prow
    return nxt


def _solve_step(Wloc, Xloc, t: int, dec: _Decision, group, lay, singular,
                pivots: list, ahead=None):
    """Superstep t of the [A | B] elimination on this rank's A blocks
    ``Wloc`` and right-hand-side rows ``Xloc`` (the JAX package's
    ``_solve_step`` and ``_solve_step_lookahead``), in place.  Only the
    live columns [t·m, N) of A move; there is no in-place column
    replacement and no unscramble.  The pivot row goes out as one stacked
    [A_live | X | H] buffer, row t as one [A_live | X]; prow_A and prow_X
    are separate products; the multipliers come from the post-swap column
    t with row t excluded.  ``ahead`` as in :func:`_inplace_step`."""
    p, m, bpw, N, Nr = lay.p, lay.m, lay.blocks_per_worker, lay.N, lay.Nr
    k = group.rank
    lo = t * m
    live, nrhs = N - lo, Xloc.shape[-1]
    g_piv, kmin = _reduce(dec, group, Nr)
    singular |= ~torch.isfinite(kmin)
    pivots.append(g_piv)
    owner, sp = g_piv % p, g_piv // p
    buf = Wloc.new_empty((m, live + nrhs + m))
    if k == owner:
        buf[:, :live] = Wloc[sp, :, lo:]
        buf[:, live:live + nrhs] = Xloc[sp]
        buf[:, live + nrhs:] = dec.invs[sp - dec.s_live]
    group.broadcast(buf, owner)
    H = buf[:, live + nrhs:]
    rp_A, rp_X = buf[:, :live], buf[:, live:live + nrhs]
    if g_piv != t:
        rt_A, rt_X = _row_broadcast([Wloc[:, :, lo:], Xloc], t, group, lay)
        if k == owner:                                  # swap-by-copy
            Wloc[sp, :, lo:] = rt_A
            Xloc[sp] = rt_X
    prow_A = _matmul(H, rp_A)
    prow_X = _matmul(H, rp_X)
    own_t = k == t % p
    E = Wloc[:, :, lo:lo + m].clone()
    if own_t:
        E[t // p] = 0
    E2 = E.view(bpw * m, m)
    W2 = Wloc.view(bpw * m, N)
    nxt = None
    if ahead is not None and t < Nr - 1:
        c0 = lo + m
        _addmm_(W2[:, c0:c0 + m], E2, prow_A[:, m:2 * m])
        nxt = ahead(t + 1, slice(c0, c0 + m))
        _addmm_(W2[:, lo:c0], E2, prow_A[:, :m])
        if c0 + m < N:
            _addmm_(W2[:, c0 + m:], E2, prow_A[:, 2 * m:])
    else:
        _addmm_(W2[:, lo:], E2, prow_A)
    _addmm_(Xloc.view(bpw * m, nrhs), E2, prow_X)
    if own_t:
        Wloc[t // p, :, lo:] = prow_A
        Xloc[t // p] = prow_X
    return nxt


def _run_steps(step, Wloc, group, lay, eps, probe, lookahead: bool,
               t0: int = 0, t1: int | None = None) -> list:
    """Supersteps [t0, t1) of a plain or probe-ahead loop, ``step(t, dec,
    ahead)`` being :func:`_inplace_step` or :func:`_solve_step` bound to
    the rank's state.  Returns the steps this rank probed."""
    p, m = lay.p, lay.m
    t1 = lay.Nr if t1 is None else t1
    k = group.rank
    steps = []
    side = _SideProbe(Wloc.device) if lookahead else None

    def probe_col(t):
        s_live = _live_start(t, p, k)
        return _probe(Wloc[s_live:, :, t * m:(t + 1) * m].contiguous(), t,
                      lay, k, s_live, eps, probe, steps)

    def ahead(t, cols):
        s1 = _live_start(t, p, k)
        return side.launch(
            lambda c: _probe(c, t, lay, k, s1, eps, probe, steps),
            Wloc[s1:, :, cols].contiguous())

    dec = probe_col(t0) if lookahead else None
    for t in range(t0, t1):
        dec = side.take(dec) if lookahead else probe_col(t)
        dec = step(t, dec, ahead if lookahead else None)
    return steps


def _no_singular(Wloc):
    return torch.zeros(1, dtype=torch.bool, device=Wloc.device)


def _plain_steps(Wloc, group, lay, eps, probe, lookahead: bool,
                 t0: int = 0, t1: int | None = None, singular=None):
    """The plain and probe-ahead invert loops over supersteps [t0, t1);
    returns (singular, pivots, probe_steps)."""
    singular = _no_singular(Wloc) if singular is None else singular
    pivots = []
    steps = _run_steps(
        lambda t, dec, ahead: _inplace_step(Wloc, t, dec, group, lay,
                                            singular, pivots, ahead),
        Wloc, group, lay, eps, probe, lookahead, t0, t1)
    return singular, pivots, steps


def _solve_loop(Wloc, Xloc, group, lay, eps, probe, lookahead: bool,
                t0: int = 0, t1: int | None = None, singular=None):
    """The plain and probe-ahead [A | B] loops over supersteps [t0, t1);
    returns (singular, pivots, probe_steps)."""
    singular = _no_singular(Wloc) if singular is None else singular
    pivots = []
    steps = _run_steps(
        lambda t, dec, ahead: _solve_step(Wloc, Xloc, t, dec, group, lay,
                                          singular, pivots, ahead),
        Wloc, group, lay, eps, probe, lookahead, t0, t1)
    return singular, pivots, steps


def _grouped_steps(Wloc, group, lay, eps, probe, kgrp: int):
    """The delayed-group-update loop (the JAX 1D ``_gstep``/``_group_end``
    pair): U (bpw, m, kg·m) holds the local rows of the pending panels
    (swapped with W's rows), P (kg·m, N) the finalized pivot rows, the
    same on every rank; a group closes with one GEMM, no collective."""
    p, m, bpw, N, Nr = lay.p, lay.m, lay.blocks_per_worker, lay.N, lay.Nr
    k = group.rank
    kgrp = max(1, min(kgrp, Nr))
    singular = torch.zeros(1, dtype=torch.bool, device=Wloc.device)
    pivots, steps = [], []
    for t0 in range(0, Nr, kgrp):
        kg = min(kgrp, Nr - t0)
        U = Wloc.new_zeros((bpw, m, kg * m))
        P = Wloc.new_zeros((kg * m, N))
        for j in range(kg):
            t = t0 + j
            cs = slice(t * m, (t + 1) * m)
            # --- EAGER CANDIDATE COLUMN: W[:, t] minus pending panels.
            col = Wloc[:, :, cs].clone()
            if j:
                _addmm_(col.view(bpw * m, m),
                        U[:, :, :j * m].reshape(bpw * m, j * m),
                        P[:j * m, cs])
            s_live = _live_start(t, p, k)
            dec = _probe(col[s_live:].contiguous(), t, lay, k, s_live, eps,
                         probe, steps)
            g_piv, kmin = _reduce(dec, group, Nr)
            singular |= ~torch.isfinite(kmin)
            pivots.append(g_piv)
            # --- the pivot row with its U row and H; row t with its U row
            # and its eager column block (main.cpp:1097/1122-1129).
            row_piv, u_p, H = _pivot_broadcast(Wloc, dec, g_piv, group,
                                               lay, extra=U)
            sp, st = g_piv // p, t // p
            if g_piv != t:
                row_t, u_t, col_t = _row_broadcast([Wloc, U, col], t, group,
                                                   lay)
                if k == g_piv % p:                      # swap-by-copy
                    Wloc[sp] = row_t
                    U[sp] = u_t
                    col[sp] = col_t
            own_t = k == t % p
            if own_t:
                col[st] = 0
            # --- EAGER PIVOT ROW + NORMALIZE; the t-chunk becomes H.
            if j:
                tally_gemm(m, j * m, N)
                row_piv = torch.addmm(row_piv, u_p[:, :j * m], P[:j * m],
                                      alpha=-1)
            prow = _matmul(H, row_piv)
            prow[:, cs] = H
            # --- BOOKKEEPING: zero W's column t and P's pending t-chunk,
            # finalize row t, record the panel.
            Wloc[:, :, cs] = 0
            if j:
                P[:j * m, cs] = 0
            if own_t:
                Wloc[st] = prow
                U[st] = 0
            U[:, :, j * m:(j + 1) * m] = col
            P[j * m:(j + 1) * m] = prow
        # --- GROUP END: one (bpw·m, kg·m)×(kg·m, N) GEMM, no collective.
        _addmm_(Wloc.view(bpw * m, N), U.view(bpw * m, kg * m), P)
    return singular, pivots, steps


def _swapfree_steps(Wloc, group, lay, eps, probe):
    """The swap-free loop: rows stay put; ``pos[x]`` is the swap
    coordinate of physical row x (``ipos`` its inverse), the same on every
    rank; ties go to the lowest swap coordinate (the swap engines'
    lowest-current-row rule, main.cpp:1051-1064).  Returns (singular,
    swap coordinates, probe_steps, pos)."""
    p, m, bpw, N, Nr = lay.p, lay.m, lay.blocks_per_worker, lay.N, lay.Nr
    k = group.rank
    dev = Wloc.device
    singular = torch.zeros(1, dtype=torch.bool, device=dev)
    alive = list(range(bpw))
    pos, ipos = list(range(Nr)), list(range(Nr))
    swaps, steps = [], []
    for t in range(Nr):
        cs = slice(t * m, (t + 1) * m)
        if alive:
            steps.append(t)
            idx = torch.as_tensor(alive, dtype=torch.long, device=dev)
            invs, sing = probe(Wloc[:, :, cs].index_select(0, idx), eps)
            key = torch.where(sing, float("inf"), block_inf_norms(invs))
            posl = torch.as_tensor([pos[s * p + k] for s in alive],
                                   dtype=torch.long, device=dev)
            lmin = key.min()
            my_pos = torch.where(key == lmin, posl, Nr).min().reshape(1)
            my_key = lmin.reshape(1)
        else:
            invs = None
            my_key = torch.full((1,), float("inf"), dtype=Wloc.dtype,
                                device=dev)
            my_pos = torch.full((1,), Nr, dtype=torch.long, device=dev)
        kmin = group.all_reduce(my_key.clone(), "min")
        win = torch.where(my_key == kmin, my_pos, Nr)
        group.all_reduce(win, "min")
        finite, win_pos = torch.stack(
            [torch.isfinite(kmin).to(torch.float64)[0],
             win.to(torch.float64)[0]]).tolist()
        singular |= ~torch.isfinite(kmin)
        # All-singular pin: the physical row at swap position t, H := 0.
        g_piv = ipos[int(win_pos)] if finite else ipos[t]
        owner, sp = g_piv % p, g_piv // p
        buf = Wloc.new_empty((m, N + m))
        if k == owner:
            buf[:, :N] = Wloc[sp]
            if finite:
                buf[:, N:] = invs[alive.index(sp)]
            else:
                buf[:, N:] = 0
        group.broadcast(buf, owner)
        row_piv, H = buf[:, :N], buf[:, N:]
        prow = _matmul(H, row_piv)
        prow[:, cs] = H
        # --- ELIMINATE every row but the pivot's physical row, which
        # receives prow (rows stay put).
        E = Wloc[:, :, cs].clone()
        if k == owner:
            E[sp] = 0
        Wloc[:, :, cs] = 0
        _eliminate(Wloc, E, prow)
        if k == owner:
            Wloc[sp] = prow
            alive.remove(sp)
        # --- BOOKKEEPING: replay the swap engines' t <-> pos[g_piv] on
        # the replicated permutation.
        piv_pos, x = pos[g_piv], ipos[t]
        pos[x], pos[g_piv] = piv_pos, t
        ipos[t], ipos[piv_pos] = g_piv, x
        swaps.append(piv_pos)
    return singular, swaps, steps, pos


@upcast_sub_fp32
def invert_blocks(blocks, group, lay: CyclicLayout, engine: str = "inplace",
                  group_k: int = 0, eps: float | None = None,
                  probe=probe_blocks):
    """Invert the distributed identity-padded matrix whose rank-local
    (bpw, m, N) cyclic blocks are ``blocks`` (not modified).  ``engine``
    is one of :data:`ENGINES_1D` (``group_k`` the grouped engine's k,
    default 2); ``probe(cands, eps)`` inverts a candidate stack (default
    ``probe_blocks``: the kernels on the card).  Every rank of ``group``
    calls it together.  Returns ``(inverse blocks, singular, pivots,
    probe_steps)``: this rank's blocks of the inverse in cyclic natural row
    order, the 0-d-like (1,) singular flag, the pivot sequence and the
    steps this rank probed.  Counterpart of the JAX package's
    ``compile_sharded_jordan_inplace(...)(blocks)``."""
    if engine not in ENGINES_1D:
        raise ValueError(f"unknown 1D engine {engine!r}; choose from "
                         f"{'/'.join(ENGINES_1D)}")
    if eps is None:
        eps = eps_for(blocks.dtype)
    W = blocks.clone()
    if engine == "swapfree":
        from .permute import permute_rows

        singular, pivots, steps, pos = _swapfree_steps(W, group, lay, eps,
                                                       probe)
        W = apply_col_perm(W, compose_swap_perm(pivots, lay.Nr), lay.m)
        W = permute_rows(W, pos, group, lay)
    else:
        if engine == "grouped":
            singular, pivots, steps = _grouped_steps(
                W, group, lay, eps, probe, group_k if group_k > 1 else 2)
        else:
            singular, pivots, steps = _plain_steps(
                W, group, lay, eps, probe, lookahead=engine == "lookahead")
        W = apply_col_perm(W, compose_swap_perm(pivots, lay.Nr), lay.m)
    return W, singular, pivots, steps


def to_identity_padded_blocks(a: torch.Tensor, lay: CyclicLayout,
                              rank: int) -> torch.Tensor:
    """Rank ``rank``'s (bpw, m, N) blocks of ``a`` identity-padded to N
    (global block row ``s·p + rank`` at slot s).  Counterpart of the JAX
    package's ``ring_gemm._to_identity_padded_blocks`` (a scatter there,
    a slice of the rank's own rows here)."""
    from ..ops.padding import pad_with_identity

    ap = pad_with_identity(a, lay.N).reshape(lay.Nr, lay.m, lay.N)
    return ap[rank::lay.p].contiguous()


def gather_inverse_inplace(shards, lay: CyclicLayout, n: int):
    """The (n, n) inverse from the ranks' blocks ``shards`` (a list in rank
    order, or the (Nr, m, N) cyclic storage tensor): cyclic row order to
    natural order, padding stripped.  Counterpart of the JAX package's
    ``gather_inverse_inplace``."""
    from .layout import cyclic_scatter_perm

    out = shards if isinstance(shards, torch.Tensor) else torch.cat(shards)
    perm = cyclic_scatter_perm(lay).to(out.device)
    out = out.index_select(0, perm)
    return out.reshape(lay.N, lay.N)[:n, :n]


def inverse_corner_1d(shards, lay: CyclicLayout, n: int, max_p: int = 10):
    """The top-left min(n, max_p) corner of the inverse from the owning
    blocks alone (the ``gather=False`` verbose print, main.cpp:459-461).
    ``shards``: the ranks' blocks in rank order.  Counterpart of the JAX
    package's ``inverse_corner_1d``."""
    c = min(n, max_p)
    nb = -(-c // lay.m)
    parts = [shards[r % lay.p][r // lay.p, :, :c] for r in range(nb)]
    return torch.cat(parts, dim=0)[:c]


def invert_shards(group, shards, lay: CyclicLayout, engine: str = "inplace",
                  group_k: int = 0, probe=probe_blocks) -> dict:
    """:func:`invert_blocks` on this rank's shard of ``shards`` (every
    rank's (bpw, m, N) blocks in rank order, numpy arrays or CPU tensors:
    ``interop.split_cyclic_blocks`` of the JAX package's block tensor),
    moved to the rank's device.  Returns this rank's CPU outcome:
    ``blocks``, ``singular``, ``pivots``, ``probe_steps``."""
    from ..interop import from_numpy

    W = from_numpy(shards[group.rank], group.device)
    inv, singular, pivots, steps = invert_blocks(
        W, group, lay, engine=engine, group_k=group_k, probe=probe)
    return {"blocks": inv.cpu(), "singular": bool(singular.item()),
            "pivots": pivots, "probe_steps": steps}


# --- The distributed [A | B] solve: X = A⁻¹B with no inverse formed.


@upcast_sub_fp32
def solve_blocks(blocks, rhs, group, lay: CyclicLayout,
                 lookahead: bool = False, eps: float | None = None,
                 probe=probe_blocks):
    """Solve on this rank's (bpw, m, N) identity-padded A blocks and its
    (bpw, m, k) zero-padded right-hand-side rows (neither is modified);
    every rank of ``group`` calls it together.  Returns ``(x blocks,
    singular, pivots, probe_steps)``: this rank's rows of X in cyclic
    order.  ``lookahead`` takes the probe-ahead schedule (the same pivots
    and the same collectives).  Counterpart of the JAX package's
    ``compile_sharded_jordan_solve(...)(W, X)``."""
    if eps is None:
        eps = eps_for(blocks.dtype)
    W = blocks.clone()
    X = rhs.to(device=W.device, dtype=W.dtype).clone()
    singular, pivots, steps = _solve_loop(W, X, group, lay, eps, probe,
                                          lookahead)
    return X, singular, pivots, steps


def compile_sharded_jordan_solve(lay: CyclicLayout, eps: float | None = None,
                                 probe=probe_blocks,
                                 unroll: bool | None = None,
                                 lookahead: bool = False):
    """The 1D distributed solve for a layout, as ``run(group, W, X) -> (x
    blocks, singular, pivots, probe_steps)``.  The JAX package compiles an
    unrolled engine up to MAX_UNROLL_NR and a fori twin beyond; here both
    are the one eager loop of :func:`solve_blocks`.  ``lookahead=True`` is
    the probe-ahead engine, unrolled-only as in the JAX package: refused
    above MAX_UNROLL_NR.  Counterpart of ``compile_sharded_jordan_solve``."""
    from ..config import MAX_UNROLL_NR
    from ..errors import UsageError

    if unroll is None:
        unroll = lay.Nr <= MAX_UNROLL_NR
    if lookahead and not unroll:
        raise UsageError(
            f"engine='solve_lookahead' is unrolled-only (the critical-panel "
            f"split needs static column offsets) and Nr={lay.Nr} exceeds "
            f"MAX_UNROLL_NR={MAX_UNROLL_NR}; use engine='solve_sharded' (its "
            f"fori twin covers any Nr) or a larger block_size")

    def run(group, W, X):
        return solve_blocks(W, X, group, lay, lookahead=lookahead, eps=eps,
                            probe=probe)

    return run


def scatter_rhs_1d(b, lay: CyclicLayout, rank: int) -> torch.Tensor:
    """Rank ``rank``'s (bpw, m, k) rows of the (n, k) right-hand side ``b``
    (a tensor or numpy array), zero-padded to N rows: the padding rows of X
    stay exactly zero through the elimination.  Counterpart of the JAX
    package's ``scatter_rhs_1d`` (a scatter there, the rank's own rows
    here)."""
    b = torch.as_tensor(b)
    bp = b.new_zeros((lay.N, b.shape[-1]))
    bp[:b.shape[0]] = b
    return bp.view(lay.Nr, lay.m, -1)[rank::lay.p].contiguous()


def gather_solution_1d(xb, lay: CyclicLayout, n: int) -> torch.Tensor:
    """The (n, k) solution from the ranks' X blocks (a list in rank order,
    or the (Nr, m, k) cyclic storage tensor): natural row order, padding
    stripped.  Counterpart of the JAX package's ``gather_solution_1d``."""
    from .layout import cyclic_scatter_perm

    out = xb if isinstance(xb, torch.Tensor) else torch.cat(list(xb))
    out = out.index_select(0, cyclic_scatter_perm(lay).to(out.device))
    return out.reshape(lay.N, -1)[:n]


# --- Segment entries of the checkpointed runs (resilience/checkpoint.py):
# supersteps [t0, t1) with the monolithic loops' own step code; the
# unscramble runs only in the finalize.


def inplace_segment_1d(Wloc, singular, swaps, group, lay: CyclicLayout,
                       t0: int, t1: int, eps: float | None = None,
                       probe=probe_blocks) -> list:
    """Supersteps [t0, t1) of the plain 1D invert on this rank's blocks
    ``Wloc`` and its (1,) ``singular`` flag, in place; the pivots go to
    ``swaps[t0:t1]`` (the rank's row of the (p, Nr) record, the same on
    every rank).  Returns the steps this rank probed.  Counterpart of the
    JAX package's ``_sharded_jordan_inplace_segment``."""
    if eps is None:
        eps = eps_for(Wloc.dtype)
    _, pivots, steps = _plain_steps(Wloc, group, lay, eps, probe, False,
                                    t0, t1, singular)
    swaps[t0:t1] = torch.as_tensor(pivots, dtype=swaps.dtype)
    return steps


def solve_segment_1d(Wloc, Xloc, singular, group, lay: CyclicLayout,
                     t0: int, t1: int, eps: float | None = None,
                     probe=probe_blocks) -> list:
    """Supersteps [t0, t1) of the 1D solve on this rank's ``Wloc``,
    ``Xloc`` and ``singular``, in place; returns the steps this rank
    probed.  Counterpart of the JAX package's
    ``_sharded_jordan_solve_segment``."""
    if eps is None:
        eps = eps_for(Wloc.dtype)
    _, _, steps = _solve_loop(Wloc, Xloc, group, lay, eps, probe, False,
                              t0, t1, singular)
    return steps


def inplace_finalize_1d(Wloc, swaps, lay: CyclicLayout) -> torch.Tensor:
    """The invert's unscramble after the last segment: the swap record as
    one block-column permutation, applied rank-locally.  Counterpart of
    the JAX package's ``_sharded_inplace_finalize``."""
    return apply_col_perm(Wloc, compose_swap_perm(swaps.tolist(), lay.Nr),
                          lay.m)
