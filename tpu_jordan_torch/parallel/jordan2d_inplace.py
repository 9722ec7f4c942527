"""The 2D block-cyclic in-place engines, one process per rank of a (pr, pc)
mesh.  Counterpart of the JAX package's ``parallel/jordan2d_inplace.py``:
the invert family (``compile_sharded_jordan_inplace_2d``: the plain engine
and its fori twin, the grouped, probe-ahead and swap-free engines), the
[A | B] solves (``compile_sharded_jordan_solve_2d``) and the segment
entries of the checkpointed runs, over ``torch.distributed``
(``group.MeshGroup2D``) instead of ``shard_map``.

Each rank holds its (bpr, m, Wc) shard of the identity-padded matrix
(``jordan2d.py``: slot s is global row block s·pr + kr, chunk u global
column block u·pc + kc; Wc = N/pc).  A superstep t, as the JAX ``_step2d``
runs it (main.cpp:953-1204):

  * **chunk broadcast** on the row communicator from the owner column
    (t % pc): the (bpr, m, m) t-chunk, which is both the probe's
    candidates and the eliminate's multipliers;
  * **probe** (``ops.block_inverse.probe_blocks``: the panel kernel or
    ``gj_probe.cu`` on the card) of this rank's share of the live slots
    (global rows ≥ t): under the "column" probe layout every mesh column
    probes the slots ``s0+kc, s0+kc+pc, …`` of the live window (s0 =
    t // pr), under "owner" the owner column probes them all and the
    others launch nothing.  A rank with no live candidate offers +∞;
  * **pivot reduction**: the world's ``all_reduce(MIN)`` of the key, then
    of the global row (ties to the lowest), read on the host; the prober
    broadcasts H over the world;
  * **row broadcasts** on the column communicator: the pivot row, and row
    t unless the pivot is row t (every rank knows);
  * **swap-by-copy**; the pivot row is normalized (prow = H·row_piv) and
    the owner column's t-chunk of prow becomes H;
  * **swap fix-up**: the slot that received old row t (on mesh row
    g % pr) needs old row t's t-chunk as its multiplier: an (m, m)
    broadcast on that mesh row's communicator from the owner column (the
    JAX package psums it on every mesh row; only that one needs it), and
    the slot now holding row t gets zero multipliers;
  * **eliminate**: one ``addmm_`` over the whole shard; row t takes prow.

The live window is exact (slots from the rank's first row ≥ t), so the
JAX fori engines' quarter ladder (``probe_blocks_quarter_masked``: a
masked full window in a traced loop) has no counterpart: the "unrolled"
and "fori" twins are the one eager loop here.  Each candidate is probed
by exactly one rank, so both probe layouts give the same pivots, bit for
bit.  **The probe layout** ``"auto"`` is the port's reading of the JAX
rule (column on a TPU, owner on shared silicon): "column" when every rank
has a card of its own (the backend rule's nccl case), "owner" otherwise
(CPU ranks, or several ranks on one card, whose probes serialize).

**The unscramble**: the JAX package replays the column swaps in reverse,
exchanging two (bpr, m, m) panels with one-hot psums along "pc" each step.
Here the swap record is folded into one block-column permutation
(``compose_swap_perm``) and the chunks move once, point to point on the
row communicator (``permute.permute_cyclic``; a chunk that stays on its
mesh column is a local copy).  It is pure data movement: the bits are the
same.

Engines: ``inplace``; ``lookahead``: the critical panel (the chunk holding
column t+1) first, then step t+1's chunk broadcast, and its probe on a
side CUDA stream (the 1D ``_SideProbe``), then the trailing chunks; the
reduction runs at the top of step t+1.  ``grouped`` (k): U (bpr, m, k·m),
the pending panels' multipliers, replicated along the row communicator, P
(k·m, Wc), the finalized pivot rows, column-sharded; the eager chunk is
the owner column's W chunk less U·P; each step's two rows, their U rows and
the eager chunk's t-block travel as one stacked (2m, Wc + k·m + m) sum on
the column communicator (the JAX psum); a group closes with one
``addmm_``, TF32 off, no collective.  ``swapfree``: rows never move; the
pivot permutation is tracked on the host (``pos``/``ipos``, ties by swap
coordinate), the probe covers the alive slots, one pivot-row broadcast a
step and no fix-up; after the loop one column permutation on the row
communicator and one row permutation on the column communicator
(``permute.py``).

The solve (:func:`solve_blocks_2d`) runs the same superstep on [A | X]: X
(bpr, m, k) is row-sharded along pr and replicated along pc; only A's
chunks from t // pc on and X move; the pivot row and row t each go out as
one stacked [A_live | X] row on the column communicator; prow_A and prow_X
are separate products; there is no column replacement and no unscramble.
Every mesh column applies the same X update from the same operands, so
the replicas stay bit-identical.

Every rank issues the same collectives on the same communicators in the
same order, on the singular path too: a rank whose probe slice is empty,
a non-owner column, a rank outside the mesh row of a fix-up (which
issues nothing there) all keep step.  The probe launches of a rank equal
the steps at which its slice was non-empty; the entries return those
steps and the global rows probed at each.
"""

from __future__ import annotations

import torch

from ..config import MAX_UNROLL_NR, eps_for
from ..errors import UsageError
from ..ops.block_inverse import probe_blocks
from ..ops.jordan_inplace import compose_swap_perm
from ..ops.norms import block_inf_norms
from .layout import CyclicLayout2D
from .group import tally_gemm
from .sharded_inplace import (_addmm_, _eliminate, _live_start, _matmul,
                              _reduce, _SideProbe)
from .upcast import upcast_sub_fp32

#: The 2D engines of ``invert_blocks_2d``.
ENGINES_2D = ("inplace", "lookahead", "grouped", "swapfree")

#: The probe layouts (``resolve_probe_layout``).
PROBE_LAYOUTS = ("auto", "column", "owner")


def resolve_probe_layout(probe_layout: str, backend: str) -> bool:
    """True for the column layout.  "auto" is column when every rank has a
    card of its own (``backend`` "nccl"), owner otherwise (module
    docstring)."""
    if probe_layout not in PROBE_LAYOUTS:
        raise ValueError(f"probe_layout {probe_layout!r}: choose from "
                         f"{'/'.join(PROBE_LAYOUTS)}")
    if probe_layout == "auto":
        return backend == "nccl"
    return probe_layout == "column"


class _Dec2D:
    """A rank's pivot candidate for one step before the reduction: its key
    (inf without a live candidate), its global row (``Nr`` without one),
    the probed inverses, the local slots probed, the broadcast chunk, and
    (swap-free) the candidate's swap coordinate."""

    def __init__(self, key, g_cand, invs, slots, chunk, pos=None):
        self.key, self.g_cand, self.invs = key, g_cand, invs
        self.slots, self.chunk, self.pos = slots, chunk, pos


class _Run:
    """One rank's static context of a 2D run: the mesh, the layout, the
    probe and its layout, and the record of what this rank probed
    (``probed``: (t, global rows) of every step with a non-empty slice)
    and of the swap-free steps whose window was all singular (``pinned``:
    no H goes out there, so the comm inventory needs them)."""

    def __init__(self, mg, lay: CyclicLayout2D, eps, probe, probe_cols):
        self.mg, self.lay, self.eps, self.probe = mg, lay, eps, probe
        self.probe_cols = probe_cols
        self.probed = []
        self.pinned = []

    # --- collectives

    def chunk_bcast(self, t: int, local) -> torch.Tensor:
        """Step t's (bpr, m, m) chunk from the owner column ``t % pc`` on
        the row communicator; ``local`` is read on the owner only."""
        mg, lay = self.mg, self.lay
        if mg.kc == t % lay.pc:
            buf = local.clone(memory_format=torch.contiguous_format)
        else:
            buf = local.new_empty((lay.bpr, lay.m, lay.m))
        return mg.row.broadcast(buf, mg.rank_of(mg.kr, t % lay.pc))

    def row_bcast(self, rows, r: int, lo: int = 0) -> torch.Tensor:
        """Global row ``r`` of the (bpr, m, ·) tensors ``rows`` (columns
        from ``lo`` for the first), stacked into one (m, Σw) buffer on the
        column communicator from its owner mesh row."""
        mg, lay = self.mg, self.lay
        parts = [rows[0][:, :, lo:]] + list(rows[1:])
        buf = rows[0].new_empty((lay.m, sum(x.shape[-1] for x in parts)))
        if mg.kr == r % lay.pr:
            torch.cat([x[r // lay.pr] for x in parts], dim=1, out=buf)
        return mg.col.broadcast(buf, mg.rank_of(r % lay.pr, mg.kc))

    def h_bcast(self, dec: _Dec2D, g: int, t: int,
                sweep_all: bool = False) -> torch.Tensor:
        """H, the winner's probed inverse, from the rank that probed row
        ``g`` over the world."""
        mg, lay = self.mg, self.lay
        sp = g // lay.pr
        if not self.probe_cols:
            kc_p = t % lay.pc
        else:
            kc_p = (sp if sweep_all else sp - t // lay.pr) % lay.pc
        src = mg.rank_of(g % lay.pr, kc_p)
        if mg.rank == src:
            buf = dec.invs[dec.slots.index(sp)].contiguous()
        else:
            buf = dec.chunk.new_empty((lay.m, lay.m))
        return mg.world.broadcast(buf, src)

    def fixup(self, row_t, g: int, t: int, u_t: int):
        """Old row t's t-chunk on mesh row ``g % pr`` (the swap fix-up),
        from the owner column's copy of row t; None elsewhere."""
        mg, lay, m = self.mg, self.lay, self.lay.m
        if mg.kr != g % lay.pr:
            return None
        if mg.kc == t % lay.pc:
            buf = row_t[:, u_t * m:(u_t + 1) * m].contiguous()
        else:
            buf = row_t.new_empty((m, m))
        return mg.row.broadcast(buf, mg.rank_of(mg.kr, t % lay.pc))

    # --- the probe

    def slots(self, t: int, alive=None) -> list:
        """This rank's probe slice at step t: local slots of live rows
        (``alive``: the swap-free engine's alive slots, a full window)."""
        lay, kr, kc = self.lay, self.mg.kr, self.mg.kc
        pr, pc = lay.pr, lay.pc
        if alive is None:
            live = range(_live_start(t, pr, kr), lay.bpr)
            s0 = t // pr
            if self.probe_cols:
                return [s for s in live if (s - s0) % pc == kc]
        else:
            live = alive
            if self.probe_cols:
                return [s for s in live if s % pc == kc]
        return list(live) if kc == t % pc else []

    def probe_at(self, t: int, chunk, alive=None, pos=None) -> _Dec2D:
        """Probe this rank's slice of step t's broadcast chunk and pick its
        candidate: smallest ‖inv‖∞, then the lowest global row (swap-free:
        the lowest swap coordinate)."""
        lay, kr = self.lay, self.mg.kr
        slots = self.slots(t, alive)
        dev = chunk.device
        if not slots:
            key = torch.full((1,), float("inf"), dtype=chunk.dtype,
                             device=dev)
            none = torch.full((1,), lay.Nr, dtype=torch.long, device=dev)
            return _Dec2D(key, none, None, slots, chunk, none)
        self.probed.append((t, [s * lay.pr + kr for s in slots]))
        step = slots[1] - slots[0] if len(slots) > 1 else 1
        if alive is None:
            cands = chunk[slots[0]:slots[-1] + 1:step].contiguous()
        else:
            cands = chunk.index_select(
                0, torch.as_tensor(slots, dtype=torch.long, device=dev))
        invs, sing = self.probe(cands, self.eps)
        key = torch.where(sing, float("inf"), block_inf_norms(invs))
        g = torch.as_tensor([s * lay.pr + kr for s in slots],
                            dtype=torch.long, device=dev)
        if pos is None:
            rel = torch.argmin(key)
            return _Dec2D(key[rel].reshape(1), g[rel].reshape(1), invs,
                          slots, chunk)
        posl = torch.as_tensor([pos[x] for x in g.tolist()],
                               dtype=torch.long, device=dev)
        lmin = key.min()
        my_pos = torch.where(key == lmin, posl, lay.Nr).min().reshape(1)
        return _Dec2D(lmin.reshape(1), None, invs, slots, chunk, my_pos)


def _no_singular(W):
    return torch.zeros(1, dtype=torch.bool, device=W.device)


def _step2d(run: _Run, Wloc, t: int, dec: _Dec2D, singular, pivots: list,
            ahead=None):
    """Superstep t of the plain (and probe-ahead) 2D invert on this rank's
    shard, in place, from step t's decision ``dec`` (module docstring).
    ``ahead(t + 1, panel)`` (the lookahead engine) runs after the critical
    panel, and its decision is returned."""
    mg, lay = run.mg, run.lay
    pr, pc, m, Nr = lay.pr, lay.pc, lay.m, lay.Nr
    kr, kc = mg.kr, mg.kc
    u_t = t // pc
    cs = slice(u_t * m, (u_t + 1) * m)
    own_c = kc == t % pc
    g, kmin = _reduce(dec, mg.world, Nr)
    singular |= ~torch.isfinite(kmin)
    pivots.append(g)
    H = run.h_bcast(dec, g, t)
    row_piv = run.row_bcast([Wloc], g)
    row_t = row_piv if g == t else run.row_bcast([Wloc], t)
    own_p, sp = kr == g % pr, g // pr
    own_t, st = kr == t % pr, t // pr
    if own_p and g != t:
        Wloc[sp] = row_t                            # swap-by-copy
    prow = _matmul(H, row_piv)
    if own_c:
        prow[:, cs] = H
    E = dec.chunk.clone()
    if g != t:
        fix = run.fixup(row_t, g, t, u_t)
        if own_p:
            E[sp] = fix
    if own_t:
        E[st] = 0
    if own_c:
        Wloc[:, :, cs] = 0
    nxt = None
    if ahead is not None and t < Nr - 1:
        c0 = ((t + 1) // pc) * m
        _eliminate(Wloc, E, prow, slice(c0, c0 + m))    # critical panel
        panel = Wloc[:, :, c0:c0 + m].clone()
        if own_t:
            panel[st] = prow[:, c0:c0 + m]
        nxt = ahead(t + 1, panel)
        if c0:
            _eliminate(Wloc, E, prow, slice(0, c0))     # trailing
        if c0 + m < Wloc.shape[-1]:
            _eliminate(Wloc, E, prow, slice(c0 + m, Wloc.shape[-1]))
    else:
        _eliminate(Wloc, E, prow)
    if own_t:
        Wloc[st] = prow
    return nxt


def _solve_step2d(run: _Run, Wloc, Xloc, t: int, dec: _Dec2D, singular,
                  pivots: list, ahead=None):
    """Superstep t of the 2D [A | B] elimination on this rank's A shard and
    its (bpr, m, k) rows of X, in place (the JAX ``_solve_step_2d`` and
    ``_solve_step_2d_lookahead``): A's chunks from t // pc on move, the
    pivot row and row t go out as stacked [A_live | X] rows, prow_A and
    prow_X are separate products, no column replacement.  ``ahead`` as in
    :func:`_step2d`."""
    mg, lay = run.mg, run.lay
    pr, pc, m, bpr, Nr = lay.pr, lay.pc, lay.m, lay.bpr, lay.Nr
    kr = mg.kr
    Wc, nrhs = Wloc.shape[-1], Xloc.shape[-1]
    lo = (t // pc) * m
    live = Wc - lo
    g, kmin = _reduce(dec, mg.world, Nr)
    singular |= ~torch.isfinite(kmin)
    pivots.append(g)
    H = run.h_bcast(dec, g, t)
    rp = run.row_bcast([Wloc, Xloc], g, lo)
    own_p, sp = kr == g % pr, g // pr
    own_t, st = kr == t % pr, t // pr
    E = dec.chunk.clone()
    if g != t:
        rt = run.row_bcast([Wloc, Xloc], t, lo)
        if own_p:                                   # swap-by-copy
            Wloc[sp, :, lo:] = rt[:, :live]
            Xloc[sp] = rt[:, live:]
        # The owner column's t-chunk heads its live slice.
        fix = run.fixup(rt, g, t, 0)
        if own_p:
            E[sp] = fix
    prow_A = _matmul(H, rp[:, :live])
    prow_X = _matmul(H, rp[:, live:])
    if own_t:
        E[st] = 0
    E2 = E.view(bpr * m, m)
    W2 = Wloc.view(bpr * m, Wc)
    nxt = None
    if ahead is not None and t < Nr - 1:
        c0 = ((t + 1) // pc) * m
        off = c0 - lo
        _addmm_(W2[:, c0:c0 + m], E2, prow_A[:, off:off + m])
        panel = Wloc[:, :, c0:c0 + m].clone()
        if own_t:
            panel[st] = prow_A[:, off:off + m]
        nxt = ahead(t + 1, panel)
        if off:
            _addmm_(W2[:, lo:c0], E2, prow_A[:, :off])
        if c0 + m < Wc:
            _addmm_(W2[:, c0 + m:], E2, prow_A[:, off + m:])
    else:
        _addmm_(W2[:, lo:], E2, prow_A)
    _addmm_(Xloc.view(bpr * m, nrhs), E2, prow_X)
    if own_t:
        Wloc[st, :, lo:] = prow_A
        Xloc[st] = prow_X
    return nxt


def _run_steps(run: _Run, step, Wloc, lookahead: bool, t0: int = 0,
               t1: int | None = None) -> None:
    """Supersteps [t0, t1) of a plain or probe-ahead loop, ``step(t, dec,
    ahead)`` being :func:`_step2d` or :func:`_solve_step2d` bound to the
    rank's state."""
    lay, m = run.lay, run.lay.m
    t1 = lay.Nr if t1 is None else t1
    side = _SideProbe(Wloc.device) if lookahead else None

    def fresh(t):
        u = t // lay.pc
        return run.probe_at(t, run.chunk_bcast(
            t, Wloc[:, :, u * m:(u + 1) * m]))

    def ahead(t, panel):
        chunk = run.chunk_bcast(t, panel)
        dec = side.launch(lambda c: run.probe_at(t, c), chunk)
        return dec

    dec = fresh(t0) if lookahead else None
    for t in range(t0, t1):
        dec = side.take(dec) if lookahead else fresh(t)
        dec = step(t, dec, ahead if lookahead else None)


def _grouped_steps(run: _Run, Wloc, kgrp: int):
    """The delayed-group-update loop (the JAX ``_gstep2d`` and
    ``_group_end_2d``): U replicated along the row communicator, P
    column-sharded; returns (singular, pivots)."""
    mg, lay = run.mg, run.lay
    pr, pc, m, bpr, Nr = lay.pr, lay.pc, lay.m, lay.bpr, lay.Nr
    kr, kc = mg.kr, mg.kc
    Wc = Wloc.shape[-1]
    kgrp = max(1, min(kgrp, Nr))
    singular = _no_singular(Wloc)
    pivots = []
    for t0 in range(0, Nr, kgrp):
        kg = min(kgrp, Nr - t0)
        Uw = kg * m
        U = Wloc.new_zeros((bpr, m, Uw))
        P = Wloc.new_zeros((Uw, Wc))
        for j in range(kg):
            t = t0 + j
            u_t = t // pc
            cs = slice(u_t * m, (u_t + 1) * m)
            own_c = kc == t % pc
            # --- EAGER CHUNK on the owner column: W's t-chunk less the
            # pending panels, broadcast on the row communicator.
            chunk = Wloc[:, :, cs]
            if own_c and j:
                chunk = chunk.clone(memory_format=torch.contiguous_format)
                _addmm_(chunk.view(bpr * m, m),
                        U[:, :, :j * m].reshape(bpr * m, j * m),
                        P[:j * m, cs])
            dec = run.probe_at(t, run.chunk_bcast(t, chunk))
            chunk_all = dec.chunk
            g, kmin = _reduce(dec, mg.world, Nr)
            singular |= ~torch.isfinite(kmin)
            pivots.append(g)
            H = run.h_bcast(dec, g, t)
            # --- ONE STACKED SUM on the column communicator: [pivot row |
            # its U row | 0] and [row t | its U row | eager t-block].
            own_p, sp = kr == g % pr, g // pr
            own_t, st = kr == t % pr, t // pr
            buf = Wloc.new_zeros((2 * m, Wc + Uw + m))
            if own_p:
                buf[:m, :Wc] = Wloc[sp]
                buf[:m, Wc:Wc + Uw] = U[sp]
            if own_t:
                buf[m:, :Wc] = Wloc[st]
                buf[m:, Wc:Wc + Uw] = U[st]
                buf[m:, Wc + Uw:] = chunk_all[st]
            mg.col.all_reduce(buf, "sum")
            row_piv, u_p = buf[:m, :Wc], buf[:m, Wc:Wc + Uw]
            # --- SWAP-BY-COPY in W, U and the eager chunk; the chunk's
            # row t is zeroed (its multiplier is the prow write).
            chunk_all = chunk_all.clone()
            if own_p:
                Wloc[sp] = buf[m:, :Wc]
                U[sp] = buf[m:, Wc:Wc + Uw]
                chunk_all[sp] = buf[m:, Wc + Uw:]
            if own_t:
                chunk_all[st] = 0
            # --- EAGER PIVOT ROW + NORMALIZE; the t-chunk becomes H.
            if j:
                tally_gemm(m, j * m, Wc)
                row_piv = torch.addmm(row_piv, u_p[:, :j * m], P[:j * m],
                                      alpha=-1)
            prow = _matmul(H, row_piv)
            if own_c:
                prow[:, cs] = H
                Wloc[:, :, cs] = 0
                if j:
                    P[:j * m, cs] = 0
            if own_t:
                Wloc[st] = prow
                U[st] = 0
            U[:, :, j * m:(j + 1) * m] = chunk_all
            P[j * m:(j + 1) * m] = prow
        # --- GROUP END: one local GEMM, no collective.
        _addmm_(Wloc.view(bpr * m, Wc), U.view(bpr * m, Uw), P)
    return singular, pivots


def _swapfree_steps(run: _Run, Wloc):
    """The swap-free loop (the JAX ``_step2d_swapfree``): rows stay put;
    returns (singular, swap coordinates, pos)."""
    mg, lay = run.mg, run.lay
    pr, pc, m, Nr = lay.pr, lay.pc, lay.m, lay.Nr
    kr, kc = mg.kr, mg.kc
    singular = _no_singular(Wloc)
    alive = list(range(lay.bpr))
    pos, ipos = list(range(Nr)), list(range(Nr))
    swaps = []
    for t in range(Nr):
        u_t = t // pc
        cs = slice(u_t * m, (u_t + 1) * m)
        own_c = kc == t % pc
        chunk_all = run.chunk_bcast(t, Wloc[:, :, cs])
        dec = run.probe_at(t, chunk_all, alive=alive, pos=pos)
        kmin = mg.world.all_reduce(dec.key.clone(), "min")
        win = torch.where(dec.key == kmin, dec.pos, Nr)
        mg.world.all_reduce(win, "min")
        finite, win_pos = torch.stack(
            [torch.isfinite(kmin).to(torch.float64)[0],
             win.to(torch.float64)[0]]).tolist()
        singular |= ~torch.isfinite(kmin)
        # All-singular pin: the physical row at swap position t, H := 0.
        g = ipos[int(win_pos)] if finite else ipos[t]
        if not finite:
            run.pinned.append(t)
        H = (run.h_bcast(dec, g, t, sweep_all=True) if finite
             else Wloc.new_zeros((m, m)))
        row_piv = run.row_bcast([Wloc], g)
        prow = _matmul(H, row_piv)
        if own_c:
            prow[:, cs] = H
        own_p, sp = kr == g % pr, g // pr
        E = chunk_all.clone()
        if own_p:
            E[sp] = 0
        if own_c:
            Wloc[:, :, cs] = 0
        _eliminate(Wloc, E, prow)
        if own_p:
            Wloc[sp] = prow
            alive.remove(sp)
        piv_pos, x = pos[g], ipos[t]
        pos[x], pos[g] = piv_pos, t
        ipos[t], ipos[piv_pos] = g, x
        swaps.append(piv_pos)
    return singular, swaps, pos


def permute_columns_2d(Wloc, cols, mg, lay: CyclicLayout2D):
    """This rank's shard after the block-column permutation ``cols``
    (output column block j is input column block ``cols[j]``): the chunks
    move on the row communicator."""
    from .permute import permute_cyclic

    m, bpr = lay.m, lay.bpr
    bc = Wloc.shape[-1] // m
    icols = [0] * len(cols)
    for j, c in enumerate(cols):
        icols[c] = j
    chunks = Wloc.reshape(bpr, m, bc, m).permute(2, 0, 1, 3).contiguous()
    chunks = permute_cyclic(chunks, icols, mg.row, lay.pc, mg.kc,
                            lambda d: mg.rank_of(mg.kr, d))
    return chunks.permute(1, 2, 0, 3).reshape(bpr, m, bc * m)


def permute_rows_2d(Wloc, pos, mg, lay: CyclicLayout2D):
    """This rank's shard after moving physical row block x to natural row
    block ``pos[x]``: the rows move on the column communicator."""
    from .permute import permute_cyclic

    return permute_cyclic(Wloc, pos, mg.col, lay.pr, mg.kr,
                          lambda d: mg.rank_of(d, mg.kc))


def check_engine_2d(lay: CyclicLayout2D, engine: str, group_k: int = 0,
                    lookahead: bool = False, swapfree: bool = False) -> None:
    """The JAX compile's refusals: lookahead with swapfree or a group, and
    lookahead above MAX_UNROLL_NR, typed."""
    if engine not in ENGINES_2D:
        raise ValueError(f"unknown 2D engine {engine!r}; choose from "
                         f"{'/'.join(ENGINES_2D)}")
    if engine == "lookahead" or lookahead:
        if engine == "swapfree" or swapfree or group_k > 1:
            raise UsageError(
                "lookahead=True composes only with the plain 2D engine "
                "(the panel/trailing split is defined on its per-step "
                "schedule); drop swapfree/group or drop lookahead")
        if lay.Nr > MAX_UNROLL_NR:
            raise UsageError(
                f"the lookahead engine is unrolled-only (the critical-"
                f"panel split needs static chunk offsets) and Nr="
                f"{lay.Nr} exceeds MAX_UNROLL_NR={MAX_UNROLL_NR}; use "
                f"engine='inplace' (its fori twin) or a larger "
                f"block_size")


@upcast_sub_fp32
def invert_blocks_2d(blocks, mg, lay: CyclicLayout2D,
                     engine: str = "inplace", group_k: int = 0,
                     eps: float | None = None, probe=probe_blocks,
                     probe_layout: str = "auto", pinned: list | None = None):
    """Invert the distributed identity-padded matrix whose shard on this
    rank of the mesh ``mg`` is ``blocks`` (not modified).  ``engine`` is
    one of :data:`ENGINES_2D` (``group_k`` the grouped engine's k, default
    2), ``probe_layout`` one of :data:`PROBE_LAYOUTS`; a ``pinned`` list
    receives the swap-free steps whose window was all singular.  Every rank
    calls it together.  Returns ``(inverse shard, singular, pivots, probed)``: this
    rank's shard of the inverse in 2D-cyclic order, the (1,) flag, the
    pivot sequence (swap coordinates for swapfree) and the (t, global
    rows) this rank probed.  Counterpart of the JAX package's
    ``compile_sharded_jordan_inplace_2d(...)(W)``."""
    check_engine_2d(lay, engine, group_k)
    if eps is None:
        eps = eps_for(blocks.dtype)
    run = _Run(mg, lay, eps, probe,
               resolve_probe_layout(probe_layout, mg.backend))
    W = blocks.clone()
    if engine == "swapfree":
        singular, pivots, pos = _swapfree_steps(run, W)
        if pinned is not None:
            pinned.extend(run.pinned)
        W = permute_columns_2d(W, compose_swap_perm(pivots, lay.Nr), mg,
                               lay)
        W = permute_rows_2d(W, pos, mg, lay)
        return W, singular, pivots, run.probed
    if engine == "grouped":
        singular, pivots = _grouped_steps(run, W,
                                          group_k if group_k > 1 else 2)
    else:
        singular, pivots = _no_singular(W), []
        _run_steps(run, lambda t, dec, ahead: _step2d(
            run, W, t, dec, singular, pivots, ahead), W,
            lookahead=engine == "lookahead")
    W = permute_columns_2d(W, compose_swap_perm(pivots, lay.Nr), mg, lay)
    return W, singular, pivots, run.probed


def compile_sharded_jordan_inplace_2d(lay: CyclicLayout2D,
                                      eps: float | None = None,
                                      probe=probe_blocks,
                                      unroll: bool | None = None,
                                      group: int = 0,
                                      probe_layout: str = "auto",
                                      swapfree: bool = False,
                                      lookahead: bool = False):
    """The 2D invert for a layout as ``run(mg, W) -> (inverse shard,
    singular, pivots, probed)``.  The JAX package compiles an unrolled
    engine up to MAX_UNROLL_NR and a fori twin beyond; here both are one
    eager loop.  Its refusals are kept (:func:`check_engine_2d`)."""
    engine = ("lookahead" if lookahead else "swapfree" if swapfree
              else "grouped" if group and group > 1 else "inplace")
    check_engine_2d(lay, engine, group, lookahead, swapfree)

    def run(mg, W):
        return invert_blocks_2d(W, mg, lay, engine=engine, group_k=group,
                                eps=eps, probe=probe,
                                probe_layout=probe_layout)

    return run


def invert_shards_2d(world, shards, shape: tuple, n: int, m: int,
                     engine: str = "inplace", group_k: int = 0,
                     probe_layout: str = "auto", probe=probe_blocks) -> dict:
    """:func:`invert_blocks_2d` on this rank's shard of ``shards`` (every
    rank's shard in rank order, numpy arrays or CPU tensors: the JAX
    package's storage tensor split by ``jordan2d.split_shards_2d``) on the
    (pr, pc) mesh ``shape`` of ``world``.  Returns this rank's CPU
    outcome: ``blocks``, ``singular``, ``pivots``, ``probed``,
    ``probe_steps``."""
    from ..interop import from_numpy
    from .group import mesh_group

    pr, pc = shape
    mg = mesh_group(world, pr, pc)
    lay = CyclicLayout2D.create(n, m, pr, pc)
    W = from_numpy(shards[world.rank], world.device)
    inv, singular, pivots, probed = invert_blocks_2d(
        W, mg, lay, engine=engine, group_k=group_k, probe=probe,
        probe_layout=probe_layout)
    return {"blocks": inv.cpu(), "singular": bool(singular.item()),
            "pivots": pivots, "probed": probed,
            "probe_steps": [t for t, _ in probed]}


def gather_inverse_inplace_2d(out, lay: CyclicLayout2D, n: int):
    """The (n, n) inverse from the 2D-cyclic storage (a tensor, or the
    shards in rank order): natural order on both axes, unpadded.
    Counterpart of the JAX package's ``gather_inverse_inplace_2d``."""
    from .jordan2d import gather_matrix_2d

    return gather_matrix_2d(out, lay, n)


def inverse_corner_2d(shards, lay: CyclicLayout2D, n: int, max_p: int = 10):
    """The top-left min(n, max_p) corner of the inverse from the owning
    blocks alone (the ``gather=False`` verbose print, main.cpp:459-461):
    global block (i, j) is slot i // pr, chunk j // pc of rank
    (i % pr, j % pc).  ``shards``: the ranks' shards in rank order.
    Counterpart of the JAX package's ``inverse_corner_2d``."""
    c = min(n, max_p)
    nb = -(-c // lay.m)
    m = lay.m
    rows = []
    for i in range(nb):
        rows.append(torch.cat([
            torch.as_tensor(shards[(i % lay.pr) * lay.pc + j % lay.pc])[
                i // lay.pr, :, (j // lay.pc) * m:(j // lay.pc + 1) * m]
            for j in range(nb)], dim=1))
    return torch.cat(rows, dim=0)[:c, :c]


# --- The 2D [A | B] solve: X = A⁻¹B with no inverse formed.


def scatter_rhs_2d(b, lay: CyclicLayout2D, kr: int) -> torch.Tensor:
    """Mesh row kr's (bpr, m, k) rows of the (n, k) right-hand side ``b``,
    zero-padded to N rows (every mesh column of the row holds the same):
    X is row-sharded along pr and replicated along pc.  Counterpart of the
    JAX package's ``scatter_rhs_2d``."""
    b = torch.as_tensor(b)
    bp = b.new_zeros((lay.N, b.shape[-1]))
    bp[:b.shape[0]] = b
    return bp.view(lay.Nr, lay.m, -1)[kr::lay.pr].contiguous()


def gather_solution_2d(xb, lay: CyclicLayout2D, n: int) -> torch.Tensor:
    """The (n, k) solution from X's row blocks: a list of the ranks'
    blocks in rank order (mesh column 0 of each mesh row is read), or the
    (Nr, m, k) row-cyclic storage tensor.  Counterpart of the JAX
    package's ``gather_solution_2d``."""
    from .jordan2d import _inv_perm

    if not isinstance(xb, torch.Tensor):
        xb = torch.cat([torch.as_tensor(xb[kr * lay.pc])
                        for kr in range(lay.pr)])
    rowp = torch.as_tensor(lay.row_perm(), dtype=torch.long)
    out = xb.index_select(0, _inv_perm(rowp).to(xb.device))
    return out.reshape(lay.N, -1)[:n]


def _solve_loop(run: _Run, W, X, lookahead: bool, t0: int = 0,
                t1: int | None = None, singular=None):
    singular = _no_singular(W) if singular is None else singular
    pivots = []
    _run_steps(run, lambda t, dec, ahead: _solve_step2d(
        run, W, X, t, dec, singular, pivots, ahead), W, lookahead, t0, t1)
    return singular, pivots


@upcast_sub_fp32
def solve_blocks_2d(blocks, rhs, mg, lay: CyclicLayout2D,
                    lookahead: bool = False, eps: float | None = None,
                    probe=probe_blocks, probe_layout: str = "auto"):
    """Solve on this rank's identity-padded A shard and its mesh row's
    (bpr, m, k) zero-padded rows of B (neither is modified); every rank
    calls it together.  Returns ``(x rows, singular, pivots, probed)``.
    Counterpart of the JAX package's
    ``compile_sharded_jordan_solve_2d(...)(W, X)``."""
    if eps is None:
        eps = eps_for(blocks.dtype)
    run = _Run(mg, lay, eps, probe,
               resolve_probe_layout(probe_layout, mg.backend))
    W = blocks.clone()
    X = rhs.to(device=W.device, dtype=W.dtype).clone()
    singular, pivots = _solve_loop(run, W, X, lookahead)
    return X, singular, pivots, run.probed


def compile_sharded_jordan_solve_2d(lay: CyclicLayout2D,
                                    eps: float | None = None,
                                    probe=probe_blocks,
                                    unroll: bool | None = None,
                                    probe_layout: str = "auto",
                                    lookahead: bool = False):
    """The 2D distributed solve for a layout as ``run(mg, W, X) -> (x
    rows, singular, pivots, probed)``: one eager loop for the JAX
    unrolled and fori engines; ``lookahead=True`` is unrolled-only, as
    there: refused above MAX_UNROLL_NR."""
    if unroll is None:
        unroll = lay.Nr <= MAX_UNROLL_NR
    if lookahead and not unroll:
        raise UsageError(
            f"engine='solve_lookahead' is unrolled-only (the critical-panel "
            f"split needs static chunk offsets) and Nr={lay.Nr} exceeds "
            f"MAX_UNROLL_NR={MAX_UNROLL_NR}; use engine='solve_sharded' (its "
            f"fori twin covers any Nr) or a larger block_size")

    def run(mg, W, X):
        return solve_blocks_2d(W, X, mg, lay, lookahead=lookahead, eps=eps,
                               probe=probe, probe_layout=probe_layout)

    return run


# --- Segment entries of the checkpointed runs (resilience/checkpoint.py):
# supersteps [t0, t1) with the monolithic loops' own step code; the
# unscramble runs only in the finalize.


def _segment_run(mg, lay, W, eps, probe):
    return _Run(mg, lay, eps_for(W.dtype) if eps is None else eps, probe,
                resolve_probe_layout("auto", mg.backend))


def inplace_segment_2d(Wloc, singular, swaps, mg, lay: CyclicLayout2D,
                       t0: int, t1: int, eps: float | None = None,
                       probe=probe_blocks) -> list:
    """Supersteps [t0, t1) of the plain 2D invert on this rank's shard
    ``Wloc`` and (1,) ``singular``, in place; the pivots go to
    ``swaps[t0:t1]`` (the same on every rank).  Returns the (t, rows) this
    rank probed.  Counterpart of the JAX package's
    ``_sharded_jordan2d_inplace_segment``."""
    run = _segment_run(mg, lay, Wloc, eps, probe)
    pivots = []
    _run_steps(run, lambda t, dec, ahead: _step2d(
        run, Wloc, t, dec, singular, pivots, ahead), Wloc, False, t0, t1)
    swaps[t0:t1] = torch.as_tensor(pivots, dtype=swaps.dtype)
    return run.probed


def solve_segment_2d(Wloc, Xloc, singular, mg, lay: CyclicLayout2D,
                     t0: int, t1: int, eps: float | None = None,
                     probe=probe_blocks) -> list:
    """Supersteps [t0, t1) of the 2D solve on this rank's ``Wloc``,
    ``Xloc`` and ``singular``, in place; returns the (t, rows) it probed.
    Counterpart of the JAX package's ``_sharded_jordan_solve_2d_segment``."""
    run = _segment_run(mg, lay, Wloc, eps, probe)
    _solve_loop(run, Wloc, Xloc, False, t0, t1, singular)
    return run.probed


def inplace_finalize_2d(Wloc, swaps, mg, lay: CyclicLayout2D):
    """The invert's unscramble after the last segment: the swap record as
    one block-column permutation on the row communicator.  Counterpart of
    the JAX package's ``_sharded_jordan2d_inplace_finalize``."""
    return permute_columns_2d(Wloc, compose_swap_perm(swaps.tolist(),
                                                      lay.Nr), mg, lay)
