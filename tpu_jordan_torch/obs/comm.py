"""The communication observatory of the distributed paths.  Counterpart of
the JAX package's ``obs/comm.py``: which bytes moved, and does the code
issue exactly the collectives that the layout predicts.

The paper's distributed core is communication: the pivot-row broadcast
(main.cpp:1097), the row exchange (main.cpp:1093-1131) and the ring GEMM
(main.cpp:534-641).  Three parts:

1. **The analytical inventory** (:func:`engine_report`): for one
   distributed solve, the (kind, axis, shape, dtype) of every collective
   each rank issues, derived from the port's own step code
   (``parallel/sharded_inplace.py``, ``parallel/jordan2d_inplace.py``,
   ``parallel/permute.py``) and its sections: ``timing`` (the barrier and
   the elapsed max of ``dist_solve._timed``), ``engine``, ``gather``
   (``dist_solve.gather_parts``: real point-to-point to rank 0, so
   ``implicit`` is False; only the JAX package's gather is an implicit XLA
   all-gather) and ``residual`` (the 1D ring GEMM or the 2D SUMMA, with the
   κ∞ row-sum maxima).  The kinds are the port's own: ``all_reduce_min``
   (the two-stage pivot reduction), ``broadcast`` (the owners' broadcasts
   where the JAX package psums one-hot rows), ``all_reduce_sum``/``_max``,
   and ``send``/``recv`` (one message each: the exact buckets of the
   permutations where the JAX package rotates padded ``ppermute`` rounds).
   The axis names are the JAX package's ("p", "pr", "pc", "pr,pc").

   **The inventory depends on the run's pivot record**, the one input to
   it that comes from the data: the plain steps skip the row-t broadcast
   and the 2D swap fix-up when the pivot is row t itself (the JAX package
   psums on every step), the permutations' buckets are functions of the
   swap record (the swap-free ``pos`` is replayed from it), and the 2D
   swap-free engine sends no H at a step whose window was all singular
   (``pinned``).  Every other count is a function of the layout alone.

   ``traced`` equals ``executed``: the eager loop issues every superstep's
   collectives, nothing is traced once for many (a departure from the JAX
   package's trace-time counts).  ``sigs`` are **summed over the ranks**
   (each rank's own inventory is ``rank_sigs``).

2. **The recording point** (``parallel/group.py``): with
   :func:`recording` active, every rank of a distributed solve runs under a
   ``RankLog`` and returns what it issued, by section
   (:meth:`CommReport.attach_observed`).  Reconciliation is judged twice:
   per rank against that rank's own inventory, and for the world on the
   sums (what ``tools/check_comm.py`` re-derives), so a fault on one rank
   cannot hide behind an opposite fault on another; over the world, every
   ``send`` must meet a ``recv`` of the same axis, shape and dtype.  A mismatch is a
   listed, typed verdict (``reconciled`` False, :meth:`CommReport.check`
   raises :class:`ReconciliationError`), never a silent pass.

3. **Drift against the H100 cost model** (:func:`observe_drift`): the
   slowest rank's elapsed less the projected compute
   (``tuning/cost_model.predict``'s elim + probe + glue at the solve's
   point) over its projected ``comm`` term, with the achieved GB/s of the
   engine's wire bytes.  Judged (an out-of-band ratio is a ``comm_drift``
   flight-recorder event and a counter) where the projection claims to
   describe the hardware: in the port that is the backend rule's nccl
   case, a card for every rank (``parallel/group.backend_rule``), the
   port's reading of the JAX package's "a real TPU backend".  CPU ranks
   and gloo ranks sharing one card are recorded, unjudged.  Judged ratios
   feed the opt-in cost-hook calibration (:func:`cost_comm_scale`,
   ``tuning/registry.projected_seconds``).

Byte conventions (the JAX package's): ``payload_bytes`` is the operand's
shape × width; ``wire_bytes`` is S·(a−1)/a for a reduction or broadcast
over a axis members and S for one point-to-point message (counted on its
``send``; its ``recv`` moves the same bytes and adds none).

The demo (:func:`comm_demo`, ``--comm-demo``) runs its legs in one world
of 4 ranks (:func:`comm_demo_rank`); ``tools/check_comm.py`` judges it.
"""

from __future__ import annotations

import contextlib
import math
import threading
from collections import Counter
from dataclasses import dataclass, field

from . import metrics as _metrics
from . import recorder as _recorder

#: Where in the solve the bytes move: ``pivot`` = the two-stage key
#: reduction and the 2D H broadcast; ``row_bcast`` = the pivot row (with H
#: in the 1D engines, with its U row in the grouped ones); ``row_exchange``
#: = row t and the 2D swap fix-up; ``panel_bcast`` = the 2D t-chunk;
#: ``permute`` = the swap-free permutations; ``unscramble`` = the 2D
#: column permutation after the loop; ``residual``; ``gather``;
#: ``timing`` = the barrier and the elapsed max around the engine.
PHASES = ("pivot", "row_bcast", "row_exchange", "panel_bcast", "permute",
          "unscramble", "residual", "gather", "timing")

_M_BYTES = _metrics.counter(
    "tpu_jordan_torch_comm_bytes_total",
    "analytical per-solve collective payload bytes summed over the ranks, "
    "by phase and collective kind")
_M_MSGS = _metrics.counter(
    "tpu_jordan_torch_comm_messages_total",
    "analytical per-solve collectives issued, summed over the ranks, by "
    "phase and collective kind")
_M_DRIFT = _metrics.counter(
    "tpu_jordan_torch_comm_drift_total",
    "distributed solves whose measured non-compute residue fell outside "
    "the cost model's projected comm band (judged backends only)")
_M_GBPS = _metrics.gauge(
    "tpu_jordan_torch_comm_achieved_gbps",
    "achieved interconnect GB/s of the last distributed solve per engine "
    "(modeled wire bytes / measured non-compute residue)")

#: The index dtype of the pivot reduction's second stage (torch.long).
INDEX_DTYPE = "int64"

_ITEMSIZE = {"float32": 4, "float64": 8, "float16": 2, "bfloat16": 2,
             "int32": 4, "int64": 8}


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _nelems(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


class ReconciliationError(RuntimeError):
    """The observed collectives of a solve differ from its inventory."""


@dataclass(frozen=True)
class CollectiveSig:
    """One collective signature of a solve: (kind, axis, shape, dtype),
    how often it was issued (``executed``; ``traced`` is the same count in
    the eager port), its phase and section."""

    phase: str
    kind: str
    axis: str
    axis_size: int
    shape: tuple
    dtype: str
    traced: int
    executed: int
    section: str = "engine"
    implicit: bool = False

    @property
    def payload_bytes(self) -> int:
        return _nelems(self.shape) * _ITEMSIZE[self.dtype]

    @property
    def wire_bytes(self) -> float:
        s = float(self.payload_bytes)
        if self.kind == "send":
            return s
        if self.kind == "recv":
            return 0.0
        a = self.axis_size
        return 0.0 if a <= 1 else s * (a - 1) / a

    def key(self) -> tuple:
        return (self.kind, self.axis, self.shape, self.dtype)

    def to_json(self) -> dict:
        return {
            "phase": self.phase, "kind": self.kind, "axis": self.axis,
            "axis_size": self.axis_size, "shape": list(self.shape),
            "dtype": self.dtype, "traced": self.traced,
            "executed": self.executed, "section": self.section,
            "implicit": self.implicit,
            "payload_bytes": self.payload_bytes,
            "wire_bytes": round(self.wire_bytes, 1),
        }


# ---------------------------------------------------------------------
# Recording: the switch the driver reads.
# ---------------------------------------------------------------------

_STATE = threading.local()


@contextlib.contextmanager
def recording():
    """Take the observed collectives and the counted GEMM FLOPs of the
    distributed solves inside the block (``SolveResult.comm`` reconciles,
    ``SolveResult.work`` carries the counted pin).  Off (the default) the
    solves still get both analytical reports."""
    prev = getattr(_STATE, "on", False)
    _STATE.on = True
    try:
        yield
    finally:
        _STATE.on = prev


def recording_active() -> bool:
    return bool(getattr(_STATE, "on", False))


# ---------------------------------------------------------------------
# The analytical inventory, one rank at a time.
# ---------------------------------------------------------------------


class _Builder:
    def __init__(self):
        self.sigs: list[CollectiveSig] = []

    def add(self, phase, kind, ax, shape, dtype, section="engine",
            count=1):
        """One collective on axis ``ax`` = (name, size); nothing on an
        axis of one rank (a view of one rank issues nothing)."""
        if ax[1] <= 1 or count <= 0:
            return
        self.sigs.append(CollectiveSig(
            phase=phase, kind=kind, axis=ax[0], axis_size=int(ax[1]),
            shape=tuple(int(s) for s in shape), dtype=str(dtype),
            traced=int(count), executed=int(count), section=section))

    def permute(self, phase, dest, ax, k, n_items, tail, dtype):
        """The messages of ``permute.permute_cyclic`` at position ``k`` of
        the axis: one exact bucket to each peer that gets items, one from
        each peer that sends some."""
        a = ax[1]
        for d in range(a):
            if d == k:
                continue
            ns = sum(1 for s in range(n_items) if dest[s * a + k] % a == d)
            nr = sum(1 for s in range(n_items) if dest[s * a + d] % a == k)
            if ns:
                self.add(phase, "send", ax, (ns,) + tuple(tail), dtype)
            if nr:
                self.add(phase, "recv", ax, (nr,) + tuple(tail), dtype)


def merge_sigs(sigs) -> list[CollectiveSig]:
    """Collapse identical signatures, summing their counts."""
    agg: dict[tuple, list] = {}
    for s in sigs:
        k = (s.phase, s.kind, s.axis, s.axis_size, s.shape, s.dtype,
             s.section, s.implicit)
        if k not in agg:
            agg[k] = [0, 0]
        agg[k][0] += s.traced
        agg[k][1] += s.executed
    return [CollectiveSig(phase=k[0], kind=k[1], axis=k[2], axis_size=k[3],
                          shape=k[4], dtype=k[5], traced=v[0],
                          executed=v[1], section=k[6], implicit=k[7])
            for k, v in agg.items()]


def replay_positions(swaps, Nr: int) -> list:
    """The swap-free engines' ``pos`` (physical row → natural row) from
    their swap record, as their bookkeeping builds it step by step."""
    pos, ipos = list(range(Nr)), list(range(Nr))
    for t, piv_pos in enumerate(swaps):
        g, x = ipos[piv_pos], ipos[t]
        pos[x], pos[g] = piv_pos, t
        ipos[t], ipos[piv_pos] = g, x
    return pos


def _grouped_schedule(Nr: int, group: int):
    """(t0, kg) of the grouped engines' groups (k = 2 by default)."""
    kgrp = max(1, min(group if group > 1 else 2, Nr))
    return [(t0, min(kgrp, Nr - t0)) for t0 in range(0, Nr, kgrp)]


def _rank_1d(b: _Builder, lay, dt: str, engine: str, group: int, pivots,
             rhs: int, rank: int) -> None:
    """One rank's engine section on the 1D layout, as the step functions
    of ``parallel/sharded_inplace.py`` issue it."""
    m, N, Nr, p = lay.m, lay.N, lay.Nr, lay.p
    ax = ("p", p)

    def reduce():
        b.add("pivot", "all_reduce_min", ax, (1,), dt)
        b.add("pivot", "all_reduce_min", ax, (1,), INDEX_DTYPE)

    if engine in ("solve_sharded", "solve_lookahead"):
        for t in range(Nr):
            live = N - t * m
            reduce()
            b.add("row_bcast", "broadcast", ax, (m, live + rhs + m), dt)
            if pivots[t] != t:
                b.add("row_exchange", "broadcast", ax, (m, live + rhs), dt)
        return
    if engine == "swapfree":
        for t in range(Nr):
            reduce()
            b.add("row_bcast", "broadcast", ax, (m, N + m), dt)
        b.permute("permute", replay_positions(pivots, Nr), ax, rank,
                  lay.blocks_per_worker, (m, N), dt)
        return
    if engine == "grouped":
        for t0, kg in _grouped_schedule(Nr, group):
            w = N + kg * m + m
            for t in range(t0, t0 + kg):
                reduce()
                b.add("row_bcast", "broadcast", ax, (m, w), dt)
                if pivots[t] != t:
                    b.add("row_exchange", "broadcast", ax, (m, w), dt)
        return
    # inplace, lookahead; augmented on its (m, 2N) rows of [A | I]
    # (parallel/sharded_jordan.py).
    width = 2 * N if engine == "augmented" else N
    for t in range(Nr):
        reduce()
        b.add("row_bcast", "broadcast", ax, (m, width + m), dt)
        if pivots[t] != t:
            b.add("row_exchange", "broadcast", ax, (m, width), dt)


def _rank_2d(b: _Builder, lay, dt: str, engine: str, group: int, pivots,
             pinned, rhs: int, rank: int) -> None:
    """One rank's engine section on the (pr, pc) mesh, as the step
    functions of ``parallel/jordan2d_inplace.py`` issue it."""
    from ..ops.jordan_inplace import compose_swap_perm

    m, Nr, pr, pc, bpr = lay.m, lay.Nr, lay.pr, lay.pc, lay.bpr
    Wc = lay.N // pc
    kr, kc = divmod(rank, pc)
    row, col, world = ("pc", pc), ("pr", pr), ("pr,pc", pr * pc)

    def head(t, h=True):
        b.add("panel_bcast", "broadcast", row, (bpr, m, m), dt)
        b.add("pivot", "all_reduce_min", world, (1,), dt)
        b.add("pivot", "all_reduce_min", world, (1,), INDEX_DTYPE)
        if h:
            b.add("pivot", "broadcast", world, (m, m), dt)

    def swap(t, width):
        g = pivots[t]
        if g != t:
            b.add("row_exchange", "broadcast", col, (m, width), dt)
            if kr == g % pr:                    # the swap fix-up
                b.add("row_exchange", "broadcast", row, (m, m), dt)

    def unscramble(swaps):
        cols = compose_swap_perm(swaps, Nr)
        icols = [0] * Nr
        for j, c in enumerate(cols):
            icols[c] = j
        b.permute("unscramble", icols, row, kc, Nr // pc, (bpr, m, m), dt)

    if engine in ("solve_sharded", "solve_lookahead"):
        for t in range(Nr):
            live = Wc - (t // pc) * m
            head(t)
            b.add("row_bcast", "broadcast", col, (m, live + rhs), dt)
            swap(t, live + rhs)
        return
    if engine == "swapfree":
        skip = set(pinned)
        for t in range(Nr):
            head(t, h=t not in skip)
            b.add("row_bcast", "broadcast", col, (m, Wc), dt)
        unscramble(pivots)
        b.permute("permute", replay_positions(pivots, Nr), col, kr, bpr,
                  (m, Wc), dt)
        return
    if engine == "grouped":
        for t0, kg in _grouped_schedule(Nr, group):
            for t in range(t0, t0 + kg):
                head(t)
                b.add("row_bcast", "all_reduce_sum", col,
                      (2 * m, Wc + kg * m + m), dt)
        unscramble(pivots)
        return
    if engine == "augmented":                   # parallel/jordan2d.py
        for t in range(Nr):
            head(t)
            b.add("row_bcast", "broadcast", col, (m, 2 * Wc), dt)
            swap(t, 2 * Wc)
        return
    for t in range(Nr):                         # inplace, lookahead
        head(t)
        b.add("row_bcast", "broadcast", col, (m, Wc), dt)
        swap(t, Wc)
    unscramble(pivots)


def _rank_residual(b: _Builder, lay, dt: str, rank: int) -> None:
    """The verification: the 1D ring GEMM (p − 1 rotations) or the 2D
    SUMMA (Nr panel pairs, the row sums along "pc"), then the world's
    max of the residual and of the two κ∞ row-sum norms."""
    m, Nr = lay.m, lay.Nr
    kw = {"section": "residual"}
    if hasattr(lay, "pc"):
        pr, pc, bpr = lay.pr, lay.pc, lay.bpr
        Wc = lay.N // pc
        row, col, world = ("pc", pc), ("pr", pr), ("pr,pc", pr * pc)
        b.add("residual", "broadcast", row, (bpr, m, m), dt, count=Nr, **kw)
        b.add("residual", "broadcast", col, (m, Wc), dt, count=Nr, **kw)
        b.add("residual", "all_reduce_sum", row, (bpr * m,), dt, **kw)
        b.add("residual", "all_reduce_sum", row, (bpr, m), dt, count=2,
              **kw)
        b.add("residual", "all_reduce_max", world, (1,), dt, count=3, **kw)
        return
    p, bpw = lay.p, lay.blocks_per_worker
    ax = ("p", p)
    b.add("residual", "send", ax, (bpw * m, lay.N), dt, count=p - 1, **kw)
    b.add("residual", "recv", ax, (bpw * m, lay.N), dt, count=p - 1, **kw)
    b.add("residual", "all_reduce_max", ax, (1,), dt, count=3, **kw)


def _rank_gather(b: _Builder, lay, dt: str, rank: int) -> None:
    """``dist_solve.gather_parts``: each rank's inverse blocks (storage
    dtype) point to point to rank 0."""
    if hasattr(lay, "pc"):
        ax, shard = ("pr,pc", lay.pr * lay.pc), (lay.bpr, lay.m,
                                                 lay.N // lay.pc)
    else:
        ax, shard = ("p", lay.p), (lay.blocks_per_worker, lay.m, lay.N)
    if rank == 0:
        b.add("gather", "recv", ax, shard, dt, section="gather",
              count=ax[1] - 1)
    else:
        b.add("gather", "send", ax, shard, dt, section="gather")


def _rank_timing(b: _Builder, lay) -> None:
    """``dist_solve._timed``: the barrier and the slowest rank's elapsed."""
    ax = (("pr,pc", lay.pr * lay.pc) if hasattr(lay, "pc")
          else ("p", lay.p))
    b.add("timing", "all_reduce_sum", ax, (1,), "float32", section="timing")
    b.add("timing", "all_reduce_max", ax, (1,), "float64", section="timing")


#: Engines with a registered collective inventory: :func:`engine_report`
#: refuses any other name.
INVENTORY_ENGINES = frozenset(
    {"inplace", "grouped", "swapfree", "augmented", "solve_sharded",
     "lookahead", "solve_lookahead"})


def rank_inventory(rank: int, *, engine: str, lay, dtype: str, pivots,
                   pinned=(), gather: bool = True, refine: int = 0,
                   group: int = 0, rhs: int = 0,
                   storage_dtype: str | None = None,
                   singular: bool = False) -> list[CollectiveSig]:
    """Rank ``rank``'s collectives in one distributed solve (the arguments
    of :func:`engine_report`), merged by signature."""
    b = _Builder()
    dt = _dtype_name(dtype)
    solve = engine in ("solve_sharded", "solve_lookahead")
    _rank_timing(b, lay)
    if hasattr(lay, "pc"):
        _rank_2d(b, lay, dt, engine, group, pivots, pinned, rhs, rank)
    else:
        _rank_1d(b, lay, dt, engine, group, pivots, rhs, rank)
    if not solve and not singular:
        if gather:
            _rank_gather(b, lay, _dtype_name(storage_dtype or dt), rank)
        if not refine:
            _rank_residual(b, lay, dt, rank)
    return merge_sigs(b.sigs)


def engine_report(*, engine: str, lay, dtype, pivots, pinned=(),
                  gather: bool = True, refine: int = 0, group: int = 0,
                  rhs: int = 0, storage_dtype=None,
                  singular: bool = False) -> "CommReport":
    """The analytical :class:`CommReport` of one distributed solve.
    ``lay`` is its ``CyclicLayout``/``CyclicLayout2D``; ``dtype`` the
    WORKING dtype (sub-fp32 storage computes in fp32; the gathered blocks
    travel in ``storage_dtype``); ``pivots`` the ranks' pivot record (the
    swap coordinates of the swap-free engines) and ``pinned`` the 2D
    swap-free steps whose window was all singular: the inventory depends
    on them (module docstring).  ``refine > 0`` runs no residual section;
    a ``singular`` invert stops after the engine; the solves (``rhs`` the
    right-hand-side columns) have no gather and no residual section.  An
    engine outside :data:`INVENTORY_ENGINES` is a ``ValueError``."""
    if engine not in INVENTORY_ENGINES:
        raise ValueError(
            f"no collective inventory registered for engine {engine!r} "
            f"(obs/comm.INVENTORY_ENGINES); a distributed engine ships "
            f"WITH its analytical accounting")
    if len(pivots) != lay.Nr:
        raise ValueError(f"the pivot record has {len(pivots)} steps; the "
                         f"layout has Nr={lay.Nr}")
    dt = _dtype_name(dtype)
    if hasattr(lay, "pc"):
        ranks = lay.pr * lay.pc
        mesh, workers = f"{lay.pr}x{lay.pc}", (lay.pr, lay.pc)
    else:
        ranks = lay.p
        mesh, workers = f"1D p={lay.p}", lay.p
    kw = dict(engine=engine, lay=lay, dtype=dt, pivots=list(pivots),
              pinned=tuple(pinned), gather=gather, refine=refine,
              group=group, rhs=rhs, storage_dtype=storage_dtype,
              singular=singular)
    rank_sigs = {r: rank_inventory(r, **kw) for r in range(ranks)}
    sigs = merge_sigs([s for r in range(ranks) for s in rank_sigs[r]])
    return CommReport(engine=engine, mesh=mesh, workers=workers, n=lay.n,
                      block_size=lay.m, dtype=dt, gather=bool(gather),
                      group=int(group), rhs=int(rhs), sigs=sigs,
                      rank_sigs=rank_sigs)


# ---------------------------------------------------------------------
# The report: totals, reconciliation, metrics, span attrs.
# ---------------------------------------------------------------------


def _expected(sigs, section: str) -> Counter:
    c: Counter = Counter()
    for s in sigs:
        if s.section == section and not s.implicit and s.traced:
            c[s.key()] += s.traced
    return c


def _counts(recs) -> Counter:
    return Counter((str(k), str(a), tuple(int(x) for x in sh), str(dt))
                   for k, a, sh, dt in recs)


def _diff(prefix: str, want: Counter, got: Counter) -> list:
    out = []
    for key in sorted(set(want) | set(got), key=str):
        w, g = want.get(key, 0), got.get(key, 0)
        if w != g:
            kind, axis, shape, dt = key
            out.append(f"{prefix}: {kind}@{axis} {list(shape)} {dt}: "
                       f"analytical {w} vs observed {g}")
    return out


def _records_json(recs) -> list:
    return [{"kind": k, "axis": a, "shape": list(sh), "dtype": dt,
             "count": c} for (k, a, sh, dt), c in sorted(
                 _counts(recs).items(), key=str)]


@dataclass
class CommReport:
    """One distributed solve's communication record (``SolveResult.comm``,
    ``SolveSystemResult.comm``)."""

    engine: str
    mesh: str
    workers: object
    n: int
    block_size: int
    dtype: str
    gather: bool
    group: int
    rhs: int = 0
    #: The inventory summed over the ranks.
    sigs: list = field(default_factory=list)
    #: Each rank's own inventory.
    rank_sigs: dict = field(default_factory=dict)
    #: Observed records summed over the ranks, by section (empty: not
    #: recorded), and each rank's own.
    observed: dict = field(default_factory=dict)
    observed_ranks: dict = field(default_factory=dict)
    #: True/False once observed (per rank AND for the world), None before.
    reconciled: bool | None = None
    mismatches: list = field(default_factory=list)
    drift: dict | None = None

    # ---- totals ------------------------------------------------------

    def total_bytes(self, implicit: bool = True) -> int:
        return sum(s.payload_bytes * s.executed for s in self.sigs
                   if implicit or not s.implicit)

    def total_wire_bytes(self, section: str | None = None) -> float:
        return sum(s.wire_bytes * s.executed for s in self.sigs
                   if section is None or s.section == section)

    def total_messages(self) -> int:
        return sum(s.executed for s in self.sigs if not s.implicit)

    def phase_totals(self) -> dict:
        """{(phase, kind): {"bytes", "messages", "wire_bytes"}}."""
        out: dict[tuple, dict] = {}
        for s in self.sigs:
            d = out.setdefault((s.phase, s.kind), {
                "bytes": 0, "messages": 0, "wire_bytes": 0.0})
            d["bytes"] += s.payload_bytes * s.executed
            d["messages"] += 0 if s.implicit else s.executed
            d["wire_bytes"] += s.wire_bytes * s.executed
        return out

    # ---- reconciliation ---------------------------------------------

    def expected_traced(self, section: str, rank: int | None = None
                        ) -> Counter:
        """The multiset of (kind, axis, shape, dtype) that ``section``
        must issue: summed over the ranks, or rank ``rank``'s own."""
        return _expected(self.sigs if rank is None
                         else self.rank_sigs.get(rank, []), section)

    def attach_observed(self, ranks: dict) -> None:
        """Record what every rank issued (``{rank: {section: [(kind,
        axis, shape, dtype), ...]}}``, the ranks' ``observed``) and judge
        it.  A section the inventory predicts and no rank recorded counts
        as observed empty: the eager port issues every collective it
        runs, so an empty capture is a stripped section."""
        self.observed_ranks = {
            int(r): {sec: [tuple(x) for x in recs]
                     for sec, recs in (d or {}).items()}
            for r, d in ranks.items()}
        world: dict = {}
        for d in self.observed_ranks.values():
            for sec, recs in d.items():
                world.setdefault(sec, []).extend(recs)
        for s in self.sigs:
            world.setdefault(s.section, [])
        self.observed = world
        self._reconcile()

    def _reconcile(self) -> None:
        self.mismatches = []
        for r in sorted(set(self.rank_sigs) | set(self.observed_ranks)):
            got = self.observed_ranks.get(r)
            if got is None:
                self.mismatches.append(f"rank {r}: nothing observed")
                continue
            secs = {s.section for s in self.rank_sigs.get(r, [])} | set(got)
            for sec in sorted(secs):
                self.mismatches += _diff(
                    f"rank {r}/{sec}", self.expected_traced(sec, r),
                    _counts(got.get(sec, [])))
        for sec in sorted(self.observed):
            self.mismatches += _diff(
                f"world/{sec}", self.expected_traced(sec),
                _counts(self.observed[sec]))
        # Over the world every message is one send and one receive.
        ends = Counter()
        for recs in self.observed.values():
            for kind, axis, shape, dt in recs:
                if kind in ("send", "recv"):
                    ends[(kind, axis, tuple(shape), dt)] += 1
        for axis, shape, dt in sorted({k[1:] for k in ends}, key=str):
            sent, got = ends[("send", axis, shape, dt)], ends[
                ("recv", axis, shape, dt)]
            if sent != got:
                self.mismatches.append(
                    f"world/p2p: {axis} {list(shape)} {dt}: {sent} sends "
                    f"vs {got} receives")
        self.reconciled = not self.mismatches

    def check(self) -> None:
        """Raise :class:`ReconciliationError` when the observed collectives
        differ from the inventory (a no-op before observation)."""
        if self.reconciled is False:
            raise ReconciliationError(
                f"{self.engine} on {self.mesh}: {len(self.mismatches)} "
                f"mismatches; first: {self.mismatches[0]}")

    # ---- export ------------------------------------------------------

    def observe_metrics(self, sections: tuple | None = None) -> None:
        """Increment the comm counters by the analytical totals."""
        for s in self.sigs:
            if sections is not None and s.section not in sections:
                continue
            nb = s.payload_bytes * s.executed
            if nb:
                _M_BYTES.inc(nb, phase=s.phase, collective=s.kind)
            if s.executed and not s.implicit:
                _M_MSGS.inc(s.executed, phase=s.phase, collective=s.kind)

    def attach_span(self, span) -> None:
        """The engine section's payload bytes, wire bytes and messages on
        the ``execute`` span (what its wall brackets)."""
        if span is None:
            return
        eng = [s for s in self.sigs if s.section == "engine"]
        span.attrs["comm_payload_bytes"] = int(sum(
            s.payload_bytes * s.executed for s in eng))
        span.attrs["comm_wire_bytes"] = round(
            self.total_wire_bytes("engine"), 1)
        span.attrs["comm_messages"] = int(sum(s.executed for s in eng))

    def to_json(self) -> dict:
        return {
            "engine": self.engine, "mesh": self.mesh,
            "workers": (list(self.workers)
                        if isinstance(self.workers, tuple)
                        else self.workers),
            "n": self.n, "block_size": self.block_size,
            "dtype": self.dtype, "gather": self.gather,
            "group": self.group, "rhs": self.rhs,
            "sigs": [s.to_json() for s in self.sigs],
            "totals": {
                "payload_bytes": self.total_bytes(),
                "explicit_payload_bytes": self.total_bytes(False),
                "wire_bytes": round(self.total_wire_bytes(), 1),
                "engine_wire_bytes": round(
                    self.total_wire_bytes("engine"), 1),
                "messages": self.total_messages(),
            },
            "observed": {sec: _records_json(recs)
                         for sec, recs in self.observed.items()},
            "observed_ranks": {
                str(r): {sec: _records_json(recs)
                         for sec, recs in d.items()}
                for r, d in self.observed_ranks.items()},
            "reconciled": self.reconciled,
            "mismatches": list(self.mismatches),
            "drift": self.drift,
        }


_LAST_LOCK = threading.Lock()
LAST_REPORT: CommReport | None = None


def set_last_report(report: CommReport) -> None:
    """The most recent distributed solve's report (``--comm-report``)."""
    global LAST_REPORT
    with _LAST_LOCK:
        LAST_REPORT = report


# ---------------------------------------------------------------------
# Measured-vs-projected drift.
# ---------------------------------------------------------------------


@dataclass
class DriftPolicy:
    """When a measured/projected comm ratio becomes a ``comm_drift``
    event: outside [1/tolerance, tolerance], if judged.  ``judge``:
    "auto" (judged on the nccl backend, a card for every rank: the only
    case the H100 model describes), "always" or "never"."""

    tolerance: float = 4.0
    judge: str = "auto"


_DRIFT_LOCK = threading.Lock()
_DRIFT = DriftPolicy()


def drift_policy() -> DriftPolicy:
    with _DRIFT_LOCK:
        return _DRIFT


@contextlib.contextmanager
def set_drift_policy(tolerance: float | None = None,
                     judge: str | None = None):
    """Scoped drift-policy override (a context manager)."""
    global _DRIFT
    if judge is not None and judge not in ("auto", "always", "never"):
        raise ValueError(f"judge {judge!r}: auto/always/never")
    with _DRIFT_LOCK:
        prev = _DRIFT
        _DRIFT = DriftPolicy(
            tolerance=(prev.tolerance if tolerance is None
                       else float(tolerance)),
            judge=prev.judge if judge is None else judge)
    try:
        yield
    finally:
        with _DRIFT_LOCK:
            _DRIFT = prev


def projection(report: CommReport) -> dict:
    """The H100 cost model at the solve's (n, m, p, pc, group, swapfree)
    point: its ``comm`` term and its compute (elim + probe + glue)."""
    from ..tuning import cost_model

    chip = cost_model.CHIPS["h100"]
    pr, pc = (report.workers if isinstance(report.workers, (tuple, list))
              else (report.workers, 1))
    group = (max(report.group, 2) if report.engine == "grouped" else 1)
    r = cost_model.predict(report.n, report.block_size, chip, group=group,
                           p=int(pr), swapfree=report.engine == "swapfree",
                           pc=int(pc))
    return {"chip": chip.name, "comm_s": r["comm"],
            "compute_s": r["elim"] + r["probe"] + r["glue"],
            "total_s": r["total"]}


def observe_drift(report: CommReport, elapsed: float, backend: str,
                  span=None) -> dict:
    """Hold the slowest rank's elapsed, less the projected compute,
    against the projected comm term; record the achieved GB/s gauge, the
    span attrs, and, judged and out of band, a ``comm_drift`` event and
    the counter.  Judged ratios feed :func:`cost_comm_scale`."""
    pol = drift_policy()
    proj = projection(report)
    residue = max(float(elapsed) - proj["compute_s"], 0.0)
    wire = report.total_wire_bytes("engine")
    gbps = (wire / residue / 1e9) if residue > 0 else None
    ratio = (residue / proj["comm_s"]) if proj["comm_s"] > 0 else None
    judged = (pol.judge == "always"
              or (pol.judge == "auto" and backend == "nccl"))
    band = [1.0 / pol.tolerance, pol.tolerance]
    out_of_band = (judged and ratio is not None
                   and not (band[0] <= ratio <= band[1]))
    drift = {
        "elapsed_s": float(elapsed),
        "projected_comm_s": proj["comm_s"],
        "projected_compute_s": proj["compute_s"],
        "residue_s": residue,
        "comm_vs_projected": ratio,
        "band": band,
        "chip": proj["chip"],
        "backend": backend,
        "judged": judged,
        "out_of_band": out_of_band,
        "achieved_gbps": gbps,
        "wire_bytes": round(wire, 1),
        "event_recorded": False,
    }
    if gbps is not None:
        _M_GBPS.set(gbps, engine=report.engine)
    if span is not None:
        if ratio is not None:
            span.attrs["comm_vs_projected"] = float(f"{ratio:.4g}")
        if gbps is not None:
            span.attrs["comm_achieved_gbps"] = float(f"{gbps:.4g}")
        span.attrs["comm_projection_chip"] = proj["chip"]
        span.attrs["comm_drift_judged"] = judged
    if out_of_band:
        _M_DRIFT.inc(engine=report.engine)
        _recorder.record(
            "comm_drift", engine=report.engine, mesh=report.mesh,
            n=report.n, ratio=float(ratio), band=band, chip=proj["chip"],
            backend=backend, residue_s=residue,
            projected_comm_s=proj["comm_s"])
        drift["event_recorded"] = True
    if judged and ratio is not None and math.isfinite(ratio):
        _record_calibration(ratio)
    report.drift = drift
    return drift


# ---------------------------------------------------------------------
# Cost-hook feedback (opt-in, inert by default).
# ---------------------------------------------------------------------

_CAL_LOCK = threading.Lock()
_CAL = {"enabled": False, "ratio": None, "samples": 0}
_CAL_ALPHA = 0.25          # EWMA weight of the newest judged solve
_CAL_CLAMP = (0.25, 16.0)  # a calibration can re-price, not erase


def _record_calibration(ratio: float) -> None:
    with _CAL_LOCK:
        r = min(max(float(ratio), _CAL_CLAMP[0]), _CAL_CLAMP[1])
        if _CAL["ratio"] is None:
            _CAL["ratio"] = r
        else:
            _CAL["ratio"] = ((1 - _CAL_ALPHA) * _CAL["ratio"]
                             + _CAL_ALPHA * r)
        _CAL["samples"] += 1


def set_cost_feedback(enabled: bool) -> None:
    """Let judged measured/projected comm ratios scale the comm term of
    the registry's cost hooks.  Off by default: then, or with no judged
    ratio recorded, :func:`cost_comm_scale` is exactly 1.0 and every
    cost ranking is unchanged."""
    with _CAL_LOCK:
        _CAL["enabled"] = bool(enabled)


def cost_comm_scale() -> float:
    """The comm-term multiplier of ``tuning/registry.projected_seconds``:
    the EWMA of judged ratios with feedback on, else 1.0."""
    with _CAL_LOCK:
        if not _CAL["enabled"] or _CAL["ratio"] is None:
            return 1.0
        return float(_CAL["ratio"])


def calibration_state() -> dict:
    with _CAL_LOCK:
        return dict(_CAL)


def reset_calibration() -> None:
    """Drop the calibration and turn feedback off."""
    with _CAL_LOCK:
        _CAL.update({"enabled": False, "ratio": None, "samples": 0})


# ---------------------------------------------------------------------
# The --comm-report snapshot.
# ---------------------------------------------------------------------


def snapshot() -> dict:
    """The process-wide comm snapshot: the last distributed solve's report
    and the comm counter families."""
    reg = _metrics.REGISTRY.snapshot()
    with _LAST_LOCK:
        last = LAST_REPORT
    return {
        "metric": "comm_report",
        "last_solve": None if last is None else last.to_json(),
        "counters": {name: reg[name] for name in (
            "tpu_jordan_torch_comm_bytes_total",
            "tpu_jordan_torch_comm_messages_total",
            "tpu_jordan_torch_comm_drift_total") if name in reg},
        "calibration": calibration_state(),
    }


def write_report(path: str) -> None:
    import json

    with open(path, "w") as f:
        json.dump(snapshot(), f)


# ---------------------------------------------------------------------
# The demo (--comm-demo): one world of 4 ranks for every leg.
# ---------------------------------------------------------------------

#: The ranks of the demos' world: the 1D p = 4 legs and the 2×2 legs.
DEMO_RANKS = 4


def ragged_size(n: int, m: int) -> int:
    """The demos' ragged n: n itself unless m divides it."""
    return n - m // 2 if n % m == 0 else n


def _leg_out(out: dict, res, mark: int) -> dict:
    out.update(elapsed_s=res.elapsed, rel_residual=res.rel_residual,
               pivots=res.ranks[0]["pivots"],
               launches=[r.get("launches") for r in res.ranks],
               comm=res.comm.to_json(), work=res.work.to_json(),
               drift_events=[e for e in _recorder.RECORDER.since(mark)
                             if e["kind"] == "comm_drift"])
    return out


def invert_leg(group, name: str, *, n: int, m: int, workers, engine: str,
               gather: bool, group_k: int = 0, dtype: str = "float32",
               generator: str = "absdiff", file: str | None = None,
               record: bool = True) -> dict:
    """One invert leg on this rank of a joined world, under
    :func:`recording` (unless ``record`` is False): ``driver.solve``
    through its joined-world branch.  A singular matrix still reports
    (``LAST_REPORT``).  Every rank returns the leg; recorded, it carries
    every rank's launches, and the ``comm_drift`` events this rank
    recorded during it."""
    from ..driver import solve
    from ..errors import SingularMatrixError

    out = {"name": name, "n": n, "block_size": m}
    mark = _recorder.RECORDER.total
    with recording() if record else contextlib.nullcontext():
        try:
            res = solve(n, m, file=file, workers=workers, engine=engine,
                        group=group_k, gather=gather, generator=generator,
                        dtype=dtype, device=group.device.type)
        except SingularMatrixError:
            from . import work as _work

            out.update(singular=True, comm=LAST_REPORT.to_json(),
                       work=_work.LAST_REPORT.to_json())
            return out
    out["singular"] = False
    return _leg_out(out, res, mark)


def solve_leg(group, name: str, *, n: int, m: int, workers, gather: bool,
              k: int, dtype: str = "float32", generator: str = "absdiff",
              engine: str = "solve_sharded", record: bool = True) -> dict:
    """One distributed-solve leg on this rank of a joined world, under
    :func:`recording` (unless ``record`` is False):
    ``linalg.solve_system`` through its joined-world branch, A from
    ``generator`` and B ``rand`` from row n on, as in the JAX package's
    demo."""
    from ..interop import resolve_dtype
    from ..linalg import solve_system
    from ..ops.generators import generate

    dt = resolve_dtype(dtype)
    a = generate(generator, (n, n), dt)
    b = generate("rand", (n, k), dt, row_offset=n)
    mark = _recorder.RECORDER.total
    with recording() if record else contextlib.nullcontext():
        res = solve_system(a, b, block_size=m, workers=workers,
                           gather=gather, engine=engine,
                           device=group.device.type, check=False)
    return _leg_out({"name": name, "n": n, "block_size": m,
                     "singular": res.singular}, res, mark)


def run_leg(group, kind: str, name: str, kwargs: dict) -> dict:
    """:func:`invert_leg` (``kind`` "invert") or :func:`solve_leg` with
    ``kwargs``, in the shape ``parallel.run_calls`` calls."""
    return (invert_leg if kind == "invert" else solve_leg)(group, name,
                                                           **kwargs)


def comm_demo_rank(group, n: int, m: int, dtype: str,
                   generator: str) -> dict:
    """Every leg of :func:`comm_demo` on this rank of its world; returns
    the report (rank 0's is the demo's)."""
    mark = _recorder.RECORDER.total
    kw = {"dtype": dtype, "generator": generator}
    legs = [
        invert_leg(group, "1d_p4_inplace_gathered", n=n, m=m, workers=4,
                   engine="inplace", gather=True, **kw),
        invert_leg(group, "1d_p4_grouped2_gathered", n=n, m=m, workers=4,
                   engine="grouped", gather=True, group_k=2, **kw),
        invert_leg(group, "1d_p4_swapfree_sharded", n=n, m=m, workers=4,
                   engine="swapfree", gather=False, **kw),
        invert_leg(group, "1d_p4_lookahead_sharded", n=n, m=m, workers=4,
                   engine="lookahead", gather=False, **kw),
        invert_leg(group, "2d_2x2_inplace_gathered", n=n, m=m,
                   workers=(2, 2), engine="inplace", gather=True, **kw),
        invert_leg(group, "2d_2x2_swapfree_sharded", n=n, m=m,
                   workers=(2, 2), engine="swapfree", gather=False, **kw),
        solve_leg(group, "1d_p4_solve_gathered", n=n, m=m, workers=4,
                  gather=True, k=3, **kw),
        solve_leg(group, "2d_2x2_solve_sharded", n=n, m=m, workers=(2, 2),
                  gather=False, k=2, **kw),
        solve_leg(group, "1d_p4_solve_lookahead_sharded", n=n, m=m,
                  workers=4, gather=False, k=2, engine="solve_lookahead",
                  **kw),
    ]
    # The deliberate drift leg: judged with a tight band; the measured
    # residue of a world of CPU ranks or of gloo ranks sharing one card is
    # nowhere near the H100 model's NVLink projection, so the event fires.
    with set_drift_policy(tolerance=1.5, judge="always"):
        drift_leg = invert_leg(group, "1d_p4_inplace_drift", n=n, m=m,
                               workers=4, engine="inplace", gather=True,
                               **kw)
    blackbox = _recorder.RECORDER.dump(
        events=_recorder.RECORDER.since(mark))
    drift_events = [e for e in blackbox["events"]
                    if e["kind"] == "comm_drift"]
    unreconciled = [leg["name"] for leg in legs + [drift_leg]
                    if leg["comm"]["reconciled"] is not True]
    mismatches = [msg for leg in legs + [drift_leg]
                  for msg in leg["comm"]["mismatches"]]
    dr = drift_leg["comm"]["drift"] or {}
    silent_drift = bool(dr.get("judged") and dr.get("out_of_band")
                        and not drift_events)
    reg = _metrics.REGISTRY.snapshot()
    return {
        "metric": "comm_demo",
        "n": n, "block_size": m, "dtype": dtype, "generator": generator,
        "ragged": n % m != 0,
        "ranks": group.world_size, "backend": group.backend,
        "device": str(group.device.type),
        "legs": legs,
        "drift_leg": drift_leg,
        "drift_events": len(drift_events),
        "comm_drift_total": sum(
            s.get("value", 0) for s in reg.get(
                "tpu_jordan_torch_comm_drift_total", {}).get("series", [])),
        "unreconciled": unreconciled,
        "mismatches": mismatches,
        "silent_comm": bool(unreconciled or mismatches or silent_drift),
        "blackbox": blackbox,
    }


def demo_world(rank_fn, *args, device=None):
    """Run ``rank_fn(group, *args)`` in one spawned world of
    :data:`DEMO_RANKS` ranks on ``device`` (the card unless "cpu"; on one
    card the ranks are gloo ranks sharing it); returns rank 0's result."""
    from ..driver import WORLD_DEADLINE_S
    from ..interop import resolve_device
    from ..parallel.launch import run_workers

    dev = resolve_device(device)
    return run_workers(DEMO_RANKS, rank_fn, *args,
                       deadline_s=WORLD_DEADLINE_S,
                       device_type=dev.type)[0]


def refuse_complex(dtype, flag: str) -> str:
    """The demos' dtype: a real one, by name; complex is a typed refusal
    (the distributed engines are real-dtype)."""
    from ..errors import UsageError
    from ..interop import resolve_dtype

    dt = resolve_dtype(dtype if dtype is not None else "float32")
    if dt.is_complex:
        raise UsageError(
            f"{flag} accounts the DISTRIBUTED engines and complex dtypes "
            f"run single-device (driver.solve's contract); use a real "
            f"dtype")
    return str(dt).removeprefix("torch.")


def comm_demo(n: int = 48, block_size: int = 8, seed: int = 0, dtype=None,
              generator: str = "absdiff", device=None) -> dict:
    """The communication observatory's acceptance run: nine distributed
    solves with recording on (1D p = 4 and 2×2, both gather modes, the
    grouped, swap-free and probe-ahead engines, the three solve flavors, a
    RAGGED n so the identity-padded tail rides every inventory), each
    reconciled per rank and for the world, then the deliberate drift leg
    under ``set_drift_policy(tolerance=1.5, judge="always")``.  All legs
    run in one world of 4 ranks (``--device cpu``: CPU ranks; on the card:
    gloo ranks sharing it).  Returns the report ``tools/check_comm.py``
    judges (exit 2 = an unaccounted collective or a silent drift)."""
    del seed  # the demo fixtures are deterministic generators
    dt = refuse_complex(dtype, "--comm-demo")
    m = int(block_size)
    return demo_world(comm_demo_rank, ragged_size(int(n), m), m, dt,
                      generator, device=device)
