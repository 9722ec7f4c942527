"""The work observatory of the distributed paths.  Counterpart of the JAX
package's ``obs/work.py``: which worker did the work, and was a straggler
the layout or the replica.

The paper's 1D row-block-cyclic layout (``local_to_global``,
main.cpp:118-123; the ragged last block, main.cpp:95-116) exists for load
balance as the live window shrinks.  Two layers:

1. **The analytical per-worker inventory** (:func:`engine_report`): the
   per-(worker, superstep, phase) useful FLOPs of one distributed solve,
   integer layout math (ownership × live window × workload), so the
   per-worker shares sum exactly to the headline convention (invert 2n³,
   solve n³ + n²k).  Pad blocks carry zero useful work: the layout's tail
   imbalance.  On the same layout every number equals the JAX package's.
   ``unroll`` describes the eager loop, which runs every superstep with
   its own shapes: in the port the traced model IS the executed model, so
   it defaults to True.

   **The pin** (:meth:`WorkReport.attach_counted`).  The JAX package holds
   the executed model against XLA's ``cost_analysis`` of the sharded
   executables; eager PyTorch has no executable cost (``obs/hwcost.py``
   reports it unavailable, never modeled).  The port's counterpart is a
   COUNT of the GEMM FLOPs each rank's engine actually issued: 2·M·K·N
   from the operands' shapes at every ``addmm_``/``@`` call site of the
   engines (``parallel/group.tally_gemm``), taken per rank in the engine
   window alone while ``obs.comm.recording()`` is active, on every rank (ranks
   with no live probe too; the lookahead engine's split GEMMs count as the
   products they are).  It rides the checker's key ``xla`` with a
   ``source`` naming what was counted (a departure from the JAX
   package's compiler count), and is judged against the executed model
   within :data:`XLA_BAND`.

2. **Measured fleet skew** (:class:`FleetSkewJudge`): per-replica execute
   p99s (``serve/stats.cross_replica_spread``) normalized by each
   replica's analytical critical path (:func:`expected_latency_factor`)
   before the spread meets the threshold, so layout-inherent imbalance is
   never read as a sick replica.  Suspicion is transition-only (one
   ``straggler_suspected`` event, then one ``straggler_cleared``), and the
   live verdict is the autoscaler's pre-shed veto
   (``fleet/autoscaler.py``).

The demo (:func:`work_demo`, ``--work-demo``) runs its solve legs in one
world of 4 ranks; ``tools/check_work.py`` judges it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from . import metrics as _metrics
from . import recorder as _recorder

#: ``pivot`` = the work on the pivot block row itself; ``eliminate`` =
#: every other owned row's rank-m update.
PHASES = ("pivot", "eliminate")

_M_SHARE = _metrics.gauge(
    "tpu_jordan_torch_work_share",
    "analytical useful-FLOP share of the last distributed solve, per "
    "worker (layout-derived)")
_M_SKEW = _metrics.gauge(
    "tpu_jordan_torch_work_skew",
    "max-over-mean per-worker imbalance factor of the last distributed "
    "solve per engine (1.0 = perfectly balanced)")
_M_STRAGGLER = _metrics.counter(
    "tpu_jordan_torch_straggler_suspected_total",
    "fleet replicas whose normalized execute-latency spread exceeded the "
    "straggler threshold (transition-only, evidence in the flight "
    "recorder)")

#: What the port's pin counts (``WorkReport.xla["source"]``).
COUNTED_SOURCE = ("counted GEMM FLOPs: 2*M*K*N of every addmm_/@ the "
                  "engines issued, per rank, engine window only (eager "
                  "PyTorch has no executable cost_analysis)")


def _sig(v: float) -> float:
    return float(f"{float(v):.4g}")


# ---------------------------------------------------------------------
# Layout math: useful block heights and convention totals.
# ---------------------------------------------------------------------


def useful_heights(n: int, m: int) -> list[int]:
    """Heights of the useful block rows: m for every full block, the
    ragged tail's height last, nothing for pad blocks (Σ = n)."""
    from ..parallel.layout import last_block_height, num_block_rows

    Tu = num_block_rows(n, m)
    return [m] * (Tu - 1) + [last_block_height(n, m)]


def convention_flops(n: int, workload: str, k: int = 0) -> int:
    """The headline useful-FLOP convention (``obs/hwcost.py``): invert
    2n³, solve n³ + n²k, as an exact integer."""
    if workload == "invert":
        return 2 * n ** 3
    if workload == "solve":
        return n ** 3 + n ** 2 * int(k)
    raise ValueError(f"no work convention for workload {workload!r}")


def _cyclic_sums(h: list[int], p: int) -> list[int]:
    out = [0] * p
    for r, hr in enumerate(h):
        out[r % p] += hr
    return out


def _inventory_1d(lay, workload: str, k: int):
    """Per-(worker, superstep, phase) useful FLOPs on the 1D layout: block
    row r → worker r % p; the invert window is n wide, the solve's live
    width W_{t−1} + W_t + k."""
    n, m, p = lay.n, lay.m, lay.p
    h = useful_heights(n, m)
    R = _cyclic_sums(h, p)
    per_worker = {str(w): {"pivot": 0, "eliminate": 0} for w in range(p)}
    per_superstep = []
    C = 0
    for t, ht in enumerate(h):
        if workload == "invert":
            f = 2 * ht * n
        else:
            w_prev = n - C
            C += ht
            f = ht * (w_prev + (n - C) + k)
        owner = t % p
        tot_t = 0
        for w in range(p):
            piv = f * ht if w == owner else 0
            elim = f * (R[w] - (ht if w == owner else 0))
            per_worker[str(w)]["pivot"] += piv
            per_worker[str(w)]["eliminate"] += elim
            tot_t += piv + elim
        per_superstep.append(tot_t)
    return per_worker, per_superstep


def _inventory_2d(lay, workload: str, k: int):
    """The same on the (pr, pc) mesh: block (r, j) → worker (r % pr,
    j % pc); the solve's k RHS columns (replicated along pc in the
    engine) are split cyclically over the column workers so the useful
    total stays exact."""
    n, m, pr, pc = lay.n, lay.m, lay.pr, lay.pc
    h = useful_heights(n, m)
    Rr = _cyclic_sums(h, pr)
    S = _cyclic_sums(h, pc)
    kc = [len(range(c, int(k), pc)) for c in range(pc)]
    per_worker = {f"{wr},{wc}": {"pivot": 0, "eliminate": 0}
                  for wr in range(pr) for wc in range(pc)}
    per_superstep = []
    P = [0] * pc
    for t, ht in enumerate(h):
        tc = t % pc
        P[tc] += ht
        tot_t = 0
        for wc in range(pc):
            if workload == "invert":
                colw = S[wc]
            else:
                colw = 2 * (S[wc] - P[wc]) + (ht if wc == tc else 0)
                colw += kc[wc]
            f = 2 * ht * colw if workload == "invert" else ht * colw
            owner = t % pr
            for wr in range(pr):
                piv = f * ht if wr == owner else 0
                elim = f * (Rr[wr] - (ht if wr == owner else 0))
                cell = per_worker[f"{wr},{wc}"]
                cell["pivot"] += piv
                cell["eliminate"] += elim
                tot_t += piv + elim
        per_superstep.append(tot_t)
    return per_worker, per_superstep


def executed_model_flops(engine: str, workload: str, *, N: int, m: int,
                         k: int = 0, unroll: bool = True,
                         pc: int = 1) -> float:
    """The FLOPs the engines launch, summed over the ranks, padded
    dimensions: invert 2·N³ (4·N³ for an [A | I] strip); the solve with
    ``unroll`` shrinks the live width per superstep (the port's eager
    loop, the JAX unrolled flavor), without it keeps N + k·pc (X is
    replicated along pc)."""
    Nr = N // m
    if workload == "invert":
        width = 2 * N if engine == "augmented" else N
        return 2.0 * N * N * width
    if not unroll:
        return 2.0 * N * N * (N + k * pc)
    total = 0.0
    for t in range(Nr):
        if pc > 1:
            bc1 = Nr // pc
            live = pc * (bc1 - t // pc) * m
        else:
            live = N - t * m
        total += 2.0 * m * N * (live + k * pc)
    return total


#: Engines with a registered work inventory (the comm inventory's set).
INVENTORY_ENGINES = frozenset(
    {"inplace", "grouped", "swapfree", "augmented", "solve_sharded",
     "lookahead", "solve_lookahead"})

#: Acceptance band of the pin: counted (or, in the JAX package, compiled)
#: FLOPs over the executed model.  The count adds the per-step pivot-row
#: products (2·m²·W a rank) the GEMM-order model leaves out.
XLA_BAND = (0.5, 4.0)


def engine_report(*, engine: str, lay, dtype=None, k: int = 0,
                  group: int = 0, unroll: bool | None = None
                  ) -> "WorkReport":
    """The analytical :class:`WorkReport` of one distributed engine
    configuration on ``lay`` (``k`` the solve's right-hand-side columns).
    ``unroll=None`` is the port's eager loop (True, module docstring); an
    explicit value selects the JAX package's flavor of the executed model.
    An engine outside :data:`INVENTORY_ENGINES` is a ``ValueError``."""
    from ..parallel.layout import last_block_height, num_block_rows

    if engine not in INVENTORY_ENGINES:
        raise ValueError(
            f"no work inventory registered for engine {engine!r} "
            f"(obs/work.INVENTORY_ENGINES); a distributed engine ships "
            f"WITH its analytical work accounting")
    unroll = True if unroll is None else bool(unroll)
    workload = ("solve" if engine in ("solve_sharded", "solve_lookahead")
                else "invert")
    dt = None if dtype is None else str(dtype).removeprefix("torch.")
    if hasattr(lay, "pc"):
        per_worker, per_superstep = _inventory_2d(lay, workload, int(k))
        mesh, workers = f"{lay.pr}x{lay.pc}", (lay.pr, lay.pc)
        n_devices, pc = lay.pr * lay.pc, lay.pc
    else:
        per_worker, per_superstep = _inventory_1d(lay, workload, int(k))
        mesh, workers = f"1D p={lay.p}", lay.p
        n_devices, pc = lay.p, 1
    n, m = lay.n, lay.m
    executed = executed_model_flops(engine, workload, N=lay.N, m=m,
                                    k=int(k), unroll=unroll, pc=pc)
    ideal = executed_model_flops(engine, workload, N=n, m=m, k=int(k),
                                 unroll=unroll, pc=pc)
    return WorkReport(
        engine=engine, mesh=mesh, workers=workers, n=n, block_size=m,
        workload=workload, rhs=int(k), dtype=dt, group=int(group),
        unroll=unroll, n_devices=n_devices,
        supersteps=num_block_rows(n, m), padded_supersteps=lay.Nr,
        padded_n=lay.N, last_height=last_block_height(n, m),
        per_worker=per_worker, per_superstep=per_superstep,
        convention=convention_flops(n, workload, int(k)),
        executed_model=float(executed),
        ragged_penalty=(float(executed) / float(ideal) - 1.0
                        if ideal else 0.0))


@dataclass
class WorkReport:
    """One distributed solve's work record (``SolveResult.work``,
    ``SolveSystemResult.work``)."""

    engine: str
    mesh: str
    workers: object
    n: int
    block_size: int
    workload: str
    rhs: int = 0
    dtype: str | None = None
    group: int = 0
    unroll: bool = True
    n_devices: int = 1
    supersteps: int = 0
    padded_supersteps: int = 0
    padded_n: int = 0
    last_height: int = 0
    #: {worker: {"pivot": int, "eliminate": int}}, integer-exact.
    per_worker: dict = field(default_factory=dict)
    #: Useful FLOPs per superstep, summed over the workers.
    per_superstep: list = field(default_factory=list)
    convention: int = 0
    executed_model: float = 0.0
    ragged_penalty: float = 0.0
    #: The counted pin (:meth:`attach_counted`); None before.
    xla: dict | None = None

    def worker_flops(self) -> dict:
        return {w: d["pivot"] + d["eliminate"]
                for w, d in self.per_worker.items()}

    def accounted_flops(self) -> int:
        return sum(self.worker_flops().values())

    @property
    def exact(self) -> bool:
        """The per-worker shares sum exactly to the convention total."""
        return self.accounted_flops() == self.convention

    def shares(self) -> dict:
        tot = float(self.convention) or 1.0
        return {w: f / tot for w, f in self.worker_flops().items()}

    def max_worker_flops(self) -> int:
        """The layout's critical path: the most loaded worker's FLOPs."""
        return max(self.worker_flops().values(), default=0)

    def skew(self) -> float:
        """Max-over-mean per-worker imbalance (1.0 = balanced)."""
        f = list(self.worker_flops().values())
        mean = sum(f) / len(f) if f else 0.0
        return (max(f) / mean) if mean else 1.0

    # ---- the counted pin ---------------------------------------------

    def attach_counted(self, per_rank_flops, span=None) -> dict:
        """Judge the ranks' counted GEMM FLOPs (a list in rank order; None:
        nothing was counted, recording off) against the executed model
        (module docstring).  ``total_flops`` is ``per_device_flops ×
        devices``, the checker's unit."""
        if per_rank_flops is None:
            self.xla = {"available": False, "source": COUNTED_SOURCE}
            return self.xla
        per_rank = [int(f) for f in per_rank_flops]
        per_dev = float(sum(per_rank)) / self.n_devices
        total = per_dev * self.n_devices
        model = float(self.executed_model)
        if not self.unroll and self.padded_supersteps:
            traced = (min(self.group, self.padded_supersteps)
                      if self.group > 1 else 1)
            model = model * traced / self.padded_supersteps
        ratio = (total / model) if model > 0 else None
        within = ratio is not None and XLA_BAND[0] <= ratio <= XLA_BAND[1]
        self.xla = {
            "available": True,
            "source": COUNTED_SOURCE,
            "per_rank_flops": per_rank,
            "per_device_flops": per_dev,
            "devices": self.n_devices,
            "total_flops": total,
            "model_traced_flops": model,
            "model_executed_flops": float(self.executed_model),
            "xla_vs_model": None if ratio is None else _sig(ratio),
            "band": [XLA_BAND[0], XLA_BAND[1]],
            "within": within,
        }
        if span is not None and ratio is not None:
            span.attrs["work_counted_vs_model"] = _sig(ratio)
        return self.xla

    # ---- export ------------------------------------------------------

    def observe_metrics(self) -> None:
        for w, s in self.shares().items():
            _M_SHARE.set(s, engine=self.engine, worker=w)
        _M_SKEW.set(self.skew(), engine=self.engine)

    def attach_span(self, span) -> None:
        """The imbalance factor, the most loaded worker's share and the
        ragged penalty on the ``execute`` span."""
        if span is None:
            return
        span.attrs["work_skew"] = _sig(self.skew())
        span.attrs["work_max_share"] = _sig(
            max(self.shares().values(), default=0.0))
        span.attrs["work_ragged_penalty"] = _sig(self.ragged_penalty)

    def to_json(self) -> dict:
        shares = self.shares()
        return {
            "engine": self.engine, "mesh": self.mesh,
            "workers": (list(self.workers)
                        if isinstance(self.workers, tuple)
                        else self.workers),
            "n": self.n, "block_size": self.block_size,
            "workload": self.workload, "rhs": self.rhs,
            "dtype": self.dtype, "group": self.group,
            "unroll": self.unroll, "n_devices": self.n_devices,
            "supersteps": self.supersteps,
            "padded_supersteps": self.padded_supersteps,
            "padded_n": self.padded_n, "last_height": self.last_height,
            "per_worker": {
                w: {"pivot": d["pivot"], "eliminate": d["eliminate"],
                    "flops": d["pivot"] + d["eliminate"],
                    "share": _sig(shares[w])}
                for w, d in self.per_worker.items()},
            "per_superstep": list(self.per_superstep),
            "totals": {
                "convention_flops": self.convention,
                "accounted_flops": self.accounted_flops(),
                "exact": self.exact,
                "executed_model_flops": self.executed_model,
                "skew": _sig(self.skew()),
                "ragged_penalty": _sig(self.ragged_penalty),
            },
            "xla": self.xla,
        }


_LAST_LOCK = threading.Lock()
LAST_REPORT: WorkReport | None = None


def set_last_report(report: WorkReport) -> None:
    """The most recent distributed solve's report (``--work-report``)."""
    global LAST_REPORT
    with _LAST_LOCK:
        LAST_REPORT = report


def snapshot() -> dict:
    """The process-wide work snapshot: the last distributed solve's report
    and the work metric families."""
    reg = _metrics.REGISTRY.snapshot()
    with _LAST_LOCK:
        last = LAST_REPORT
    return {
        "metric": "work_report",
        "last_solve": None if last is None else last.to_json(),
        "gauges": {name: reg[name] for name in (
            "tpu_jordan_torch_work_share",
            "tpu_jordan_torch_work_skew") if name in reg},
        "counters": {name: reg[name] for name in (
            "tpu_jordan_torch_straggler_suspected_total",) if name in reg},
    }


def write_report(path: str) -> None:
    import json

    with open(path, "w") as f:
        json.dump(snapshot(), f)


# ---------------------------------------------------------------------
# Measured fleet skew, reconciled against the layout.
# ---------------------------------------------------------------------

#: A replica whose normalized p99 exceeds the fleet's best by this factor
#: is a suspected straggler.
STRAGGLER_SPREAD = 2.0


def expected_latency_factor(report: WorkReport) -> float:
    """A replica's analytical expected-latency unit: its layout's critical
    path (the most loaded worker's useful FLOPs)."""
    return float(report.max_worker_flops())


class FleetSkewJudge:
    """The measured-vs-analytical skew reconciler: ``assess`` takes
    per-replica execute p99s (ms) and optional analytical expected-latency
    factors, returns a verdict and records a transition-only
    ``straggler_suspected``/``straggler_cleared`` pair; :meth:`veto` is
    the autoscaler's pre-shed veto input."""

    def __init__(self, threshold: float = STRAGGLER_SPREAD):
        self.threshold = float(threshold)
        self._lock = threading.Lock()
        self._last: dict | None = None
        self._suspected = False

    def assess(self, p99_ms: dict, expected: dict | None = None) -> dict:
        """Judge one observation of the fleet; fewer than two replicas
        with data is ``judged: False``."""
        norm = {}
        for rep, v in p99_ms.items():
            if v is None or v <= 0:
                continue
            e = float(expected.get(rep, 1.0)) if expected else 1.0
            if e <= 0:
                e = 1.0
            norm[str(rep)] = float(v) / e
        verdict: dict = {
            "threshold": self.threshold,
            "p99_ms": {str(r): (None if v is None else float(v))
                       for r, v in p99_ms.items()},
            "expected": ({str(r): float(v) for r, v in expected.items()}
                         if expected else None),
            "normalized": {r: _sig(v) for r, v in norm.items()},
        }
        if len(norm) < 2:
            verdict.update({"judged": False, "suspected": False,
                            "spread": None, "replica": None})
        else:
            worst = max(norm, key=lambda r: norm[r])
            spread = norm[worst] / min(norm.values())
            verdict.update({"judged": True, "spread": _sig(spread),
                            "replica": worst,
                            "suspected": spread > self.threshold})
        with self._lock:
            was = self._suspected
            now = bool(verdict["suspected"])
            self._suspected = now
            self._last = verdict
        if now and not was:
            _M_STRAGGLER.inc(replica=verdict["replica"])
            _recorder.record(
                "straggler_suspected", replica=verdict["replica"],
                spread=verdict["spread"], threshold=self.threshold,
                p99_ms=verdict["p99_ms"], normalized=verdict["normalized"])
        elif was and not now:
            _recorder.record("straggler_cleared", spread=verdict["spread"],
                             threshold=self.threshold)
        return verdict

    def veto(self) -> dict | None:
        """The last verdict while it suspects a straggler, else None."""
        with self._lock:
            if self._suspected and self._last is not None:
                return dict(self._last)
            return None

    @property
    def last_verdict(self) -> dict | None:
        with self._lock:
            return None if self._last is None else dict(self._last)


def _fleet_skew_legs() -> tuple[list, dict]:
    """The measured-skew legs, synthetic latencies through the real
    rollup and judge (``ServeStats.batch`` → ``cross_replica_spread`` →
    :class:`FleetSkewJudge`): a sick replica (suspected, recorded), a
    layout-attributed spread (clean), and the recovery (cleared)."""
    from ..parallel.layout import CyclicLayout
    from ..serve.stats import ServeStats, cross_replica_spread

    def replica_stats(slot: int, exec_s: list) -> ServeStats:
        st = ServeStats(labels={"replica": str(slot)})
        for e in exec_s:
            st.batch("demo", occupancy=1, exec_seconds=e, queue_seconds=())
        return st

    legs = []
    judge = FleetSkewJudge()
    snaps = [replica_stats(i, [0.010 + 0.001 * j for j in range(8)])
             for i in range(2)]
    snaps.append(replica_stats(2, [0.050 + 0.005 * j for j in range(8)]))
    spread = cross_replica_spread([s.snapshot() for s in snaps])
    p99 = {r: d["exec_ms"]["p99"] for r, d in spread["replicas"].items()}
    verdict = judge.assess(p99)
    legs.append({"name": "fleet_straggler_suspected", "synthetic": True,
                 "spread": spread, "verdict": verdict,
                 "expect_suspected": True})

    rep_big = engine_report(engine="inplace",
                            lay=CyclicLayout.create(44, 8, 8))
    rep_small = engine_report(engine="inplace",
                              lay=CyclicLayout.create(44, 8, 2))
    expected = {"0": expected_latency_factor(rep_big),
                "1": expected_latency_factor(rep_small)}
    ratio = expected["1"] / expected["0"]
    snaps = [replica_stats(0, [0.010] * 8),
             replica_stats(1, [0.010 * ratio] * 8)]
    spread_b = cross_replica_spread([s.snapshot() for s in snaps])
    p99_b = {r: d["exec_ms"]["p99"] for r, d in spread_b["replicas"].items()}
    verdict_b = FleetSkewJudge().assess(p99_b, expected=expected)
    legs.append({"name": "fleet_skew_layout_attributed", "synthetic": True,
                 "spread": spread_b, "expected": expected,
                 "verdict": verdict_b, "expect_suspected": False})

    verdict_c = judge.assess({r: 11.0 for r in p99})
    legs.append({"name": "fleet_straggler_recovered", "synthetic": True,
                 "verdict": verdict_c, "expect_suspected": False})
    return legs, {"threshold": STRAGGLER_SPREAD,
                  "veto_after_recovery": judge.veto()}


# ---------------------------------------------------------------------
# The demo (--work-demo): one world of 4 ranks for the solve legs.
# ---------------------------------------------------------------------


def work_demo_rank(group, n: int, m: int, dtype: str,
                   generator: str) -> dict:
    """Every leg of :func:`work_demo` on this rank of its world; returns
    the report (rank 0's is the demo's)."""
    from .comm import invert_leg, solve_leg

    n_ali = 8 * m
    mark = _recorder.RECORDER.total
    kw = {"dtype": dtype, "generator": generator}
    legs = [
        invert_leg(group, "1d_p4_inplace_gathered", n=n, m=m, workers=4,
                   engine="inplace", gather=True, **kw),
        invert_leg(group, "1d_p4_swapfree_sharded", n=n, m=m, workers=4,
                   engine="swapfree", gather=False, **kw),
        invert_leg(group, "1d_p4_inplace_aligned", n=n_ali, m=m, workers=4,
                   engine="inplace", gather=True, **kw),
        invert_leg(group, "2d_2x2_inplace_gathered", n=n, m=m,
                   workers=(2, 2), engine="inplace", gather=True, **kw),
        solve_leg(group, "1d_p4_solve_gathered", n=n, m=m, workers=4,
                  gather=True, k=3, **kw),
        solve_leg(group, "2d_2x2_solve_sharded", n=n, m=m, workers=(2, 2),
                  gather=False, k=2, **kw),
    ]
    fleet_legs, fleet = _fleet_skew_legs()
    blackbox = _recorder.RECORDER.dump(
        events=_recorder.RECORDER.since(mark))
    straggler_events = [e for e in blackbox["events"]
                        if e["kind"] == "straggler_suspected"]
    cleared_events = [e for e in blackbox["events"]
                      if e["kind"] == "straggler_cleared"]
    unaccounted = [leg["name"] for leg in legs
                   if not leg["work"]["totals"]["exact"]]
    xla_unreconciled = [
        leg["name"] for leg in legs
        if (leg["work"]["xla"] or {}).get("available")
        and not leg["work"]["xla"]["within"]]
    aligned = next(leg for leg in legs
                   if leg["name"] == "1d_p4_inplace_aligned")
    penalty_bad = aligned["work"]["totals"]["ragged_penalty"] != 0.0
    verdict_wrong = [
        leg["name"] for leg in fleet_legs
        if bool(leg["verdict"]["suspected"]) != leg["expect_suspected"]]
    silent_straggler = (any(leg["expect_suspected"] for leg in fleet_legs)
                        and not straggler_events)
    return {
        "metric": "work_demo",
        "n": n, "aligned_n": n_ali, "block_size": m,
        "dtype": dtype, "generator": generator,
        "ragged": n % m != 0,
        "ranks": group.world_size, "backend": group.backend,
        "device": str(group.device.type),
        "legs": legs,
        "fleet_legs": fleet_legs,
        "fleet": fleet,
        "straggler_events": len(straggler_events),
        "cleared_events": len(cleared_events),
        "unaccounted": unaccounted,
        "xla_unreconciled": xla_unreconciled,
        "penalty_nonzero_aligned": penalty_bad,
        "verdict_wrong": verdict_wrong,
        "silent_work": bool(unaccounted or xla_unreconciled or penalty_bad
                            or verdict_wrong or silent_straggler),
        "blackbox": blackbox,
    }


def work_demo(n: int = 48, block_size: int = 8, seed: int = 0, dtype=None,
              generator: str = "absdiff", device=None) -> dict:
    """The work observatory's acceptance run: distributed solves on 1D and
    2D meshes, invert and solve workloads, a RAGGED n (the pad blocks'
    zero work skews the shares) and an ALIGNED n (penalty exactly 0), each
    leg's shares summing exactly to the convention and its counted GEMM
    FLOPs judged against the executed model; then the fleet-skew legs.
    The solve legs run in one world of 4 ranks (``--device cpu``: CPU
    ranks; on the card: gloo ranks sharing it).  Returns the report
    ``tools/check_work.py`` judges (exit 2 = unaccounted work or an
    unsupported straggler verdict)."""
    from .comm import demo_world, ragged_size, refuse_complex

    del seed  # the demo fixtures are deterministic generators
    dt = refuse_complex(dtype, "--work-demo")
    m = int(block_size)
    return demo_world(work_demo_rank, ragged_size(int(n), m), m, dt,
                      generator, device=device)
