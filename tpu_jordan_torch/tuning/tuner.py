"""The tuner: legality and cost pruning over the registry, robust
measurement of the survivors on the point's device, measured-against-
projected drift, and the plan-cache read and write.  Counterpart of the
JAX package's ``tuning/tuner.py``.

Selection ladder (``Tuner.select``), cheapest evidence first:

  1. **Plan-cache hit**: a cached plan whose registry config still exists,
     resolves to the same ``(engine, group)`` and is legal at the point
     wins with zero measurements.  A measuring tuner is satisfied only by
     a measured plan.
  2. **Cost ranking**: without ``measure=True`` the cheapest projected
     candidate (``registry.select_by_cost``).
  3. **Measured tuning**: with ``measure=True`` the ``survivors`` cheapest
     finite-cost candidates are each measured (``measure_config``) and
     the fastest median wins; every trial records its drift.

Whatever rung produced the plan, it is written back to an attached,
writable cache, so the next selection at the same key is rung 1.

A distributed point (p ranks of the 1D layout, or a (pr, pc) mesh of the
2D layout) measures each configuration in one world of its ranks
(``parallel.dist_solve.measure_rank``): the warm-up and every sample run
inside that world, each sample the slowest rank's time, so a spawn
(0.34–0.63 s on the H100 machine, PERF.md §6) and a world's first
run are never in a sample.  Its plans are keyed by the point's workers
(``p4``, ``2x2``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..errors import UsageError
from ..obs import metrics as _obs_metrics
from . import registry as _registry
from .measure import Measurement, measure_direct
from .plan_cache import Plan, PlanCache, plan_key
from .registry import EngineConfig, TunePoint

_M_HITS = _obs_metrics.counter(
    "tpu_jordan_torch_plan_cache_hits_total",
    "tuner selections satisfied by a cached plan (zero measurements)")
_M_MISSES = _obs_metrics.counter(
    "tpu_jordan_torch_plan_cache_misses_total",
    "tuner selections that fell through to cost ranking or measurement")
_M_MEASUREMENTS = _obs_metrics.counter(
    "tpu_jordan_torch_tuner_measurements_total",
    "engine measurements performed by tune=True selection")


def measure_config(point: TunePoint, cfg: EngineConfig,
                   samples: int = 5) -> Measurement:
    """Measure one configuration at a point on the point's device: whole
    engine calls, through the same functions a solve runs, warmed once.

    Invert points run ``driver.invert`` on the ``rand`` matrix; solve
    points run the solve engine on ``rand`` (``kms`` at SPD points) with
    one ``rand`` (``crand``) right-hand side, as the JAX tuner does.  No
    engine writes its input, so one matrix serves every sample.  On the
    card each timed call ends in a synchronize.  A distributed point runs
    :func:`measure_distributed`."""
    import torch

    from ..driver import invert
    from ..interop import resolve_dtype
    from ..linalg.api import solve_engine_fn
    from ..ops import generate

    if point.workload == "update":
        raise UsageError(
            "tune=True has nothing to measure for the update workload "
            "(smw_update is its one engine; the serve update lanes "
            "resolve cost-only)")
    if point.distributed:
        return measure_distributed(point, cfg, samples=samples)
    dev = torch.device(point.backend)
    dtype = resolve_dtype(point.dtype)
    n, m = point.n, point.block_size
    if dev.type == "cuda":
        # Full fp32 products, as every entry point runs them.
        torch.backends.cuda.matmul.allow_tf32 = False
    if point.workload == "invert":
        a = generate("rand", (n, n), dtype, device=dev)

        def run():
            return invert(a, cfg.engine, cfg.group, m)
    else:
        a = generate("kms" if cfg.workload == "solve_spd" else "rand",
                     (n, n), dtype, device=dev)
        b = generate("crand" if dtype.is_complex else "rand", (n, 1), dtype,
                     device=dev)
        engine = solve_engine_fn(cfg.engine, m)

        def run():
            return engine(a, b)

    def call():
        out = run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    return measure_direct(call, samples=samples)


def measure_distributed(point: TunePoint, cfg: EngineConfig,
                        samples: int = 5, warmup: int = 1) -> Measurement:
    """Measure one configuration at a distributed point in ONE world of
    ``point.workers`` ranks on the point's device type: the ranks' warm-up
    and ``samples`` timed runs (``parallel.dist_solve.measure_rank``, each
    sample the slowest rank's CUDA-event time), reduced by the robust core.
    The ``measure`` fault point fires here, in the caller's process, once
    for each of those runs (each with the transient retry), as
    ``measure_direct`` fires it once a call."""
    from ..driver import WORLD_DEADLINE_S
    from ..parallel.dist_solve import MeasureSpec, measure_rank
    from ..parallel.launch import run_workers
    from ..resilience import faults as _faults
    from .measure import MEASURE_RETRY, robust_stats

    spec = MeasureSpec(n=point.n, m=point.block_size, dtype=point.dtype,
                       workload=("invert" if point.workload == "invert"
                                 else "solve"),
                       engine=cfg.engine, group_k=cfg.group,
                       mesh=(point.workers if isinstance(point.workers, tuple)
                             else None))
    for _ in range(warmup + samples):
        MEASURE_RETRY.call(lambda: _faults.fire("measure"),
                           component="measure")
    ranks = run_workers(point.ranks, measure_rank, spec, samples,
                        warmup, deadline_s=WORLD_DEADLINE_S,
                        device_type=point.backend)
    return robust_stats(ranks[0])


@dataclass
class Tuner:
    """One tuning session.  ``measurements`` counts the measurements it
    performed: a warm cache leaves it at 0."""

    cache: PlanCache | None = None
    measure: bool = False
    measure_fn: object = None          # (point, cfg, samples) -> Measurement
    survivors: int = 3                 # candidates measured per point
    samples: int = 5                   # timed calls per candidate
    measurements: int = 0
    last_source: str | None = field(default=None, repr=False)

    def select(self, point: TunePoint) -> Plan:
        key = plan_key(point)
        if self.cache is not None:
            cached = self.cache.get(key)
            # A cost_model entry does not satisfy tune=True: it would pin
            # the unmeasured guess for good.
            if (cached is not None and self._still_valid(cached, point)
                    and (not self.measure or cached.source == "measured")):
                self.last_source = "cache"
                _M_HITS.inc()
                return cached
        _M_MISSES.inc()
        plan = self._tune(point) if self.measure else self._rank(point)
        self.last_source = plan.source
        if self.cache is not None and not self.cache.read_only:
            self.cache.put(key, plan)
            self.cache.save()
        return plan

    @staticmethod
    def _still_valid(plan: Plan, point: TunePoint) -> bool:
        """A cached plan is honored only while its config exists in the
        live registry, resolves to the same (engine, group), serves the
        point's workload and is legal at the point."""
        cfg = _registry.REGISTRY.get(plan.config)
        return (cfg is not None
                and cfg.engine == plan.engine
                and cfg.group == plan.group
                and cfg.workload == point.workload
                and cfg.legal(point))

    def _rank(self, point: TunePoint) -> Plan:
        cfg = _registry.select_by_cost(point)
        proj = cfg.cost(point)
        return Plan(config=cfg.name, engine=cfg.engine, group=cfg.group,
                    source="cost_model",
                    projected=None if math.isinf(proj) else proj)

    def _tune(self, point: TunePoint) -> Plan:
        cands = _registry.candidates(point)
        if not cands:
            raise ValueError(f"no legal engine at {point}")
        # Only the cheapest `survivors` finite-cost candidates are worth a
        # measurement.
        survivors = [c for c in cands if not math.isinf(c.cost(point))]
        survivors = survivors[:max(1, self.survivors)] or cands[:1]
        fn = self.measure_fn or measure_config
        trials = []
        best = None                       # (seconds, trial, cfg, meas)
        for cfg in survivors:
            proj = cfg.cost(point)
            meas = fn(point, cfg, samples=self.samples)
            self.measurements += 1
            _M_MEASUREMENTS.inc()
            drift = (None if math.isinf(proj) or proj <= 0.0
                     else meas.seconds / proj)
            trial = {
                "config": cfg.name,
                "projected": None if math.isinf(proj) else proj,
                "measured": meas.seconds,
                "drift": drift,
                "spread_pct": meas.spread_pct,
                "rejected_samples": len(meas.rejected),
            }
            if meas.variance_flag:
                trial["variance_flag"] = meas.variance_flag
            trials.append(trial)
            if best is None or meas.seconds < best[0]:
                best = (meas.seconds, trial, cfg, meas)
        seconds, trial, cfg, meas = best
        return Plan(config=cfg.name, engine=cfg.engine, group=cfg.group,
                    source="measured", seconds=seconds,
                    projected=trial["projected"], drift=trial["drift"],
                    variance_flag=meas.variance_flag,
                    trials=tuple(trials))


def auto_select(n: int, block_size: int | None, dtype, workers,
                gather: bool, tune: bool = False,
                plan_cache: str | None = None,
                telemetry=None,
                workload: str = "invert",
                device=None) -> tuple[str, int, Plan]:
    """``engine="auto"`` of the entry points: the tuning point of the call
    on its resolved ``device`` (a CPU point when None), the selection
    ladder, and the resolved ``(engine, group, plan)``.  ``plan_cache`` is
    a JSON path, consulted always and updated whenever selection ran;
    ``tune=True`` measures the cost-pruned survivors (without spans, as
    the JAX package's trials run).  ``telemetry`` records the ladder walk
    as a ``select`` span, with the resolved engine and the rung that
    chose it (``source``)."""
    from ..obs.spans import NULL

    tel = telemetry if telemetry is not None else NULL
    with tel.span("select", n=n, tune=tune, workload=workload) as sp:
        point = TunePoint.create(n, block_size, dtype, workers, gather,
                                 workload=workload, device=device)
        cache = PlanCache.load(plan_cache) if plan_cache else None
        tuner = Tuner(cache=cache, measure=tune)
        plan = tuner.select(point)
        sp.attrs["engine"] = plan.engine
        sp.attrs["source"] = tuner.last_source
    return plan.engine, plan.group, plan
