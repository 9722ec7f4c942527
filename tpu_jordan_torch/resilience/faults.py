"""Deterministic fault injection: counterpart of the JAX package's
``resilience/faults.py``, with the same points, modes and seeded
schedules.

Every fault is an nth-call schedule: an injection point fires on exactly
the k-th time it is reached (1-based, counted per point under a lock), so
a seeded :class:`FaultPlan` fires at the same calls on every run, and at
the same calls as the JAX package's plan of that seed.

The point names are the JAX package's (``POINTS``).  Wired in the port:

  ==================  =================================================
  point               fires inside
  ==================  =================================================
  compile             once per entry call, where the JAX entry compiles:
                      after ``load`` and before the execute in
                      ``driver.solve``, ``linalg.solve_system`` (so
                      ``lstsq``) and ``linalg.solve_update``; once per
                      configuration in ``JordanSolver`` (its first
                      ``invert``).  Under a policy it runs in
                      ``policy.retry`` with the JAX component names
                      (``solve.compile``, ``solve_system.compile``,
                      ``solve_update.compile``, ``solver.compile``).
                      Serving: once per lane executor build
                      (``serve.executors.BucketExecutor``, component
                      ``serve.compile``)
  dispatch            the serving dispatcher, once per dispatched batch
                      before its executor lookup (a failure fans to the
                      batch's riders)
  execute             the timed engine call of the same four entries,
                      inside the policy's retry (``driver.solve``
                      re-loads A before a retry); serving: each attempt of
                      a batch's run (component ``serve.execute``)
  result_corrupt_nan  after the execute: ``driver.solve`` poisons
                      ``inv[0, 0]``, ``solve_system`` ``x[0, 0]`` (before
                      the singular check), ``solve_update`` its
                      rel_residual, so the residual gate must catch it;
                      serving: the rel_residual of the batch's first
                      non-singular rider, so the integrity gate must
                      catch it
  measure             ``tuning/measure.measure_direct``, every timed call
  plan_cache_write    ``tuning/plan_cache.PlanCache.save`` (simulates a
                      full disk or a read-only directory)
  replica_kill        a fleet replica's admission guard
                      (``fleet/replica.py``), once per routed request:
                      the replica dies and the router re-dispatches
  preempt             the segment boundaries of the checkpointed
                      runners (``resilience/checkpoint.py``), after the
                      previous boundary's checkpoint is durable
  ==================  =================================================

The port has no compile step: eager PyTorch builds no executable, and the
kernels under ``csrc/`` are built and loaded once per process
(``_build.py``).  Its ``compile`` point stands for the step that readies
the engine (the resolved engine callable, and on the card the kernel
load), fired once per entry call where the JAX entry compiles, so a
seeded plan's per-point call counts (``FaultPlan.calls``) equal the JAX
package's on the same call sequence.  ``replica_kill`` fires on a fleet
replica's admission path (``fleet/replica.py``); the distributed entries'
sites come with ROADMAP.md Queue A item 15.

A point with no active plan costs one module-global ``is None`` check.
Every fired injection increments ``tpu_jordan_torch_faults_injected_total``
(labeled by point), is logged on the plan (``injections``, ``report``) and
is recorded as a ``fault_injected`` flight-recorder event.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import numpy as np

from ..obs import metrics as _obs_metrics
from ..obs import recorder as _recorder

#: The named injection points.  ``fire()`` on an unknown point raises: a
#: misspelt point would otherwise be chaos that never happens.
POINTS = ("compile", "execute", "plan_cache_write", "measure",
          "result_corrupt_nan", "dispatch", "replica_kill", "preempt")

#: How a scheduled hit shows at the call site:
#:   transient: raises :class:`InjectedTransientError` (classified
#:     retryable by ``resilience.policy.is_transient``);
#:   permanent: raises :class:`InjectedFaultError` (never retried);
#:   oserror: raises ``OSError`` (the plan-cache write failure class);
#:   corrupt: raises nothing; ``corrupt(point)`` returns True and the call
#:     site poisons its own result.
MODES = ("transient", "permanent", "oserror", "corrupt")

_M_INJECTED = _obs_metrics.counter(
    "tpu_jordan_torch_faults_injected_total",
    "faults fired by an active FaultPlan, labeled by injection point")


class InjectedFaultError(RuntimeError):
    """A permanent injected fault: not transient, so retry policies let it
    through at once."""


class InjectedTransientError(ConnectionError):
    """A transient injected fault: a transport type with the "INTERNAL"
    marker, which ``resilience.policy.is_transient`` classifies as
    transient, so the production retry path handles it unchanged."""


@dataclass(frozen=True)
class FaultSpec:
    """One point's schedule: fire on the given 1-based call indices."""

    point: str
    calls: tuple[int, ...]
    mode: str = "transient"

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; "
                             f"choose from {'/'.join(POINTS)}")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; "
                             f"choose from {'/'.join(MODES)}")
        if any(c < 1 for c in self.calls):
            raise ValueError("call indices are 1-based")


class FaultPlan:
    """A set of :class:`FaultSpec` schedules and the per-point call
    counters.  Thread-safe.  ``injections`` lists every fired fault as
    ``(point, call_index, mode)`` in firing order."""

    def __init__(self, specs):
        self._lock = threading.Lock()
        self._calls: dict[str, int] = {}
        self._sched: dict[str, dict[int, str]] = {}
        self.specs = tuple(specs)
        for spec in self.specs:
            sched = self._sched.setdefault(spec.point, {})
            for c in spec.calls:
                if c in sched:
                    raise ValueError(
                        f"duplicate schedule for {spec.point!r} call {c}")
                sched[c] = spec.mode
        self.injections: list[tuple[str, int, str]] = []

    @classmethod
    def seeded(cls, seed: int, horizon: int = 20,
               points: dict | None = None) -> "FaultPlan":
        """Schedules from a seed: for each point, in sorted order, ``count``
        distinct call indices drawn uniformly from [1, horizon] by one
        ``np.random.default_rng(seed)`` stream, so the same seed and
        ``points`` give the same plan as the JAX package's.

        ``points`` maps a point to its count, or to ``(count, horizon)``;
        the default is the JAX chaos mix (one compile failure, three
        transient execute errors, two NaN corruptions, one plan-cache
        write failure).  Modes: ``plan_cache_write`` oserror,
        ``result_corrupt_nan`` corrupt, ``replica_kill`` and ``preempt``
        permanent, the others transient."""
        if points is None:
            points = {"compile": 1, "execute": 3,
                      "result_corrupt_nan": 2, "plan_cache_write": 1}
        rng = np.random.default_rng(seed)
        specs = []
        for point in sorted(points):
            spec = points[point]
            count, h = spec if isinstance(spec, tuple) else (spec, horizon)
            if count < 1:
                continue
            count = min(count, h)
            calls = tuple(sorted(
                int(c) + 1
                for c in rng.choice(h, size=count, replace=False)))
            mode = ("oserror" if point == "plan_cache_write"
                    else "corrupt" if point == "result_corrupt_nan"
                    else "permanent" if point in ("replica_kill",
                                                  "preempt")
                    else "transient")
            specs.append(FaultSpec(point, calls, mode))
        return cls(specs)

    def _hit(self, point: str) -> str | None:
        """Count one call at ``point``; the scheduled mode if this call
        fires, else None."""
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r}")
        with self._lock:
            idx = self._calls.get(point, 0) + 1
            self._calls[point] = idx
            mode = self._sched.get(point, {}).get(idx)
            if mode is not None:
                self.injections.append((point, idx, mode))
        if mode is not None:
            _M_INJECTED.inc(point=point)
            _recorder.record("fault_injected", point=point, call=idx,
                             mode=mode)
        return mode

    def fire(self, point: str) -> None:
        """Count a call at a raise-style point and raise per the
        schedule (a corrupt schedule on a raise point does nothing)."""
        mode = self._hit(point)
        if mode is None or mode == "corrupt":
            return
        msg = f"injected {mode} fault at point {point!r}"
        if mode == "transient":
            raise InjectedTransientError(f"INTERNAL: {msg}")
        if mode == "oserror":
            raise OSError(28, f"{msg} (simulated disk full)")
        raise InjectedFaultError(msg)

    def corrupt(self, point: str) -> bool:
        """Count a call at a corrupt-style point; True when the call
        site should poison its result."""
        return self._hit(point) == "corrupt"

    @property
    def injected_total(self) -> int:
        with self._lock:
            return len(self.injections)

    def calls(self) -> dict[str, int]:
        with self._lock:
            return dict(self._calls)

    def report(self) -> dict:
        """Plain JSON: injected counts by point, calls by point and the
        firing log."""
        with self._lock:
            by_point: dict[str, int] = {}
            for point, _, _ in self.injections:
                by_point[point] = by_point.get(point, 0) + 1
            return {
                "injected_total": len(self.injections),
                "injected_by_point": by_point,
                "calls_by_point": dict(self._calls),
                "log": [{"point": p, "call": c, "mode": m}
                        for p, c, m in self.injections],
            }


#: The active plan, visible across threads; None makes every point a
#: no-op.
_ACTIVE: FaultPlan | None = None
_ACTIVE_LOCK = threading.Lock()


@contextlib.contextmanager
def activate(plan: FaultPlan):
    """Install ``plan`` as the process-wide active plan for the block.
    Scopes do not nest: overlapping plans would make the call counts
    ambiguous."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already active; chaos "
                               "scopes do not nest")
        _ACTIVE = plan
    try:
        yield plan
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = None


def active() -> FaultPlan | None:
    return _ACTIVE


def fire(point: str) -> None:
    """The raise-style hook; with no active plan, one global load."""
    plan = _ACTIVE
    if plan is not None:
        plan.fire(point)


def corrupt(point: str) -> bool:
    """The corrupt-style hook; False with no active plan."""
    plan = _ACTIVE
    return False if plan is None else plan.corrupt(point)
