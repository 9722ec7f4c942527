""":class:`JordanFleet`, the supervised replica pool.  Counterpart of the
JAX package's ``fleet/pool.py``.

One ``JordanService`` is a throughput ceiling and a single point of
failure.  The fleet runs N of them as supervised replicas behind a
bucket-affinity router:

  * **shared**: the built lane executors (one
    :class:`~..serve.executors.ExecutorStore`: one build per key across the
    pool), the read-only plan cache (N readers, zero writes) and the
    resident handles (one :class:`~..serve.handles.HandleStore` with one
    budget, so a kill never loses resident state);
  * **per replica**: the dispatcher thread, the bounded queue, the lane
    breakers and the serving stats (mirrored into the registry with a
    ``replica`` label);
  * **supervision**: heartbeat and liveness deadline, warm rolling
    restarts (a replacement builds and measures nothing), a per-slot
    restart breaker, and the router's re-queue of a dead replica's queued
    requests within the retry and deadline budget.

Typed failures, fleet-wide: ``ServiceOverloadedError`` when every live
replica's queue is full, ``CircuitOpenError`` when every live replica's
breaker of a lane is open, ``DeadlineExceededError``/``ReplicaKilledError``
per request when budgets run out.  ``fleet/demo.py`` and
``tools/check_fleet.py`` hold the chaos contract: under a seeded
``replica_kill`` every response bit-matches the fault-free replay or
carries a typed error.

Beyond the JAX pool: ``device=`` (the card unless "cpu") is passed to every
replica's service, and results are tensors on it; ``dtype`` is the storage
dtype as a torch dtype (``fleet.dtype``).  Every replica launches on its
dispatcher thread's default stream: one stream for the process, so the
shared handles need no cross-stream events and cuBLAS stays bit-for-bit
reproducible across replicas (replica streams are ROADMAP.md Queue B
work).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import torch

from ..errors import SingularMatrixError
from ..interop import resolve_device, resolve_dtype
from ..obs import capacity as _obs_capacity
from ..obs import metrics as _obs_metrics
from ..obs.journey import JourneyLog
from ..resilience.policy import DEFAULT_POLICY, CircuitBreaker
from ..serve.executors import ExecutorStore
from ..serve.handles import HandleStore
from ..serve.service import JordanService
from ..serve.stats import cross_replica_spread as _cross_replica_spread
from ..tuning.plan_cache import PlanCache
from .replica import READY, Replica
from .router import Router
from .supervisor import Supervisor

_M_READY = _obs_metrics.gauge(
    "tpu_jordan_torch_fleet_replicas_ready",
    "replicas currently READY and receiving traffic")
_M_REQUESTS = _obs_metrics.counter(
    "tpu_jordan_torch_fleet_requests_total",
    "requests accepted by the fleet router")


@dataclass
class _Slot:
    """One replica slot: the live replica (swapped by the supervisor), its
    generation counter, install time, stability credit and restart
    breaker.  ``parked``: emptied by ``drain_slot`` (the supervisor skips
    it until ``grow()`` un-parks it)."""

    index: int
    breaker: CircuitBreaker
    replica: Replica | None = None
    generation: int = 0
    installed_at: float = 0.0
    credited: bool = False
    lineage: tuple = field(default=())
    parked: bool = False


class JordanFleet:
    """A pool of supervised :class:`JordanService` replicas behind a
    breaker-aware bucket-affinity router.

    Arguments that configure each replica mirror :class:`JordanService`
    (engine, plan_cache, dtype, device, batch_cap, max_wait_ms, max_queue
    PER REPLICA, block_size, policy, default_deadline_ms, telemetry,
    update_drift_budget_factor).  Fleet-specific:

      replicas: slot count (>= 1).
      plan_cache_read_only: default True, N replicas reading one shared
        plan cache; False only for a deliberately writable setup.
      executor_store: an :class:`ExecutorStore` to share (across demo
        phases); None builds a fresh one.
      handle_store / handle_budget_bytes: the one shared resident-handle
        store, or the budget of a fresh one (not both).
      heartbeat_interval_s / liveness_deadline_s / check_interval_s /
        stable_after_s: the supervision clock.
      restart_failures / restart_cooldown_s: the per-slot restart breaker.
      restart_grace_s: how long a request that finds no live replica waits
        for a warm replacement.
      autostart: False leaves every dispatcher unstarted (tests stage the
        queues, then ``start()``).
      autostart_supervisor: False keeps supervision manual
        (``supervisor.check()`` runs one pass inline).
    """

    def __init__(self, replicas: int = 3, engine: str = "auto",
                 plan_cache=None, plan_cache_read_only: bool = True,
                 dtype=torch.float32, batch_cap: int = 8,
                 max_wait_ms: float = 2.0, max_queue: int = 256,
                 block_size: int | None = None, policy="default",
                 default_deadline_ms: float | None = None,
                 telemetry=None,
                 executor_store: ExecutorStore | None = None,
                 handle_store: HandleStore | None = None,
                 handle_budget_bytes: int | None = None,
                 update_drift_budget_factor: float | None = None,
                 heartbeat_interval_s: float = 0.05,
                 liveness_deadline_s: float = 1.0,
                 check_interval_s: float = 0.05,
                 stable_after_s: float = 2.0,
                 restart_failures: int = 3,
                 restart_cooldown_s: float = 5.0,
                 restart_grace_s: float = 2.0,
                 autostart: bool = True,
                 autostart_supervisor: bool = True, clock=None,
                 device=None):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.slots = int(replicas)
        self.clock = clock if clock is not None else time.monotonic
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.store = (executor_store if executor_store is not None
                      else ExecutorStore())
        from ..serve.handles import build_handle_store

        # ONE handle store for every replica and every warm replacement,
        # with the fleet's one budget: admission is a pool property.
        self.handles = build_handle_store(handle_store,
                                          handle_budget_bytes, "the fleet")
        self._handle_seq = 0
        self.policy = DEFAULT_POLICY if policy == "default" else policy
        if (plan_cache is not None and plan_cache_read_only
                and not isinstance(plan_cache, PlanCache)):
            # Load the shared file ONCE: every replica and replacement
            # shares this frozen instance, so all serve identical plans.
            plan_cache = PlanCache.load(plan_cache, read_only=True)
        self._svc_kw = dict(
            engine=engine, plan_cache=plan_cache,
            plan_cache_read_only=plan_cache_read_only, dtype=self.dtype,
            batch_cap=batch_cap, max_wait_ms=max_wait_ms,
            max_queue=max_queue, block_size=block_size,
            telemetry=telemetry, policy=self.policy,
            default_deadline_ms=default_deadline_ms,
            shared_executors=self.store, shared_handles=self.handles,
            update_drift_budget_factor=update_drift_budget_factor,
            device=self.device)
        self._hb_interval = float(heartbeat_interval_s)
        self.restart_grace_s = float(restart_grace_s)
        # A Condition: routers that find ZERO live replicas wait on it for
        # the supervisor's replacement.
        self._lock = threading.Condition()
        self._warm_shapes: set[int] = set()
        self._warm_updates: set[tuple[int, int]] = set()
        self._warm_solves: set[tuple[int, int]] = set()
        # Close teardown serializes here (the Condition stays free for
        # grace-waiting routers): a second close() blocks until the first
        # has drained every replica.
        self._close_lock = threading.Lock()
        self._close_complete = False
        self._submitted = 0
        self._resolved_ok = 0
        self._resolved_error = 0
        self.closing = False
        self._restart_failures = int(restart_failures)
        self._restart_cooldown_s = float(restart_cooldown_s)
        self._slots = [_Slot(index=i, breaker=self._slot_breaker(i))
                       for i in range(self.slots)]
        # One journey per request at the fleet's front door, threaded
        # through every replica it visits.
        self.journey = JourneyLog(prefix="fleet")
        # Once True, every replica spawned starts its dispatcher, so a
        # replacement entering a running fleet never sits idle.
        self._started = bool(autostart)
        for slot in self._slots:
            self._install(slot, self._spawn_replica(slot.index))
        self.router = Router(
            self, max_reroutes=(self.policy.retry.max_retries
                                if self.policy is not None else 1))
        self.supervisor = Supervisor(
            self, check_interval_s=check_interval_s,
            liveness_deadline_s=liveness_deadline_s,
            stable_after_s=stable_after_s)
        if autostart_supervisor:
            self.supervisor.start()

    # ---- replica lifecycle plumbing ---------------------------------

    def _slot_breaker(self, index: int) -> CircuitBreaker:
        return CircuitBreaker(
            failures=self._restart_failures,
            cooldown_s=self._restart_cooldown_s,
            clock=self.clock, name=f"fleet_slot_{index}")

    def _spawn_replica(self, slot_index: int) -> Replica:
        with self._lock:
            self._slots[slot_index].generation += 1
            gen = self._slots[slot_index].generation
        # A replica entering a started fleet starts its dispatcher at
        # once, so its warmup runs there before it is installed.
        service = JordanService(
            autostart=self._started,
            metric_labels={"replica": str(slot_index)}, **self._svc_kw)
        return Replica(slot_index, gen, service,
                       heartbeat_interval_s=self._hb_interval,
                       clock=self.clock, on_death=self._on_death)

    def _install(self, slot: _Slot, replica: Replica) -> None:
        with self._lock:
            slot.replica = replica
            slot.installed_at = self.clock()
            slot.credited = False
            slot.lineage = slot.lineage + (replica.name,)
            started = self._started
            self._lock.notify_all()     # wake routers awaiting a replica
        if started:
            # Idempotent: a no-op on a running dispatcher.
            replica.service.start()
        self._export_ready_gauge()

    def _on_death(self, replica: Replica, reason: str) -> None:
        """A replica's death (any thread): count it against the slot's
        restart breaker and wake the supervisor."""
        self._slots[replica.slot].breaker.record_failure()
        self._export_ready_gauge()
        self._kick_supervisor()

    def _kick_supervisor(self) -> None:
        self.supervisor.kick()

    def _export_ready_gauge(self) -> None:
        _M_READY.set(float(sum(
            1 for s in self._slots
            if s.replica is not None and s.replica.state == READY)))

    # ---- capacity changes (FleetAutoscaler's calls) ------------------

    def ready_count(self) -> int:
        """Replicas currently READY."""
        return len(self.live_replicas())

    def grow(self) -> int | None:
        """Add one replica: un-park the lowest-index parked slot, or append
        a new one.  The replica warms every lane the fleet has served
        before it enters the slot table.  Returns the slot index, or None
        while the fleet is closing."""
        with self._lock:
            if self.closing:
                return None
            parked = [s for s in self._slots if s.parked]
            if parked:
                slot = parked[0]
                slot.parked = False
            else:
                slot = _Slot(index=len(self._slots),
                             breaker=self._slot_breaker(len(self._slots)))
                self._slots.append(slot)
                self.slots += 1
        replica = self._spawn_replica(slot.index)
        replica.warmup(self.warm_shapes(),
                       update_shapes=self.warm_update_shapes(),
                       solve_shapes=self.warm_solve_shapes())
        self._install(slot, replica)
        return slot.index

    def drain_slot(self) -> int | None:
        """Remove one replica: the highest-index live slot drains its queue
        (nothing dropped), then parks empty.  Refuses (None) to drain the
        last live replica, or while closing."""
        with self._lock:
            live = [s for s in self._slots
                    if not s.parked and s.replica is not None]
            if len(live) <= 1 or self.closing:
                return None
            slot = live[-1]
            slot.parked = True
            replica = slot.replica
        if replica is not None:
            replica.close(drain=True)
            with self._lock:
                slot.replica = None
                self._lock.notify_all()
        self._export_ready_gauge()
        return slot.index

    # ---- router plumbing --------------------------------------------

    def slot_table(self):
        with self._lock:
            return list(self._slots)

    def live_replicas(self):
        with self._lock:
            return [s.replica for s in self._slots
                    if s.replica is not None
                    and s.replica.state == READY]

    def wait_for_live_replica(self, timeout_s: float) -> bool:
        """Block (bounded) until some slot holds a READY replica or the
        fleet is closing: the router's total-loss grace."""
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        with self._lock:
            while not self.closing:
                if any(s.replica is not None
                       and s.replica.state == READY
                       for s in self._slots):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._lock.wait(remaining)
            return False

    def warm_shapes(self):
        with self._lock:
            return sorted(self._warm_shapes)

    def warm_update_shapes(self):
        with self._lock:
            return sorted(self._warm_updates)

    def warm_solve_shapes(self):
        with self._lock:
            return sorted(self._warm_solves)

    def _record_bucket(self, bucket: int) -> None:
        with self._lock:
            self._warm_shapes.add(int(bucket))

    def _account_submitted(self) -> None:
        with self._lock:
            self._submitted += 1
        _M_REQUESTS.inc()

    def _account_resolved(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self._resolved_ok += 1
            else:
                self._resolved_error += 1

    def _deadline(self, deadline_ms):
        return (self._svc_kw["default_deadline_ms"] if deadline_ms is None
                else deadline_ms)

    # ---- request path (the JordanService surface, fleet-wide) -------

    def submit(self, a, deadline_ms: float | None = None):
        """Route one (n, n) matrix; the future resolves to an
        :class:`~..serve.batcher.InvertResult`.  Typed rejections:
        ``ServiceOverloadedError`` (saturated), ``CircuitOpenError``
        (every live replica's breaker open for the bucket)."""
        return self.router.submit(a, self.dtype,
                                  deadline_ms=self._deadline(deadline_ms))

    def invert(self, a, timeout: float | None = None,
               deadline_ms: float | None = None, resident: bool = False,
               handle_id: str | None = None):
        """Synchronous fleet invert; ``SingularMatrixError`` when flagged.
        ``resident=True`` installs the result as a resident handle in the
        FLEET-SHARED store and returns its
        :class:`~..serve.handles.HandleRef`: any replica, and every future
        replacement, serves ``update(ref, u, v)`` against it.  With a
        budget the handle's bytes are admitted BEFORE the invert is routed
        (LRU evictions, each a ``capacity_evict`` hop on this request's
        journey, or the typed ``CapacityExceededError`` at submit)."""
        if not resident:
            res = self.submit(a, deadline_ms=deadline_ms).result(timeout)
            if res.singular:
                raise SingularMatrixError("singular matrix")
            return res
        from ..serve.executors import bucket_for
        from ..serve.handles import (create_resident_handle,
                                     resident_handle_bytes)
        from .router import _host

        a = _host(a, self.dtype)
        n = a.shape[0]
        bucket = bucket_for(n)
        # Minted before admission, so every eviction is attributable to
        # the request that forced it; the router threads it through.
        ctx = self.journey.new(n, bucket)
        try:
            self.handles.ensure_capacity(
                resident_handle_bytes(bucket, self.dtype),
                hop=ctx.event, replacing=handle_id)
        except Exception as e:
            ctx.close("error", error=type(e).__name__)
            raise
        res = self.router.submit(
            a, self.dtype, deadline_ms=self._deadline(deadline_ms),
            _ctx=ctx).result(timeout)
        if res.singular:
            raise SingularMatrixError("singular matrix")
        if handle_id is None:
            with self._lock:
                self._handle_seq += 1
                handle_id = f"fh{self._handle_seq}"
        return create_resident_handle(self.handles, self.dtype, a, res,
                                      handle_id)

    def submit_update(self, handle, u, v,
                      deadline_ms: float | None = None):
        """Route one rank-k resident-inverse update: a READY replica's
        update lane mutates the handle's committed state in the shared
        store, and a mid-flight death re-queues the request (the retry
        re-reads committed state: an update is applied exactly once)."""
        return self.router.submit_update(
            handle, u, v, self.dtype,
            deadline_ms=self._deadline(deadline_ms))

    def update(self, handle, u, v, timeout: float | None = None,
               deadline_ms: float | None = None):
        """``submit_update`` and wait; ``SingularMatrixError`` when the
        mutation destroyed rank (the committed state untouched)."""
        res = self.submit_update(handle, u, v,
                                 deadline_ms=deadline_ms).result(timeout)
        if res.singular:
            raise SingularMatrixError(
                "singular matrix (rank-k update destroyed rank; "
                "resident state unchanged)")
        return res

    def submit_solve(self, a, b, deadline_ms: float | None = None,
                     ckpt=None):
        """Route one solve X = A⁻¹B: the result has ``workload="solve"``
        and ``solution`` the (n, k) X (no inverse formed).  ``ckpt`` (a
        spec dict: ``store``, ``run_id``, ``cadence``, optional ``engine``
        and ``block_size``) routes the checkpointed superstep path, whose
        re-queued hop resumes from the last durable checkpoint."""
        return self.router.submit_solve(
            a, b, self.dtype, deadline_ms=self._deadline(deadline_ms),
            ckpt=ckpt)

    def solve_system(self, a, b, timeout: float | None = None,
                     deadline_ms: float | None = None, ckpt=None):
        """``submit_solve`` and wait; ``SingularMatrixError`` on a
        singular A."""
        res = self.submit_solve(a, b, deadline_ms=deadline_ms,
                                ckpt=ckpt).result(timeout)
        if res.singular:
            raise SingularMatrixError("singular matrix")
        return res

    # ---- lifecycle ---------------------------------------------------

    def warmup(self, shapes, update_shapes=(), solve_shapes=()) -> dict:
        """Warm every replica against the shared store: the first replica
        to reach a lane builds it (once, fleet-wide), the others and every
        replacement find it built; each replica then runs one inert batch
        of every lane on its own dispatcher thread (``Replica.warmup``).
        ``update_shapes``/``solve_shapes``: (n, k) pairs of the update and
        solve lanes.  Returns {lane: engine} of the last replica."""
        from ..serve.executors import (bucket_for, k_bucket_for,
                                       rhs_bucket_for)

        shapes = [int(s) for s in shapes]
        update_shapes = [(int(n), int(k)) for n, k in update_shapes]
        solve_shapes = [(int(n), int(k)) for n, k in solve_shapes]
        with self._lock:
            # Lane coordinates, as _record_bucket stores them.
            self._warm_shapes.update(bucket_for(s) for s in shapes)
            self._warm_updates.update(
                (bucket_for(n), k_bucket_for(k)) for n, k in update_shapes)
            self._warm_solves.update(
                (bucket_for(n), rhs_bucket_for(k))
                for n, k in solve_shapes)
        out = {}
        for replica in self.live_replicas():
            out = replica.warmup(shapes, update_shapes=update_shapes,
                                 solve_shapes=solve_shapes)
        return out

    def start(self) -> None:
        """Start every replica's dispatcher (a no-op with
        ``autostart=True``); later replacements start at install."""
        with self._lock:
            self._started = True
        for replica in self.live_replicas():
            replica.service.start()

    def close(self, drain: bool = True) -> None:
        """Stop supervision, then close every replica (``drain=True``
        completes queued and in-flight work first).  Idempotent and
        thread-safe."""
        with self._lock:
            self.closing = True
            self._lock.notify_all()     # release grace-waiting routers
        with self._close_lock:
            if self._close_complete:
                return
            self.supervisor.stop()
            for slot in self.slot_table():
                if slot.replica is not None:
                    slot.replica.close(drain=drain)
            self._export_ready_gauge()
            self._close_complete = True

    def __enter__(self) -> "JordanFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- observability ----------------------------------------------

    def stats(self) -> dict:
        """The request ledger (submitted == ok + typed errors once drained),
        the journey-derived ledger, per-slot snapshots with lineage and
        restart breakers, each live replica's serving stats, the handles,
        the capacity rollup and the cross-replica execute spread."""
        with self._lock:
            ledger = {"submitted": self._submitted,
                      "resolved_ok": self._resolved_ok,
                      "resolved_error": self._resolved_error,
                      "outstanding": (self._submitted - self._resolved_ok
                                      - self._resolved_error)}
            slots = list(self._slots)
        per_slot = []
        ready = 0
        for s in slots:
            entry = {"slot": s.index,
                     "restart_breaker": s.breaker.state,
                     "lineage": list(s.lineage),
                     "parked": s.parked,
                     "replica": None}
            if s.replica is not None:
                entry["replica"] = s.replica.snapshot()
                if s.replica.state == READY:
                    ready += 1
                    entry["service"] = s.replica.service.stats()
            per_slot.append(entry)
        return {
            "replicas": self.slots,
            "ready": ready,
            "ledger": ledger,
            "journey_ledger": self.journey.ledger(),
            "warm_shapes": self.warm_shapes(),
            "warm_update_shapes": [list(p) for p
                                   in self.warm_update_shapes()],
            "warm_solve_shapes": [list(p) for p
                                  in self.warm_solve_shapes()],
            "executors_compiled": len(self.store),
            "handles": self.handles.snapshot(),
            "handle_budget": self.handles.budget_snapshot(),
            "capacity": _obs_capacity.snapshot(),
            "exec_spread": _cross_replica_spread(
                [e["service"] for e in per_slot if e.get("service")]),
            "slots": per_slot,
        }
