"""The replica supervisor.  Counterpart of the JAX package's
``fleet/supervisor.py``.

One background thread keeps the pool at strength:

  * **Death detection**: a replica that crashed (the seeded
    ``replica_kill``, or any path calling ``kill()``) kicks the supervisor
    at once through the pool's death callback.
  * **Wedge detection**: a READY replica whose heartbeat stamp is older
    than ``liveness_deadline_s`` is declared wedged, killed (its queued
    work fails typed and the router re-queues it) and replaced.
  * **Warm rolling restart**: the replacement is built against the
    fleet-shared executor store, handle store and read-only plan cache,
    and warms every lane the fleet has served BEFORE it enters the slot
    table, so the router never routes to a cold worker and a replacement
    builds nothing and measures nothing.
  * **Restart breaker**: each slot carries a
    :class:`~..resilience.policy.CircuitBreaker`; a slot whose replicas
    keep dying before ``stable_after_s`` of uptime stops being restarted
    (the fleet runs degraded instead of crash-looping) until the cooldown
    admits a half-open restart.  A replacement that survives
    ``stable_after_s`` records the success that closes it.
"""

from __future__ import annotations

import threading

from ..obs import capacity as _capacity
from ..obs import metrics as _obs_metrics
from ..obs import recorder as _recorder
from .replica import DEAD, READY

_M_RESTARTS = _obs_metrics.counter(
    "tpu_jordan_torch_fleet_restarts_total",
    "warm rolling restarts performed by the supervisor (a replacement "
    "entered the slot), labeled by slot")
_M_RESTART_FAILURES = _obs_metrics.counter(
    "tpu_jordan_torch_fleet_restart_failures_total",
    "replacement replicas that failed to build or warm up (counted "
    "against the slot's restart breaker)")


class Supervisor:
    """The pool's health-check and restart loop.  ``check()`` is the whole
    policy and may be called inline (tests drive it with
    ``autostart_supervisor=False``); the thread runs it every
    ``check_interval_s``, or at once when kicked."""

    def __init__(self, pool, check_interval_s: float = 0.05,
                 liveness_deadline_s: float = 1.0,
                 stable_after_s: float = 2.0):
        self.pool = pool
        self.check_interval_s = float(check_interval_s)
        self.liveness_deadline_s = float(liveness_deadline_s)
        self.stable_after_s = float(stable_after_s)
        self._kick = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None
        # Serializes start/stop: racing closers each return only after the
        # loop thread is joined.
        self._lifecycle = threading.Lock()
        # The thread inside check(): the router must never grace-wait for
        # a replacement on the one thread that could install it.
        self._supervising: threading.Thread | None = None
        # Slots whose withheld restart was already recorded this episode
        # (the loop revisits an open breaker every pass).
        self._withheld_recorded: set[int] = set()

    # ---- lifecycle ---------------------------------------------------

    def start(self) -> None:
        with self._lifecycle:
            if self._thread is None and not self._stop:
                self._thread = threading.Thread(
                    target=self._loop,
                    name="tpu-jordan-torch-fleet-supervisor", daemon=True)
                self._thread.start()

    def kick(self) -> None:
        """Wake the loop now (a death just happened)."""
        self._kick.set()

    def stop(self) -> None:
        self._stop = True
        self._kick.set()
        with self._lifecycle:
            if self._thread is not None:
                self._thread.join()
                self._thread = None

    def _loop(self) -> None:
        while True:
            self._kick.wait(self.check_interval_s)
            self._kick.clear()
            if self._stop:
                return
            self.check()

    # ---- the health-check policy ------------------------------------

    def is_supervising_thread(self) -> bool:
        """True when the calling thread is inside ``check()``."""
        return threading.current_thread() is self._supervising

    def check(self) -> None:
        """One pass over every slot: wedge detection, refill (breaker
        permitting), stability credit."""
        if self.pool.closing:
            return
        self._supervising = threading.current_thread()
        try:
            self._check()
        finally:
            self._supervising = None

    def _check(self) -> None:
        pool = self.pool
        now = pool.clock()
        for slot in pool.slot_table():
            if slot.parked:
                # Drained capacity (``JordanFleet.drain_slot``) is a
                # designed reduction, not a death.
                continue
            replica = slot.replica
            if replica is not None and replica.state == READY:
                if now - replica.last_beat > self.liveness_deadline_s:
                    _recorder.record(
                        "heartbeat_stale", replica=replica.name,
                        slot=slot.index,
                        stale_s=round(now - replica.last_beat, 6),
                        deadline_s=self.liveness_deadline_s)
                    self._replace_wedged(slot, replica)
                elif (not slot.credited
                      and now - slot.installed_at >= self.stable_after_s):
                    slot.breaker.record_success()
                    slot.credited = True
            replica = slot.replica
            if replica is None or replica.state == DEAD:
                self._try_restart(slot)
        pool._export_ready_gauge()

    def _withhold(self, slot) -> None:
        """Record a restart the open breaker withheld, once an episode."""
        if slot.index not in self._withheld_recorded:
            self._withheld_recorded.add(slot.index)
            _recorder.record("restart_withheld", slot=slot.index,
                             breaker=slot.breaker.state)

    def _spawn_warm(self, slot):
        """A replacement replica warmed on every lane the fleet has served,
        or None (the failure counted against the slot's breaker)."""
        pool = self.pool
        replica = None
        try:
            replica = pool._spawn_replica(slot.index)
            replica.warmup(pool.warm_shapes(),
                           update_shapes=pool.warm_update_shapes(),
                           solve_shapes=pool.warm_solve_shapes())
        except Exception as e:          # noqa: BLE001 — counted, retried
            _M_RESTART_FAILURES.inc(replica=str(slot.index))
            _recorder.record("restart_failure", slot=slot.index,
                             error=type(e).__name__)
            slot.breaker.record_failure()
            if replica is not None:
                replica.close(drain=False)   # reap the half-built worker
            return None
        return replica

    def _install(self, slot, replica, cause: str) -> None:
        self.pool._install(slot, replica)
        _M_RESTARTS.inc(replica=str(slot.index))
        self._withheld_recorded.discard(slot.index)
        # On the shared store a warm restart adds no lane bytes; this
        # field is how a post-mortem sees it.
        _recorder.record("restart", slot=slot.index, replica=replica.name,
                         cause=cause,
                         executor_lane_bytes=_capacity.live_bytes(
                             "executor_lanes"))

    def _replace_wedged(self, slot, victim) -> None:
        """Kill a wedged replica, staging its warm replacement FIRST
        (breaker permitting): ``kill()`` fails the victim's queued futures
        on THIS thread and their callbacks re-dispatch through the router,
        so the replacement must already be in the slot table.  With the
        breaker open, kill anyway: running degraded is the crash-loop
        answer."""
        replacement = None
        if slot.breaker.allow():
            replacement = self._spawn_warm(slot)
        else:
            self._withhold(slot)
        if replacement is not None:
            self._install(slot, replacement, "wedged")
        victim.kill(reason="wedged")

    def _try_restart(self, slot) -> None:
        """Refill one slot with a warm replacement, breaker permitting."""
        if not slot.breaker.allow():
            # Crash loop: stay degraded, recorded once an episode so the
            # black box shows the unfilled slot is designed degradation.
            self._withhold(slot)
            return
        replica = self._spawn_warm(slot)
        if replica is not None:
            self._install(slot, replica, "death")
