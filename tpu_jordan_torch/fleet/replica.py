"""One supervised fleet replica.  Counterpart of the JAX package's
``fleet/replica.py``.

A :class:`Replica` wraps its own :class:`~..serve.service.JordanService`:
its own dispatcher thread, bounded queue and per-lane circuit breakers,
while the built lane executors live in the fleet-shared
:class:`~..serve.executors.ExecutorStore`, the engine plans come from the
shared read-only plan cache and the resident handles from the shared
:class:`~..serve.handles.HandleStore`.  Everything stateful about health is
per replica (one sick replica sheds without judging its peers), everything
expensive and immutable is shared (a replacement builds nothing and
measures nothing).

Lifecycle: ``ready`` → (``draining`` →) ``closed`` on a clean shutdown, or
``ready`` → ``dead`` on a kill.  A kill (the crash simulation, and the
supervisor's wedge remedy) stops admission, fails the QUEUED requests with
the typed :class:`ReplicaKilledError` (the router re-queues each within
its retry and deadline budget), lets the batch already dispatched complete
and deliver, and notifies the supervisor.

The kill boundary on the card: the dispatcher thread's in-flight batch
keeps launching after the kill, and a bounded join may abandon it.  Its
futures were claimed at dispatch, so the router never re-dispatches them;
an update it applies commits inside the handle's transaction over the
state it read there (``serve/handles.py``), so a late commit can never
overwrite a newer version.  Every replica launches on its dispatcher
thread's default stream, the one stream the whole process shares.

The ``replica_kill`` fault point fires on the admission path: the k-th
routed request of a seeded ``FaultPlan`` crashes whichever replica it was
routed to, the same way run after run.

Liveness: a heartbeat thread stamps ``last_beat`` every
``heartbeat_interval_s`` when the DISPATCHER proves it is alive
(``MicroBatcher.progress()``: idle, or busy with an advancing tick count).
A dispatcher stuck mid-execute keeps ``busy`` with a frozen count, the
stamp goes stale, and the supervisor's liveness deadline kills and replaces
the replica, joining the stuck dispatcher with a bounded timeout.
``wedge()`` freezes the stamp directly (the tests' wedge fixture).
``warmup`` runs one inert batch of each lane on the dispatcher thread,
which reports itself idle meanwhile: a warming replica is not judged.
"""

from __future__ import annotations

import threading
import time

from ..obs import metrics as _obs_metrics
from ..obs import recorder as _recorder
from ..resilience import faults as _faults
from ..resilience.faults import InjectedFaultError, InjectedTransientError

#: Replica lifecycle states.
READY, DRAINING, DEAD, CLOSED = "ready", "draining", "dead", "closed"

_M_DEATHS = _obs_metrics.counter(
    "tpu_jordan_torch_fleet_replica_deaths_total",
    "unclean replica deaths (killed/injected/wedged), labeled by reason "
    "and slot; each triggers a supervisor replacement attempt")


class ReplicaKilledError(RuntimeError):
    """A replica died (a crash, an injected ``replica_kill`` or the
    supervisor's wedge remedy) while this request was queued at it or being
    routed to it.  The router re-dispatches it within its deadline and
    retry budget; a caller sees it only when the budget is spent or the
    whole fleet is gone."""


class Replica:
    """One worker of the pool: a :class:`JordanService` with lifecycle
    state, a heartbeat and the kill/drain hooks the supervisor and router
    drive.  ``service`` is built by the pool (shared executor store and
    handle store, read-only plan cache, per-replica metric labels)."""

    def __init__(self, slot: int, generation: int, service,
                 heartbeat_interval_s: float = 0.05, clock=None,
                 on_death=None, kill_join_timeout_s: float = 1.0):
        self.slot = int(slot)
        self.generation = int(generation)
        self.name = f"r{slot}g{generation}"
        self.service = service
        self.clock = clock if clock is not None else time.monotonic
        self._on_death = on_death
        self._kill_join_timeout_s = float(kill_join_timeout_s)
        self._lock = threading.Lock()
        self.state = READY
        self.started_at = self.clock()
        self.last_beat = self.clock()
        self._wedged = False
        self._hb_stop = threading.Event()
        self._hb = threading.Thread(
            target=self._beat_loop, args=(float(heartbeat_interval_s),),
            name=f"tpu-jordan-torch-fleet-hb-{self.name}", daemon=True)
        self._hb.start()

    # ---- liveness ----------------------------------------------------

    def _beat_loop(self, interval: float) -> None:
        # The stamp proves DISPATCHER liveness, not this thread's: idle is
        # responsive, busy with an advancing tick count is working, busy
        # with a frozen count is the wedge (no stamp).  The liveness
        # deadline must exceed the longest legitimate batch.
        last_ticks = None
        while not self._hb_stop.wait(interval):
            ticks, busy = self.service._batcher.progress()
            if not self._wedged and (not busy or ticks != last_ticks):
                self.last_beat = self.clock()
            last_ticks = ticks

    def wedge(self) -> None:
        """Freeze the heartbeat (test fixture): the supervisor's staleness
        deadline must catch the replica and replace it."""
        self._wedged = True

    # ---- request path ------------------------------------------------

    def _admit(self, ctx) -> None:
        """The dispatch guard of every request kind: refuse when not
        serving, and fire the seeded ``replica_kill`` point (this call may
        be the one the schedule crashes; the request never entered a queue
        and the router re-dispatches it)."""
        if self.state != READY:
            raise ReplicaKilledError(
                f"replica {self.name} is {self.state}, not serving")
        try:
            _faults.fire("replica_kill")
        except (InjectedFaultError, InjectedTransientError) as e:
            if ctx is not None:
                ctx.event("fault", point="replica_kill",
                          replica=self.name)
            self.kill(reason="injected")
            raise ReplicaKilledError(
                f"replica {self.name} crashed at dispatch "
                f"(injected replica_kill)") from e

    def submit(self, a, deadline_ms: float | None = None, ctx=None):
        """Route one invert request into this replica's service, with the
        fleet's journey context (one journey across replicas)."""
        self._admit(ctx)
        return self.service.submit(a, deadline_ms=deadline_ms, _ctx=ctx)

    def submit_update(self, handle, u, v,
                      deadline_ms: float | None = None, ctx=None):
        """Route one resident-inverse update: the handle's committed state
        lives in the shared store, so a crash here loses nothing (the
        retry re-reads committed state)."""
        self._admit(ctx)
        return self.service.submit_update(handle, u, v,
                                          deadline_ms=deadline_ms,
                                          _ctx=ctx)

    def submit_solve(self, a, b, deadline_ms: float | None = None,
                     ctx=None):
        """Route one solve request X = A⁻¹B onto the service's solve
        lanes (no inverse formed)."""
        self._admit(ctx)
        return self.service.submit(a, b, deadline_ms=deadline_ms,
                                   _ctx=ctx)

    def submit_solve_ckpt(self, a, b, ckpt, resume_from=None, ctx=None):
        """Route one CHECKPOINTED solve onto this replica: the superstep
        sweep runs on a thread of its own outside the micro-batcher, with
        ``abort=`` watching this replica's lifecycle, so a kill mid-sweep
        surfaces :class:`ReplicaKilledError` at the next segment boundary,
        after that boundary's checkpoint is durable; the router re-queues
        and the next replica resumes from the store.  ``ckpt`` is the spec
        dict: ``store``, ``run_id``, ``cadence`` and optionally ``engine``
        and ``block_size`` (``mesh`` is item 15's)."""
        self._admit(ctx)
        from concurrent.futures import Future

        import numpy as np

        from ..resilience.checkpoint import checkpointed_solve
        from ..serve.batcher import InvertResult

        fut = Future()
        fut.set_running_or_notify_cancel()
        device = self.service.device

        def abort():
            if self.state != READY:
                return ReplicaKilledError(
                    f"replica {self.name} is {self.state}: died under "
                    f"a checkpointed solve — resume from the last "
                    f"durable superstep")
            return None

        def run():
            try:
                t0 = time.monotonic()
                x, singular, info = checkpointed_solve(
                    a, b, ckpt.get("block_size"),
                    store=ckpt["store"], run_id=ckpt["run_id"],
                    cadence=int(ckpt["cadence"]),
                    engine=ckpt.get("engine", "unrolled"),
                    mesh=ckpt.get("mesh"), resume_from=resume_from,
                    abort=abort, device=device)
                xh = x.cpu().numpy()
                ah = np.asarray(a, xh.dtype)
                bh = np.asarray(b, xh.dtype)
                if bh.ndim == 1:
                    bh = bh[:, None]
                if xh.ndim == 1:
                    xh = xh[:, None]
                denom = float(np.linalg.norm(bh)) or 1.0
                res = InvertResult(
                    inverse=None, n=int(ah.shape[0]),
                    bucket_n=int(ah.shape[0]),
                    singular=bool(singular), kappa=float("nan"),
                    rel_residual=float(
                        np.linalg.norm(ah @ xh - bh)) / denom,
                    queue_seconds=0.0,
                    execute_seconds=time.monotonic() - t0,
                    batch_occupancy=1, workload="solve", solution=x)
                res.ckpt_info = info
                fut.set_result(res)
            except BaseException as e:  # noqa: BLE001 — the future carries it
                fut.set_exception(e)

        threading.Thread(
            target=run, daemon=True,
            name=f"tpu-jordan-torch-ckpt-{self.name}").start()
        return fut

    def warmup(self, shapes, update_shapes=(), solve_shapes=()) -> dict:
        """Build the lanes of these shapes and run one inert batch of
        each on this replica's dispatcher thread (at its start, when it
        has not started yet), so no request pays the thread's first
        launches: on the card a lane's first batch in a fresh thread has
        run past the 1.0 s default liveness deadline."""
        return self.service.warmup(shapes, update_shapes=update_shapes,
                                   solve_shapes=solve_shapes, run=True)

    def breaker_allows(self, lane) -> bool:
        """The router's shedding hook: False while this replica's breaker
        of the lane is open (an elapsed cooldown admits the half-open
        probe here, as at submit)."""
        br = self.service.executors.breaker(lane)
        return br is None or br.allow()

    # ---- lifecycle ---------------------------------------------------

    def kill(self, reason: str = "killed") -> bool:
        """Crash semantics (idempotent; False when already down): mark
        DEAD, stop the heartbeat, fail every QUEUED request with the typed
        :class:`ReplicaKilledError` (the dispatched batch completes and
        delivers), and notify the supervisor."""
        with self._lock:
            if self.state in (DEAD, CLOSED):
                return False
            self.state = DEAD
        self._hb_stop.set()
        _M_DEATHS.inc(reason=reason, replica=str(self.slot))
        _recorder.record("replica_death", replica=self.name,
                         slot=self.slot, reason=reason)
        name = self.name
        # A bounded join: a kill may be abandoning a stuck dispatcher (the
        # wedge remedy), and an unbounded one would freeze supervision.
        self.service.close(
            drain=False,
            error=lambda: ReplicaKilledError(
                f"replica {name} died ({reason}) before this request "
                f"ran — re-queued by the fleet router"),
            join_timeout_s=self._kill_join_timeout_s)
        if self._on_death is not None:
            self._on_death(self, reason)
        return True

    def close(self, drain: bool = True) -> None:
        """Clean shutdown (idempotent): drain queued and in-flight work
        (``drain=True``), stop the heartbeat, mark CLOSED.  Not a death:
        the supervisor does not replace a closed replica."""
        with self._lock:
            if self.state in (DEAD, CLOSED):
                return
            self.state = DRAINING
        self._hb_stop.set()
        self.service.close(drain=drain)
        with self._lock:
            self.state = CLOSED

    # ---- observability ----------------------------------------------

    @property
    def queued(self) -> int:
        return self.service._batcher.queued

    def snapshot(self) -> dict:
        """The per-replica slice of ``JordanFleet.stats()``."""
        return {
            "name": self.name,
            "slot": self.slot,
            "generation": self.generation,
            "state": self.state,
            "queued": (self.queued if self.state == READY else 0),
            "breakers": {str(b): s for b, s in
                         self.service.executors.breaker_states().items()},
        }
