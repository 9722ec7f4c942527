"""The dynamic micro-batcher.  Counterpart of the JAX package's
``serve/batcher.py``, with its invert, solve, update and mesh lanes.

A thread-safe request queue grouped by lane plus ONE dispatcher thread.  A
lane dispatches when it can fill a batch (``batch_cap`` requests), when its
oldest request has waited ``max_wait_ms``, or when the service drains for
shutdown.  A partial batch is filled with identity elements (a solve lane's
with zero right-hand sides): inert, never singular, and the lane's shapes
stay fixed.  The stack is built on the host and crosses to the device in
one copy; each rider's result is sliced from the batch's on the device.

Each batch runs through its lane's executor (``executors.py``), and the
per-element results (inverse or solution unpadded to the request's n, κ∞,
rel_residual, the singular flag, queue and execute seconds) resolve the
per-request futures.  A singular element resolves ITS future with
``singular=True``; its batch-mates are untouched.

Admission is the caller's thread: a full queue raises
:class:`ServiceOverloadedError` at ``submit`` (typed backpressure, never a
silent drop).  Anything the dispatcher's execution raises is fanned to
every rider of the batch as that typed error and counted; it is never
swallowed, and nothing falls back to the CPU or to a plain probe.

With a ``resilience.ResiliencePolicy`` attached:

  * **retry and the integrity gate**: the batch's run is wrapped in
    ``policy.retry`` (component ``serve.execute``); a non-finite
    rel_residual on a real, non-singular element (the
    ``result_corrupt_nan`` point) raises
    :class:`~..resilience.policy.ResultCorruptionError`, which the retry
    absorbs by re-running on the same stacks;
  * **deadlines**: ``submit(..., deadline_s=)`` covers queue wait and
    execute; a request past it fails with
    :class:`~..resilience.policy.DeadlineExceededError` at dispatch or at
    the fan-out;
  * **circuit breaker** per lane (held by the executor cache): K
    consecutive terminal batch failures open it, and ``submit`` fast-fails
    with :class:`~..resilience.policy.CircuitOpenError` until a half-open
    probe succeeds after the cooldown.

An update lane (``workload="update"``) mutates resident handles
(``handles.py``): riders on distinct handles share one launch of the lane's
batch-cap executor, while a second rider on the same handle, and every rider
of a cap-1 lane, runs in order as a group of one through the cap-1
executor.  Each rider's deadline is judged before its commit, its numerics
before the gate; the outcome is ``refreshed``, ``re_inverted`` (the gate or
the drift budget fired and the warm cap-1 invert lane re-inverted the
mutated matrix) or ``gated`` (the mutation destroyed rank), and the handle
changes only inside its transaction, so a typed failure leaves it
untouched.

A mesh lane (``_execute_mesh``) dispatches at occupancy 1: one request is
one job on the lane's persistent world of ranks (``meshlanes.py``), with
the same journeys, breaker, deadlines, retry and integrity gate, and the
comm and work reports of the execute on its span.

The dispatcher launches on its thread's current CUDA stream (the default
stream of a fresh thread), the stream the engines use everywhere.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from ..obs import hwcost as _hwcost
from ..obs import metrics as _obs_metrics
from ..obs.spans import NULL, timed_blocking
from ..resilience import faults as _faults
from ..resilience.policy import (CircuitOpenError, DeadlineExceededError,
                                 ResultCorruptionError)


class ServiceOverloadedError(RuntimeError):
    """The bounded request queue is full: backpressure, not a drop.  The
    service never discards an accepted request."""


class ServiceClosedError(RuntimeError):
    """submit() after close(): the service no longer accepts work."""


class MixedUpdateBatchError(TypeError):
    """A rider of an update-lane batch does not match the lane's (bucket,
    k bucket, dtype): refused typed, never padded or cast to the lane's
    shape.  Only direct batcher misuse makes one
    (``JordanService.submit_update`` pads every rider to its own lane)."""


@dataclass
class InvertResult:
    """What a request's future resolves to: the unpadded result (a tensor
    on the service's device) and the per-element diagnostics of its batch.
    A solve request (``submit(a, b)``) has ``workload="solve"``,
    ``solution`` the (n, k) X and ``inverse=None``; its ``rel_residual``
    is the κ-free backward error and ``kappa`` the ‖A‖‖X‖/‖B‖ estimate."""

    inverse: object           # (n, n) tensor, padding sliced off
    n: int
    bucket_n: int
    singular: bool
    kappa: float
    rel_residual: float
    queue_seconds: float      # submit -> dispatch
    execute_seconds: float    # the batch execution this request rode
    batch_occupancy: int      # real requests in that batch
    workload: str = "invert"  # "invert" | "solve" | "update"
    solution: object = None   # (n, k) X for solve requests
    # ---- update-lane fields (None off the update lane)
    update_outcome: str = None    # "refreshed" | "re_inverted" | "gated"
    handle: object = None         # the HandleRef the update mutated
    handle_version: int = None    # committed version after this update
    drift: float = None           # accumulated drift after this update


@dataclass
class _Request:
    padded: object            # (bucket_n, bucket_n) identity-padded input
    n: int
    bucket_n: int
    t_enqueue: float
    future: Future
    t_deadline: float | None = None   # absolute perf_counter deadline
    ctx: object = None        # obs.journey.RequestContext
    workload: str = "invert"
    padded_b: object = None   # (bucket_n, rhs) zero-padded RHS
    rhs: int = 0              # RHS-width (update: rank) bucket of the lane
    k: int = 0                # this request's real RHS width or rank
    handle: object = None     # update lane: the HandleRef to mutate
    padded_u: object = None   # (bucket_n, k bucket) zero-padded, host
    padded_v: object = None   # (bucket_n, k bucket) zero-padded, host
    mesh: str = "single"      # topology of the lane

    def hop(self, event: str, **attrs) -> None:
        """One journey event for this rider (none without a context)."""
        if self.ctx is not None:
            self.ctx.event(event, **attrs)


def _lane(workload: str, bucket_n: int, rhs: int = 0,
          mesh: str = "single"):
    """The queue key of a request class: the bare bucket of an invert
    lane, ``"solve:<bucket>:k<rhs>"`` of a solve lane (the executor
    cache's label, which is also its breaker and stats key); a mesh lane
    is the 4-tuple ``(workload, bucket, rhs, mesh)``."""
    if mesh != "single":
        return (workload, bucket_n, int(rhs), mesh)
    return (bucket_n if workload == "invert"
            else f"{workload}:{bucket_n}:k{int(rhs)}")


def _lane_label(lane):
    """The breaker/stats label of a lane: the lane itself, or for a mesh
    lane its single-device label with an ``@mesh`` suffix (the executor
    cache's label)."""
    if not isinstance(lane, tuple):
        return lane
    wl, b, rhs, mesh = lane
    base = b if wl == "invert" else f"{wl}:{b}:k{rhs}"
    return f"{base}@{mesh}"


def _lane_mesh(lane) -> str:
    return lane[3] if isinstance(lane, tuple) else "single"


class MicroBatcher:
    """The queue and its dispatcher.  ``autostart=False`` leaves the
    dispatcher unstarted (tests fill the queue deterministically, then
    ``start()``); ``close()`` on a never-started batcher drains inline on
    the calling thread."""

    def __init__(self, executors, stats, batch_cap: int = 8,
                 max_wait_ms: float = 2.0, max_queue: int = 256,
                 block_size: int | None = None, autostart: bool = True,
                 telemetry=None, policy=None, numerics: str = "off",
                 handles=None, update_drift_budget_factor=None):
        if batch_cap < 1:
            raise ValueError("batch_cap must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.executors = executors
        self.stats = stats
        # The handle store the update lanes read and write through; the
        # drift factor scales the accumulated-drift budget (None:
        # linalg.update.DRIFT_BUDGET_FACTOR).
        self.handles = handles
        self._drift_factor = update_drift_budget_factor
        # "off" adds nothing to the dispatch path; "summary" observes each
        # real rider's rel_residual/κ∞ (numbers the batch already
        # returned) into the numerics histograms.
        self.numerics = numerics
        self.policy = policy
        # Each batch is an "execute" span on the dispatcher thread.
        self._tel = telemetry if telemetry is not None else NULL
        self.batch_cap = int(batch_cap)
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self.block_size = block_size
        self._cv = threading.Condition()
        # Serializes close() itself: concurrent closers block until the
        # first finished, then no-op.
        self._close_lock = threading.Lock()
        self._queues: dict = {}
        self._queued = 0
        self._closing = False
        self._thread: threading.Thread | None = None
        # Liveness: ``_ticks`` advances each time the dispatcher returns to
        # its pick/wait cycle, ``_busy`` is True while it executes a batch.
        self._ticks = 0
        self._busy = False
        # (fn, future) pairs the dispatcher runs between batches
        # (``run_on_dispatcher``).
        self._calls: deque = deque()
        if autostart:
            self.start()

    # ---- caller side -------------------------------------------------

    def submit(self, padded, n: int, bucket_n: int,
               deadline_s: float | None = None, ctx=None,
               workload: str = "invert", padded_b=None, rhs: int = 0,
               k: int = 0, handle=None, padded_u=None,
               padded_v=None, mesh: str = "single") -> Future:
        lane = _lane(workload, bucket_n, rhs, mesh)
        label = _lane_label(lane)
        br = (self.executors.breaker(label)
              if self.policy is not None else None)
        if br is not None and not br.allow():
            # Typed fast-fail instead of queueing doomed work.
            self.stats.rejected(label, workload=workload)
            if ctx is not None:
                ctx.event("breaker_fast_fail", bucket=bucket_n)
            raise CircuitOpenError(
                f"bucket {label} circuit open after repeated executor "
                f"failures — retry after the cooldown")
        now = time.perf_counter()
        req = _Request(padded, n, bucket_n, now, Future(),
                       t_deadline=(None if deadline_s is None
                                   else now + float(deadline_s)),
                       ctx=ctx, workload=workload, padded_b=padded_b,
                       rhs=int(rhs), k=int(k), handle=handle,
                       padded_u=padded_u, padded_v=padded_v, mesh=str(mesh))
        with self._cv:
            if self._closing:
                req.hop("reject", reason="closed")
                raise ServiceClosedError("service is closed")
            if self._queued >= self.max_queue:
                self.stats.rejected(label, workload=workload)
                req.hop("reject", reason="overload", queued=self._queued)
                raise ServiceOverloadedError(
                    f"request queue full ({self.max_queue} pending) — "
                    f"retry later (typed backpressure, nothing dropped)")
            # The enqueue hop is recorded under _cv, before the append, so
            # the dispatcher's "dispatch" hop cannot race ahead of it.
            req.hop("enqueue", bucket=bucket_n, queued=self._queued + 1)
            self._queues.setdefault(lane, deque()).append(req)
            self._queued += 1
            self.stats.request(label, workload=workload)
            self._cv.notify()
        return req.future

    def start(self) -> None:
        with self._cv:
            if self._closing or self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, name="tpu-jordan-torch-serve",
                daemon=True)
            self._thread.start()

    def close(self, drain: bool = True, error=None,
              join_timeout_s: float | None = None) -> None:
        """Stop accepting work.  ``drain=True`` completes every queued
        request before returning; ``drain=False`` fails the queued futures
        with :class:`ServiceClosedError`, or with what the zero-arg
        ``error`` factory builds.  Idempotent and thread-safe.  Queued
        futures are failed outside the queue lock, since their callbacks
        may submit elsewhere.  ``join_timeout_s`` bounds the dispatcher's
        join: a wedged dispatcher is then abandoned (counted) and exits if
        it ever returns."""
        with self._close_lock:
            doomed = []
            with self._cv:
                self._closing = True
                if not drain:
                    for q in self._queues.values():
                        while q:
                            doomed.append(q.popleft())
                    self._queued = 0
                self._cv.notify_all()
            make_error = error if error is not None else (
                lambda: ServiceClosedError(
                    "service closed before this request ran"))
            for req in doomed:
                # Claim, then fail: a future the caller cancelled is left.
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(make_error())
            if self._thread is not None:
                self._thread.join(join_timeout_s)
                if self._thread.is_alive():
                    _obs_metrics.counter(
                        "tpu_jordan_torch_serve_dispatcher_abandoned_total",
                        "dispatcher threads still alive past a bounded "
                        "close join (wedged mid-execute), abandoned as "
                        "daemons",
                    ).inc()
                else:
                    self._thread = None
            else:
                # Never started: drop the warm calls of a dispatcher that
                # never ran, and drain the queue inline on this thread.
                with self._cv:
                    self._calls.clear()
                if self._queued:
                    self._loop()

    def reap(self, join_timeout_s: float | None = 0.0) -> bool:
        """Retry the join of a dispatcher a bounded ``close`` abandoned.
        True when none remains (reaped now, or never abandoned), False
        while it is still alive; a live service has nothing to reap."""
        with self._close_lock:
            t = self._thread
            if t is None:
                return True
            if not self._closing:
                return False
            t.join(join_timeout_s)
            if t.is_alive():
                return False
            self._thread = None
        _obs_metrics.counter(
            "tpu_jordan_torch_serve_dispatcher_reaped_total",
            "abandoned dispatcher threads joined by a later reap()",
        ).inc()
        return True

    def run_on_dispatcher(self, fn) -> None:
        """Run ``fn()`` on the dispatcher thread before its next batch:
        the fleet's warmup pays the thread's first launches this way.  A
        running dispatcher runs it now and the caller waits (its exception
        raised here); one not started yet runs it first thing at
        ``start()``, and the caller does not wait.  Not a batch: the
        dispatcher reports itself idle (``progress()``) while it runs."""
        fut = Future()
        with self._cv:
            if self._closing:
                raise ServiceClosedError("service is closed")
            self._calls.append((fn, fut))
            self._cv.notify()
            running = self._thread is not None
        if running:
            fut.result()

    @property
    def queued(self) -> int:
        with self._cv:
            return self._queued

    def progress(self) -> tuple[int, bool]:
        """``(ticks, busy)``: the dispatcher's liveness signal; busy with a
        frozen tick count is a dispatcher stuck mid-execute."""
        with self._cv:
            return self._ticks, self._busy

    # ---- dispatcher side ---------------------------------------------

    def _pick(self, now: float):
        """The ``(lane, cause)`` to dispatch: a full batch (``"full"``),
        else the lane whose head aged past the wait (``"deadline"``, oldest
        head first), else while draining any nonempty lane (``"drain"``).
        """
        best = None
        for lane, q in self._queues.items():
            if not q:
                continue
            age = now - q[0].t_enqueue
            if len(q) >= self._lane_cap(lane):
                cause = "full"
            elif age >= self.max_wait:
                cause = "deadline"
            elif self._closing:
                cause = "drain"
            else:
                continue
            if best is None or age > best[1]:
                best = (lane, age, cause)
        return None if best is None else (best[0], best[2])

    def _lane_cap(self, lane) -> int:
        """A lane's dispatch capacity: ``batch_cap``, except on a mesh
        lane (occupancy 1: one world owns its ranks a launch)."""
        return 1 if _lane_mesh(lane) != "single" else self.batch_cap

    def _next_deadline(self, now: float) -> float | None:
        waits = [self.max_wait - (now - q[0].t_enqueue)
                 for q in self._queues.values() if q]
        return max(0.0, min(waits)) if waits else None

    def _loop(self) -> None:
        while True:
            call = None
            with self._cv:
                self._busy = False
                self._ticks += 1
                while True:
                    if self._calls:
                        call = self._calls.popleft()
                        break
                    now = time.perf_counter()
                    picked = self._pick(now)
                    if picked is not None:
                        lane, cause = picked
                        q = self._queues[lane]
                        take = min(len(q), self._lane_cap(lane))
                        batch = [q.popleft() for _ in range(take)]
                        self._queued -= take
                        # Claim each future: a cancelled one drops out here,
                        # and none can change state under the execution.
                        batch = [r for r in batch
                                 if r.future.set_running_or_notify_cancel()]
                        # Deadline, phase 1: a request past its deadline
                        # does not ride the batch.
                        batch = self._fail_expired(batch, "queue")
                        if not batch:
                            continue
                        self._busy = True
                        break
                    if self._closing and self._queued == 0:
                        return
                    self._cv.wait(self._next_deadline(now))
            if call is not None:
                fn, fut = call
                try:
                    fut.set_result(fn())
                except BaseException as e:          # noqa: BLE001
                    fut.set_exception(e)
                continue
            for req in batch:
                req.hop("dispatch", cause=cause, occupancy=len(batch))
            self._execute(lane, batch, now)

    def _fail_expired(self, batch: list, phase: str) -> list:
        """Fail the requests past their deadline with the typed error
        (counted by phase) and return the rest."""
        now = time.perf_counter()
        live = []
        for req in batch:
            if req.t_deadline is not None and now > req.t_deadline:
                _obs_metrics.counter(
                    "tpu_jordan_torch_deadline_exceeded_total").inc(
                        phase=phase,
                        exemplar=(req.ctx.request_id
                                  if req.ctx is not None else None))
                req.hop("deadline", phase=phase)
                if not req.future.done():
                    req.future.set_exception(DeadlineExceededError(
                        f"deadline exceeded in {phase} "
                        f"(n={req.n}, bucket={req.bucket_n})"))
            else:
                live.append(req)
        return live

    def _observe_numerics(self, batch, ex, sing, kappa, rel) -> None:
        """``numerics="summary"``: each real, non-singular rider's
        rel_residual/κ∞ into the numerics histograms, with spikes into the
        flight recorder; a solve rider spikes on the solve gate (its
        κ-free backward error) at its real n."""
        from ..obs import numerics as _numerics
        from ..resilience.degrade import solve_gate_threshold
        from ..resilience.policy import DEFAULT_POLICY

        wl = ex.key.workload
        pol = self.policy if self.policy is not None else DEFAULT_POLICY
        for i, req in enumerate(batch):
            if bool(sing[i]):
                continue
            thresholds = None
            if wl != "invert":
                thresholds = _numerics.SpikeThresholds(
                    residual=solve_gate_threshold(pol, req.n,
                                                  ex.key.dtype))
            rep = _numerics.summary_report(
                n=req.n, block_size=ex.block_size,
                engine=ex.key.engine, rel_residual=float(rel[i]),
                kappa=float(kappa[i]), norm_a=0.0, dtype=ex.key.dtype,
                workload=wl)
            _numerics.observe(rep)
            _numerics.record_spikes(rep, thresholds)

    def _stacks(self, ex, batch: list):
        """The lane's fixed-shape arguments, built on the host (identity
        fillers, zero RHS fillers) and moved to the device in one copy
        each."""
        from ..interop import resolve_dtype

        dtype = resolve_dtype(ex.key.dtype)
        cap, bucket = self.batch_cap, ex.key.bucket_n
        stacked = torch.eye(bucket, dtype=dtype).repeat(cap, 1, 1)
        n_real = torch.zeros((cap,), dtype=torch.int64)
        for i, req in enumerate(batch):
            stacked[i] = torch.as_tensor(req.padded)
            n_real[i] = req.n
        dev = ex.device
        if ex.key.workload == "invert":
            return stacked.to(dev), n_real.to(dev)
        stacked_b = torch.zeros((cap, bucket, ex.key.rhs), dtype=dtype)
        for i, req in enumerate(batch):
            stacked_b[i] = torch.as_tensor(req.padded_b)
        return stacked.to(dev), stacked_b.to(dev), n_real.to(dev)

    def _count_failure(self, lane, br) -> None:
        """One terminal batch failure: counted, and fed to the breaker."""
        _obs_metrics.counter(
            "tpu_jordan_torch_serve_batch_failures_total",
            "dispatched batches that terminally failed (after any "
            "retries) and fanned a typed error to their riders",
        ).inc(bucket=lane)
        if br is not None:
            br.record_failure()

    def _execute(self, lane, batch: list, t_dispatch: float) -> None:
        bucket = batch[0].bucket_n
        workload = batch[0].workload
        rhs = batch[0].rhs
        if workload == "update":
            return self._execute_updates(lane, batch, t_dispatch)
        if _lane_mesh(lane) != "single":
            return self._execute_mesh(lane, batch, t_dispatch)
        br = (self.executors.breaker(lane)
              if self.policy is not None else None)
        try:
            _faults.fire("dispatch")
            ex, source = self.executors.get_info(bucket, self.batch_cap,
                                                 self.block_size,
                                                 workload=workload, rhs=rhs)
            for req in batch:
                # Build or cache hit is a per-request journey fact.
                req.hop("executor", bucket=bucket, source=source,
                        engine=ex.key.engine)
            args = self._stacks(ex, batch)

            def run_once():
                _faults.fire("execute")
                out, esp = timed_blocking(
                    ex.run, *args, telemetry=self._tel, name="execute",
                    device=ex.device, bucket=bucket, occupancy=len(batch),
                    workload=workload)
                _hwcost.attach_execute_cost(
                    esp,
                    analytical_flops=_hwcost.baseline_workload_flops(
                        bucket, workload, k=rhs) * self.batch_cap)
                res, sing, kappa, rel = out
                sing = sing.cpu().numpy()
                kappa = kappa.cpu().numpy()
                rel = rel.cpu().numpy().copy()
                # A corrupted result would carry a corrupted rel_residual
                # (computed from it in the same run), so poisoning one is
                # the signature the gate must catch.  The target is the
                # first non-singular real element; an all-singular batch
                # consumes no injection.
                tgt = next((i for i in range(len(batch))
                            if not sing[i]), None)
                if (tgt is not None
                        and _faults.corrupt("result_corrupt_nan")):
                    rel[tgt] = np.nan
                # Integrity gate: every real, non-singular element reports
                # a finite rel_residual.
                bad = [i for i in range(len(batch))
                       if not sing[i] and not math.isfinite(rel[i])]
                if bad:
                    raise ResultCorruptionError(
                        f"non-finite rel_residual for batch elements "
                        f"{bad} (bucket {bucket}) — corrupted result "
                        f"detected by the integrity gate")
                return res, sing, kappa, rel, esp.duration

            def on_retry(exc, attempt):
                for req in batch:
                    req.hop("retry", attempt=attempt,
                            error=type(exc).__name__)

            res, sing, kappa, rel, exec_s = (
                self.policy.retry.call(
                    run_once, on_retry=on_retry,
                    component="serve.execute",
                    exemplar=(batch[0].ctx.request_id
                              if batch[0].ctx is not None else None))
                if self.policy is not None else run_once())
        except BaseException as e:                  # noqa: BLE001
            # Fan the failure to every rider: N explicit failures, never a
            # hang or a drop; one terminal failure counted per batch.
            self._count_failure(lane, br)
            for req in batch:
                req.hop("batch_failure", error=type(e).__name__)
                if not req.future.done():
                    req.future.set_exception(e)
            return
        if br is not None:
            br.record_success()

        queue_waits = [t_dispatch - req.t_enqueue for req in batch]
        self.stats.batch(lane, occupancy=len(batch), exec_seconds=exec_s,
                         queue_seconds=queue_waits,
                         singular=int(sing[:len(batch)].sum()),
                         workload=workload)
        if self.numerics == "summary":
            self._observe_numerics(batch, ex, sing, kappa, rel)
        # Deadline, phase 2: a batch that finished past a rider's
        # deadline fails that rider; its batch-mates are unaffected.
        live = {id(r) for r in self._fail_expired(batch, "execute")}
        for i, req in enumerate(batch):
            if id(req) not in live:
                continue
            req.hop("served", singular=bool(sing[i]),
                    seconds=round(exec_s, 6))
            out = (res[i, :req.n, :req.n] if workload == "invert"
                   else res[i, :req.n, :req.k]).clone()
            req.future.set_result(InvertResult(
                inverse=out if workload == "invert" else None,
                n=req.n,
                bucket_n=bucket,
                singular=bool(sing[i]),
                kappa=float(kappa[i]),
                rel_residual=float(rel[i]),
                queue_seconds=queue_waits[i],
                execute_seconds=exec_s,
                batch_occupancy=len(batch),
                workload=workload,
                solution=out if workload != "invert" else None,
            ))

    def _execute_mesh(self, lane, batch: list, t_dispatch: float) -> None:
        """Dispatch one mesh-lane request (occupancy 1): the lane's world
        runs scatter, engine and gather (``MeshLaneExecutor.run``), under
        the serve discipline: journeys, breaker, deadlines, retry and the
        integrity gate, the numerics summary, and the comm and work
        reports of the execute on its span."""
        workload, bucket, rhs, mesh = lane
        label = _lane_label(lane)
        br = (self.executors.breaker(label)
              if self.policy is not None else None)
        req = batch[0]
        try:
            _faults.fire("dispatch")
            ex, source = self.executors.get_info(
                bucket, 1, self.block_size, workload=workload, rhs=rhs,
                mesh=mesh)
            req.hop("executor", bucket=bucket, source=source,
                    engine=ex.key.engine, mesh=mesh)
            b = req.padded_b if workload != "invert" else None

            def run_once():
                _faults.fire("execute")
                out, esp = timed_blocking(
                    ex.run, req.padded, b, telemetry=self._tel,
                    name="execute", bucket=bucket, occupancy=1,
                    workload=workload, mesh=mesh)
                res, sing, outcomes = out
                _hwcost.attach_execute_cost(
                    esp,
                    analytical_flops=_hwcost.baseline_workload_flops(
                        bucket, workload, k=rhs))
                ex.comm_report(outcomes, esp.duration, span=esp)
                kappa = rel = 0.0
                if not sing:
                    kappa, rel = ex.metrics(req.padded, res, b)
                    if _faults.corrupt("result_corrupt_nan"):
                        rel = float("nan")
                    # The integrity gate, host-verified here.
                    if not math.isfinite(rel):
                        raise ResultCorruptionError(
                            f"non-finite rel_residual on mesh lane "
                            f"{label} — corrupted result detected by "
                            f"the integrity gate")
                return res, sing, kappa, rel, esp.duration

            def on_retry(exc, attempt):
                req.hop("retry", attempt=attempt, error=type(exc).__name__)

            res, sing, kappa, rel, exec_s = (
                self.policy.retry.call(
                    run_once, component="serve.execute", on_retry=on_retry,
                    exemplar=(req.ctx.request_id
                              if req.ctx is not None else None))
                if self.policy is not None else run_once())
        except BaseException as e:                  # noqa: BLE001
            self._count_failure(label, br)
            for r in batch:
                r.hop("batch_failure", error=type(e).__name__)
                if not r.future.done():
                    r.future.set_exception(e)
            return
        if br is not None:
            br.record_success()
        queue_waits = [t_dispatch - req.t_enqueue]
        self.stats.batch(label, occupancy=1, exec_seconds=exec_s,
                         queue_seconds=queue_waits, singular=int(sing),
                         workload=workload)
        if self.numerics == "summary":
            self._observe_numerics(batch, ex, [sing], [kappa], [rel])
        if not self._fail_expired(batch, "execute"):
            return
        req.hop("served", singular=sing, seconds=round(exec_s, 6),
                mesh=mesh)
        out = (res[:req.n, :req.n] if workload == "invert"
               else res[:req.n, :req.k]).clone()
        req.future.set_result(InvertResult(
            inverse=out if workload == "invert" else None,
            n=req.n, bucket_n=bucket, singular=sing,
            kappa=float(kappa), rel_residual=float(rel),
            queue_seconds=queue_waits[0], execute_seconds=exec_s,
            batch_occupancy=1, workload=workload,
            solution=out if workload != "invert" else None))

    # ---- the update lanes --------------------------------------------

    def _execute_updates(self, lane, batch: list,
                         t_dispatch: float) -> None:
        """Dispatch one update-lane batch.  Riders on DISTINCT handles
        share one launch of the lane's batch-cap executor; a later rider
        on a handle already in the batch (its input is the batch-mate's
        committed result) and every rider of a cap-1 lane run in order,
        each a group of one through the cap-1 executor.  A rider's terminal failure is its
        own typed error; a rider that does not match the lane's (bucket, k
        bucket, dtype) is refused with :class:`MixedUpdateBatchError`."""
        from ..interop import resolve_dtype
        from ..resilience.policy import ResidualGateError
        from .handles import UnknownHandleError

        _, b, k = lane.split(":")
        bucket, kb = int(b), int(k[1:])
        br = (self.executors.breaker(lane)
              if self.policy is not None else None)

        def fail_batch(riders, e):
            self._count_failure(lane, br)
            for req in riders:
                req.hop("batch_failure", error=type(e).__name__)
                if not req.future.done():
                    req.future.set_exception(e)

        try:
            _faults.fire("dispatch")
            ex, source = self.executors.get_info(
                bucket, 1, self.block_size, workload="update", rhs=kb)
        except BaseException as e:                  # noqa: BLE001
            fail_batch(batch, e)
            return
        queue_waits = [t_dispatch - req.t_enqueue for req in batch]
        dtype = resolve_dtype(ex.key.dtype)
        shape = (bucket, kb)
        conforming = []
        for i, req in enumerate(batch):
            pu, pv = req.padded_u, req.padded_v
            if (req.bucket_n != bucket or req.rhs != kb
                    or pu is None or pv is None
                    or tuple(pu.shape) != shape
                    or tuple(pv.shape) != shape
                    or pu.dtype != dtype or pv.dtype != dtype):
                e = MixedUpdateBatchError(
                    f"update rider (bucket {req.bucket_n}, k bucket "
                    f"{req.rhs}, factors "
                    f"{None if pu is None else (tuple(pu.shape), pu.dtype)})"
                    f" does not match lane {lane} (bucket {bucket}, k "
                    f"bucket {kb}, {dtype}) — mixed riders are refused, "
                    f"never padded")
                req.hop("typed_failure", error=type(e).__name__)
                if not req.future.done():
                    req.future.set_exception(e)
            else:
                conforming.append((i, req))

        # The first rider of each handle may share the batched launch;
        # later riders of the same handle follow in order.
        group, followers, seen = [], [], set()
        for i, req in conforming:
            hid = req.handle.handle_id
            if hid in seen:
                followers.append((i, req))
            else:
                seen.add(hid)
                group.append((i, req))
        if not (self.batch_cap > 1 and len(group) > 1):
            group, followers = [], conforming

        singular_served = 0
        exec_total = 0.0
        ok = True

        def settle(req, res):
            """One rider's outcome: an InvertResult, None (deadline, failed
            typed before the commit) or an exception."""
            nonlocal ok, singular_served
            if res is None:
                return
            if isinstance(res, (UnknownHandleError, ResidualGateError)):
                # The rider's own answer (an evicted handle, a gate the
                # rung could not recover), not evidence against the lane:
                # no breaker feedback, no batch-failure count.
                req.hop("typed_failure", error=type(res).__name__)
                if not req.future.done():
                    req.future.set_exception(res)
                return
            if isinstance(res, BaseException):
                ok = False
                self._count_failure(lane, br)
                req.hop("batch_failure", error=type(res).__name__)
                if not req.future.done():
                    req.future.set_exception(res)
                return
            singular_served += int(res.singular)
            req.hop("served", singular=bool(res.singular),
                    outcome=res.update_outcome,
                    version=res.handle_version,
                    seconds=round(res.execute_seconds, 6))
            req.future.set_result(res)

        def launch(members, ex_used):
            """One launch of ``ex_used`` over ``members`` ((index, rider)
            pairs on distinct handles), every rider settled."""
            nonlocal ok, exec_total
            riders = [r for _, r in members]
            try:
                results, exec_s = self._run_update_group(
                    riders, ex_used, [queue_waits[i] for i, _ in members],
                    len(batch))
            except BaseException as e:              # noqa: BLE001
                fail_batch(riders, e)
                ok = False
                return
            exec_total += exec_s
            for req, res in zip(riders, results):
                settle(req, res)

        if group:
            try:
                ex_b, source_b = self.executors.get_info(
                    bucket, self.batch_cap, self.block_size,
                    workload="update", rhs=kb)
            except BaseException as e:              # noqa: BLE001
                fail_batch([r for _, r in group], e)
                ok = False
            else:
                for _, req in group:
                    req.hop("executor", bucket=bucket, source=source_b,
                            engine=ex_b.key.engine, batched=len(group))
                launch(group, ex_b)

        for member in followers:
            member[1].hop("executor", bucket=bucket, source=source,
                          engine=ex.key.engine)
            launch([member], ex)
        if ok and br is not None:
            br.record_success()
        self.stats.batch(lane, occupancy=len(batch),
                         exec_seconds=exec_total,
                         queue_seconds=queue_waits,
                         singular=singular_served, workload="update")

    def _update_run_once(self, ex, args, slots: int, bucket: int,
                         what: str):
        """One guarded launch of an update executor over ``slots`` real
        elements: the ``execute`` fault point, the execute span, and the
        integrity gate (a non-singular element must report a finite
        rel_residual; nothing is committed yet, so the retry is safe).
        Returns (a_new, inv_new, singular, κ∞, rel) with the flags and
        numbers on the host, and the execute seconds."""
        _faults.fire("execute")
        out, esp = timed_blocking(
            ex.run, *args, telemetry=self._tel, name="execute",
            device=ex.device, bucket=bucket, occupancy=slots,
            workload="update")
        _hwcost.attach_execute_cost(
            esp,
            analytical_flops=slots * _hwcost.baseline_workload_flops(
                bucket, "update", k=ex.key.rhs))
        a_new, inv_new, sing, kappa, rel = out
        sing = sing.reshape(-1).cpu().numpy()
        kappa = kappa.reshape(-1).cpu().numpy()
        rel = rel.reshape(-1).cpu().numpy().copy()
        for slot in range(slots):
            if not sing[slot] and _faults.corrupt("result_corrupt_nan"):
                rel[slot] = np.nan
        bad = [s for s in range(slots)
               if not sing[s] and not math.isfinite(rel[s])]
        if bad:
            raise ResultCorruptionError(
                f"non-finite rel_residual for update {what} (bucket "
                f"{bucket}, slots {bad}) — corrupted result detected by "
                f"the integrity gate")
        return a_new, inv_new, sing, kappa, rel, esp.duration

    def _guarded(self, fn, riders):
        """``fn`` under the policy's retry (component ``serve.update``),
        each retry a hop on every rider."""
        if self.policy is None:
            return fn()

        def on_retry(exc, attempt):
            for req in riders:
                req.hop("retry", attempt=attempt, error=type(exc).__name__)

        return self.policy.retry.call(
            fn, component="serve.update", on_retry=on_retry,
            exemplar=(riders[0].ctx.request_id
                      if riders[0].ctx is not None else None))

    def _run_update_group(self, group: list, ex, queue_waits: list,
                          occupancy: int):
        """One SMW launch for riders on DISTINCT handles: each handle's
        committed state read under its transaction (taken in sorted id
        order, one acquisition order for every launch), the pairs stacked
        on the device with inert fillers (identity A and A⁻¹, zero U and
        V, n_real = 0) in the empty slots (a cap-1 executor takes the
        resident pair as it is, no copy), the executor run once (retried
        and integrity-gated), then every rider judged and committed on its
        own by :meth:`_finish_update`.  Returns ``(results,
        exec_seconds)``, each result an ``InvertResult``, None (deadline)
        or the rider's own exception; a raise is a whole-launch failure."""
        import contextlib

        from .handles import UnknownHandleError

        store = self.handles
        cap, N, K = ex.key.batch_cap, ex.key.bucket_n, ex.key.rhs
        dev = ex.device
        results = [None] * len(group)
        with contextlib.ExitStack() as stack:
            sts, live = {}, []
            for i, req in sorted(enumerate(group),
                                 key=lambda t: t[1].handle.handle_id):
                hid = req.handle.handle_id
                try:
                    sts[hid] = stack.enter_context(store.txn(hid))
                except UnknownHandleError as e:
                    results[i] = e
                else:
                    live.append(i)
            live.sort()
            if not live:
                return results, 0.0
            riders = [group[i] for i in live]
            pairs = [sts[r.handle.handle_id] for r in riders]
            dtype = riders[0].padded_u.dtype
            if cap == 1:
                a = pairs[0].a[None]
                inv = pairs[0].inverse[None]
            else:
                a = torch.eye(N, dtype=dtype, device=dev).repeat(cap, 1, 1)
                inv = a.clone()
                for slot, st in enumerate(pairs):
                    a[slot] = st.a
                    inv[slot] = st.inverse
            u = torch.zeros((cap, N, K), dtype=dtype)
            v = torch.zeros((cap, N, K), dtype=dtype)
            n_real = torch.zeros((cap,), dtype=torch.int64)
            for slot, req in enumerate(riders):
                u[slot] = req.padded_u
                v[slot] = req.padded_v
                n_real[slot] = req.n
            args = (a, inv, u.to(dev), v.to(dev), n_real.to(dev))
            what = ("batch" if cap > 1
                    else f"of handle {riders[0].handle.handle_id}")
            a_new, inv_new, sing, kappa, rel, exec_s = self._guarded(
                lambda: self._update_run_once(ex, args, len(live), N,
                                              what), riders)
            for slot, (i, req) in enumerate(zip(live, riders)):
                a_i, inv_i = a_new[slot], inv_new[slot]
                if cap > 1:
                    # Each handle keeps its own pair, not a view of the
                    # batch's stacks.
                    a_i, inv_i = a_i.clone(), inv_i.clone()
                try:
                    results[i] = self._finish_update(
                        req, pairs[slot], ex, a_i, inv_i,
                        bool(sing[slot]), float(kappa[slot]),
                        float(rel[slot]), exec_s, queue_waits[i],
                        occupancy)
                except BaseException as e:          # noqa: BLE001
                    # One rider's typed gate failure never aborts a
                    # batch-mate's commit.
                    results[i] = e
        return results, exec_s

    def _finish_update(self, req, st, ex, a_new, inv_new, sing: bool,
                       kappa: float, rel: float, exec_s: float,
                       queue_s: float, occupancy: int):
        """Judge and commit one rider's update (caller holds the handle's
        transaction).  The deadline is judged before the commit, so an
        expired update fails typed with the handle untouched; the numerics
        are observed before the gate; a failed gate or an exhausted drift
        budget walks the re_invert rung.  Returns the
        ``InvertResult``, or None when the deadline expired; raises
        ``ResidualGateError`` when the rung did not recover."""
        from ..linalg.update import drift_budget, drift_exceeded
        from ..resilience.degrade import gate_passes, gate_threshold

        if not self._fail_expired([req], "execute"):
            return None
        thr = None
        if self.policy is not None and not sing:
            thr = gate_threshold(self.policy, req.n, kappa, ex.key.dtype)
        if self.numerics == "summary" and not sing:
            self._observe_update_numerics(req, ex, kappa, rel, thr)
        store = self.handles
        outcome, recovery_rel = "refreshed", rel
        if sing:
            # The mutation destroyed rank: the typed singular answer, the
            # resident state unchanged.
            outcome = "gated"
        elif self.policy is not None:
            budget = drift_budget(thr, self._drift_factor)
            new_drift = st.drift + max(rel, 0.0)
            cause = None
            if not gate_passes(rel, thr):
                cause = "residual_gate"
            elif drift_exceeded(new_drift, budget):
                cause = "drift_budget"
            if cause is not None:
                if self.numerics == "summary" and cause == "drift_budget":
                    # The residual passed, so the budget's exceedance
                    # records its own spike.
                    from ..obs.numerics import record_drift_spike

                    record_drift_spike(n=req.n, engine=ex.key.engine,
                                       value=new_drift, threshold=budget)
                outcome, kappa, recovery_rel, inv_new = self._reinvert_rung(
                    req, a_new, rel, new_drift, thr, budget, cause)
                new_drift = 0.0
                # The fresh elimination flagged the mutated matrix
                # singular: the typed singular answer, state untouched.
                sing = outcome == "gated"
            if not sing:
                store.commit(st, a=a_new, inverse=inv_new, kappa=kappa,
                             rel_residual=recovery_rel, drift=new_drift,
                             reinverted=outcome == "re_inverted")
        else:
            # No policy, no gate: the drift still accumulates, so a policy
            # attached later sees the history.
            store.commit(st, a=a_new, inverse=inv_new, kappa=kappa,
                         rel_residual=rel, drift=st.drift + max(rel, 0.0))
        version, drift_after = st.version, st.drift
        req.hop("update", outcome=outcome, version=version,
                drift=round(drift_after, 9))
        return InvertResult(
            inverse=None if sing else inv_new[:req.n, :req.n].clone(),
            n=req.n, bucket_n=req.bucket_n, singular=sing, kappa=kappa,
            rel_residual=recovery_rel, queue_seconds=queue_s,
            execute_seconds=exec_s, batch_occupancy=occupancy,
            workload="update", update_outcome=outcome, handle=req.handle,
            handle_version=version, drift=drift_after)

    def _reinvert_rung(self, req, a_new, rel, new_drift, thr, budget,
                       cause: str):
        """The ``re_invert`` rung, fired by ``cause`` (``residual_gate`` or
        ``drift_budget``): the mutated matrix is
        eliminated afresh through the WARM cap-1 invert lane (built by
        ``warmup(update_shapes=)``: the request path builds nothing) and
        judged again.  Returns (outcome, κ∞, rel_residual, inverse):
        ``re_inverted`` when it passes, ``gated`` when the fresh probe flags
        the matrix singular; raises the typed ``ResidualGateError`` when it
        fails."""
        from ..resilience.degrade import (gate_passes, gate_threshold,
                                          record_gate_failure, record_rung)
        from ..resilience.policy import ResidualGateError

        record_gate_failure(req.n, rel, thr, workload="update",
                            drift=float(new_drift), budget=float(budget),
                            cause=cause)
        inv_ex = self.executors.get(req.bucket_n, 1, self.block_size)
        n_real = torch.tensor([req.n], dtype=torch.int64,
                              device=a_new.device)
        inv2, sing2, kap2, rel2 = inv_ex.run(a_new[None], n_real)
        sing2 = bool(sing2[0])
        kap2, rel2 = float(kap2[0]), float(rel2[0])
        passed = (not sing2 and gate_passes(rel2, gate_threshold(
            self.policy, req.n, kap2, inv_ex.key.dtype)))
        record_rung("re_invert", passed, rel2, workload="update",
                    singular=sing2)
        req.hop("recovery_rung", rung="re_invert", cause=cause,
                passed=passed)
        if sing2:
            return "gated", kap2, rel2, inv2[0]
        if not passed:
            raise ResidualGateError(
                f"update residual gate failed ({cause}: rel {rel:.3e},"
                f" drift {new_drift:.3e} vs threshold {thr:.3e} / "
                f"budget {budget:.3e}) and the re_invert rung did not "
                f"recover (handle {req.handle.handle_id})",
                recovery=({"rung": "re_invert", "cause": cause,
                           "rel_residual_after": rel2,
                           "passed": False},))
        return "re_inverted", kap2, rel2, inv2[0]

    def _observe_update_numerics(self, req, ex, kappa, rel,
                                 threshold) -> None:
        """``numerics="summary"`` for one update rider: its verified
        rel_residual and κ∞ against the mutated matrix (the numbers before
        any rung), spiked against ``threshold`` (the policy's gate; None
        without a policy)."""
        from ..obs import numerics as _numerics

        thresholds = (None if threshold is None
                      else _numerics.SpikeThresholds(residual=threshold))
        rep = _numerics.summary_report(
            n=req.n, block_size=ex.block_size, engine=ex.key.engine,
            rel_residual=float(rel), kappa=float(kappa), norm_a=0.0,
            dtype=ex.key.dtype, workload="update")
        _numerics.observe(rep)
        _numerics.record_spikes(rep, thresholds)
