"""Bucket-affinity router with breaker-aware load shedding.  Counterpart of
the JAX package's ``fleet/router.py``.

Placement: each shape bucket has a *home slot*, ``bucket.bit_length() %
slots``, so consecutive power-of-two buckets home on different replicas.
A request tries its bucket's home replica first, then the others in slot
order, skipping:

  * a replica that is not READY (dead or draining), counted as
    ``shed{reason="dead"}``;
  * a replica whose breaker of the request's lane is open (it gets no
    traffic of that lane until its cooldown admits a half-open probe),
    ``shed{reason="breaker"}``;
  * a replica whose bounded queue is full (typed ``ServiceOverloadedError``
    at admission), ``shed{reason="overload"}``.

Nothing acceptable anywhere is typed backpressure to the caller:
:class:`~..serve.batcher.ServiceOverloadedError` when saturation or death
blocked it, :class:`~..resilience.policy.CircuitOpenError` when every live
replica's breaker of the lane is open.  Never a silent drop.

Re-queue on a replica's death: the router resolves its own *outer* future
per request from the replica's *inner* one.  When the inner future fails
with a death-class error (:class:`~.replica.ReplicaKilledError`, or
``ServiceClosedError`` from a worker torn down mid-flight), the request is
re-dispatched to a healthy replica within the retry budget
(``policy.retry.max_retries``) and its ABSOLUTE deadline, counted in
``tpu_jordan_torch_fleet_reroutes_total``.  A spent budget is the typed
death error to the caller.  Every other failure (deadline, corruption, a
terminal batch error, a singular element) propagates typed and untouched:
a reroute never retries a real answer away.
"""

from __future__ import annotations

import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from ..obs import metrics as _obs_metrics
from ..resilience.policy import CircuitOpenError
from ..serve.batcher import ServiceClosedError, ServiceOverloadedError
from ..serve.executors import bucket_for
from .replica import ReplicaKilledError

_M_REROUTES = _obs_metrics.counter(
    "tpu_jordan_torch_fleet_reroutes_total",
    "in-flight requests re-queued to another replica after a replica "
    "death, labeled by the dead replica's slot")
_M_SHED = _obs_metrics.counter(
    "tpu_jordan_torch_fleet_shed_total",
    "routing decisions that skipped a replica or shed a request, labeled "
    "by reason (breaker|overload|dead|pre_shed)")


def _host(x, dtype) -> torch.Tensor:
    """A request array (numpy or tensor, any device) as a CPU tensor of the
    fleet's dtype: what every replica it visits re-pads."""
    t = (x if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(x)))
    return t.detach().to(device="cpu", dtype=dtype)


@dataclass
class _FleetRequest:
    """One routed request: the host matrix (re-padded by whichever replica
    serves it), the caller's ABSOLUTE deadline, the reroute budget spent,
    the outer future the caller holds, and the fleet-level journey context
    (one journey per request, however many replicas it visits).

    ``kind="update"`` routes a resident-inverse update (``handle``, ``u``,
    ``v`` in place of ``a``): the handle's committed state lives in the
    shared store, so a retried update re-reads it and is applied exactly
    once.  ``kind="solve"`` routes X = A⁻¹B through the solve lanes (``b``
    the RHS block, ``rhs`` its k-bucket): the LP/QP drivers' verification
    solves ride it.  ``kind="ckpt_solve"`` is the checkpointed sweep
    (``ckpt`` the spec dict): a re-queue hop that finds a live token in
    the store RESUMES from the last durable superstep."""

    a: object
    n: int
    bucket: int
    outer: Future
    t_deadline: float | None = None      # absolute monotonic deadline
    attempts: int = 0
    t_submit: float = field(default=0.0)
    ctx: object = None                   # obs.journey.RequestContext
    kind: str = "invert"                 # invert | update | solve | ckpt_solve
    handle: object = None                # HandleRef (update)
    u: object = None                     # (n, k) update factors
    v: object = None
    b: object = None                     # (n, k) RHS block (solve)
    rhs: int = 0                         # solve lane k-bucket
    ckpt: object = None                  # checkpoint spec (ckpt_solve)

    def remaining_ms(self, now: float) -> float | None:
        if self.t_deadline is None:
            return None
        return (self.t_deadline - now) * 1e3

    @property
    def breaker_key(self):
        """The replica breaker this request's lane trips (the batcher's
        lane key), so the router sheds what admission would fast-fail."""
        if self.kind == "update":
            from ..serve.executors import k_bucket_for

            return f"update:{self.bucket}:k{k_bucket_for(self.u.shape[1])}"
        if self.kind == "solve":
            return f"solve:{self.bucket}:k{self.rhs}"
        if self.kind == "ckpt_solve":
            # Checkpointed solves bypass the batched lanes: no breaker
            # exists for this key, and an unknown breaker allows.
            return f"ckpt:{self.bucket}"
        return self.bucket

    @property
    def rid(self) -> str | None:
        return None if self.ctx is None else self.ctx.request_id

    def hop(self, event: str, **attrs) -> None:
        if self.ctx is not None:
            self.ctx.event(event, **attrs)


class Router:
    """The fleet's front door.  It holds no replica state: it reads the
    pool's slot table on every dispatch, so a supervisor replacement is
    seen by the very next request."""

    def __init__(self, pool, max_reroutes: int = 2):
        self.pool = pool
        self.max_reroutes = max(1, int(max_reroutes))
        #: Pre-shed flag: NEW submissions are shed typed at the front door
        #: (``shed{reason="pre_shed"}``, journey-hopped) while in-flight
        #: work and death re-queues finish.  ``FleetAutoscaler`` sets it.
        self.pre_shed = False

    def _check_pre_shed(self, req: _FleetRequest) -> None:
        if not self.pre_shed:
            return
        _M_SHED.inc(reason="pre_shed", exemplar=req.rid)
        req.hop("shed", reason="pre_shed")
        req.hop("reject", reason="pre_shed")
        raise ServiceOverloadedError(
            f"pre-shedding bucket {req.bucket}: the fleet is approaching "
            f"its SLO objective — retry after backoff (typed "
            f"backpressure, nothing dropped)")

    def _admit(self, req: _FleetRequest, record_bucket: bool) -> Future:
        """Account a new request and dispatch it; a typed refusal closes
        its journey and propagates to the caller."""
        if record_bucket:
            self.pool._record_bucket(req.bucket)
        self.pool._account_submitted()
        try:
            self._check_pre_shed(req)
            self._dispatch(req)
        except Exception as e:
            self.pool._account_resolved(ok=False)
            req.ctx.close("error", error=type(e).__name__)
            raise
        return req.outer

    @staticmethod
    def _outer() -> Future:
        # Claimed at once: the outer future may be resolved from another
        # thread's callback after dispatch, and a caller's cancel() racing
        # that would crash a dispatcher.
        outer = Future()
        outer.set_running_or_notify_cancel()
        return outer

    @staticmethod
    def _deadline(now: float, deadline_ms) -> float | None:
        return None if deadline_ms is None else now + float(deadline_ms) / 1e3

    # ---- caller side -------------------------------------------------

    def submit(self, a, dtype, deadline_ms: float | None = None,
               _ctx=None) -> Future:
        """Route one invert.  ``_ctx``: a fleet journey context minted by
        the caller (``JordanFleet.invert(resident=True)`` mints it before
        budget admission, so an eviction hop lands on this request's
        journey); None mints here."""
        a = _host(a, dtype)
        if a.dim() != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected a square (n, n) matrix, "
                             f"got shape {tuple(a.shape)}")
        n = a.shape[0]
        now = time.monotonic()
        bucket = bucket_for(n)
        req = _FleetRequest(
            a=a, n=n, bucket=bucket, outer=self._outer(),
            t_deadline=self._deadline(now, deadline_ms), t_submit=now,
            ctx=(_ctx if _ctx is not None
                 else self.pool.journey.new(n, bucket)))
        return self._admit(req, record_bucket=True)

    def submit_update(self, handle, u, v, dtype,
                      deadline_ms: float | None = None) -> Future:
        """Route one rank-k resident-inverse update: one fleet journey
        (``workload="update"``), affinity off the HANDLE's bucket, typed
        backpressure, death re-queue."""
        from ..linalg.update import as_update_factors

        n = int(handle.n)
        u, v, _ = as_update_factors(u, v, n, dtype, device="cpu")
        now = time.monotonic()
        req = _FleetRequest(
            a=None, n=n, bucket=int(handle.bucket_n), outer=self._outer(),
            t_deadline=self._deadline(now, deadline_ms), t_submit=now,
            ctx=self.pool.journey.new(n, int(handle.bucket_n),
                                      workload="update"),
            kind="update", handle=handle, u=u, v=v)
        return self._admit(req, record_bucket=False)

    def submit_solve(self, a, b, dtype,
                     deadline_ms: float | None = None,
                     ckpt=None) -> Future:
        """Route one solve X = A⁻¹B through the replicas' solve lanes (no
        inverse formed); ``ckpt`` switches it to the checkpointed
        superstep path, whose death re-queue resumes from the store."""
        from ..serve.executors import rhs_bucket_for

        a = _host(a, dtype)
        if a.dim() != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected a square (n, n) matrix, "
                             f"got shape {tuple(a.shape)}")
        b = _host(b, dtype)
        if b.dim() == 1:
            b = b[:, None]
        if b.dim() != 2 or b.shape[0] != a.shape[0]:
            raise ValueError(f"expected a ({a.shape[0]}, k) RHS block, "
                             f"got shape {tuple(b.shape)}")
        n = a.shape[0]
        now = time.monotonic()
        bucket = bucket_for(n)
        req = _FleetRequest(
            a=a, n=n, bucket=bucket, outer=self._outer(),
            t_deadline=self._deadline(now, deadline_ms), t_submit=now,
            ctx=self.pool.journey.new(n, bucket, workload="solve"),
            kind=("ckpt_solve" if ckpt is not None else "solve"),
            b=b, rhs=rhs_bucket_for(b.shape[1]), ckpt=ckpt)
        return self._admit(req, record_bucket=True)

    # ---- dispatch / re-queue ----------------------------------------

    def _candidates(self, bucket: int):
        """Live replicas in affinity order: the bucket's home slot first,
        then the rest in slot order."""
        replicas = self.pool.live_replicas()
        if not replicas:
            return []
        nslots = self.pool.slots
        home = bucket.bit_length() % nslots
        return sorted(replicas,
                      key=lambda r: (r.slot - home) % nslots)

    def _hand_off(self, req: _FleetRequest, replica):
        """Submit ``req`` to ``replica`` by its kind; the inner future."""
        remaining = req.remaining_ms(time.monotonic())
        if req.kind == "update":
            return replica.submit_update(req.handle, req.u, req.v,
                                         deadline_ms=remaining, ctx=req.ctx)
        if req.kind == "solve":
            return replica.submit_solve(req.a, req.b, deadline_ms=remaining,
                                        ctx=req.ctx)
        if req.kind == "ckpt_solve":
            # A live token means an earlier hop wrote a durable checkpoint
            # before dying: this replica RESUMES it (the hop is recorded
            # before the replica sees the request).
            resume = None
            if req.ckpt["store"].has_live(req.ckpt["run_id"]):
                resume = req.ckpt["run_id"]
                req.hop("ckpt_resume", replica=replica.name,
                        run_id=resume, attempt=req.attempts)
            return replica.submit_solve_ckpt(req.a, req.b, req.ckpt,
                                             resume_from=resume,
                                             ctx=req.ctx)
        return replica.submit(req.a, deadline_ms=remaining, ctx=req.ctx)

    def _dispatch(self, req: _FleetRequest) -> None:
        """Try every candidate once; on acceptance chain the inner future
        to the outer.  Raises typed backpressure when nobody accepts (on
        the caller's thread at first submit; onto the outer future on a
        re-queue hop).

        Total-loss grace: ZERO live replicas (every slot dead mid rolling
        restart, unlike saturation) waits once, bounded by
        ``pool.restart_grace_s`` and the request's deadline, for the
        supervisor's warm replacement, then rescans."""
        shed_breaker = shed_overload = 0
        waited = False
        while True:
            candidates = self._candidates(req.bucket)
            down = self.pool.slots - len(candidates)
            if down:
                _M_SHED.inc(down, reason="dead", exemplar=req.rid)
                req.hop("shed", reason="dead", slots_down=down)
            for replica in candidates:
                if not replica.breaker_allows(req.breaker_key):
                    _M_SHED.inc(reason="breaker", exemplar=req.rid)
                    shed_breaker += 1
                    req.hop("shed", reason="breaker",
                            replica=replica.name)
                    continue
                # The route decision journeys BEFORE the replica sees the
                # request (attempt 0 = first dispatch, > 0 a re-queue).
                req.hop("route", replica=replica.name,
                        slot=replica.slot, attempt=req.attempts)
                try:
                    inner = self._hand_off(req, replica)
                except (ReplicaKilledError, ServiceClosedError):
                    # Died between the scan and the submit (or THIS submit
                    # triggered the seeded kill): next candidate.
                    _M_SHED.inc(reason="dead", exemplar=req.rid)
                    req.hop("shed", reason="dead", replica=replica.name)
                    self.pool._kick_supervisor()
                    continue
                except ServiceOverloadedError:
                    _M_SHED.inc(reason="overload", exemplar=req.rid)
                    shed_overload += 1
                    req.hop("shed", reason="overload",
                            replica=replica.name)
                    continue
                except CircuitOpenError:
                    # The breaker flipped between the check and admission.
                    _M_SHED.inc(reason="breaker", exemplar=req.rid)
                    shed_breaker += 1
                    req.hop("shed", reason="breaker",
                            replica=replica.name)
                    continue
                inner.add_done_callback(
                    lambda f, req=req, replica=replica:
                        self._on_inner_done(req, replica, f))
                return
            if (not waited and not self.pool.closing
                    and not self.pool.live_replicas()
                    # Never grace-wait ON the supervising thread: a kill's
                    # doomed-future callbacks re-dispatch here, and
                    # blocking would starve the thread that installs the
                    # replacement.
                    and not self.pool.supervisor.is_supervising_thread()):
                waited = True
                grace = self.pool.restart_grace_s
                rem = req.remaining_ms(time.monotonic())
                if rem is not None:
                    grace = min(grace, max(0.0, rem / 1e3))
                self.pool._kick_supervisor()
                if self.pool.wait_for_live_replica(grace):
                    continue
            break
        # Nobody accepted: typed backpressure, and the reject hop says why.
        if shed_overload:
            req.hop("reject", reason="saturated")
            raise ServiceOverloadedError(
                f"fleet saturated for bucket {req.bucket}: every live "
                f"replica's queue is full — retry later (typed "
                f"backpressure, nothing dropped)")
        if shed_breaker:
            req.hop("reject", reason="breaker")
            raise CircuitOpenError(
                f"every live replica's circuit for bucket {req.bucket} "
                f"is open — retry after the cooldown")
        req.hop("reject", reason="no_live_replica")
        raise ServiceOverloadedError(
            "no live replica (fleet restarting or closed) — retry "
            "later (typed backpressure, nothing dropped)")

    def _on_inner_done(self, req: _FleetRequest, replica, inner) -> None:
        """Resolve the outer future, or re-queue after a replica death.
        Runs on the thread that resolved the inner future (a dispatcher,
        or a killer failing queued work), never under a queue lock."""
        exc = inner.exception()
        if exc is None:
            self.pool._account_resolved(ok=True)
            res = inner.result()
            if req.ctx is not None:
                req.ctx.close("ok", singular=bool(
                    getattr(res, "singular", False)))
            req.outer.set_result(res)
            return
        death = (ReplicaKilledError, ServiceClosedError)
        if req.kind == "ckpt_solve":
            # A preemption mid checkpointed sweep re-queues too: the
            # re-dispatch finds the live token and resumes.
            from ..resilience.checkpoint import PreemptedError

            death += (PreemptedError,)
        if (isinstance(exc, death)
                and not self.pool.closing
                and req.attempts < self.max_reroutes):
            req.attempts += 1
            _M_REROUTES.inc(replica=str(replica.slot), exemplar=req.rid)
            req.hop("requeue", from_replica=replica.name,
                    attempt=req.attempts, error=type(exc).__name__)
            self.pool._kick_supervisor()
            try:
                self._dispatch(req)
            except Exception as e:           # noqa: BLE001 — typed out
                self.pool._account_resolved(ok=False)
                if req.ctx is not None:
                    req.ctx.close("error", error=type(e).__name__)
                req.outer.set_exception(e)
            return
        if isinstance(exc, death):
            # A death the router did not re-queue still explains itself:
            # budget spent, or the fleet is closing.
            req.hop("reject",
                    reason=("closing" if self.pool.closing
                            else "reroute_budget_exhausted"),
                    attempt=req.attempts)
        self.pool._account_resolved(ok=False)
        if req.ctx is not None:
            req.ctx.close("error", error=type(exc).__name__)
        req.outer.set_exception(exc)
