"""Request journeys: what happened to *this* request.  Counterpart of the
JAX package's ``obs/journey.py``, with its event names letter for letter
(``tools/check_blackbox.py`` reads them).

Every request entering the service (``serve.JordanService.submit``) gets a
:class:`RequestContext` with a deterministic ``request_id``; every hop of
its life appends a timestamped journey event:

  ==================  =================================================
  event               recorded by
  ==================  =================================================
  submit              the journey log, at context creation
  reject              the service, on a typed submit-time rejection
  enqueue             the micro-batcher's bounded-queue admission
  breaker_fast_fail   the batcher's circuit-breaker fast-fail
  dispatch            the dispatcher (batch occupancy + cause:
                      full | deadline | drain)
  executor            the dispatcher (bucket + source:
                      compiled | shared_store | cached)
  retry               the dispatcher's per-batch retry (attempt, error)
  deadline            the typed deadline failure (phase: queue | execute)
  batch_failure       a terminal batch error fanned to this rider
  served              the result fan-out (singular, seconds)
  result              TERMINAL: outcome ok|error, written by close()
  ==================  =================================================

The fleet's hops (``route``, ``shed``, ``requeue``, ``fault``) and the mesh
lanes' ``mesh_admitted`` come with those layers (ROADMAP.md Queue A items
14d and 15); :data:`EXPLANATORY_HOPS` already names the fleet's, as the
checker's copy does.

Every event is mirrored into the always-on flight recorder
(``obs/recorder.py``, kind ``journey``) with the same timestamp, so a
request's path is reconstructible from the black-box dump alone, and
exportable as one Chrome-trace async lane per request
(:func:`async_trace_events`).

Determinism: ``request_id`` is ``<prefix>-<seq>`` from the log's own
counter, in submit order, so a seeded demo produces the same ids run after
run.  Terminal outcomes feed ``tpu_jordan_torch_request_outcome_total`` and
``tpu_jordan_torch_request_latency_seconds``; the chaos demo derives its
outcome ledger from journey events through :func:`outcome_ledger`.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from . import metrics as _metrics
from . import recorder as _recorder

#: Journey events that explain a typed failure (the checker's "no gap"
#: rule: a typed-failure journey must carry at least one).
EXPLANATORY_HOPS = frozenset({
    "shed", "requeue", "reject", "breaker_fast_fail",
    "deadline", "batch_failure", "fault", "retry",
})

#: Completed contexts retained per log.
MAX_COMPLETED = 4096

#: Per-request event cap: a pathological loop must not grow one context
#: without bound.
MAX_EVENTS_PER_REQUEST = 256

_M_OUTCOME = _metrics.counter(
    "tpu_jordan_torch_request_outcome_total",
    "terminal request outcomes from journey close (ok | error), labeled "
    "by outcome and bucket")
_M_LATENCY = _metrics.histogram(
    "tpu_jordan_torch_request_latency_seconds",
    "submit-to-terminal-outcome wall seconds per request (journey close), "
    "labeled by bucket")


class RequestContext:
    """One request's identity and journey.  Created by
    :meth:`JourneyLog.new`, threaded through the batcher and the
    executors, closed exactly once with the terminal outcome."""

    __slots__ = ("request_id", "n", "bucket", "workload", "t_created",
                 "_log", "_lock", "_events", "_closed")

    def __init__(self, request_id: str, n: int, bucket: int, log,
                 workload: str = "invert"):
        self.request_id = request_id
        self.n = int(n)
        self.bucket = int(bucket)
        #: "invert" or "solve", stamped on the submit hop.
        self.workload = str(workload)
        self._log = log
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._closed = False
        self.t_created = log.clock()
        self.event("submit", n=self.n, bucket=self.bucket,
                   workload=self.workload)

    def event(self, name: str, **attrs) -> None:
        """One journey hop, appended here AND mirrored into the flight
        recorder with the same timestamp."""
        t = self._log.clock()
        ev = {"t": t, "event": str(name)}
        ev.update(attrs)
        with self._lock:
            if self._closed or len(self._events) >= MAX_EVENTS_PER_REQUEST:
                return
            self._events.append(ev)
        self._log.recorder.record(
            "journey", t=t, request_id=self.request_id, event=str(name),
            **attrs)

    def close(self, outcome: str, error: str | None = None,
              **attrs) -> None:
        """Record the terminal ``result`` event (idempotent: the first
        closer wins) and feed the outcome and latency series."""
        t = self._log.clock()
        payload = dict(attrs, outcome=str(outcome))
        if error is not None:
            payload["error"] = str(error)
        ev = dict(payload, t=t, event="result")
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._events.append(ev)
        self._log.recorder.record("journey", t=t,
                                  request_id=self.request_id,
                                  event="result", **payload)
        wl = ({} if self.workload == "invert"
              else {"workload": self.workload})
        _M_OUTCOME.inc(outcome=str(outcome), bucket=self.bucket, **wl)
        _M_LATENCY.observe(t - self.t_created, bucket=self.bucket, **wl)
        self._log._complete(self)

    def close_from_future(self, future) -> None:
        """The terminal outcome from a ``concurrent.futures`` done
        callback."""
        exc = future.exception() if not future.cancelled() else None
        if future.cancelled():
            self.close("error", error="Cancelled")
        elif exc is not None:
            self.close("error", error=type(exc).__name__)
        else:
            res = future.result()
            self.close("ok", singular=bool(getattr(res, "singular",
                                                   False)))

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def events(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def outcome(self) -> tuple[str, str | None] | None:
        """("ok"|"error", error type or None), or None while open."""
        for e in reversed(self.events()):
            if e["event"] == "result":
                return e["outcome"], e.get("error")
        return None


#: Logs minted per prefix, process-wide: journey ids must be unique across
#: every log of the process, since the exports group by ``request_id``.
_PREFIX_LOCK = threading.Lock()
_PREFIX_COUNTS: dict = {}


class JourneyLog:
    """The per-service context factory and retention window.  ``new()``
    mints ids in submit order; completed contexts are kept in a bounded
    ring, active ones until closed.  The second log made with a prefix
    gets an instance suffix (``req``, ``req2``, ...), so ids stay the same
    run to run and never collide between a run's services."""

    def __init__(self, prefix: str = "req", clock=None,
                 max_completed: int = MAX_COMPLETED, recorder=None):
        prefix = str(prefix)
        with _PREFIX_LOCK:
            _PREFIX_COUNTS[prefix] = _PREFIX_COUNTS.get(prefix, 0) + 1
            inst = _PREFIX_COUNTS[prefix]
        self.prefix = prefix if inst == 1 else f"{prefix}{inst}"
        self.clock = clock if clock is not None else time.perf_counter
        self.recorder = (recorder if recorder is not None
                         else _recorder.RECORDER)
        self._lock = threading.Lock()
        self._seq = 0
        self._active: dict[str, RequestContext] = {}
        self._completed: deque = deque(maxlen=int(max_completed))

    def new(self, n: int, bucket: int,
            workload: str = "invert") -> RequestContext:
        with self._lock:
            self._seq += 1
            rid = f"{self.prefix}-{self._seq:05d}"
        ctx = RequestContext(rid, n, bucket, self, workload=workload)
        with self._lock:
            self._active[rid] = ctx
        return ctx

    def _complete(self, ctx: RequestContext) -> None:
        with self._lock:
            self._active.pop(ctx.request_id, None)
            self._completed.append(ctx)

    def contexts(self) -> list[RequestContext]:
        """Completed (oldest first), then still-active contexts."""
        with self._lock:
            return list(self._completed) + list(self._active.values())

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def ledger(self) -> dict:
        """The outcome ledger of this log's journeys."""
        return outcome_ledger(e for ctx in self.contexts()
                              for e in _ctx_journey_events(ctx))


def _ctx_journey_events(ctx: RequestContext):
    for e in ctx.events():
        ev = dict(e)
        ev["request_id"] = ctx.request_id
        yield ev


def journeys_from_events(events) -> dict[str, list[dict]]:
    """Group flight-recorder ``journey`` events (or any dicts carrying
    ``request_id``/``event``) by request id, in order."""
    out: dict[str, list[dict]] = {}
    for e in events:
        if e.get("kind") not in (None, "journey"):
            continue
        rid = e.get("request_id")
        if rid is None:
            continue
        out.setdefault(str(rid), []).append(e)
    return out


def outcome_ledger(events) -> dict:
    """The outcome ledger derived from journey events alone: requests
    submitted, resolved ok or with a typed error (by type), singular, and
    the gaps (submitted, never resolved: the silent-loss signature)."""
    journeys = journeys_from_events(events)
    ok = errors = 0
    typed: dict[str, int] = {}
    gaps: list[str] = []
    singular = 0
    for rid, evs in journeys.items():
        terminal = next((e for e in reversed(evs)
                         if e.get("event") == "result"), None)
        if terminal is None:
            gaps.append(rid)
        elif terminal.get("outcome") == "ok":
            ok += 1
            singular += int(bool(terminal.get("singular")))
        else:
            errors += 1
            name = str(terminal.get("error", "UnknownError"))
            typed[name] = typed.get(name, 0) + 1
    return {
        "submitted": len(journeys),
        "ok": ok,
        "error": errors,
        "typed_errors": dict(sorted(typed.items())),
        "singular_flagged": singular,
        "gaps": sorted(gaps),
    }


def async_trace_events(events, cat: str = "tpu_jordan_request",
                       pid: int = 0) -> list[dict]:
    """Chrome-trace async events from journey events: one lane per
    request (nestable ``b``/``e`` around the journey, a nestable instant
    ``n`` per hop), grouped by ``id``, so Perfetto shows one row per
    request.  The category is the JAX package's, the one on which
    ``tools/check_telemetry.py`` requires every lane to carry hops."""
    out: list[dict] = []
    for rid, evs in sorted(journeys_from_events(events).items()):
        ts = [float(e["t"]) for e in evs]
        t0, t1 = min(ts), max(ts)
        base = {"cat": cat, "id": rid, "pid": pid, "tid": 0}
        out.append(dict(base, name=rid, ph="b",
                        ts=round(t0 * 1e6, 3)))
        for e in evs:
            args = {k: (v if isinstance(v, (str, int, float, bool,
                                            type(None))) else str(v))
                    for k, v in e.items()
                    if k not in ("t", "kind", "seq", "request_id")}
            out.append(dict(base, name=str(e["event"]), ph="n",
                            ts=round(float(e["t"]) * 1e6, 3),
                            args=args))
        out.append(dict(base, name=rid, ph="e",
                        ts=round(t1 * 1e6, 3)))
    return out
