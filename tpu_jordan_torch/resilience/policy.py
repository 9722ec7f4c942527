"""Retry, deadlines, circuit breaking and the residual-gate knobs: the
port of the JAX package's ``resilience/policy.py``.

  * :func:`is_transient` / :func:`retryable`: the typed transient classifier.
    A transport exception TYPE carrying a documented-transient message
    marker; both conditions are required, so an accuracy error that merely
    quotes a marker is never retried.  The JAX runtime error types have no
    counterpart here; the transport types and the markers stay.
  * :class:`RetryPolicy`: bounded retries with exponential backoff and
    deterministic jitter (a pure function of the attempt index), and
    :func:`retry_transient`, its one-shot form for the tuner's
    measurements.
  * :class:`DeadlineExceededError`: the typed per-request deadline
    failure (queue wait + execute) of the serving dispatcher; counted in
    ``tpu_jordan_torch_deadline_exceeded_total`` by phase.
  * :class:`CircuitBreaker`: closed -> (K consecutive failures) open ->
    typed fast-fail (:class:`CircuitOpenError`) -> half-open probe after
    the cooldown -> closed on the probe's success, open again on its
    failure.  Its state is the ``tpu_jordan_torch_breaker_state`` gauge,
    its openings ``tpu_jordan_torch_breaker_open_total``; every transition
    is a ``breaker_transition`` flight-recorder event.
  * :class:`ResiliencePolicy`: the umbrella ``solve(policy=)`` and
    ``JordanService(policy=)`` take: retry, the residual gate and
    degradation ladder (``resilience/degrade.py``), and the breaker knobs.

Every retry is counted in ``tpu_jordan_torch_retries_total`` (labeled by
component, with the affected request as the series' exemplar when the
caller names one) and recorded as a ``retry`` flight-recorder event.
:class:`CapacityExceededError` is the resident-handle budget's typed
refusal at submit (``serve/handles.py``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

from ..obs import metrics as _obs_metrics
from ..obs import recorder as _recorder

_M_RETRIES = _obs_metrics.counter(
    "tpu_jordan_torch_retries_total",
    "retries performed by RetryPolicy (transient failures and detected "
    "result corruption), labeled by component")
_M_BREAKER_STATE = _obs_metrics.gauge(
    "tpu_jordan_torch_breaker_state",
    "circuit breaker state: 0 closed, 1 open, 2 half-open")
_M_BREAKER_OPEN = _obs_metrics.counter(
    "tpu_jordan_torch_breaker_open_total",
    "closed/half-open -> open breaker transitions")
_M_DEADLINE = _obs_metrics.counter(
    "tpu_jordan_torch_deadline_exceeded_total",
    "requests failed by their deadline, labeled by phase (queue|execute)")

#: Documented-transient message markers.  Marker AND type are both required.
_RETRYABLE = ("INTERNAL", "remote_compile", "read body", "DEADLINE")


class DeadlineExceededError(TimeoutError):
    """A request's deadline elapsed (queue wait + execute) before its
    result could be delivered: the serving dispatcher's typed per-request
    deadline failure, never a hang or a silent drop."""


class CircuitOpenError(RuntimeError):
    """Fast-fail from an OPEN circuit breaker: the lane's executor failed K
    consecutive times, and queueing more work at it would queue doomed
    work.  Retry after the cooldown (the breaker then admits a half-open
    probe)."""


class ResultCorruptionError(ArithmeticError):
    """A computed result failed the integrity gate (non-finite values where
    finite ones are promised): the typed form of silent corruption, raised
    so the retry policy can act instead of a wrong answer reaching a
    caller."""


class CapacityExceededError(MemoryError):
    """A resident-bytes budget refused an admission: the requested
    residency does not fit under the :class:`~..obs.capacity.
    CapacityBudget` ceiling and nothing evictable is left (everything is
    pinned).  Raised at submit, before any device launch, so an
    over-budget ``invert(resident=True)`` is a typed answer, never an
    out-of-memory error mid-launch.  Evict or unpin a handle
    (``HandleStore.evict``/``unpin``), or raise the budget, and retry."""


class ResidualGateError(ArithmeticError):
    """The degradation ladder exhausted every rung (refine, then the
    escalated re-solve) without the residual gate passing: surfaced typed
    instead of returning a known-bad inverse."""

    def __init__(self, msg: str, recovery: tuple = ()):
        super().__init__(msg)
        self.recovery = recovery


def is_transient(e: Exception) -> bool:
    """Transient = a transport exception type carrying one of the
    documented-transient message markers (both required)."""
    if not any(s in str(e) for s in _RETRYABLE):
        return False
    return isinstance(e, (OSError, ConnectionError, TimeoutError))


def retryable(e: Exception) -> bool:
    """The default RetryPolicy classifier: the transient transport class
    plus detected result corruption (a re-run clears transient corruption;
    persistent corruption exhausts the budget and surfaces typed)."""
    return isinstance(e, ResultCorruptionError) or is_transient(e)


def _jitter_fraction(attempt: int) -> float:
    """Deterministic jitter in [0, 1): a Weyl sequence over the attempt
    index (golden-ratio multiplier)."""
    return (attempt * 0.6180339887498949) % 1.0


@dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff and deterministic jitter.

    ``call(fn)`` runs ``fn`` up to ``1 + max_retries`` times; an exception
    the ``classify`` predicate rejects propagates immediately (an accuracy
    error must never be retried into a pass).  The delay before retry k
    (0-based) is ``min(max_backoff_s, backoff_s * multiplier**k)``,
    stretched by up to ``jitter_pct`` percent of itself.
    """

    max_retries: int = 1
    backoff_s: float = 0.0
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter_pct: float = 10.0
    classify: Any = None          # predicate(exc) -> bool; None = retryable
    sleep: Any = None             # injectable; None = time.sleep

    def delay_s(self, attempt: int) -> float:
        """The deterministic pre-retry delay for 0-based ``attempt``."""
        base = min(self.max_backoff_s,
                   self.backoff_s * (self.multiplier ** attempt))
        return base * (1.0 + self.jitter_pct / 100.0
                       * _jitter_fraction(attempt))

    def call(self, fn, on_retry=None, component: str | None = None,
             exemplar: str | None = None):
        """Run ``fn()`` under the policy.  ``on_retry(exc, attempt)``
        (optional) runs before each re-attempt: the hook a caller uses to
        rebuild its input.  ``component`` labels the retry counter and the
        ``retry`` events ("default" when None).  ``exemplar`` is an
        affected request id, attached to the retry counter's series and to
        the ``retry`` events (the serving dispatcher passes one rider of
        the batch)."""
        classify = self.classify if self.classify is not None else retryable
        sleep = self.sleep if self.sleep is not None else time.sleep
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:              # noqa: BLE001
                if attempt >= self.max_retries or not classify(e):
                    raise
                label = component or "default"
                _M_RETRIES.inc(component=label, exemplar=exemplar)
                _recorder.record("retry", component=label, attempt=attempt,
                                 error=type(e).__name__,
                                 **({"request_id": exemplar}
                                    if exemplar else {}))
                delay = self.delay_s(attempt)
                if delay > 0:
                    sleep(delay)
                if on_retry is not None:
                    on_retry(e, attempt)
                attempt += 1


#: The one-shot contract of the measurement core: one retry, no backoff,
#: strict transient classification only.
_ONE_SHOT = RetryPolicy(max_retries=1, backoff_s=0.0, classify=is_transient)


def retry_transient(fn):
    """Run ``fn()`` with one retry on the documented-transient failure
    class (:func:`is_transient`).  Anything else, an accuracy or
    singularity error included, is a real result and propagates at
    once."""
    return _ONE_SHOT.call(fn, component="measure")


class CircuitBreaker:
    """Per-resource circuit breaker (each serving lane holds one).

    closed --K consecutive failures--> open --cooldown--> half-open
    --probe success--> closed; --probe failure--> open again.

    ``allow()`` is the admission check (False: fast-fail with
    :class:`CircuitOpenError` at the call site); ``record_success`` and
    ``record_failure`` are the outcome feedback.  ``clock`` is any zero-arg
    monotonic callable (tests inject a fake one)."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    _GAUGE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}

    def __init__(self, failures: int = 3, cooldown_s: float = 5.0,
                 clock=None, name: str = ""):
        if failures < 1:
            raise ValueError("failures must be >= 1")
        self.failures = int(failures)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock if clock is not None else time.monotonic
        self.name = str(name)
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._export()

    def _export(self):
        _M_BREAKER_STATE.set(self._GAUGE[self._state], breaker=self.name)

    @property
    def state(self) -> str:
        """The state, reading an open breaker past its cooldown as
        half-open even before an ``allow()`` flipped it."""
        with self._lock:
            if (self._state == self.OPEN
                    and self.clock() - self._opened_at >= self.cooldown_s):
                return self.HALF_OPEN
            return self._state

    def allow(self) -> bool:
        """Admission check; flips open -> half-open once the cooldown has
        elapsed (the next admitted request is the probe)."""
        with self._lock:
            if self._state == self.OPEN:
                if self.clock() - self._opened_at < self.cooldown_s:
                    return False
                self._state = self.HALF_OPEN
                self._export()
                _recorder.record("breaker_transition", breaker=self.name,
                                 state=self.HALF_OPEN)
            return True

    def _open(self):
        self._state = self.OPEN
        self._opened_at = self.clock()
        self._consecutive = 0
        self._export()
        _M_BREAKER_OPEN.inc(breaker=self.name)
        _recorder.record("breaker_transition", breaker=self.name,
                         state=self.OPEN)

    def record_success(self) -> None:
        with self._lock:
            transitioned = self._state != self.CLOSED
            self._state = self.CLOSED
            self._consecutive = 0
            self._export()
        if transitioned:
            # Only transitions are events: a success on every healthy batch
            # would evict the events that matter from the ring.
            _recorder.record("breaker_transition", breaker=self.name,
                             state=self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._open()                 # a failed probe: straight back
                return
            self._consecutive += 1
            if (self._state == self.CLOSED
                    and self._consecutive >= self.failures):
                self._open()


@dataclass
class ResiliencePolicy:
    """The umbrella policy ``solve(policy=)`` takes.

    Retry: ``retry`` (a :class:`RetryPolicy`) wraps the engine call.

    Residual gate / degradation ladder (``resilience/degrade.py``): a
    result whose ``rel_residual`` exceeds ``gate_tol * eps * n * kappa``
    (eps of ``gate_dtype`` when set, else of the solve's own result dtype;
    NaN always fails; capped at 0.5) escalates: ``refine_steps`` of
    Newton–Schulz refinement first, then (``escalate=True``) an fp32
    re-solve, each rung recorded on ``SolveResult.recovery``.  A ladder
    that exhausts without passing raises :class:`ResidualGateError`.

    Breaker (serving): ``breaker_failures`` consecutive terminal executor
    failures open a lane's :class:`CircuitBreaker` for
    ``breaker_cooldown_s``.
    """

    retry: RetryPolicy = field(default_factory=RetryPolicy)
    gate_tol: float = 16.0
    gate_dtype: Any = None
    refine_steps: int = 2
    escalate: bool = True
    breaker_failures: int = 3
    breaker_cooldown_s: float = 5.0


#: The defaults when no policy is passed where one is required (and the
#: service's default): two retries with a short capped backoff, the standard
#: gate, K=3 breaker.
DEFAULT_POLICY = ResiliencePolicy(
    retry=RetryPolicy(max_retries=2, backoff_s=0.01, max_backoff_s=0.25))
