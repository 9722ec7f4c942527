"""Retry and the residual-gate knobs: what the solve path uses of the JAX
package's ``resilience/policy.py``.

  * :func:`is_transient` / :func:`retryable`: the typed transient classifier.
    A transport exception TYPE carrying a documented-transient message
    marker; both conditions are required, so an accuracy error that merely
    quotes a marker is never retried.  The JAX runtime error types have no
    counterpart here; the transport types and the markers stay.
  * :class:`RetryPolicy`: bounded retries with exponential backoff and
    deterministic jitter (a pure function of the attempt index), and
    :func:`retry_transient`, its one-shot form for the tuner's
    measurements.
  * :class:`ResiliencePolicy`: the umbrella ``solve(policy=)`` takes: retry,
    the residual gate and degradation ladder (``resilience/degrade.py``),
    and the breaker knobs, carried as data.

Every retry is counted in ``tpu_jordan_torch_retries_total`` (labeled by
component) and recorded as a ``retry`` flight-recorder event.  The circuit
breaker comes with the serving stack (ROADMAP.md Queue A item 14).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

from ..obs import metrics as _obs_metrics
from ..obs import recorder as _recorder

_M_RETRIES = _obs_metrics.counter(
    "tpu_jordan_torch_retries_total",
    "retries performed by RetryPolicy (transient failures and detected "
    "result corruption), labeled by component")

#: Documented-transient message markers.  Marker AND type are both required.
_RETRYABLE = ("INTERNAL", "remote_compile", "read body", "DEADLINE")


class ResultCorruptionError(ArithmeticError):
    """A computed result failed the integrity gate (non-finite values where
    finite ones are promised): the typed form of silent corruption, raised
    so the retry policy can act instead of a wrong answer reaching a
    caller."""


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

    def call(self, fn, on_retry=None, component: str | None = None):
        """Run ``fn()`` under the policy.  ``on_retry(exc, attempt)``
        (optional) runs before each re-attempt: the hook a caller uses to
        rebuild its input.  ``component`` labels the retry counter and the
        ``retry`` events ("default" when None).  The JAX package's request
        ``exemplar`` comes with the serving stack (ROADMAP.md Queue A item
        14)."""
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
                _M_RETRIES.inc(component=label)
                _recorder.record("retry", component=label, attempt=attempt,
                                 error=type(e).__name__)
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

    Breaker knobs (``breaker_failures``, ``breaker_cooldown_s``) are carried
    as data for the serving layer, which is not ported yet.
    """

    retry: RetryPolicy = field(default_factory=RetryPolicy)
    gate_tol: float = 16.0
    gate_dtype: Any = None
    refine_steps: int = 2
    escalate: bool = True
    breaker_failures: int = 3
    breaker_cooldown_s: float = 5.0


#: The defaults when no policy is passed where one is required: two retries
#: with a short capped backoff, the standard gate, K=3 breaker.
DEFAULT_POLICY = ResiliencePolicy(
    retry=RetryPolicy(max_retries=2, backoff_s=0.01, max_backoff_s=0.25))
