"""The residual gate, its degradation ladder and the retry policy of the
solve path (the part of the JAX package's ``resilience/`` that a single
solve uses)."""

from .degrade import (
    backward_error,
    gate_eps,
    gate_passes,
    gate_threshold,
    maybe_recover,
    solve_gate_threshold,
    solve_recover,
)
from .policy import (
    DEFAULT_POLICY,
    ResidualGateError,
    ResiliencePolicy,
    ResultCorruptionError,
    RetryPolicy,
    is_transient,
    retryable,
)

__all__ = ["DEFAULT_POLICY", "ResidualGateError", "ResiliencePolicy",
           "ResultCorruptionError", "RetryPolicy", "backward_error",
           "gate_eps", "gate_passes", "gate_threshold", "is_transient",
           "maybe_recover", "retryable", "solve_gate_threshold",
           "solve_recover"]
