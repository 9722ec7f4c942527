"""The resilience layer of the single-device path: the residual gate, its
degradation ladder and the retry policy (``degrade.py``, ``policy.py``),
the deterministic fault points (``faults.py``) and superstep
checkpoint/resume (``checkpoint.py``), and the serving pieces: typed
deadlines and the circuit breaker (``policy.py``).  Counterpart of the JAX
package's ``resilience/``."""

from . import faults
from .checkpoint import (
    CheckpointCorruptError,
    CheckpointError,
    CheckpointKey,
    CheckpointMismatchError,
    CheckpointNotFoundError,
    CheckpointStore,
    CheckpointUnsupportedError,
    PreemptedError,
    checkpointed_invert,
    checkpointed_solve,
    fingerprint,
)
from .degrade import (
    backward_error,
    gate_eps,
    gate_passes,
    gate_threshold,
    maybe_recover,
    solve_gate_threshold,
    solve_recover,
)
from .faults import (
    FaultPlan,
    FaultSpec,
    InjectedFaultError,
    InjectedTransientError,
    activate,
)
from .policy import (
    DEFAULT_POLICY,
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    ResidualGateError,
    ResiliencePolicy,
    ResultCorruptionError,
    RetryPolicy,
    is_transient,
    retry_transient,
    retryable,
)

__all__ = ["CheckpointCorruptError", "CheckpointError", "CheckpointKey",
           "CheckpointMismatchError", "CheckpointNotFoundError",
           "CheckpointStore", "CheckpointUnsupportedError",
           "CircuitBreaker", "CircuitOpenError", "DeadlineExceededError",
           "DEFAULT_POLICY", "FaultPlan", "FaultSpec", "InjectedFaultError",
           "InjectedTransientError", "PreemptedError", "ResidualGateError",
           "ResiliencePolicy", "ResultCorruptionError", "RetryPolicy",
           "activate", "backward_error", "checkpointed_invert",
           "checkpointed_solve", "faults", "fingerprint", "gate_eps",
           "gate_passes", "gate_threshold", "is_transient", "maybe_recover",
           "retry_transient", "retryable", "solve_gate_threshold",
           "solve_recover"]
