"""Serving: a dynamic-batching inversion, solve and update service on one
card.  Counterpart of the JAX package's ``serve/`` (ROADMAP.md Queue A
items 14a and 14b; the mesh lanes are item 15, ``update_demo`` item 14d;
the replica fleet over these services is ``tpu_jordan_torch.fleet``):

  * ``executors``: requests round up to power-of-two n-buckets (exact by
    identity padding); one executor per (bucket, batch_cap, dtype, engine,
    block size, workload, rhs bucket), built at most once, its engine
    resolved through the tuner's plan cache at a batched point.
  * ``batcher``: the micro-batcher: same-lane requests group up to
    ``batch_cap`` or a ``max_wait_ms`` deadline on one dispatcher thread,
    run through the batched engines, and fan per-element results back to
    per-request futures; retries, the integrity gate, deadlines and
    per-lane circuit breakers under a ``ResiliencePolicy``.
  * ``handles``: the resident (A, A⁻¹) pairs on the device
    (:class:`HandleStore`, per-handle transactions, the capacity budget's
    LRU eviction and typed refusal); the update lanes of ``batcher`` apply
    rank-k SMW updates to them, one per launch or a batch of distinct
    handles in one.
  * ``service``: :class:`JordanService` (``submit(a)``, ``submit(a, b)``,
    ``invert`` with ``resident=True``, ``update``/``submit_update``,
    ``solve_system``, ``project_capacity``, warmup, draining close),
    ``serve_demo`` and ``chaos_demo`` (the CLI's ``--serve-demo`` and
    ``--chaos-demo``; ``--capacity-demo`` is ``obs.capacity``'s).
  * ``stats``: per-lane counters and latency percentiles, and the
    fleet's cross-replica execute spread.
"""

from ..resilience.policy import (CircuitOpenError, DeadlineExceededError,
                                 ResultCorruptionError)
from ..resilience.policy import CapacityExceededError
from .batcher import (InvertResult, MicroBatcher, MixedUpdateBatchError,
                      ServiceClosedError, ServiceOverloadedError)
from .executors import (MIN_BUCKET_N, MIN_UPDATE_K, BucketExecutor,
                        ExecutorCache, ExecutorKey, ExecutorStore,
                        bucket_for, k_bucket_for, lane_label,
                        projected_lane_bytes, rhs_bucket_for)
from .handles import (HandleRef, HandleState, HandleStore,
                      UnknownHandleError, build_handle_store,
                      create_resident_handle, resident_handle_bytes)
from .service import (JordanService, chaos_demo, compare_outcomes,
                      serve_demo)
from .stats import ServeStats, cross_replica_spread

__all__ = [
    "InvertResult", "MicroBatcher", "MixedUpdateBatchError",
    "ServiceClosedError", "ServiceOverloadedError",
    "CapacityExceededError", "CircuitOpenError", "DeadlineExceededError",
    "ResultCorruptionError",
    "HandleRef", "HandleState", "HandleStore", "UnknownHandleError",
    "build_handle_store", "create_resident_handle",
    "resident_handle_bytes",
    "MIN_BUCKET_N", "MIN_UPDATE_K", "BucketExecutor", "ExecutorCache",
    "ExecutorKey", "ExecutorStore", "bucket_for", "k_bucket_for",
    "lane_label", "projected_lane_bytes", "rhs_bucket_for",
    "JordanService", "chaos_demo", "compare_outcomes", "serve_demo",
    "ServeStats", "cross_replica_spread",
]
