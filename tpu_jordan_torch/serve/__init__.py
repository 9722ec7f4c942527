"""Serving: a dynamic-batching inversion and solve service on one card.
Counterpart of the JAX package's ``serve/`` core (ROADMAP.md Queue A item
14a; the resident handles and update lanes are item 14b, the mesh lanes
item 15):

  * ``executors``: requests round up to power-of-two n-buckets (exact by
    identity padding); one executor per (bucket, batch_cap, dtype, engine,
    block size, workload, rhs bucket), built at most once, its engine
    resolved through the tuner's plan cache at a batched point.
  * ``batcher``: the micro-batcher: same-lane requests group up to
    ``batch_cap`` or a ``max_wait_ms`` deadline on one dispatcher thread,
    run through the batched engines, and fan per-element results back to
    per-request futures; retries, the integrity gate, deadlines and
    per-lane circuit breakers under a ``ResiliencePolicy``.
  * ``service``: :class:`JordanService` (``submit(a)``, ``submit(a, b)``,
    ``invert``, ``solve_system``, warmup, draining close), ``serve_demo``
    and ``chaos_demo`` (the CLI's ``--serve-demo`` and ``--chaos-demo``).
  * ``stats``: per-lane counters and latency percentiles.
"""

from ..resilience.policy import (CircuitOpenError, DeadlineExceededError,
                                 ResultCorruptionError)
from .batcher import (InvertResult, MicroBatcher, ServiceClosedError,
                      ServiceOverloadedError)
from .executors import (MIN_BUCKET_N, MIN_UPDATE_K, BucketExecutor,
                        ExecutorCache, ExecutorKey, ExecutorStore,
                        bucket_for, k_bucket_for, lane_label,
                        projected_lane_bytes, rhs_bucket_for)
from .service import (JordanService, chaos_demo, compare_outcomes,
                      serve_demo)
from .stats import ServeStats

__all__ = [
    "InvertResult", "MicroBatcher", "ServiceClosedError",
    "ServiceOverloadedError",
    "CircuitOpenError", "DeadlineExceededError", "ResultCorruptionError",
    "MIN_BUCKET_N", "MIN_UPDATE_K", "BucketExecutor", "ExecutorCache",
    "ExecutorKey", "ExecutorStore", "bucket_for", "k_bucket_for",
    "lane_label", "projected_lane_bytes", "rhs_bucket_for",
    "JordanService", "chaos_demo", "compare_outcomes", "serve_demo",
    "ServeStats",
]
