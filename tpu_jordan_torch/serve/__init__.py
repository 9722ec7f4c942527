"""Serving: a dynamic-batching inversion, solve and update service on one
card, with mesh lanes on persistent worlds of ranks.  Counterpart of the
JAX package's ``serve/`` (the replica fleet over these services is
``tpu_jordan_torch.fleet``):

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
  * ``meshlanes``: the mesh lanes (:class:`MeshLaneExecutor`: one
    persistent world of ranks a (workload, bucket, dtype, mesh) lane), the
    topology vocabulary and the placement rule;
  * ``stats``: per-lane counters and latency percentiles, and the
    fleet's cross-replica execute spread;
  * ``update_demo``: the ``--update-demo`` run (a service's update ledger,
    warm update against re-invert, a fleet's kills against the replay),
    judged by ``tools/check_update.py``.
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
from .meshlanes import (MESH_SINGLE, MeshLaneExecutor, mesh_devices,
                        mesh_label, normalize_mesh, parse_mesh)
from .service import (JordanService, chaos_demo, compare_outcomes,
                      serve_demo)
from .stats import ServeStats, cross_replica_spread
from .update_demo import update_demo

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
    "MESH_SINGLE", "MeshLaneExecutor", "mesh_devices", "mesh_label",
    "normalize_mesh", "parse_mesh",
    "JordanService", "chaos_demo", "compare_outcomes", "serve_demo",
    "ServeStats", "cross_replica_spread", "update_demo",
]
