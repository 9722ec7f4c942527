"""The shape-bucketed executor cache.  Counterpart of the JAX package's
``serve/executors.py``, with its mesh lanes (``meshlanes.py``).

Requests are rounded UP to power-of-two n-buckets (:func:`bucket_for`);
identity padding makes the rounding exact (``ops/padding.py``: the padded
inverse is [[A⁻¹, 0], [0, I]]).  Each (bucket_n, batch_cap, dtype, engine,
block size, workload, rhs bucket) key gets ONE :class:`BucketExecutor`,
built at most once and reused for every batch of its lane.

The engine of a lane resolves through the tuner (``tuning/``) at a batched
tuning point (``TunePoint.create(..., batch=batch_cap)``; plan-cache keys
carry a ``|b<cap>`` segment), so a warm server performs zero measurements
and zero builds on the request path; both are counted (``Tuner.
measurements``, the per-lane ``compiles`` stat).

A lane's run does the whole batch job: the padded stack through the batched
engine, then the per-element accuracy (``driver.batch_metrics``,
``linalg.solve_batch_metrics``) on the device, so the batcher fans κ∞ and
rel_residual to every rider from the same launch sequence.  An update lane
(workload ``"update"``, engine ``smw_update``) applies rank-k SMW updates to
resident pairs and re-verifies each against its mutated matrix
(``linalg.update``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from ..config import default_block_size
from ..errors import UsageError
from ..interop import resolve_device, resolve_dtype
from ..obs import hwcost as _hwcost
from ..obs.spans import NULL
from ..resilience import faults as _faults
from ..resilience.policy import CircuitBreaker
from ..tuning.plan_cache import PlanCache, n_bucket
from ..tuning.registry import TunePoint
from ..tuning.tuner import Tuner

#: The smallest bucket served: sub-64 matrices invert exactly, identity
#: padded to 64; a finer ladder would multiply executors for launch-bound
#: work.
MIN_BUCKET_N = 64


def bucket_for(n: int, floor: int = MIN_BUCKET_N) -> int:
    """A request size rounded up to its bucket: the next power of two (the
    plan cache's ``n_bucket``), at least ``floor``."""
    if n <= 0:
        raise ValueError(f"matrix dimension must be positive, got {n}")
    return max(floor, n_bucket(n))


def rhs_bucket_for(k: int) -> int:
    """A solve request's RHS width rounded up to its lane bucket: the next
    power of two, at least 1; the one rounding ``submit`` and
    ``warmup(solve_shapes=)`` share.  Exact: zero pad columns solve to
    zero and are sliced off."""
    if k <= 0:
        raise ValueError(f"rhs width must be positive, got {k}")
    return 1 << max(0, int(k - 1).bit_length())


#: The smallest update-lane rank bucket: a smaller rank updates exactly,
#: zero-padded to 8 (the rounding is shared with the solve lanes).
MIN_UPDATE_K = 8


def k_bucket_for(k: int, floor: int = MIN_UPDATE_K) -> int:
    """An update's rank rounded up to its lane bucket: the solve lanes'
    rounding, at least ``floor``."""
    if k <= 0:
        raise ValueError(f"update rank must be positive, got {k}")
    return max(floor, rhs_bucket_for(k))


@dataclass(frozen=True)
class ExecutorKey:
    """What a lane's executor depends on: bucket, batch capacity, dtype,
    the RESOLVED engine (never "auto"), the pivot block size, and for solve
    lanes the workload and the RHS bucket.  ``mesh`` is the topology axis:
    ``"single"`` for every single-device lane, or a topology label
    (``"p4"``, ``"2x2"``) selecting a mesh lane (``meshlanes.py``);
    distinct topologies of one bucket are distinct executors, stats rows
    and capacity entries."""

    bucket_n: int
    batch_cap: int
    dtype: str
    engine: str
    block_size: int
    workload: str = "invert"
    rhs: int = 0                  # RHS-width bucket (solve lanes only)
    mesh: str = "single"


def lane_label(workload: str, bucket_n: int, batch_cap: int,
               rhs: int = 0, mesh: str = "single") -> str:
    """The capacity-ledger label of one lane: workload, bucket, batch
    capacity, the k-bucket off the invert lanes, the topology off the
    single-device default."""
    base = f"{workload}:{bucket_n}:b{batch_cap}"
    if workload != "invert":
        base = f"{base}:k{rhs}"
    return base if mesh == "single" else f"{base}@{mesh}"


def projected_lane_bytes(bucket_n: int, batch_cap: int, dtype,
                         workload: str = "invert", rhs: int = 0,
                         devices: int = 1) -> int:
    """A lane's argument + output bytes, computable before its build: the
    padded stack, the RHS and solution stacks of a solve lane, the
    per-element flags, κ∞ and rel_residual.  ``devices`` divides the
    O(n²) terms (a mesh lane's per-device share).  The values of the JAX
    package's projection, the item size from the torch dtype."""
    it = torch.empty((), dtype=resolve_dtype(dtype)).element_size()
    n2 = -(-bucket_n * bucket_n // max(1, int(devices)))
    cap, k = int(batch_cap), int(rhs)
    per_elem_out = 1 + 2 * it         # singular flag + kappa + rel
    if workload == "invert":
        args = cap * n2 * it + cap * 4
        outs = cap * n2 * it + cap * per_elem_out
    elif workload == "update":
        args = cap * (2 * n2 + 2 * bucket_n * k) * it + cap * 4
        outs = cap * 2 * n2 * it + cap * per_elem_out
    else:                             # solve lanes
        args = cap * n2 * it + cap * bucket_n * k * it + cap * 4
        outs = cap * bucket_n * k * it + cap * per_elem_out
    return int(args + outs)


def _load_probe_library(m: int, dtype: torch.dtype) -> None:
    """Load (building if need be) the CUDA library the probe of block size
    ``m`` and ``dtype`` launches (``ops.gj_probe.probe_body``)."""
    from ..ops import gj_fused_panel, gj_probe

    if gj_probe.probe_body(m, dtype) == "gj_probe_fused_panel":
        gj_fused_panel._lib()
    else:
        gj_probe._lib()


class BucketExecutor:
    """One lane's executor: the port's stand-in for the JAX package's AOT
    executable.

    Its build fires the ``compile`` fault point where the JAX build
    compiles, resolves the lane's callable, and on the card loads (through
    ``_build.load``) the CUDA library the lane's block size routes the
    probe to.  It does no device arithmetic: the JAX build compiles from
    shapes alone, with no batch materialized, and so does this one.  A
    CUDA graph of a lane is performance work (ROADMAP.md Queue B), not
    part of the build.

    ``run(stacked, n_real)`` (invert lanes) or ``run(stacked_a, stacked_b,
    n_real)`` (solve lanes) takes the identity-padded (batch_cap, N, N)
    stack (and the zero-padded (batch_cap, N, rhs) RHS stack) on the
    lane's device and returns device tensors: (inverses or solutions,
    singular flags, κ∞, rel_residual).  An update lane's ``run(a, inv, u,
    v, n_real)`` takes (batch_cap, N, N) pair stacks and (batch_cap, N, K)
    factor stacks and returns (a_new, inv_new, singular, κ∞,
    rel_residual).  It never writes its inputs, so a retry
    re-runs on the same stacks.

    Departure from the JAX package: the ``grouped`` and ``augmented``
    invert lanes run their single-matrix engines element by element (the
    pivots the JAX ``vmap`` gives, B engine runs in place of one), where
    ``inplace``/``auto`` runs the batched engine's one probe call a
    superstep for the whole stack."""

    def __init__(self, key: ExecutorKey, plan, device: torch.device):
        self.key = key
        self.block_size = key.block_size
        self.plan = plan          # tuning.Plan (None for explicit engines)
        self.device = device
        self._fn = self._build()
        # The compiler's accounting of the JAX executable: eager PyTorch
        # has none (hwcost.UNAVAILABLE).
        self.cost = _hwcost.executable_cost()

    def _build(self):
        _faults.fire("compile")
        key = self.key
        dtype = resolve_dtype(key.dtype)
        if key.workload == "update":
            fn = self._update_fn()
            # The capacitance solve's probe (k bucket rows, its default
            # block size) is what an update launches.
            m = min(default_block_size(key.rhs), key.rhs)
        else:
            fn = (self._invert_fn(dtype) if key.workload == "invert"
                  else self._solve_fn())
            m = key.block_size
        if self.device.type == "cuda":
            _load_probe_library(m, dtype)
        return fn

    def _invert_fn(self, dtype):
        from ..driver import batch_metrics
        from ..ops import (batched_jordan_invert, block_jordan_invert,
                           block_jordan_invert_inplace_grouped)

        key = self.key
        m = key.block_size
        if dtype.is_complex:
            raise UsageError(
                "complex dtypes are served on the solve lanes (submit(a, b) "
                "— linalg.block_jordan_solve is complex-native); the "
                "batched invert engines are real-dtype")
        if key.engine in ("inplace", "auto"):
            def invert(a):
                return batched_jordan_invert(a, block_size=m)
        elif key.engine in ("grouped", "augmented"):
            def one(x):
                if key.engine == "grouped":
                    return block_jordan_invert_inplace_grouped(
                        x, block_size=m, group=2)
                return block_jordan_invert(x, block_size=m)

            def invert(a):
                outs = [one(x) for x in a]
                return (torch.stack([o[0] for o in outs]),
                        torch.stack([o[1] for o in outs]))
        else:
            raise UsageError(
                f"engine {key.engine!r} is not servable on a single device "
                f"(the service batches on one card: inplace, grouped, "
                f"augmented)")

        def fn(a, n_real):
            inv, sing = invert(a)
            met = batch_metrics(a, inv, n_real)
            return inv, sing, met["kappa"], met["rel_residual"]

        return fn

    def _solve_fn(self):
        from ..linalg.engine import (block_jordan_solve_batched,
                                     solve_batch_metrics)

        key = self.key
        if key.engine not in ("solve_aug", "solve_spd"):
            raise UsageError(
                f"engine {key.engine!r} is not a solve-lane engine "
                f"(solve_aug/solve_spd)")
        m, spd = key.block_size, key.engine == "solve_spd"

        def fn(a, b, n_real):
            x, sing = block_jordan_solve_batched(a, b, block_size=m, spd=spd)
            met = solve_batch_metrics(a, x, b, n_real)
            return x, sing, met["kappa_est"], met["rel_residual"]

        return fn

    def _update_fn(self):
        """The update lane: SMW rank-k updates of a (batch_cap, N, N)
        stack of distinct pairs, re-verified against the mutated matrices
        (``smw_update_batched_with_metrics``: one capacitance probe call a
        superstep for the stack, where the JAX package maps the single
        update over the batch)."""
        from ..linalg.update import smw_update_batched_with_metrics

        if self.key.engine != "smw_update":
            raise UsageError(
                f"engine {self.key.engine!r} is not an update-lane engine "
                f"(smw_update is the one registered update engine)")
        return smw_update_batched_with_metrics

    def run(self, *args):
        return self._fn(*args)

    def inert_args(self) -> tuple:
        """The lane's arguments with every slot an inert filler, on its
        device: identity matrices, zero right-hand sides and factors,
        n_real 0 (what the empty slots of a partial batch hold)."""
        key, dev = self.key, self.device
        dtype = resolve_dtype(key.dtype)
        cap, n = key.batch_cap, key.bucket_n
        eye = torch.eye(n, dtype=dtype).repeat(cap, 1, 1).to(dev)
        n_real = torch.zeros((cap,), dtype=torch.int64, device=dev)
        if key.workload == "invert":
            return eye, n_real
        zeros = torch.zeros((cap, n, key.rhs), dtype=dtype, device=dev)
        if key.workload == "update":
            return eye, eye.clone(), zeros, zeros.clone(), n_real
        return eye, zeros, n_real

    def warm(self) -> None:
        """One run on :meth:`inert_args`, its flags and numbers read back
        to the host as a served batch reads them: the calling thread pays
        its first launches of the lane here, not on a request."""
        out = self.run(*self.inert_args())
        for t in out[-3:]:
            t.cpu()


class ExecutorStore:
    """A thread-safe home for built :class:`BucketExecutor` objects that
    several caches may share (the fleet's replicas): an executor
    is built at most once per key across them.  ``get_or_build`` serializes
    builds on a per-key lock, so builds of different keys proceed
    concurrently; a failed build installs nothing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._executors: dict[ExecutorKey, BucketExecutor] = {}
        self._building: dict[ExecutorKey, threading.Lock] = {}

    def get_or_build(self, key: ExecutorKey, build):
        """``(executor, built)``: the stored executor (``built=False``), or
        the result of ``build()`` installed under the key's lock."""
        with self._lock:
            ex = self._executors.get(key)
            if ex is not None:
                return ex, False
            key_lock = self._building.setdefault(key, threading.Lock())
        with key_lock:
            with self._lock:
                ex = self._executors.get(key)
                if ex is not None:      # a racing builder won
                    return ex, False
            ex = build()
            with self._lock:
                self._executors[key] = ex
            self._meter(key)
            return ex, True

    def entries(self):
        """[(key, executor)] of every built executor."""
        with self._lock:
            return list(self._executors.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._executors)

    def _meter(self, key: ExecutorKey) -> None:
        """One ``executor_lanes`` capacity entry per executor, at its
        projected argument + output bytes (labeled ``projected``: no
        compiler reports a footprint here)."""
        from ..obs import capacity as _capacity

        devices = 1
        if key.mesh != "single":
            from .meshlanes import mesh_devices, parse_mesh

            devices = mesh_devices(parse_mesh(key.mesh))
        nbytes = projected_lane_bytes(key.bucket_n, key.batch_cap,
                                      key.dtype, key.workload, key.rhs,
                                      devices=devices)
        label = lane_label(key.workload, key.bucket_n, key.batch_cap,
                           key.rhs, key.mesh)
        _capacity.register("executor_lanes", (id(self), key), nbytes,
                           detail=f"{label}:projected")



class ExecutorCache:
    """The service's executor cache: ``get()`` builds at most once per key
    (``compiles``/``cache_hits`` counted per lane in ``ServeStats``) and
    resolves a lane's engine through the tuner, plan cache first, cost
    ranking otherwise, at a batched tuning point on the cache's device.

    ``policy`` drives the build's retry (component ``serve.compile``) and
    sizes the per-lane circuit breakers the batcher consults.  ``store`` is
    an optional
    shared :class:`ExecutorStore`; breakers, stats and plan resolution stay
    per cache.  ``plan_cache`` is a path or a loaded ``PlanCache``;
    ``plan_cache_read_only`` opens a path frozen."""

    def __init__(self, engine: str = "auto", plan_cache=None,
                 dtype=torch.float32, device=None, stats=None,
                 telemetry=None, policy=None,
                 store: ExecutorStore | None = None,
                 plan_cache_read_only: bool = False):
        from ..driver import resolve_engine

        self.engine, self.group = resolve_engine(engine, 0)
        self.dtype = str(resolve_dtype(dtype)).removeprefix("torch.")
        self.device = resolve_device(device)
        self.stats = stats
        self.policy = policy
        self._breakers: dict = {}
        # Builds are "compile" spans, so a warm server's trace has none.
        self._tel = telemetry if telemetry is not None else NULL
        self._lock = threading.Lock()
        self._store = store if store is not None else ExecutorStore()
        #: this cache's own view of the executors it resolved.
        self._executors: dict[ExecutorKey, BucketExecutor] = {}
        #: (engine, plan) per (bucket, cap, m, workload): resolution cannot
        #: change for the cache's life, so dispatch never re-walks it.
        self._resolved: dict[tuple, tuple] = {}
        if isinstance(plan_cache, PlanCache):
            cache = plan_cache
        else:
            cache = (PlanCache.load(plan_cache,
                                    read_only=plan_cache_read_only)
                     if plan_cache else None)
        self.tuner = Tuner(cache=cache)

    def breaker(self, lane) -> CircuitBreaker | None:
        """The lane's breaker (made on demand; None without a policy)."""
        if self.policy is None:
            return None
        with self._lock:
            br = self._breakers.get(lane)
            if br is None:
                br = self._breakers[lane] = CircuitBreaker(
                    failures=self.policy.breaker_failures,
                    cooldown_s=self.policy.breaker_cooldown_s,
                    name=f"serve_bucket_{lane}")
            return br

    def breaker_states(self) -> dict:
        with self._lock:
            return {b: br.state for b, br in self._breakers.items()}

    @property
    def measurements(self) -> int:
        """The tuner's measurement counter (0 on the cost-only ladder)."""
        return self.tuner.measurements

    def _resolve(self, bucket_n: int, batch_cap: int, block_size: int,
                 workload: str, mesh: str = "single"):
        """(engine, plan) of a lane: an explicit invert engine as given,
        else the tuner's ladder at the batched, workload-scoped point (a
        service with an explicit invert engine still resolves its solve
        and update lanes through the ladder; ``smw_update`` is the one
        update engine).  A mesh lane always resolves through the ladder
        at its distributed point (the plan-cache key carries the
        topology): a single-device engine is not a distributed
        vocabulary."""
        if mesh != "single":
            from .meshlanes import normalize_mesh

            point = TunePoint.create(
                bucket_n, block_size, self.dtype,
                workers=normalize_mesh(mesh, self.device.type), gather=True,
                batch=1, workload=workload, device=self.device)
            plan = self.tuner.select(point)
            return plan.engine, plan
        if self.engine != "auto" and workload == "invert":
            return self.engine, None
        point = TunePoint.create(bucket_n, block_size, self.dtype,
                                 workers=1, gather=True, batch=batch_cap,
                                 workload=workload, device=self.device)
        plan = self.tuner.select(point)
        return plan.engine, plan

    def get(self, bucket_n: int, batch_cap: int,
            block_size: int | None = None, workload: str = "invert",
            rhs: int = 0) -> BucketExecutor:
        """The executor of a lane: built at first use, a cache hit after."""
        return self.get_info(bucket_n, batch_cap, block_size,
                             workload=workload, rhs=rhs)[0]

    def get_info(self, bucket_n: int, batch_cap: int,
                 block_size: int | None = None, workload: str = "invert",
                 rhs: int = 0, mesh: str = "single"
                 ) -> tuple[BucketExecutor, str]:
        """``get`` and how the executor was obtained: ``"cached"`` (this
        cache's view), ``"shared_store"`` (another cache built it) or
        ``"compiled"`` (this call built it); the dispatcher stamps it on
        each rider's journey.  ``mesh`` selects a mesh lane (always
        ``batch_cap=1``: one world of ranks a launch)."""
        if mesh != "single":
            batch_cap = 1
        m = min(block_size if block_size is not None
                else default_block_size(bucket_n), bucket_n)
        with self._lock:
            rkey = (bucket_n, batch_cap, m, workload, mesh)
            if rkey not in self._resolved:
                self._resolved[rkey] = self._resolve(bucket_n, batch_cap, m,
                                                     workload, mesh)
            engine, plan = self._resolved[rkey]
            key = ExecutorKey(bucket_n, batch_cap, self.dtype, engine, m,
                              workload, rhs, mesh)
            ex = self._executors.get(key)
        # Invert lanes are labeled by the bare bucket, solve and update
        # lanes by "<workload>:<bucket>:k<rhs>", so their builds never
        # count as an invert bucket's.
        label = (bucket_n if workload == "invert"
                 else f"{workload}:{bucket_n}:k{rhs}")
        if mesh != "single":
            label = f"{label}@{mesh}"
        if ex is not None:
            if self.stats is not None:
                self.stats.cache_hit(label, workload=workload)
            return ex, "cached"

        def build():
            # The compile span wraps the real build only; a transient
            # build failure (the `compile` fault point) is retried per the
            # policy, a terminal one reaches the caller (the dispatcher
            # fans it to the batch's riders).
            with self._tel.span("compile", bucket=bucket_n, engine=engine,
                                batch_cap=batch_cap, mesh=mesh):
                def one():
                    if mesh != "single":
                        from .meshlanes import MeshLaneExecutor

                        return MeshLaneExecutor(key, plan, self.device)
                    return BucketExecutor(key, plan, self.device)
                return (self.policy.retry.call(
                            one, component="serve.compile")
                        if self.policy is not None else one())

        # The wait on the store's per-key build happens outside this
        # cache's lock, so one slow build never stalls the warm lanes.
        ex, built = self._store.get_or_build(key, build)
        with self._lock:
            self._executors[key] = ex
        if self.stats is not None:
            if built:
                self.stats.compile(label, workload=workload)
            else:
                self.stats.cache_hit(label, workload=workload)
            self.stats.executable_cost(label, ex.cost)
        return ex, ("compiled" if built else "shared_store")

    def entries(self):
        with self._lock:
            return list(self._executors.items())
