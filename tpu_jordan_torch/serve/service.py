"""``JordanService``: the serving surface, and the serve and chaos demos.
Counterpart of the JAX package's ``serve/service.py``, with its mesh lanes.

Callers ``submit()`` (n, n) matrices, or a matrix and right-hand sides, and
get futures.  Requests round up to power-of-two buckets (exact by identity
padding), are micro-batched per lane up to ``batch_cap`` or a
``max_wait_ms`` deadline, and run through lane executors built at most
once (``serve/executors.py``); a lane's engine rides the tuner's plan
cache, so a warm server performs zero measurements and zero builds.

  * **Admission control**: the queue is bounded (``max_queue``); a full
    queue raises :class:`ServiceOverloadedError` at submit.
  * **Warmup**: ``warmup(shapes=, solve_shapes=, update_shapes=)`` builds
    the lanes those requests land in, so the first request never pays a
    build; ``project_capacity`` gives each lane's bytes before any build.
  * **Resident handles**: ``invert(a, resident=True)`` keeps the (A, A⁻¹)
    pair on the device in the handle store (``handles.py``) and returns a
    ``HandleRef``; ``update(ref, u, v)`` applies a rank-k SMW update
    through the update lanes.  With ``handle_budget_bytes`` the store
    evicts least-recently-served unpinned handles to admit a new one, or
    refuses it with the typed ``CapacityExceededError`` at submit.
  * **Per-element verification**: every result carries κ∞ and
    rel_residual from its batch's run and its element's singular flag; a
    singular request never poisons its batch-mates.
  * **Mesh lanes** (``mesh_shapes`` with ``lane_budget_bytes``): a request
    whose single-device projection exceeds the per-device budget routes at
    submit to the smallest configured mesh whose per-rank share fits (a
    ``mesh_admitted`` hop), and one no mesh holds is a typed
    ``CapacityExceededError`` at submit.  A mesh lane runs on a
    persistent world of ranks (``meshlanes.py``).
  * **Clean shutdown**: ``close()`` (or the context manager) drains queued
    and in-flight work, and ends every mesh lane's world.
  * **Results** are torch tensors on the service's device (the card
    unless ``device="cpu"``).

The chaos demo classifies a response by the bytes of its inverse on the
host (``.cpu().numpy()``), so a chaos pass is held bit for bit against its
fault-free replay.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future

import numpy as np
import torch

from ..errors import SingularMatrixError, UsageError
from ..interop import resolve_device, resolve_dtype
from ..obs import metrics as _obs_metrics
from ..obs.journey import JourneyLog
from ..resilience.policy import DEFAULT_POLICY
from .batcher import InvertResult, MicroBatcher
from .executors import (ExecutorCache, bucket_for, k_bucket_for,
                        rhs_bucket_for)
from .handles import HandleRef
from .stats import ServeStats

_M_WARM_BATCHES = _obs_metrics.counter(
    "tpu_jordan_torch_serve_warm_batches_total",
    "inert batches run on a dispatcher thread by warmup(run=True), one a "
    "lane: their kernel launches are warmup's, no request's")


class JordanService:
    """A dynamic-batching inversion and solve service on one device.

    Args:
      engine: "auto" (resolved per lane through the tuner: plan cache, then
        cost ranking) or an explicit single-device invert engine
        ("inplace" | "grouped" | "augmented").
      plan_cache: a plan-cache path (or a loaded ``PlanCache``); batched
        keys carry a ``|b<cap>`` segment.
      dtype: storage dtype of requests and results.
      device: where the lanes run; None means the CUDA card
        (``interop.resolve_device``: without one, DeviceUnavailableError
        here, never a CPU fallback); tests pass "cpu".
      batch_cap: requests fused into one lane run (its fixed batch size).
      max_wait_ms: how long the oldest queued request waits for
        batch-mates before a partial batch dispatches.
      max_queue: the bounded admission limit across all lanes.
      block_size: pivot block size of every lane (default:
        ``config.default_block_size`` of the bucket).
      autostart: start the dispatcher now (tests pass False to stage the
        queue, then ``start()``).
      telemetry: an ``obs.Telemetry``; builds and batch runs become
        ``compile`` and ``execute`` spans.
      policy: the ``resilience.ResiliencePolicy``; "default" is
        ``DEFAULT_POLICY`` (retries, the integrity gate, K=3 breakers),
        None turns the layer off.
      default_deadline_ms: the deadline of every submit that passes none
        (queue wait + execute; ``DeadlineExceededError``); None: none.
      shared_executors: an ``ExecutorStore`` shared with other services.
      plan_cache_read_only: open ``plan_cache`` frozen.
      metric_labels: extra labels on every mirrored metric series.
      numerics: "off" (nothing added to the dispatch path) or "summary";
        "trace" is refused as the JAX package refuses it.
      shared_handles: a ``HandleStore`` shared with other services (its
        budget is its own); None: a private store.
      handle_budget_bytes: the resident-bytes ceiling of the private store
        (``obs.capacity.CapacityBudget``); refused with ``shared_handles``.
      update_drift_budget_factor: gate-widths of accumulated drift a
        resident inverse may carry before the re_invert rung fires (None:
        ``linalg.update.DRIFT_BUDGET_FACTOR``).

      mesh_shapes: topologies this service may open mesh lanes on: ints
        ('p4'), (pr, pc) tuples ('2x2') or topology labels, checked at
        construction against the placement rule
        (``meshlanes.normalize_mesh``: a typed UsageError here).  Requires
        ``lane_budget_bytes``.
      lane_budget_bytes: the per-device byte budget the admission walk
        compares ``executors.projected_lane_bytes`` against; None (the
        default) serves every request on the single-device lanes.
    """

    def __init__(self, engine: str = "auto", plan_cache=None,
                 dtype=torch.float32, batch_cap: int = 8,
                 max_wait_ms: float = 2.0, max_queue: int = 256,
                 block_size: int | None = None, autostart: bool = True,
                 telemetry=None, policy="default",
                 default_deadline_ms: float | None = None,
                 shared_executors=None,
                 plan_cache_read_only: bool = False,
                 metric_labels: dict | None = None,
                 numerics: str = "off", device=None,
                 shared_handles=None, handle_budget_bytes=None,
                 update_drift_budget_factor=None, mesh_shapes=(),
                 lane_budget_bytes=None):
        from ..obs.numerics import resolve_mode

        self.numerics = resolve_mode(numerics)
        if self.numerics == "trace":
            raise UsageError(
                "numerics='trace' is a solve-path mode (the serve "
                "executables are fused; the host cannot see their "
                "supersteps) — use numerics='summary' on the service, "
                "or driver.solve(numerics='trace') for the full trace")
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        if self.device.type == "cuda":
            # True fp32 products, as every entry point runs them.
            torch.backends.cuda.matmul.allow_tf32 = False
        self.batch_cap = int(batch_cap)
        self.telemetry = telemetry
        self.policy = DEFAULT_POLICY if policy == "default" else policy
        self.default_deadline_ms = default_deadline_ms
        from .handles import build_handle_store

        # The resident (A, A⁻¹) pairs the update lanes mutate.
        self.handles = build_handle_store(shared_handles,
                                          handle_budget_bytes,
                                          "the service")
        self._handle_seq = 0
        self._stats = ServeStats(labels=metric_labels)
        self.executors = ExecutorCache(
            engine=engine, plan_cache=plan_cache, dtype=self.dtype,
            device=self.device, stats=self._stats, telemetry=telemetry,
            policy=self.policy, store=shared_executors,
            plan_cache_read_only=plan_cache_read_only)
        self._batcher = MicroBatcher(
            self.executors, self._stats, batch_cap=batch_cap,
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            block_size=block_size, autostart=autostart,
            telemetry=telemetry, policy=self.policy,
            numerics=self.numerics, handles=self.handles,
            update_drift_budget_factor=update_drift_budget_factor)
        # Request journeys, always on: ids in submit order, every hop
        # mirrored into the flight recorder.
        self.journey = JourneyLog(prefix="req")
        # The mesh lanes' topologies, checked now and held by rank count:
        # the admission walk routes to the smallest mesh that fits.
        from .meshlanes import mesh_devices, mesh_label, normalize_mesh

        lanes = {}
        for spec in mesh_shapes:
            workers = normalize_mesh(spec, self.device.type)
            lanes[mesh_label(workers)] = mesh_devices(workers)
        self._mesh_lanes = sorted(lanes.items(), key=lambda t: (t[1], t[0]))
        self.lane_budget_bytes = (None if lane_budget_bytes is None
                                  else int(lane_budget_bytes))
        if self._mesh_lanes and self.lane_budget_bytes is None:
            raise UsageError(
                "mesh_shapes without lane_budget_bytes: the per-device "
                "byte budget IS the admission signal deciding which "
                "requests leave the single-device lane — pass "
                "lane_budget_bytes")
        self._own_executors = shared_executors is None
        self._closed = False
        self._close_lock = threading.Lock()

    # ---- mesh admission ----------------------------------------------

    def _admit_mesh(self, n: int, bucket: int, workload: str, rhs: int,
                    ctx) -> str:
        """The submit-time admission walk: the single-device lane if its
        projection fits the budget, else the smallest configured mesh
        whose per-rank share fits (a ``mesh_admitted`` hop), else a typed
        ``CapacityExceededError`` with a ``reject`` hop and a
        ``capacity_refused`` flight-recorder event."""
        from .executors import projected_lane_bytes
        from .meshlanes import MESH_SINGLE

        budget = self.lane_budget_bytes
        if budget is None:
            return MESH_SINGLE
        single = projected_lane_bytes(bucket, self.batch_cap, self.dtype,
                                      workload, rhs)
        if single <= budget:
            return MESH_SINGLE
        best = single
        for label, devices in self._mesh_lanes:
            proj = projected_lane_bytes(bucket, 1, self.dtype, workload,
                                        rhs, devices=devices)
            best = min(best, proj)
            if proj <= budget:
                ctx.event("mesh_admitted", mesh=label,
                          projected_bytes=proj, budget_bytes=budget,
                          single_device_bytes=single)
                return label
        from ..obs import capacity as _capacity
        from ..resilience.policy import CapacityExceededError

        _capacity.record_refusal(
            requested=best,
            live_bytes=_capacity.live_bytes("executor_lanes"),
            budget_bytes=budget, pinned=0)
        ctx.event("reject", reason="capacity", projected_bytes=best,
                  budget_bytes=budget)
        largest = (f"the largest configured mesh "
                   f"({self._mesh_lanes[-1][0]!r})"
                   if self._mesh_lanes else
                   "the single-device lane (no mesh_shapes configured)")
        raise CapacityExceededError(
            f"n={n} (bucket {bucket}, workload {workload!r}) projects "
            f"{best} bytes/device on {largest}; lane_budget_bytes is "
            f"{budget} — configure a larger mesh_shapes entry or raise "
            f"the budget (the request is refused at submit, never an "
            f"OOM mid-launch)")

    # ---- request path ------------------------------------------------

    def _host(self, x) -> torch.Tensor:
        """A request's array (numpy or tensor) as a CPU tensor of the
        service dtype."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return t.detach().to(device="cpu", dtype=self.dtype)

    def submit(self, a, b=None, deadline_ms: float | None = None,
               _ctx=None) -> Future:
        """Queue one request; the future resolves to :class:`InvertResult`.

        ``submit(a)`` inverts; ``submit(a, b)`` solves X = A⁻¹B with no
        inverse formed (``b`` is (n,) or (n, k)), on its own (bucket, rhs
        bucket) lane, the result carrying ``solution`` and
        ``workload="solve"``.  Raises :class:`ServiceOverloadedError` on a
        full queue, ``CircuitOpenError`` while the lane's breaker is open
        and :class:`ServiceClosedError` after ``close()``.  ``deadline_ms``
        (default ``default_deadline_ms``) bounds queue wait + execute."""
        a = self._host(a)
        if a.dim() != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected a square (n, n) matrix, "
                             f"got shape {tuple(a.shape)}")
        n = a.shape[0]
        bucket = bucket_for(n)
        padded = torch.eye(bucket, dtype=self.dtype)
        padded[:n, :n] = a
        workload, padded_b, rhs, k = "invert", None, 0, 0
        if b is not None:
            workload = "solve"
            b = self._host(b)
            if b.dim() == 1:
                b = b[:, None]
            if b.dim() != 2 or b.shape[0] != n or b.shape[1] < 1:
                raise ValueError(f"b must be (n,) or (n, k>=1) with "
                                 f"n={n} rows, got shape {tuple(b.shape)}")
            k = b.shape[1]
            rhs = rhs_bucket_for(k)
            padded_b = torch.zeros((bucket, rhs), dtype=self.dtype)
            padded_b[:n, :k] = b
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        own_ctx = _ctx is None
        ctx = (self.journey.new(n, bucket, workload=workload)
               if own_ctx else _ctx)
        try:
            mesh = self._admit_mesh(n, bucket, workload, rhs, ctx)
            fut = self._batcher.submit(
                padded, n, bucket,
                deadline_s=(None if deadline_ms is None
                            else float(deadline_ms) / 1e3),
                ctx=ctx, workload=workload, padded_b=padded_b,
                rhs=rhs, k=k, mesh=mesh)
        except Exception as e:
            if own_ctx:
                ctx.close("error", error=type(e).__name__)
            raise
        if own_ctx:
            fut.add_done_callback(ctx.close_from_future)
        return fut

    @staticmethod
    def result(future: Future, timeout: float | None = None) -> InvertResult:
        """Block on a submitted future."""
        return future.result(timeout)

    def invert(self, a, timeout: float | None = None,
               deadline_ms: float | None = None, resident: bool = False,
               handle_id: str | None = None):
        """Submit and wait; raises SingularMatrixError when THIS request's
        element was flagged (``submit`` reports the flag instead).

        ``resident=True`` also installs the (A, A⁻¹) pair as a resident
        handle (on the service's device) and returns its
        :class:`~.handles.HandleRef` (``ref.result`` is the
        ``InvertResult``); ``handle_id`` names it (default ``h<N>``; an
        existing id is replaced).  With a budget on the handle store the
        handle's 2·bucket²·itemsize bytes are admitted BEFORE the invert is
        submitted: LRU unpinned handles are evicted (a ``capacity_evict``
        hop each on this request's journey), or the typed
        ``CapacityExceededError`` is raised here and nothing launches."""
        if not resident:
            res = self.submit(a, deadline_ms=deadline_ms).result(timeout)
            if res.singular:
                raise SingularMatrixError("singular matrix")
            return res
        from .handles import resident_handle_bytes

        a = self._host(a)
        if a.dim() != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected a square (n, n) matrix, "
                             f"got shape {tuple(a.shape)}")
        n = a.shape[0]
        bucket = bucket_for(n)
        if self.lane_budget_bytes is not None:
            from .executors import projected_lane_bytes

            if (projected_lane_bytes(bucket, self.batch_cap, self.dtype)
                    > self.lane_budget_bytes):
                raise UsageError(
                    f"resident=True pins the (A, A⁻¹) pair on ONE "
                    f"device (the SMW update lanes are single-chip); "
                    f"bucket {bucket} exceeds lane_budget_bytes="
                    f"{self.lane_budget_bytes} on the single-device "
                    f"lane, so this invert would route to a mesh lane "
                    f"— invert without resident=True (the mesh lanes "
                    f"serve it), or raise lane_budget_bytes")
        ctx = self.journey.new(n, bucket, workload="invert")
        try:
            self.handles.ensure_capacity(
                resident_handle_bytes(bucket, self.dtype),
                hop=ctx.event, replacing=handle_id)
            fut = self.submit(a, deadline_ms=deadline_ms, _ctx=ctx)
        except Exception as e:
            ctx.close("error", error=type(e).__name__)
            raise
        fut.add_done_callback(ctx.close_from_future)
        res = fut.result(timeout)
        if res.singular:
            raise SingularMatrixError("singular matrix")
        return self._create_handle(a, res, handle_id)

    def _create_handle(self, a, res: InvertResult,
                       handle_id: str | None) -> HandleRef:
        """Install one resident handle from a completed invert
        (``handles.create_resident_handle``)."""
        from .handles import create_resident_handle

        if handle_id is None:
            with self._close_lock:
                self._handle_seq += 1
                handle_id = f"h{self._handle_seq}"
        return create_resident_handle(self.handles, self.dtype, a, res,
                                      handle_id)

    def submit_update(self, handle: HandleRef, u, v,
                      deadline_ms: float | None = None,
                      _ctx=None) -> Future:
        """Queue one rank-k update A ← A + U·Vᵀ of a resident handle: its
        inverse refreshed by Sherman–Morrison–Woodbury in O(n²k) and
        re-verified against the mutated matrix in the same run, the drift
        budget deciding when the re_invert rung pays a fresh elimination.
        ``u`` and ``v`` are (n,) or (n, k); only they cross to the device.
        The future resolves to an :class:`InvertResult` with
        ``workload="update"``, the committed ``handle_version`` and
        ``drift``, and ``update_outcome`` (refreshed, re_inverted or
        gated).  Typed rejections as ``submit``'s."""
        from ..linalg.update import as_update_factors

        if not isinstance(handle, HandleRef):
            raise ValueError(f"update() takes the HandleRef returned by "
                             f"invert(resident=True), got "
                             f"{type(handle).__name__}")
        n = handle.n
        u, v, k = as_update_factors(u, v, n, self.dtype, device="cpu")
        kb = k_bucket_for(k)
        bucket = handle.bucket_n
        padded_u = torch.zeros((bucket, kb), dtype=self.dtype)
        padded_u[:n, :k] = u
        padded_v = torch.zeros((bucket, kb), dtype=self.dtype)
        padded_v[:n, :k] = v
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        own_ctx = _ctx is None
        ctx = (self.journey.new(n, bucket, workload="update")
               if own_ctx else _ctx)
        try:
            fut = self._batcher.submit(
                None, n, bucket,
                deadline_s=(None if deadline_ms is None
                            else float(deadline_ms) / 1e3),
                ctx=ctx, workload="update", rhs=kb, k=k, handle=handle,
                padded_u=padded_u, padded_v=padded_v)
        except Exception as e:
            if own_ctx:
                ctx.close("error", error=type(e).__name__)
            raise
        if own_ctx:
            fut.add_done_callback(ctx.close_from_future)
        return fut

    def update(self, handle: HandleRef, u, v, timeout: float | None = None,
               deadline_ms: float | None = None) -> InvertResult:
        """``submit_update`` and wait; raises SingularMatrixError when the
        mutation made the matrix singular (the handle is untouched)."""
        res = self.submit_update(handle, u, v,
                                 deadline_ms=deadline_ms).result(timeout)
        if res.singular:
            raise SingularMatrixError(
                "singular matrix (rank-k update destroyed rank; "
                "resident state unchanged)")
        return res

    def solve_system(self, a, b, timeout: float | None = None,
                     deadline_ms: float | None = None) -> InvertResult:
        """``submit(a, b)`` and wait; raises SingularMatrixError when THIS
        request's element was flagged."""
        res = self.submit(a, b, deadline_ms=deadline_ms).result(timeout)
        if res.singular:
            raise SingularMatrixError("singular matrix")
        return res

    # ---- lifecycle ---------------------------------------------------

    def project_capacity(self, shapes=(), solve_shapes=(),
                         update_shapes=(), mesh_shapes=()) -> dict:
        """The argument + output bytes of every lane the given request mix
        would open (:meth:`warmup`'s vocabulary: an (n, k) update shape
        opens n's invert lane, its cap-1 re_invert twin and the cap-1 and
        batch-cap update lanes), computed with nothing built; each is
        recorded on ``tpu_jordan_torch_capacity_projected_lane_bytes``.
        ``mesh_shapes`` entries ``(n, mesh)`` (an invert lane) or ``(n, k,
        mesh)`` (a solve lane) project the mesh lanes at their per-rank
        share."""
        from ..obs import capacity as _capacity
        from .executors import lane_label, projected_lane_bytes

        cap = self.batch_cap
        out = {}

        def project(workload, bucket, batch_cap, rhs=0, mesh="single",
                    devices=1):
            label = lane_label(workload, bucket, batch_cap, rhs, mesh)
            out[label] = projected_lane_bytes(bucket, batch_cap, self.dtype,
                                              workload, rhs, devices=devices)
            _capacity.record_projection(label, out[label])

        for n in shapes:
            project("invert", bucket_for(int(n)), cap)
        for n, k in solve_shapes:
            project("solve", bucket_for(int(n)), cap,
                    rhs_bucket_for(int(k)))
        for n, k in update_shapes:
            b, kb = bucket_for(int(n)), k_bucket_for(int(k))
            project("invert", b, cap)
            if cap != 1:
                project("invert", b, 1)      # the re_invert rung's lane
            project("update", b, 1, kb)
            if cap != 1:
                project("update", b, cap, kb)
        for entry in mesh_shapes:
            workload, b, rhs, label, devices = self._mesh_entry(entry)
            project(workload, b, 1, rhs, mesh=label, devices=devices)
        return out

    def _mesh_entry(self, entry):
        """One mesh entry, ``(n, mesh)`` (invert) or ``(n, k, mesh)``
        (solve), as ``(workload, bucket, rhs, mesh label, ranks)``."""
        from .meshlanes import mesh_devices, mesh_label, normalize_mesh

        if len(entry) == 2:
            n, spec = entry
            workload, rhs = "invert", 0
        else:
            n, k, spec = entry
            workload, rhs = "solve", rhs_bucket_for(int(k))
        workers = normalize_mesh(spec, self.device.type)
        return (workload, bucket_for(int(n)), rhs, mesh_label(workers),
                mesh_devices(workers))

    def warmup(self, shapes=(), solve_shapes=(), update_shapes=(),
               mesh_shapes=(), run: bool = False) -> dict:
        """Build the executors of every lane the given request sizes
        (``shapes``), (n, k) solves (``solve_shapes``) and (n, k) updates
        (``update_shapes``: n's invert lane, its cap-1 twin that the
        re_invert rung runs, and the cap-1 and batch-cap update lanes,
        whose build loads the capacitance probe's kernel) land in, each
        projected first (:meth:`project_capacity`); returns {lane:
        resolved engine}.  After a warmup covering the live mix the serve
        path performs zero builds and zero measurements.  ``run=True``
        also runs one inert batch of each of those lanes on the dispatcher
        thread (counted in ``tpu_jordan_torch_serve_warm_batches_total``),
        so no request pays the thread's first launches.  ``mesh_shapes``
        entries (:meth:`project_capacity`'s) build the mesh lanes: each
        starts its world of ranks and runs one inert job, so a warm mesh
        lane starts no world on the request path."""
        self.project_capacity(shapes=shapes, solve_shapes=solve_shapes,
                              update_shapes=update_shapes,
                              mesh_shapes=mesh_shapes)
        out = {}
        lanes = {}

        def get(b, cap, **kw):
            ex = self.executors.get(b, cap, self._batcher.block_size, **kw)
            lanes.setdefault(ex.key, ex)
            return ex

        for n in shapes:
            b = bucket_for(int(n))
            out[b] = get(b, self.batch_cap).key.engine
        for n, k in solve_shapes:
            b = bucket_for(int(n))
            rhs = rhs_bucket_for(int(k))
            ex = get(b, self.batch_cap, workload="solve", rhs=rhs)
            out[f"solve:{b}:k{rhs}"] = ex.key.engine
        for n, k in update_shapes:
            b, kb = bucket_for(int(n)), k_bucket_for(int(k))
            out[b] = get(b, self.batch_cap).key.engine
            if self.batch_cap != 1:
                get(b, 1)
            ex = get(b, 1, workload="update", rhs=kb)
            out[f"update:{b}:k{kb}"] = ex.key.engine
            if self.batch_cap != 1:
                get(b, self.batch_cap, workload="update", rhs=kb)
        for entry in mesh_shapes:
            workload, b, rhs, label, _ = self._mesh_entry(entry)
            ex, _src = self.executors.get_info(
                b, 1, self._batcher.block_size, workload=workload, rhs=rhs,
                mesh=label)
            lane = f"{b}" if workload == "invert" else f"{workload}:{b}:k{rhs}"
            out[f"{lane}@{label}"] = ex.key.engine
        if run:
            self._batcher.run_on_dispatcher(
                lambda: self._warm_lanes(lanes.values()))
        return out

    def _warm_lanes(self, lanes) -> None:
        """One inert batch of each lane on the calling thread, counted."""
        for ex in lanes:
            if ex.key.mesh != "single":
                continue                # warmed by its build
            ex.warm()
            key = ex.key
            _M_WARM_BATCHES.inc(
                workload=key.workload, bucket=str(key.bucket_n),
                cap=str(key.batch_cap), block=str(key.block_size),
                rhs=str(key.rhs), dtype=key.dtype, **self._stats._labels)

    def start(self) -> None:
        """Start the dispatcher (a no-op with ``autostart=True``)."""
        self._batcher.start()

    def close(self, drain: bool = True, error=None,
              join_timeout_s: float | None = None) -> None:
        """Stop accepting requests; ``drain=True`` completes all queued and
        in-flight work first.  Idempotent and thread-safe; ``error`` (a
        zero-arg exception factory, ``drain=False``) types the failure the
        queued requests get; ``join_timeout_s`` bounds the dispatcher's
        join.  Closing a closed service retries the reap of a dispatcher a
        bounded close abandoned."""
        with self._close_lock:
            if not self._closed:
                self._batcher.close(drain=drain, error=error,
                                    join_timeout_s=join_timeout_s)
                self._closed = True
                if self._own_executors:
                    for key, ex in self.executors.entries():
                        if key.mesh != "single":
                            ex.close()
            else:
                self._batcher.reap(join_timeout_s=(
                    0.0 if join_timeout_s is None else join_timeout_s))

    def __enter__(self) -> "JordanService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- observability -----------------------------------------------

    def stats(self) -> dict:
        """Per-lane counters and latency percentiles (``serve/stats.py``),
        the resolved engine of each built lane, the tuner's measurement
        count, the queue depth, the resident handles and their budget, and
        the breakers' states."""
        snap = self._stats.snapshot()
        snap["engines"] = {
            ((f"{k.bucket_n}" if k.workload == "invert"
              else f"{k.workload}:{k.bucket_n}:k{k.rhs}")
             + (f"@{k.mesh}" if k.mesh != "single" else "")):
            {"engine": k.engine,
             "batch_cap": k.batch_cap,
             "workload": k.workload,
             "mesh": k.mesh,
             "plan_source": ex.plan.source if ex.plan else None}
            for k, ex in self.executors.entries()
        }
        snap["mesh_lanes"] = dict(self._mesh_lanes)
        snap["lane_budget_bytes"] = self.lane_budget_bytes
        snap["measurements"] = self.executors.measurements
        snap["batch_cap"] = self.batch_cap
        snap["queued"] = self._batcher.queued
        snap["handles"] = self.handles.snapshot()
        snap["handle_budget"] = self.handles.budget_snapshot()
        snap["breakers"] = {str(b): s for b, s
                            in self.executors.breaker_states().items()}
        return snap


def serve_demo(n: int, block_size: int | None = None, requests: int = 64,
               batch_cap: int = 8, max_wait_ms: float = 2.0,
               engine: str = "auto", plan_cache=None,
               dtype=torch.float32, generator: str = "rand",
               telemetry=None, numerics: str = "off", device=None,
               workers=1) -> dict:
    """The ``--serve-demo`` run: ``requests`` mixed-size requests (sizes
    cycling through {n, n/2, n/4}, so at least 3 buckets from n ≥ 256)
    through a warmed :class:`JordanService`, every future awaited, and the
    one-line JSON report: counts, per-lane stats with occupancy and
    latency percentiles, the build and measurement counters (zero on the
    request path of a warm server), the worst rel_residual, the wall time,
    and the runtime fingerprint.

    ``workers`` other than 1 (an int, a (pr, pc) tuple or a label such as
    '2x2') configures one mesh lane with ``lane_budget_bytes`` one byte
    under the largest bucket's single-device projection, so the largest
    size routes through the mesh lane (its ``mesh_admitted`` hop) while
    the smaller sizes stay single-device; the report adds the mesh, the
    budget, the mesh requests and the world starts on the request path
    (zero on a warm lane)."""
    import time

    from ..obs import hwcost as _hwcost
    from ..ops import generate
    from ..parallel.world import world_starts
    from .executors import projected_lane_bytes
    from .meshlanes import mesh_label, normalize_mesh

    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    sizes = sorted({max(1, n), max(1, n // 2), max(1, n // 4)},
                   reverse=True)
    mesh_kw, label = {}, None
    if workers not in (1, None):
        label = mesh_label(normalize_mesh(workers, dev.type))
        budget = projected_lane_bytes(bucket_for(sizes[0]), batch_cap,
                                      dtype) - 1
        mesh_kw = {"mesh_shapes": (label,), "lane_budget_bytes": budget}
    elapsed0 = time.perf_counter()
    with JordanService(engine=engine, plan_cache=plan_cache, dtype=dtype,
                       batch_cap=batch_cap, max_wait_ms=max_wait_ms,
                       max_queue=max(requests, 1),
                       block_size=block_size, telemetry=telemetry,
                       numerics=numerics, device=dev, **mesh_kw) as svc:
        if label is None:
            svc.warmup(shapes=sizes)
        else:
            svc.warmup(shapes=sizes[1:], mesh_shapes=[(sizes[0], label)])
        compiles_after_warmup = svc.stats()["totals"]["compiles"]
        starts_after_warmup = world_starts()
        futures = []
        for i in range(requests):
            sz = sizes[i % len(sizes)]
            # Distinct matrices per request by index offsets (the
            # solve_batch convention), generated on the device as the JAX
            # demo generates them; submit takes them to the host.
            a = generate(generator, (sz, sz), dtype, row_offset=i * sz,
                         col_offset=i * sz, device=dev)
            futures.append(svc.submit(a))
        results = [f.result(timeout=600) for f in futures]
        stats = svc.stats()
        starts_on_path = world_starts() - starts_after_warmup
        lanes = [ex for key, ex in svc.executors.entries()
                 if key.mesh != "single"]
    elapsed = time.perf_counter() - elapsed0
    singular = sum(r.singular for r in results)
    worst_rel = max((r.rel_residual for r in results
                     if not r.singular and r.rel_residual is not None),
                    default=None)
    mesh_doc = {}
    if label is not None:
        mesh_rel = max((r.rel_residual for r in results
                        if r.n == sizes[0] and not r.singular), default=None)
        mesh_doc = {
            "mesh_worst_rel_residual": (None if mesh_rel is None
                                        else f"{mesh_rel:.1e}"),
            "mesh": label,
            "lane_budget_bytes": mesh_kw["lane_budget_bytes"],
            "mesh_requests": sum(
                s["requests"] for s in stats["buckets"].values()
                if s.get("mesh", "single") != "single"),
            "world_starts_on_request_path": starts_on_path,
            # The lane's world: its start (once, at warmup), the ranks'
            # kernel launches over every run, and the first request's
            # pivots (run 0 is warmup's inert job).
            "mesh_world": [{
                "start_s": ex.world.start_s, "starts": ex.world.starts,
                "jobs": ex.world.jobs, "launches": dict(ex.launches),
                "first_request_pivots": (ex.recent[1]["pivots"]
                                         if len(ex.recent) > 1 else None)}
                for ex in lanes]}
    return {
        "metric": "serve_demo",
        "requests": requests,
        "request_sizes": sizes,
        "buckets": len(stats["buckets"]),
        "batch_cap": batch_cap,
        **mesh_doc,
        "singular": singular,
        "worst_rel_residual": (None if worst_rel is None
                               else f"{worst_rel:.1e}"),
        "compiles": stats["totals"]["compiles"],
        "compiles_on_request_path": (stats["totals"]["compiles"]
                                     - compiles_after_warmup),
        "plan_cache_measurements": stats["measurements"],
        "mean_occupancy": {
            b: s["mean_occupancy"] for b, s in stats["buckets"].items()},
        "elapsed_s": round(elapsed, 3),
        "device": str(dev),
        "env": _hwcost.runtime_env(),
        "device_memory": _device_memory(dev),
        "stats": stats,
    }


def _device_memory(dev) -> dict | None:
    """The allocator's live and peak bytes after the run (None on the
    CPU)."""
    from ..obs import hwcost as _hwcost

    stats = _hwcost.observe_device_memory(dev)
    if stats is None:
        return None
    return {k: stats.get(k) for k in ("bytes_in_use", "peak_bytes_in_use")}


def _chaos_requests(n: int, requests: int, seed: int, dtype):
    """The deterministic mixed request stream both chaos passes share:
    sizes cycling {n, n/2}, standard-normal fixtures from one seeded
    numpy stream (the JAX package's), and rank-1 singular matrices at
    fixed indices, whose flags must survive the chaos.  Sub-fp32 fixtures
    are made in fp32 (numpy has no bfloat16) and rounded at submit."""
    rng = np.random.default_rng(seed)
    sizes = [max(1, n), max(1, n // 2)]
    dt = resolve_dtype(dtype)
    np_dtype = (np.float32 if dt in (torch.bfloat16, torch.float16)
                else np.dtype(str(dt).removeprefix("torch.")))
    mats = []
    for i in range(requests):
        s = sizes[i % len(sizes)]
        if i % 17 == 5:
            mats.append(np.ones((s, s), np_dtype))      # rank 1: singular
        else:
            mats.append(rng.standard_normal((s, s)).astype(np_dtype))
    return mats


def _classify_response(f, timeout: float = 600.0):
    """One response's outcome: ("ok", the inverse's bytes on the host,
    singular) or ("error", type name, None).  ``f`` is a future, or the
    typed exception a submit-time rejection raised."""
    if isinstance(f, Exception):
        return ("error", type(f).__name__, None)
    try:
        r = f.result(timeout)
        return ("ok", r.inverse.cpu().numpy().tobytes(), bool(r.singular))
    except Exception as e:                           # noqa: BLE001
        return ("error", type(e).__name__, None)


def compare_outcomes(baseline, under):
    """Compare a chaos stream's outcomes with the fault-free replay's,
    bit for bit; returns ``(matched, singular, typed_errors,
    mismatches)``."""
    matched = singular = 0
    typed_errors: dict[str, int] = {}
    mismatches: list[dict] = []
    for i, (base, chaos) in enumerate(zip(baseline, under)):
        if chaos[0] == "error":
            typed_errors[chaos[1]] = typed_errors.get(chaos[1], 0) + 1
            continue
        if base[0] != "ok":
            mismatches.append({"request": i, "why": (
                f"fault-free run failed ({base[1]}) but chaos "
                f"succeeded")})
        elif chaos[2] != base[2]:
            mismatches.append({"request": i,
                               "why": "singular flag diverged"})
        elif chaos[1] != base[1]:
            mismatches.append({"request": i,
                               "why": "inverse bits diverged"})
        else:
            matched += 1
            singular += int(chaos[2])
    return matched, singular, typed_errors, mismatches


def _run_stream(svc, mats, timeout: float = 600.0):
    """Submit a staged stream (queue everything, then start the
    dispatcher, so the batches are deterministic) and classify every
    response; a typed submit-time rejection is an "error" outcome."""
    futs = []
    for a in mats:
        try:
            futs.append(svc.submit(a))
        except Exception as e:                       # noqa: BLE001
            futs.append(e)
    svc.start()
    return [_classify_response(f, timeout) for f in futs]


def chaos_demo(n: int = 96, block_size: int | None = None,
               requests: int = 50, batch_cap: int = 4,
               max_wait_ms: float = 2.0, seed: int = 0,
               dtype=torch.float32, plan_cache: str | None = None,
               telemetry=None, device=None) -> dict:
    """The ``--chaos-demo`` run: one deterministic mixed request stream
    served twice, fault-free (the replay) and under a seeded
    ``FaultPlan`` injecting build failures, transient execute errors, NaN
    result corruption and plan-cache write failures.  Every chaos response
    must bit-match the replay's or carry a typed error, and every injected
    fault is accounted for as retried, degraded or a terminal failure
    (``tools/check_chaos.py`` validates the report)."""
    import shutil
    import tempfile
    import time

    from ..obs.journey import outcome_ledger
    from ..obs.metrics import REGISTRY
    from ..obs.recorder import RECORDER
    from ..resilience import FaultPlan, ResiliencePolicy
    from ..resilience import activate as _activate
    from ..resilience.policy import RetryPolicy

    t0 = time.perf_counter()
    dev = resolve_device(device)
    mats = _chaos_requests(n, requests, seed, dtype)
    shapes = sorted({a.shape[0] for a in mats})
    # A retry budget that absorbs the worst case of the schedule stacking
    # on one batch: execute (3) + corrupt (2), plus headroom.
    policy = ResiliencePolicy(
        retry=RetryPolicy(max_retries=6, backoff_s=0.0))

    def make_service(cache_path):
        svc = JordanService(engine="auto", plan_cache=cache_path,
                            dtype=dtype, batch_cap=batch_cap,
                            max_wait_ms=max_wait_ms,
                            max_queue=max(requests, 1),
                            block_size=block_size, autostart=False,
                            telemetry=telemetry, policy=policy, device=dev)
        svc.warmup(shapes=shapes)
        return svc

    # ---- pass 1: the fault-free replay ------------------------------
    with make_service(None) as svc:
        baseline = _run_stream(svc, mats)

    # ---- the seeded plan; horizons sized to how often each point is
    # reached: compile and plan_cache_write at the 2-bucket warmup, execute
    # and corrupt once a dispatched batch.
    exec_horizon = max(4, requests // max(1, batch_cap) // 2)
    plan = FaultPlan.seeded(seed, points={
        "compile": (1, 2),
        "execute": (3, exec_horizon),
        "result_corrupt_nan": (2, exec_horizon),
        "plan_cache_write": (1, 2),
    })

    # ---- pass 2: the same stream under the plan ----------------------
    def counters():
        return {
            "retries": REGISTRY.counter(
                "tpu_jordan_torch_retries_total").total(),
            "plan_cache_write_failures": REGISTRY.counter(
                "tpu_jordan_torch_plan_cache_write_failures_total").total(),
            "recovery_rungs": REGISTRY.counter(
                "tpu_jordan_torch_recovery_rungs_total").total(),
            "breaker_opens": REGISTRY.counter(
                "tpu_jordan_torch_breaker_open_total").total(),
            "deadline_exceeded": REGISTRY.counter(
                "tpu_jordan_torch_deadline_exceeded_total").total(),
            "batch_failures": REGISTRY.counter(
                "tpu_jordan_torch_serve_batch_failures_total").total(),
        }

    before = counters()
    cache_dir = None
    if plan_cache is None:
        cache_dir = tempfile.mkdtemp(prefix="tpu_jordan_torch_chaos_")
        plan_cache = f"{cache_dir}/plans.json"
    # The black-box window of the chaos pass: the report carries the
    # causal evidence (fault -> retry or degradation -> response).
    bb_mark = RECORDER.total
    try:
        with _activate(plan):
            with make_service(plan_cache) as svc:
                chaos = _run_stream(svc, mats)
    finally:
        if cache_dir is not None:
            shutil.rmtree(cache_dir, ignore_errors=True)
    delta = {k: counters()[k] - before[k] for k in before}
    blackbox = RECORDER.dump(events=RECORDER.since(bb_mark))
    journey_ledger = outcome_ledger(blackbox["events"])

    matched, singular, typed_errors, mismatches = compare_outcomes(
        baseline, chaos)

    # Fault accounting in fault events: every injection triggered one
    # counted retry, degraded, or ended one attempt chain (one terminal
    # batch failure however many riders it reached).  A positive
    # remainder is a silently absorbed fault.
    injected = plan.injected_total
    typed_total = sum(typed_errors.values())
    degraded = delta["plan_cache_write_failures"] + delta["recovery_rungs"]
    terminal = delta["batch_failures"]
    unaccounted = int(injected - delta["retries"] - degraded - terminal)
    return {
        "metric": "chaos_demo",
        "requests": requests,
        "request_sizes": sorted({a.shape[0] for a in mats}, reverse=True),
        "seed": seed,
        "batch_cap": batch_cap,
        "device": str(dev),
        "faults": plan.report(),
        "accounting": {
            "injected": injected,
            "retried": delta["retries"],
            "degraded": degraded,
            "terminal_failures": terminal,
            "typed_error_responses": typed_total,
            "unaccounted": unaccounted,
        },
        "counters_delta": delta,
        "matched_bitwise": matched,
        "singular_flagged": singular,
        "typed_errors": typed_errors,
        "mismatches": mismatches,
        "journey_ledger": journey_ledger,
        "blackbox": blackbox,
        # A journey gap (submitted, never resolved) is silent corruption
        # by definition; a negative remainder (a real transient besides
        # the injected ones) is not.
        "silent_corruption": (bool(mismatches) or unaccounted > 0
                              or bool(journey_ledger["gaps"])),
        "elapsed_s": round(time.perf_counter() - t0, 3),
    }
