"""Mesh-backed serve lanes.  Counterpart of the JAX package's
``serve/meshlanes.py``: a :class:`MeshLaneExecutor` is the distributed
twin of ``executors.BucketExecutor``, one per (workload, bucket, dtype,
mesh), built from the engines the library path ships (the 1D and 2D
invert engines, the [A | B] solves) and resolved through the same tuner
ladder at a distributed point, so a warm mesh lane performs zero builds
and zero measurements, as the single-device lanes do.

The JAX lane compiles one sharded program once and runs it warm.  The
port's counterpart of that executable is a **persistent world of ranks**
(``parallel/world.py``) that the lane owns: the build starts the world
once and runs one inert job (an identity), and every request after that
is one job on the same ranks, with no spawn and no group join.  A
request is the scatter (each rank is handed its own strip or shard of
the padded A, and of B, through the world's files), the engine on the
ranks, and the gather (each rank's blocks come back through its result
file, so no gather collective runs); ``metrics`` is the dense
verification on the service's device; ``comm_report`` is the analytical
inventory of this execute (``gather=False``, no residual section),
reconciled against the ranks' recorded collectives when recording is on.

Contract differences from the single-device lanes, as in the JAX package:
batch_cap is 1 (one world owns its ranks for a launch); admission is
byte-projected (``projected_lane_bytes(..., devices=p)``, the per-rank
share); complex dtypes, the SPD fast path, the update workload and
resident handles are refused typed, naming the single-device lanes.

**The placement rule** (a departure): JAX forms a mesh from
``jax.device_count()`` devices.  Port ranks are processes, and ranks may
share a card over gloo (``parallel/group.backend_rule``), so the port
places at most :data:`RANKS_PER_CARD` ranks on each card, and on the CPU
at most one rank per core (``os.cpu_count()``): :func:`placement_capacity`.
A mesh that needs more is refused with a typed ``UsageError`` at
configure time.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import replace

import torch

from ..errors import UsageError
from ..interop import resolve_dtype
from ..resilience import faults as _faults

#: The non-mesh topology label: ``ExecutorKey.mesh`` of every
#: single-device lane.
MESH_SINGLE = "single"

#: Ranks the placement rule puts on one card: the 4 gloo ranks of one
#: H100 the distributed phases of ``chip_smoke.py`` run.
RANKS_PER_CARD = 4


def mesh_label(workers) -> str:
    """The topology label of a workers spec ('p8' for 1D, '2x4' for 2D):
    the tuner's ``TunePoint`` spelling."""
    if isinstance(workers, tuple):
        return f"{int(workers[0])}x{int(workers[1])}"
    w = int(workers)
    return MESH_SINGLE if w == 1 else f"p{w}"


def parse_mesh(label: str):
    """The inverse of :func:`mesh_label`: 'p8' -> 8, '2x4' -> (2, 4).  A
    malformed label is a typed ``UsageError``."""
    s = str(label)
    if s == MESH_SINGLE:
        return 1
    if "x" in s:
        pr, _, pc = s.partition("x")
        if pr.isdigit() and pc.isdigit() and int(pr) > 0 and int(pc) > 0:
            return (int(pr), int(pc))
    elif s.startswith("p") and s[1:].isdigit() and int(s[1:]) > 0:
        return int(s[1:])
    raise UsageError(
        f"mesh spec {label!r} is not a topology label: use 'pN' (1D "
        f"row-cyclic over N devices), 'PRxPC' (2D block-cyclic), an "
        f"int, or a (pr, pc) tuple")


def mesh_devices(workers) -> int:
    """Rank count of a workers spec (1D p -> p, (pr, pc) -> pr*pc)."""
    if isinstance(workers, tuple):
        return int(workers[0]) * int(workers[1])
    return int(workers)


def placement_capacity(device_type: str) -> tuple[int, str]:
    """The most ranks this process can place on ``device_type``, and the
    rule in words (module docstring)."""
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        return (cards * RANKS_PER_CARD,
                f"{RANKS_PER_CARD} ranks a card, {cards} card(s)")
    cores = os.cpu_count() or 1
    return cores, f"one CPU rank a core, {cores} core(s)"


def normalize_mesh(spec, device_type: str = "cuda"):
    """A mesh spec (int, (pr, pc) tuple, or topology label) as the
    driver's workers spec, checked against :func:`placement_capacity`: an
    unplaceable mesh is a typed ``UsageError`` naming the rank count."""
    workers = parse_mesh(spec) if isinstance(spec, str) else spec
    if isinstance(workers, tuple):
        workers = (int(workers[0]), int(workers[1]))
        if workers[0] < 1 or workers[1] < 1:
            raise UsageError(
                f"mesh shape {workers} is not a topology: both mesh "
                f"axes must be positive")
    else:
        workers = int(workers)
        if workers < 1:
            raise UsageError(
                f"mesh size {workers} is not a topology: workers must "
                f"be positive")
    need = mesh_devices(workers)
    if need < 2:
        raise UsageError(
            "a 1-device mesh is the single-device lane (mesh="
            "'single'); mesh lanes need workers > 1 or a (pr, pc) "
            "tuple")
    have, rule = placement_capacity(device_type)
    if need > have:
        raise UsageError(
            f"mesh {mesh_label(workers)!r} needs {need} ranks; this process "
            f"places at most {have} ({rule}) — serve this topology on a "
            f"host that can place it, or configure a smaller mesh_shapes "
            f"entry")
    return workers


class MeshLaneExecutor:
    """One mesh lane: a persistent world of ranks and the engine it runs
    (module docstring).  ``key`` is an ``executors.ExecutorKey`` with
    ``mesh != 'single'`` and ``batch_cap == 1``; ``plan`` the tuner's
    resolved plan; ``device`` the service's device (the ranks' device
    type, and where the verification runs)."""

    def __init__(self, key, plan, device: torch.device):
        self.key = key
        self.plan = plan
        self.block_size = key.block_size
        self.device = device
        if key.batch_cap != 1:
            raise UsageError(
                "mesh lanes dispatch at occupancy 1 (one sharded "
                "program owns the whole mesh per launch); batch_cap "
                "must be 1")
        in_dtype = resolve_dtype(key.dtype)
        if in_dtype.is_complex:
            raise UsageError(
                "complex dtypes run single-device (the distributed "
                "scatter/collective paths are real-dtype, the invert "
                "engines' contract); serve complex requests on the "
                "single-device lanes (mesh='single')")
        if key.engine == "solve_spd":
            raise UsageError(
                "assume='spd' is the single-device pivot-free fast "
                "path; the distributed [A | B] elimination pivots — "
                "serve SPD requests on the single-device lanes "
                "(mesh='single'), or drop the spd promise")
        if key.workload == "update":
            raise UsageError(
                "the SMW update lanes are single-chip (resident "
                "handles live on one device); mesh lanes serve "
                "workload='invert' and 'solve'")
        if (key.workload == "solve"
                and key.engine not in ("solve_sharded", "solve_lookahead")):
            raise UsageError(
                f"engine={key.engine!r} is a single-device solve "
                f"engine; mesh solve lanes run engine='solve_sharded' "
                f"or 'solve_lookahead' (or 'auto', which resolves "
                f"there)")
        self.workers = normalize_mesh(key.mesh, device.type)
        self.devices = mesh_devices(self.workers)
        self.in_dtype = in_dtype
        # Sub-fp32 storage computes in fp32, as the distributed core does.
        self.work_dtype = (torch.float32 if in_dtype.itemsize < 4
                           else in_dtype)
        _faults.fire("compile")
        from ..parallel.layout import CyclicLayout, CyclicLayout2D
        from ..parallel.world import World

        N, m = key.bucket_n, self.block_size
        mesh = self.workers if isinstance(self.workers, tuple) else None
        self.lay = (CyclicLayout2D.create(N, m, *mesh) if mesh is not None
                    else CyclicLayout.create(N, m, self.workers))
        self.group = getattr(plan, "group", 0) or 0
        self.engine = ("inplace" if key.engine in ("inplace", "auto")
                       else key.engine)
        self._spec = self._make_spec(mesh)
        #: The kernel launches the ranks reported, summed over every run,
        #: and the recent runs' pivots, singular flags and engine seconds.
        self.launches: dict = {}
        self.recent: deque = deque(maxlen=256)
        self.world = World(self.workers, device.type)
        # "Compile once": start the world and run one inert job.
        try:
            self.run(torch.eye(N, dtype=in_dtype),
                     None if key.workload == "invert"
                     else torch.zeros((N, key.rhs), dtype=in_dtype))
        except BaseException:
            self.world.close()
            raise

    def _make_spec(self, mesh):
        from ..parallel.dist_solve import DistSolveSpec, DistSpec

        dt = str(self.work_dtype).removeprefix("torch.")
        n, m = self.key.bucket_n, self.block_size
        if self.key.workload == "solve":
            if mesh is not None:
                from ..parallel.jordan2d_inplace import \
                    compile_sharded_jordan_solve_2d
                compile_sharded_jordan_solve_2d(
                    self.lay, lookahead=self.engine == "solve_lookahead")
            return DistSolveSpec(n=n, m=m, dtype=dt, engine=self.engine,
                                 mesh=mesh)
        if mesh is not None and self.engine != "augmented":
            from ..parallel.jordan2d_inplace import check_engine_2d

            check_engine_2d(self.lay, self.engine, self.group)
        return DistSpec(n=n, m=m, generator="rand", dtype=dt,
                        engine=self.engine, group_k=self.group, mesh=mesh)

    # ---- the per-request path ----------------------------------------

    def run(self, a, b=None):
        """One request on the lane's world: ``a`` the identity-padded
        (bucket, bucket) matrix (``b`` the zero-padded (bucket, rhs)
        right-hand sides on a solve lane), on the host.  Returns
        ``(result, singular, outcomes)``: the inverse or X on the
        service's device in the request dtype, the collective singular
        flag, and the ranks' outcomes (pivots, launches, elapsed, and
        with recording their collectives)."""
        from ..driver import WORLD_DEADLINE_S
        from ..obs.comm import recording_active
        from ..parallel.dist_solve import (invert_strip_rank, join_rhs,
                                           join_strips, solve_system_rank,
                                           split_rhs, split_strips)

        lay, N = self.lay, self.key.bucket_n
        spec = replace(self._spec, record=recording_active())
        a = torch.as_tensor(a).to(device="cpu", dtype=self.work_dtype)
        strips = split_strips(a, lay)
        if self.key.workload == "invert":
            outs = self.world.run(invert_strip_rank, spec,
                                  per_rank=[(s,) for s in strips],
                                  deadline_s=WORLD_DEADLINE_S)
            res = join_strips([o["blocks"] for o in outs], lay, N)
        else:
            b = torch.as_tensor(b).to(device="cpu", dtype=self.work_dtype)
            outs = self.world.run(solve_system_rank, spec,
                                  per_rank=list(zip(strips,
                                                    split_rhs(b, lay))),
                                  deadline_s=WORLD_DEADLINE_S)
            res = join_rhs([o["x_blocks"] for o in outs], lay, N)
        singular = any(o["singular"] for o in outs)
        for o in outs:
            o.pop("blocks", None)
            o.pop("x_blocks", None)
            for k, c in o["launches"].items():
                self.launches[k] = self.launches.get(k, 0) + c
        self.recent.append({"pivots": outs[0]["pivots"], "singular": singular,
                            "elapsed": max(o["elapsed"] for o in outs)})
        return res.to(device=self.device, dtype=self.in_dtype), singular, outs

    def metrics(self, a, result, b=None):
        """``(kappa_est, rel_residual)`` of the result against the caller's
        padded A (and B), dense, on the service's device: the backward
        error the batched lanes compute in their launch."""
        a = torch.as_tensor(a).to(self.device, self.work_dtype)
        x = result.to(self.work_dtype)
        rhs = (torch.as_tensor(b).to(self.device, self.work_dtype)
               if b is not None
               else torch.eye(a.shape[0], dtype=a.dtype, device=a.device))
        r = a @ x - rhs
        residual = float(r.abs().sum(dim=-1).amax())
        norm_a = float(a.abs().sum(dim=-1).amax())
        norm_x = float(x.abs().sum(dim=-1).amax())
        norm_b = float(rhs.abs().sum(dim=-1).amax())
        denom = norm_a * norm_x + norm_b
        rel = residual / denom if denom else residual
        kappa = (norm_a * norm_x / norm_b) if norm_b else 0.0
        return kappa, rel

    def comm_report(self, outcomes, elapsed: float, span=None):
        """The comm and work reports of one execute from the ranks'
        ``outcomes`` (``driver.observatories``: the analytical inventory,
        reconciled against the ranks' records when they were recorded, on
        the execute ``span``): ``gather=False`` (the blocks come back
        through the world's files) and no residual section (the
        verification is :meth:`metrics`)."""
        from ..driver import observatories

        key = self.key
        return observatories(
            outcomes, engine=self.engine, lay=self.lay,
            dtype=self.work_dtype, group=self.group, gather=False,
            refine=1, rhs=key.rhs if key.workload == "solve" else 0,
            elapsed=elapsed, span=span,
            record="observed" in outcomes[0])

    def close(self) -> None:
        """End the lane's world."""
        self.world.close()
