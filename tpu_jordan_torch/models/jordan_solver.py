"""JordanSolver: a configured inversion pipeline, reused across many
matrices of one shape.

The reference re-runs its whole program per matrix (main.cpp:65-93).  The
JAX package's solver caches a compiled executable; torch has none to
compile, so this one caches what the port can: the resolved engine, as a
callable, and its block size, fixed at construction; ``engine="auto"``
resolves once, through the tuner, at construction.  The first
:meth:`JordanSolver.invert` crosses the ``compile`` fault point
(``resilience/faults.py``), where the JAX solver compiles, and every
``invert`` the ``execute`` point inside the policy's retry.

**Distributed** (``workers=p`` or a (pr, pc) mesh): the solver owns one
persistent world of ranks (``parallel/world.py``) for its life, the port's
counterpart of the JAX solver's cached sharded executable: the first
``invert`` starts it, a second ``invert`` starts none.  Each ``invert``
hands every rank its own strip (shard) of A and runs the engine there;
with ``gather=True`` the inverse comes back through the world's files and
is assembled here, with ``gather=False`` the inverse blocks stay on the
ranks and ``invert`` returns a :class:`DistributedInverse` naming them,
which :meth:`JordanSolver.residual` verifies on the ranks (the ring or
SUMMA residual) without forming anything n×n in any process.  ``comm``
and ``work`` are the last invert's reports (``obs/comm.py``,
``obs/work.py``); the residual section is counted only when ``residual``
runs.  Departure from the JAX package: the solver holds processes, so it
has :meth:`JordanSolver.close` and is a context manager (a closed solver's
world is gone; an ``atexit`` hook ends it otherwise).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Any

import torch

from ..config import default_block_size
from ..errors import UsageError
from ..interop import from_numpy, resolve_device, resolve_dtype
from ..obs import spans as _spans
from ..ops import residual_inf_norm
from ..ops.jordan_inplace import _SUB_FP32
from ..resilience import faults as _faults

_HANDLES = itertools.count(1)


@dataclass(frozen=True)
class DistributedInverse:
    """The ``gather=False`` result of a distributed ``invert``: the inverse
    blocks stay on the solver's ranks under ``key`` (each rank its
    (bpw, m, N) strip, or its (bpr, m, N/pc) shard, in ``layout``)."""

    key: str
    n: int
    layout: Any
    dtype: Any


@dataclass
class JordanSolver:
    """Configured blocked Gauss–Jordan inversion on one device or on p
    ranks (module docstring).

    ``n`` the matrix dimension; ``block_size`` the pivot block size m
    (``config.default_block_size(n)`` unless given); ``dtype`` the storage
    dtype (sub-fp32 computes in fp32 and rounds once at the end; complex64
    and complex128 run the augmented engine, on one device); ``refine``
    Newton–Schulz steps after every inversion (``gather=True``);
    ``workers`` 1, p ranks or a (pr, pc) mesh; ``precision`` "highest"
    only (as ``driver.solve``); ``gather`` False keeps a distributed
    inverse on the ranks; ``engine``/``group`` as
    ``driver.resolve_engine``, "auto" resolved by the tuner's ladder as in
    ``driver.solve`` (the plan cache ``plan_cache``, the cost ranking,
    measurement with ``tune=True``; complex: "augmented"), the plan kept
    on ``plan``; ``policy`` a ``resilience.ResiliencePolicy`` whose retry
    wraps every engine call; ``telemetry`` an ``obs.Telemetry``: the
    construction's ``select`` span (engine="auto"), and an ``invert``
    (``invert_batch``) root for every call, its ``execute`` child timed
    by ``obs.spans.timed_blocking`` with the engine's measured steps
    under it, its rates and the registry's solve counters (as
    ``driver.solve`` keeps them); without it a call is timed by nothing,
    and while a ``torch.profiler`` collects its spans go to
    ``obs.spans.PROFILED``, timed by CUDA events with no synchronisation
    of their own; ``device`` the card unless "cpu".
    Counterpart of the JAX package's ``models.JordanSolver``."""

    n: int
    block_size: int | None = None
    dtype: Any = torch.float32
    refine: int = 0
    workers: Any = 1
    precision: str = "highest"
    gather: bool = True
    engine: str = "auto"
    group: int = 0
    tune: bool = False
    plan_cache: str | None = None
    telemetry: Any = None
    policy: Any = None
    device: Any = None
    plan: Any = field(default=None, repr=False)
    #: The last distributed invert's ``obs.comm.CommReport`` and
    #: ``obs.work.WorkReport`` (None on one device).
    comm: Any = field(default=None, repr=False)
    work: Any = field(default=None, repr=False)
    _run: Any = field(default=None, repr=False)
    _compiled: bool = field(default=False, repr=False)

    def __post_init__(self):
        from ..driver import (PALLAS_ENGINES, check_entry_options, invert,
                              resolve_invert_engine)
        from ..ops.refine import resolve_precision

        if isinstance(self.workers, (list, tuple)):
            self.workers = (int(self.workers[0]), int(self.workers[1]))
        check_entry_options(self.workers, self.gather, self.policy,
                            self.dtype)
        if self._distributed and not self.gather:
            # The JAX solver's gather flags, before refine is bumped.
            if self.precision == "mixed":
                raise UsageError(
                    "precision='mixed' requires gather=True: it implies >=2 "
                    "Newton-Schulz steps, which run on the gathered inverse")
            if self.refine:
                raise UsageError("refine requires gather=True (it runs on "
                                 "the gathered inverse)")
        self.dtype = resolve_dtype(self.dtype)
        self._device = resolve_device(self.device)
        if self.block_size is None:
            self.block_size = default_block_size(self.n)
        _, self.refine = resolve_precision(self.precision, self.refine)
        # The resolution of driver.solve, once: the pick is pinned on
        # engine/group/plan.
        self.engine, self.group, self.plan = resolve_invert_engine(
            self.engine, self.group, self.n, self.block_size, self.dtype,
            tune=self.tune, plan_cache=self.plan_cache,
            workers=self.workers, gather=self.gather, device=self._device,
            telemetry=self.telemetry)
        self._work_dtype = (torch.float32 if self.dtype in _SUB_FP32
                            else self.dtype)
        self._world = None
        if not self._distributed:
            self._run = partial(invert, engine=self.engine, group=self.group,
                                block_size=self.block_size,
                                refine=self.refine)
            return
        if self.engine in PALLAS_ENGINES:
            raise UsageError(
                f"engine={self.engine!r} is a single-device fused-kernel "
                "engine (no sharded variant yet); use engine='grouped' "
                "on distributed meshes")
        from ..parallel.dist_solve import DistSpec
        from ..parallel.layout import CyclicLayout, CyclicLayout2D
        from ..parallel.world import World

        m = min(self.block_size, self.n)
        mesh = self.workers if isinstance(self.workers, tuple) else None
        if mesh is not None:
            from ..parallel.group import check_mesh

            check_mesh(mesh[0], mesh[1], mesh[0] * mesh[1])
            self.layout = CyclicLayout2D.create(self.n, m, *mesh)
            if self.engine != "augmented":
                from ..parallel.jordan2d_inplace import check_engine_2d

                check_engine_2d(self.layout, self.engine, self.group)
        else:
            self.layout = CyclicLayout.create(self.n, m, self.workers)
        self._spec = DistSpec(
            n=self.n, m=m, generator="rand",
            dtype=str(self._work_dtype).removeprefix("torch."),
            engine=self.engine, group_k=self.group, mesh=mesh)
        self._world = World(self.workers, self._device.type)

    @property
    def _distributed(self) -> bool:
        return isinstance(self.workers, tuple) or self.workers != 1

    @property
    def world(self):
        """The solver's persistent world of ranks (None on one device)."""
        return self._world

    def close(self) -> None:
        """End the solver's world of ranks (a no-op on one device)."""
        if self._world is not None:
            self._world.close()

    def __enter__(self) -> "JordanSolver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _compile(self):
        """The JAX solver's compile, once per configuration: here only its
        ``compile`` fault point (the engine callable is ``_run``, or the
        world on p ranks)."""
        if self.policy is not None:
            self.policy.retry.call(lambda: _faults.fire("compile"),
                                   component="solver.compile")
        else:
            _faults.fire("compile")
        self._compiled = True

    def _matrix(self, a, shape):
        a = from_numpy(a, self._device, self._work_dtype)
        if tuple(a.shape[-2:]) != shape[-2:] or (
                len(shape) == 2 and a.dim() != 2):
            raise ValueError(f"expected {shape}, got {tuple(a.shape)}")
        return a

    def _execute(self, fn):
        if self._device.type == "cuda":
            # Full fp32 products on the card (the JAX package's HIGHEST).
            torch.backends.cuda.matmul.allow_tf32 = False
        return (self.policy.retry.call(fn, component="solver.execute")
                if self.policy is not None else fn())

    def invert(self, a):
        """Invert one (n, n) matrix (a numpy array or a tensor); returns
        ``(inverse, singular)``, the inverse in the storage dtype and
        ``singular`` a 0-d bool tensor.  Distributed with ``gather=False``
        the first element is a :class:`DistributedInverse`.  While spans
        are on the call is an ``invert`` span around an ``execute``
        child (class docstring)."""
        tel = _spans.active(self.telemetry)
        if tel is None:
            return self._invert(a, None)
        with tel.span("invert", n=self.n, engine=self.engine):
            return self._invert(a, tel)

    def _invert(self, a, tel):
        a = self._matrix(a, (self.n, self.n))
        if not self._compiled:
            self._compile()
        if self._distributed:
            return self._invert_distributed(a)

        def run():
            _faults.fire("execute")
            return self._engine_call(tel, self._run, a, 1)

        inv, singular = self._execute(run)
        return inv.to(self.dtype), singular

    def _engine_call(self, tel, fn, a, batch: int):
        """``fn(a)``, in an ``execute`` span while spans are on: with the
        solver's own telemetry timed by ``timed_blocking`` and counted in
        the registry (``driver._solve_metrics``, no read of the singular
        flag), else timed on the device without a synchronisation."""
        if tel is None:
            return fn(a)
        if tel is not self.telemetry:
            with tel.span("execute", device=self._device,
                          engine=self.engine, batch=batch):
                return fn(a)
        from ..driver import _solve_metrics
        from ..obs import hwcost as _hwcost

        out, esp = _spans.timed_blocking(
            fn, a, telemetry=tel, name="execute", device=self._device,
            engine=self.engine, batch=batch)
        _solve_metrics(self.n, esp.duration, esp, batch=batch)
        _hwcost.attach_execute_cost(
            esp, analytical_flops=2.0 * float(self.n) ** 3 * batch)
        return out

    def _record(self):
        from ..obs.comm import recording_active

        return replace(self._spec, record=recording_active())

    def _invert_distributed(self, a):
        from ..driver import WORLD_DEADLINE_S
        from ..obs import comm as _comm
        from ..obs import work as _work
        from ..obs.spans import NULL
        from ..parallel.dist_solve import (invert_strip_rank, join_strips,
                                           split_strips)

        strips = split_strips(a.cpu(), self.layout)
        keep = None if self.gather else f"solver{id(self)}-{next(_HANDLES)}"
        spec = self._record()
        tel = self.telemetry if self.telemetry is not None else NULL

        def run():
            _faults.fire("execute")
            with tel.span("execute", engine=self.engine,
                          workers=str(self.workers)) as esp:
                outs = self._world.run(invert_strip_rank, spec,
                                       per_rank=[(s, keep) for s in strips],
                                       deadline_s=WORLD_DEADLINE_S)
            return outs, esp

        outs, esp = self._execute(run)
        head = outs[0]
        self.comm = _comm.engine_report(
            engine=self.engine, lay=self.layout, dtype=self._work_dtype,
            pivots=head["pivots"], pinned=head.get("pinned", ()),
            gather=False, refine=1, group=self.group,
            singular=head["singular"])
        self.work = _work.engine_report(engine=self.engine, lay=self.layout,
                                        dtype=self._work_dtype,
                                        group=self.group)
        self._observed = None
        if spec.record:
            self._observed = {o["rank"]: o["observed"] for o in outs}
            self.comm.attach_observed(self._observed)
            self.work.attach_counted([o["gemm_flops"] for o in outs])
        else:
            self.work.attach_counted(None)
        self.comm.observe_metrics()
        self.work.observe_metrics()
        self.comm.attach_span(esp)
        self.work.attach_span(esp)
        self._pivots = head["pivots"]
        self._pinned = head.get("pinned", ())
        self.ranks = [{k: v for k, v in o.items()
                       if k not in ("blocks", "observed")} for o in outs]
        singular = torch.tensor(any(o["singular"] for o in outs))
        if keep is not None:
            return (DistributedInverse(keep, self.n, self.layout,
                                       self.dtype), singular)
        inv = join_strips([o["blocks"] for o in outs], self.layout,
                          self.n).to(self._device, self._work_dtype)
        if self.refine and not bool(singular):
            from ..ops import newton_schulz

            inv = newton_schulz(a, inv, self.refine)
        return inv.to(self.dtype), singular

    def invert_batch(self, stack):
        """Invert a (B, n, n) stack through the batched engine
        (``ops/batched.py``, one probe call a superstep for the whole
        stack); returns ``(inverses, singular_flags)`` of shapes (B, n, n)
        and (B,).  Real dtypes on one device only: the batched engine is
        the in-place one.  Spanned as :meth:`invert` is, the root named
        ``invert_batch``."""
        if self._distributed:
            raise UsageError(
                "invert_batch is single-device; for distributed batches "
                "shard the batch axis over the mesh")
        if self.dtype.is_complex:
            raise UsageError("invert_batch runs the batched in-place "
                             "engine, a real-dtype engine; invert complex "
                             "matrices one at a time")
        tel = _spans.active(self.telemetry)
        if tel is None:
            return self._invert_batch(stack, None)
        with tel.span("invert_batch", n=self.n, engine="batched"):
            return self._invert_batch(stack, tel)

    def _invert_batch(self, stack, tel):
        from ..ops import batched_jordan_invert

        a = self._matrix(stack, (-1, self.n, self.n))
        run = partial(batched_jordan_invert, block_size=self.block_size,
                      refine=self.refine)
        inv, sing = self._execute(
            lambda: self._engine_call(tel, run, a, a.shape[0]))
        return inv.to(self.dtype), sing

    def residual(self, a, inv) -> float:
        """The independent ‖A·A⁻¹ − I‖∞ of ``inv`` against ``a``: whatever
        ``invert`` returned, or any inverse.  Distributed, it runs on the
        ranks (the ring residual, or SUMMA on a mesh): an n×n ``inv`` is
        cut into the ranks' strips, a :class:`DistributedInverse` is read
        where it lies."""
        a = self._matrix(a, (self.n, self.n))
        if not self._distributed:
            inv = from_numpy(inv, self._device, self._work_dtype)
            return float(residual_inf_norm(a, inv))
        from ..driver import WORLD_DEADLINE_S
        from ..parallel.dist_solve import residual_strip_rank, split_strips

        strips = split_strips(a.cpu(), self.layout)
        if isinstance(inv, DistributedInverse):
            invs = [inv.key] * len(strips)
        else:
            inv = from_numpy(inv, "cpu", self._work_dtype)
            invs = split_strips(inv, self.layout)
        spec = self._record()
        outs = self._world.run(residual_strip_rank, spec,
                               per_rank=list(zip(strips, invs)),
                               deadline_s=WORLD_DEADLINE_S)
        self._count_residual(outs, spec.record)
        return float(outs[0]["residual"])

    def _count_residual(self, outs, recorded: bool) -> None:
        """The residual section of the comm report, counted now that it
        ran (the report grows it; the invert's sections are not
        recounted)."""
        from ..obs import comm as _comm

        if self.comm is None or getattr(self, "_pivots", None) is None:
            return
        full = _comm.engine_report(
            engine=self.engine, lay=self.layout, dtype=self._work_dtype,
            pivots=self._pivots, pinned=self._pinned,
            gather=False, refine=0, group=self.group)
        if recorded and self._observed is not None:
            merged = {r: dict(d) for r, d in self._observed.items()}
            for o in outs:
                merged.setdefault(o["rank"], {}).update(o["observed"])
            full.attach_observed(merged)
        full.observe_metrics(sections=("residual",))
        self.comm = full

    def drop(self, inv: DistributedInverse) -> None:
        """Free the ranks' blocks of a ``gather=False`` inverse."""
        from ..parallel.dist_solve import drop_state

        self._world.run(drop_state, [inv.key])

