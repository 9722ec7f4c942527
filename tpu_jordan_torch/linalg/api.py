"""``solve_system`` and ``lstsq``: the solve workloads as typed results.

The JAX package's ``linalg/api.py``: for real and complex dtypes on one
device, and for real dtypes on p ranks of the 1D layout:
the engine choice (``resolve_solve_engine``, with "auto" resolved by the
tuner at a workload-scoped point: plan cache, cost ranking, measurement
with ``tune=True``), the solve timed with
CUDA events on the card, the verification ‖A·X − B‖∞ against the caller's
A and B, the κ-free backward-error gate and its recovery ladder when a
policy is attached (``resilience/degrade.py``), and the results
:class:`SolveSystemResult` and :class:`LstsqResult`.  Entry points run on
the card unless ``device="cpu"``.  ``telemetry`` records a
``solve_system`` root span with ``load``, ``select``, ``execute``,
``residual`` and ``recover`` children; ``numerics`` gives a
``NumericsReport`` ("summary", or "trace" on the unrolled [A | B] engine).
Every call counts in ``tpu_jordan_torch_workload_requests_total`` and
crosses the ``compile``, ``execute`` and ``result_corrupt_nan`` fault
points (``resilience/faults.py``; a distributed solve the first two, as
in the JAX package).  Complex A and B flow through the engine, the
residual (every norm is of |z|) and the gate; lstsq forms the conjugate
transpose.

``workers=p`` solves on p ranks (``solve_sharded``, or its probe-ahead
twin ``solve_lookahead``; ``parallel/sharded_inplace.py``).  The caller's A
and B are split in this process into each rank's strips (identity-padded
A, zero-padded B, in the compute dtype), and each rank reads only its own,
from a file of its own in the world's temporary directory
(``run_workers(per_rank=...)``): no rank is sent the whole matrix.  The
ranks return their rows of X, which is assembled here (it is O(n·k)) and
verified against the caller's A and B, in either gather mode;
``gather=False`` also keeps the rows as ``x_blocks``.  The policy's refine
rung re-runs the distributed solve on the residual (a world of its own:
the first one has ended), and a recovered X is cut into ``x_blocks``
again.  The ``solve_system`` span tree of a distributed solve has
``scatter``, ``world`` (with ``execute``), ``gather``, ``residual`` and
``recover`` children.  ``workers=(pr, pc)`` solves on a mesh of the 2D
layout (``parallel/jordan2d_inplace.py``): each rank's (bpr, m, N/pc)
shard of A and its mesh row's rows of B reach it the same way, and X's
row blocks come back from mesh column 0 (the pc replicas are equal).  In a
process of a world joined outside (``--distributed``, or a world of the
tests and demos), every rank calls ``solve_system`` with the same A and B,
cuts its own strips, and the ranks' rows of X are gathered to every rank
(``dist_solve.share_outcomes``).  A distributed solve carries the comm and
work observatories on ``comm``/``work`` (``driver.observatories``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import default_block_size
from ..driver import check_entry_options, refuse_tune_for_explicit_engine
from ..errors import SingularMatrixError, UsageError
from ..interop import from_numpy, resolve_device, resolve_dtype
from ..obs import hwcost as _hwcost
from ..obs import metrics as _obs_metrics
from ..obs.spans import NULL as _NULL_TEL
from ..obs.spans import timed_blocking
from ..ops.norms import inf_norm
from ..ops.residual import solve_residual_stats
from ..resilience import faults as _faults
from ..resilience.degrade import backward_error, solve_recover
from ..tuning.registry import SOLVE_ENGINES, TunePoint, select_by_cost
from ..tuning.tuner import auto_select
from .engine import block_jordan_solve, block_jordan_solve_fori

ASSUME = ("general", "spd")
#: The distributed solve engines (SOLVE_ENGINES comes from the registry).
DIST_SOLVE_ENGINES = ("solve_sharded", "solve_lookahead")

_M_WORKLOAD = _obs_metrics.counter(
    "tpu_jordan_torch_workload_requests_total",
    "direct-API workload executions (solve_system / lstsq / "
    "solve_update), labeled by workload")


def count_workload(workload: str) -> None:
    """One direct-API workload execution in the traffic counter."""
    _M_WORKLOAD.inc(workload=workload)


@dataclass
class SolveSystemResult:
    """One ``solve_system`` outcome.  ``residual`` is ‖A·X − B‖∞;
    ``rel_residual`` the normwise backward error it is gated on;
    ``kappa_est`` = ‖A‖∞‖X‖∞/‖B‖∞, a lower bound of κ∞(A) that forms no
    A⁻¹."""

    x: torch.Tensor | None
    elapsed: float                # seconds of the engine call
    residual: float               # ‖A·X − B‖∞
    n: int
    k: int
    block_size: int
    gflops: float                 # n³(1 + k/n) / elapsed
    engine: str | None = None
    workload: str = "solve"
    singular: bool = False
    plan: object | None = None    # tuning.Plan when engine="auto"
    kappa_est: float | None = None
    recovery: tuple = ()          # ladder rungs (policy solves only)
    device: str = ""
    trace: object | None = None   # obs.spans.Span root ("solve_system")
    numerics: object | None = None  # obs.numerics.NumericsReport
    workers: object = 1           # the ranks the solve ran on
    # gather=False distributed solves: each rank's (bpw, m, k) rows of X in
    # cyclic order (rank order), and their layout.
    x_blocks: list | None = None
    layout: object | None = None
    # Distributed solves: one summary a rank (pivots, the steps it probed,
    # its kernels' launches, elapsed, backend and the rule's reason).
    ranks: list | None = None
    # Distributed solves: the obs.comm.CommReport and obs.work.WorkReport.
    comm: object | None = None
    work: object | None = None
    _norm_a: float | None = None
    _norm_x: float | None = None
    _norm_b: float | None = None

    @property
    def rel_residual(self) -> float | None:
        """‖A·X−B‖∞ / (‖A‖∞‖X‖∞ + ‖B‖∞), the normwise backward error;
        ``resilience.solve_gate_threshold`` is its gate."""
        if self._norm_a is None:
            return None
        return backward_error(self.residual, self._norm_a,
                              self._norm_x or 0.0, self._norm_b or 0.0)


@dataclass
class LstsqResult:
    """One ``lstsq`` outcome: ``x`` minimizes ‖A·x − b‖ through the normal
    equations (AᴴA)x = Aᴴb, solved by ``solve_system``.  A singular Gram
    system sets ``rank_deficient`` with ``x=None``; ``kappa_est`` is the
    Gram system's (≈ κ(A)²)."""

    x: torch.Tensor | None
    residual: float               # ‖A·x − b‖∞
    normal_residual: float        # ‖(AᵀA)x − Aᵀb‖∞ of the inner solve
    rows: int
    n: int
    k: int
    rank_deficient: bool
    kappa_est: float | None
    elapsed: float
    engine: str | None = None
    workload: str = "lstsq"
    plan: object | None = None
    inner: SolveSystemResult | None = None


def resolve_solve_engine(engine: str, assume: str):
    """The engine/assume flag contract of the solve workloads.  Returns
    ``(engine, workload)`` with "auto" left for :func:`auto_solve_engine`;
    ``workload`` is "solve_spd" under the assume="spd" promise, else
    "solve"."""
    if assume not in ASSUME:
        raise UsageError(f"unknown assume {assume!r}; choose from "
                         f"{'/'.join(ASSUME)}")
    if engine not in SOLVE_ENGINES:
        raise UsageError(
            f"unknown solve engine {engine!r}; choose from "
            f"{'/'.join(SOLVE_ENGINES)} (the invert engines are not "
            f"solve engines — use driver.solve for inverses)")
    if engine == "solve_spd" and assume != "spd":
        raise UsageError(
            "engine='solve_spd' is the pivot-free path and requires "
            "the assume='spd' promise (skipping pivoting on a general "
            "matrix is unsound)")
    if engine == "solve_lookahead" and assume == "spd":
        raise UsageError(
            "engine='solve_lookahead' overlaps the pivot-condition "
            "probe with the trailing eliminate; the assume='spd' "
            "pivot-free path has nothing to probe ahead — legal "
            "lookahead engines are engine='solve_lookahead' "
            "(assume='general', workers>1) and driver.solve "
            "engine='lookahead'; under spd use engine='solve_spd' or "
            "'auto'")
    return engine, ("solve_spd" if assume == "spd" else "solve")


def auto_solve_engine(n: int, m: int, workload: str) -> str:
    """The registry's cost-only pick on one device at a "solve" or
    "solve_spd" point: where the unrolled engines are legal (Nr <=
    MAX_UNROLL_NR) the cheapest, ``solve_spd`` at "solve_spd" points and
    ``solve_aug`` at "solve" points; above, the pivoting ``solve_fori``
    (the registry's ``solve_fori_spd`` entry at spd points).  No dtype or
    chip constant decides it."""
    return select_by_cost(TunePoint.create(n, m, workload=workload)).engine


def solve_engine_fn(engine: str, m: int):
    """The resolved engine as ``fn(a, b, **kw) -> (x, singular)``."""
    spd = engine == "solve_spd"
    if engine == "solve_fori":
        return lambda aa, bb, **kw: block_jordan_solve_fori(
            aa, bb, block_size=m, spd=spd, **kw)
    return lambda aa, bb, **kw: block_jordan_solve(aa, bb, block_size=m,
                                                   spd=spd, **kw)


def _as_2d_rhs(b, dtype, n: int, what: str, dev):
    b = from_numpy(b, dev, dtype)
    squeezed = b.dim() == 1
    if squeezed:
        b = b[:, None]
    if b.dim() != 2 or b.shape[0] != n or b.shape[1] < 1:
        raise UsageError(
            f"{what} must be (n,) or (n, k>=1) with n={n} rows, got "
            f"shape {tuple(b.shape)}")
    return b, squeezed


def solve_system(
    a,
    b,
    block_size: int | None = None,
    dtype=None,
    assume: str = "general",
    engine: str = "auto",
    workers=1,
    gather: bool = True,
    tune: bool = False,
    plan_cache: str | None = None,
    telemetry=None,
    policy=None,
    numerics: str = "off",
    check: bool = True,
    verbose: bool = False,
    device=None,
) -> SolveSystemResult:
    """Solve A·X = B by Gauss–Jordan on [A | B]; no inverse is formed.

    ``a`` (n, n) and ``b`` ((n,) or (n, k)) are numpy arrays or tensors,
    moved to ``device`` (the card unless "cpu") as ``dtype`` (``a``'s own
    unless given).  ``engine`` is one of SOLVE_ENGINES: "auto" resolves
    through the tuner at the "solve" (or "solve_spd") point on this device
    (``tuning.auto_select``: the JSON plan cache ``plan_cache``, the cost
    ranking, or with ``tune=True`` a measurement; the plan is on
    ``result.plan``); ``assume="spd"`` promises a symmetric (Hermitian,
    for a complex A) positive definite A and makes "auto" take the
    pivot-free path.
    ``policy`` (a ``resilience.ResiliencePolicy``) retries the engine call
    and holds the result to ``rel_residual <= gate_tol·eps·n``
    (``solve_gate_threshold``), walking the solve ladder (refine, repivot
    under spd, an fp32 re-solve of sub-fp32 storage) when it fails;
    ``ResidualGateError`` when the ladder runs out.  ``telemetry`` records
    the ``solve_system`` span tree on ``result.trace``; ``numerics=
    "summary"`` puts the workload-tagged ``NumericsReport`` on
    ``result.numerics`` and ``"trace"`` adds the unrolled engine's
    per-superstep record over [A_live | X] (refused on the spd path and on
    ``solve_fori``, in the JAX package's words); its spikes are recorded
    before any rung.  ``check=False`` reports a singular system on
    ``result.singular`` with ``x=None`` instead of raising
    SingularMatrixError.  ``workers=p`` solves on p ranks (module
    docstring): "auto" resolves at the distributed point to
    ``solve_lookahead`` (``solve_sharded`` beyond MAX_UNROLL_NR); real
    dtypes, the pivoting path and ``numerics="summary"`` only, as in the
    JAX package.  ``gather=False`` (p > 1 only)
    also returns each rank's rows of X as ``x_blocks`` with their
    ``layout``; ``result.ranks`` holds each rank's pivots, probe steps,
    launches and time.  A and B may be complex64 or complex128 on one
    device.  Counterpart of the JAX package's ``solve_system``."""
    from ..obs.numerics import resolve_mode

    check_entry_options(workers, gather, policy,
                        dtype if dtype is not None else getattr(a, "dtype",
                                                                None))
    if isinstance(workers, tuple):
        from ..parallel.group import check_mesh

        check_mesh(int(workers[0]), int(workers[1]),
                   int(workers[0]) * int(workers[1]))
        workers = (int(workers[0]), int(workers[1]))
    elif int(workers) < 1:
        raise UsageError("workers must be >= 1")
    distributed = workers != 1
    if distributed and assume == "spd":
        raise UsageError(
            "assume='spd' is the single-device pivot-free fast "
            "path; the distributed [A | B] elimination pivots "
            "(workers must be 1, or drop the spd promise)")
    numerics = resolve_mode(numerics)
    if numerics == "trace" and distributed:
        raise UsageError(
            "numerics='trace' instruments the single-device unrolled "
            "engines (the per-superstep stats are host-visible there); "
            "distributed solves support numerics='summary'")
    if numerics == "trace" and assume == "spd":
        raise UsageError(
            "numerics='trace' traces the condition-based pivot probe; "
            "the assume='spd' fast path has no probe (one diagonal "
            "candidate per superstep) — use numerics='summary', or "
            "assume='general'")
    engine, workload = resolve_solve_engine(engine, assume)
    if engine == "solve_sharded" and not distributed:
        raise UsageError(
            "engine='solve_sharded' is the distributed [A | B] "
            "elimination (its win is the mesh); pass workers=p or "
            "workers=(pr, pc)")
    if engine == "solve_lookahead" and not distributed:
        raise UsageError(
            "engine='solve_lookahead' is the probe-ahead distributed "
            "[A | B] elimination; it is not wired on the single-device "
            "augmented engine — pass workers=p or workers=(pr, pc), "
            "or use engine='solve_aug'/'auto' single-device (for "
            "inverses, driver.solve engine='lookahead')")
    if distributed and engine not in ("auto",) + DIST_SOLVE_ENGINES:
        raise UsageError(
            f"engine={engine!r} is a single-device solve engine; "
            f"distributed points run engine='solve_sharded' or "
            f"'solve_lookahead' (or 'auto', which resolves there)")
    refuse_tune_for_explicit_engine(engine, tune, plan_cache)
    dev = resolve_device(device)
    tel = telemetry if telemetry is not None else _NULL_TEL
    with tel.span("solve_system", workload=workload) as root:
        with tel.span("load"):
            a = from_numpy(a, dev,
                           None if dtype is None else resolve_dtype(dtype))
            if a.dim() != 2 or a.shape[0] != a.shape[1]:
                raise UsageError(f"expected a square (n, n) matrix, got "
                                 f"shape {tuple(a.shape)}")
            n = int(a.shape[0])
            b2, squeezed = _as_2d_rhs(b, a.dtype, n, "b", dev)
        dtype = a.dtype
        k = int(b2.shape[1])
        m = min(block_size or default_block_size(n), n)
        root.attrs.update(n=n, k=k)
        plan = None
        if engine == "auto":
            engine, _, plan = auto_select(n, m, dtype, workers, gather,
                                          tune=tune, plan_cache=plan_cache,
                                          telemetry=tel, workload=workload,
                                          device=dev)
        if numerics == "trace" and engine == "solve_fori":
            raise UsageError(
                "numerics='trace' instruments the UNROLLED solve engine "
                "only (the fori engine's traced supersteps have no "
                "host-visible stats twin); use a larger block_size so "
                "Nr <= MAX_UNROLL_NR, or numerics='summary'")
        count_workload(workload)
        if engine in DIST_SOLVE_ENGINES:
            result = _solve_system_dist_impl(
                a, b2, n, k, m, dtype, workers, gather, engine,
                workload, plan, tel, policy, numerics, check, verbose, dev)
        else:
            result = _solve_system_impl(a, b2, n, k, m, dtype, engine,
                                        workload, plan, tel, policy,
                                        numerics, check, verbose, dev)
    if telemetry is not None:
        result.trace = root
    if squeezed and result.x is not None:
        result.x = result.x[:, 0]
    return result


def _solve_system_impl(a, b2, n, k, m, dtype, engine, workload, plan, tel,
                       policy, numerics, check, verbose, dev):
    spd = engine == "solve_spd"
    collect = numerics == "trace"
    if dev.type == "cuda":
        # Full fp32 products on the card (the JAX package's HIGHEST).
        torch.backends.cuda.matmul.allow_tf32 = False

    def ready():
        # The compile analogue (resilience/faults.py): the engine callable.
        _faults.fire("compile")
        return solve_engine_fn(engine, m)

    run = (policy.retry.call(ready, component="solve_system.compile")
           if policy is not None else ready())

    def execute():
        _faults.fire("execute")
        return timed_blocking(
            lambda: (run(a, b2, collect_stats=True) if collect
                     else run(a, b2)),
            telemetry=tel, name="execute", device=dev, engine=engine,
            workload=workload)

    out, esp = (policy.retry.call(execute, component="solve_system.execute")
                if policy is not None else execute())
    x, singular = out[:2]
    nstats = out[2] if collect else None
    elapsed = esp.duration
    flops = _hwcost.baseline_workload_flops(n, workload, k=k)
    if elapsed > 0:
        esp.attrs["gflops"] = round(flops / elapsed / 1e9, 3)
    _hwcost.attach_execute_cost(esp, _hwcost.executable_cost(),
                                analytical_flops=flops)
    _obs_metrics.histogram(
        "tpu_jordan_torch_solve_seconds",
        "timed elimination seconds (the glob_time analog)",
    ).observe(elapsed, workload=workload)
    if _faults.corrupt("result_corrupt_nan"):
        x = x.clone()
        x[0, 0] = float("nan")
    if bool(singular):
        _obs_metrics.counter("tpu_jordan_torch_singular_total",
                             "solves/requests flagged singular"
                             ).inc(component="solve_system")
        if check:
            raise SingularMatrixError("singular matrix")
        return SolveSystemResult(
            x=None, elapsed=elapsed, residual=float("inf"), n=n, k=k,
            block_size=m, gflops=0.0, engine=engine, workload=workload,
            singular=True, plan=plan, device=str(dev))

    with tel.span("residual"):
        stats = solve_residual_stats(a, x, b2)
    residual, norm_a, norm_x, norm_b = stats
    kappa_est = (norm_a * norm_x / norm_b) if norm_b else None
    nreport = None
    if numerics != "off":
        # Recorded and spiked BEFORE the ladder.
        nreport = _solve_numerics(
            n, m, engine, workload, backward_error(*stats), kappa_est,
            norm_a, dtype, policy, stats=nstats)
    recovery = ()
    if policy is not None:
        def fresh(aa, bb, pivot_free):
            # A fresh re-solve on the engine auto picks (the unrolled
            # engines within MAX_UNROLL_NR, solve_fori beyond).
            return solve_engine_fn(auto_solve_engine(
                n, m, "solve_spd" if pivot_free else "solve"), m)(aa, bb)

        x, stats, recovery = solve_recover(
            policy, tel, a=a, b=b2, x=x, stats=stats, n=n, dtype=dtype,
            spd=spd, rerun=run, fresh=fresh, workload=workload)
    residual, norm_a, norm_x, norm_b = stats
    if verbose:
        print(f"glob_time: {elapsed:.2f}")
        print(f"residual: {residual:e}")
    return SolveSystemResult(
        x=x, elapsed=elapsed, residual=residual, n=n, k=k, block_size=m,
        gflops=(flops / elapsed / 1e9) if elapsed > 0 else 0.0,
        engine=engine, workload=workload, singular=False, plan=plan,
        kappa_est=(norm_a * norm_x / norm_b) if norm_b else None,
        recovery=recovery, device=str(x.device), numerics=nreport,
        _norm_a=norm_a, _norm_x=norm_x, _norm_b=norm_b)


def _solve_system_dist_impl(a, b2, n, k, m, dtype, workers, gather, engine,
                            workload, plan, tel, policy, numerics, check,
                            verbose, dev):
    """The distributed solve (the JAX package's ``_solve_system_dist_impl``
    on the 1D layout or the 2D mesh, one process per rank): each rank's
    strips (shards) of [A | B] in the compute dtype, the ranks'
    elimination, X assembled here and verified densely against the
    caller's A and B.  The ``compile`` fault point fires under the
    policy's retry, ``execute`` unretried, and no other, as there."""
    import torch.distributed as dist

    from ..driver import WORLD_DEADLINE_S, observatories
    from ..obs.comm import recording_active
    from ..parallel.dist_solve import (DistSolveSpec, join_rhs,
                                       share_outcomes, solve_system_rank,
                                       split_rhs, split_strips)
    from ..parallel.launch import run_workers
    from ..parallel.layout import CyclicLayout

    work = torch.float32 if dtype.itemsize < 4 else dtype
    lookahead = engine == "solve_lookahead"
    mesh = workers if isinstance(workers, tuple) else None
    # The JAX compile's refusal (solve_lookahead is unrolled-only), before
    # any rank starts.
    if mesh is None:
        from ..parallel.sharded_inplace import compile_sharded_jordan_solve

        p = workers
        lay = CyclicLayout.create(n, m, p)
        compile_sharded_jordan_solve(lay, lookahead=lookahead)
    else:
        from ..parallel.jordan2d_inplace import \
            compile_sharded_jordan_solve_2d
        from ..parallel.layout import CyclicLayout2D

        p = mesh[0] * mesh[1]
        lay = CyclicLayout2D.create(n, m, *mesh)
        compile_sharded_jordan_solve_2d(lay, lookahead=lookahead)

    def gather_x(blocks):
        return join_rhs(blocks, lay, n)

    with tel.span("scatter"):
        a_strips = [s.numpy() for s in split_strips(a.to(work).cpu(), lay)]

    def ready():
        # The compile analogue (resilience/faults.py): the world's spec.
        _faults.fire("compile")
        return DistSolveSpec(n=n, m=m,
                             dtype=str(work).removeprefix("torch."),
                             engine=engine, mesh=mesh,
                             record=recording_active())

    spec = (policy.retry.call(ready, component="solve_system.compile")
            if policy is not None else ready())

    def world(rhs):
        rhs = rhs.to(work).cpu()
        if dist.is_initialized():
            from ..parallel.group import MeshSizeError, current_group

            grp = current_group(dev.type)
            if grp.world_size != p:
                raise MeshSizeError(
                    f"workers={workers} but this process's world has "
                    f"{grp.world_size} ranks")
            out = solve_system_rank(grp, spec, a_strips[grp.rank],
                                    split_rhs(rhs, lay)[grp.rank].numpy())
            return share_outcomes(out, drop=())
        return run_workers(
            p, solve_system_rank, spec,
            per_rank=[(a_strips[r], x.numpy())
                      for r, x in enumerate(split_rhs(rhs, lay))],
            deadline_s=WORLD_DEADLINE_S, device_type=dev.type)

    def assemble(results):
        return (gather_x([r["x_blocks"] for r in results]).to(
                    device=dev, dtype=dtype),
                any(r["singular"] for r in results))

    _faults.fire("execute")
    with tel.span("world", workers=p) as wsp:
        results = world(b2)
    elapsed = max(r["elapsed"] for r in results)
    wsp.attrs["backend"] = results[0]["backend"]
    esp = wsp.child("execute", wsp.t_start, wsp.t_start + elapsed,
                    clock="cuda_event" if dev.type == "cuda" else "host",
                    engine=engine, workload=workload)
    flops = _hwcost.baseline_workload_flops(n, workload, k=k)
    if elapsed > 0:
        esp.attrs["gflops"] = round(flops / elapsed / 1e9, 3)
    _hwcost.attach_execute_cost(esp, _hwcost.executable_cost(),
                                analytical_flops=flops)
    _obs_metrics.histogram(
        "tpu_jordan_torch_solve_seconds",
        "timed elimination seconds (the glob_time analog)",
    ).observe(elapsed, workload=workload)
    ranks = [{key: v for key, v in r.items() if key != "x_blocks"}
             for r in results]
    comm, wrep = observatories(
        ranks, engine=engine, lay=lay, dtype=work, rhs=k, gather=gather,
        elapsed=elapsed, span=esp, record=spec.record)
    common = dict(n=n, k=k, block_size=m, engine=engine, workload=workload,
                  plan=plan, workers=workers, ranks=ranks, comm=comm,
                  work=wrep)
    with tel.span("gather", gathered=gather):
        x, singular = assemble(results)
        xb = None if gather else [r["x_blocks"].to(dtype) for r in results]
    if singular:
        _obs_metrics.counter("tpu_jordan_torch_singular_total",
                             "solves/requests flagged singular"
                             ).inc(component="solve_system")
        if check:
            raise SingularMatrixError("singular matrix")
        return SolveSystemResult(x=None, elapsed=elapsed,
                                 residual=float("inf"), gflops=0.0,
                                 singular=True, device=str(dev), **common)
    with tel.span("residual"):
        stats = solve_residual_stats(a, x, b2)
    residual, norm_a, norm_x, norm_b = stats
    nreport = None
    if numerics != "off":
        nreport = _solve_numerics(
            n, m, engine, workload, backward_error(*stats),
            (norm_a * norm_x / norm_b) if norm_b else None, norm_a, dtype,
            policy)
    recovery = ()
    if policy is not None:
        def rerun(_a, r):
            # The refine rung: the distributed solve again, on the
            # residual right-hand side.
            return assemble(world(r))

        def fresh(aa, bb, pivot_free):
            # Deeper rungs: a fresh single-device solve, as in the JAX
            # package's ladder.
            return solve_engine_fn(auto_solve_engine(
                n, m, "solve_spd" if pivot_free else "solve"), m)(aa, bb)

        x, stats, recovery = solve_recover(
            policy, tel, a=a, b=b2, x=x, stats=stats, n=n, dtype=dtype,
            spd=False, rerun=rerun, fresh=fresh, workload=workload)
        if recovery and not gather:
            # A rung replaced X: cut the recovered solution into the
            # ranks' rows again, never hand out the pre-recovery blocks.
            xb = split_rhs(x.cpu(), lay)
    residual, norm_a, norm_x, norm_b = stats
    if verbose:
        print(f"glob_time: {elapsed:.2f}")
        print(f"residual: {residual:e}")
    return SolveSystemResult(
        x=x, elapsed=elapsed, residual=residual,
        gflops=(flops / elapsed / 1e9) if elapsed > 0 else 0.0,
        singular=False, kappa_est=(norm_a * norm_x / norm_b) if norm_b
        else None, recovery=recovery, device=str(x.device),
        numerics=nreport, x_blocks=xb, layout=None if gather else lay,
        _norm_a=norm_a, _norm_x=norm_x, _norm_b=norm_b, **common)


def _solve_numerics(n, m, engine, workload, rel, kappa_est, norm_a, dtype,
                    policy, stats=None):
    """The solve's numerics record: the κ-free backward error, the
    ‖A‖‖X‖/‖B‖ estimate as κ, and with ``stats`` the engine's
    per-superstep record; spiked at the policy's solve gate."""
    from ..obs import numerics as _numerics
    from ..resilience.degrade import solve_gate_threshold

    kw = dict(n=n, block_size=m, engine=engine, rel_residual=rel,
              kappa=(kappa_est if kappa_est is not None else 1.0),
              norm_a=norm_a, dtype=dtype, workload=workload)
    if stats is not None:
        report = _numerics.trace_report(stats, trace_engine=engine, **kw)
    else:
        report = _numerics.summary_report(**kw)
    _numerics.observe(report)
    thresholds = None
    if policy is not None:
        gd = policy.gate_dtype if policy.gate_dtype is not None else dtype
        thresholds = _numerics.SpikeThresholds(
            residual=solve_gate_threshold(policy, n, gd))
    _numerics.record_spikes(report, thresholds)
    return report


def lstsq(
    a,
    b,
    block_size: int | None = None,
    dtype=None,
    assume: str = "spd",
    engine: str = "auto",
    tune: bool = False,
    plan_cache: str | None = None,
    telemetry=None,
    policy=None,
    numerics: str = "off",
    verbose: bool = False,
    device=None,
) -> LstsqResult:
    """argmin‖A·x − b‖₂ for a full-column-rank (rows, n) A through the
    normal equations (AᴴA)x = Aᴴb (Aᴴ = Aᵀ for a real A): the Gram matrix
    and the projected right-hand sides by ``torch.matmul``, then
    :func:`solve_system`, on the pivot-free path under the default
    ``assume="spd"`` (the Gram matrix of a full-column-rank A is Hermitian
    positive definite).  A singular Gram system is surfaced as
    ``rank_deficient=True`` with ``x=None``.  The normal equations square
    the conditioning; ``residual`` reports the original ‖A·x − b‖∞ beside
    the Gram system's.  ``engine``, ``tune`` and ``plan_cache`` go to that
    solve, whose plan is on ``result.plan``; ``telemetry`` and
    ``numerics`` too (its span tree and report are ``result.inner``'s).
    Counterpart of the JAX package's ``lstsq``."""
    check_entry_options(1, True, policy,
                        dtype if dtype is not None else getattr(a, "dtype",
                                                                None))
    dev = resolve_device(device)
    a = from_numpy(a, dev, None if dtype is None else resolve_dtype(dtype))
    if a.dim() != 2:
        raise UsageError(f"expected a (rows, n) matrix, got shape "
                         f"{tuple(a.shape)}")
    rows, n = int(a.shape[0]), int(a.shape[1])
    if rows < n:
        raise UsageError(
            f"lstsq needs rows >= n (got {rows} x {n}); the "
            f"underdetermined minimum-norm problem is not implemented")
    b2, squeezed = _as_2d_rhs(b, a.dtype, rows, "b", dev)
    k = int(b2.shape[1])
    count_workload("lstsq")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ah = a.T.conj() if a.is_complex() else a.T
    gram = ah @ a
    rhs = ah @ b2
    inner = solve_system(gram, rhs, block_size=block_size, assume=assume,
                         engine=engine, tune=tune, plan_cache=plan_cache,
                         telemetry=telemetry, policy=policy,
                         numerics=numerics, check=False, device=dev)
    if inner.singular:
        if verbose:
            print("rank deficient (singular normal equations)")
        return LstsqResult(
            x=None, residual=float("inf"), normal_residual=float("inf"),
            rows=rows, n=n, k=k, rank_deficient=True, kappa_est=None,
            elapsed=inner.elapsed, engine=inner.engine, plan=inner.plan,
            inner=inner)
    x = inner.x
    residual = float(inf_norm(a @ x.to(a.dtype) - b2))
    if verbose:
        print(f"lstsq residual: {residual:e}")
    return LstsqResult(
        x=x[:, 0] if squeezed else x, residual=residual,
        normal_residual=inner.residual, rows=rows, n=n, k=k,
        rank_deficient=False, kappa_est=inner.kappa_est,
        elapsed=inner.elapsed, engine=inner.engine, plan=inner.plan,
        inner=inner)
