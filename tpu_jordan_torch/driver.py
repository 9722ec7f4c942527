"""End-to-end solve driver: the single-device core of the JAX package's
``driver.solve``, and its ``solve_batch``.

Rebuild of ``solve`` (main.cpp:343-519): generate or read A, time the
inversion, then verify independently with the residual ‖A·A⁻¹ − I‖∞ on a
freshly regenerated/re-read A (the reference destroys A and reloads it,
main.cpp:463-488, so verification never trusts state left over from the
algorithm).

On the card the inversion is timed with CUDA events around the engine call
(``obs.spans.timed_blocking``; the first call of a process also builds the
kernels, so callers that want a steady-state time run it twice).  fp32
products run in full fp32: ``solve`` turns TF32 off for cuBLAS, the
counterpart of the JAX package's ``Precision.HIGHEST``.

With ``telemetry`` (an ``obs.Telemetry``) the solve is a span tree on
``SolveResult.trace``: ``solve`` → ``select`` (the tuner) / ``load`` /
``execute`` (with the engine's measured steps and hot-loop phases,
``obs/spans.py``) / ``residual`` / ``recover``.  The execute span's
duration IS ``elapsed``.  ``numerics="summary"|"trace"``
puts an ``obs.numerics.NumericsReport`` on ``SolveResult.numerics``,
mirrored into the metrics and spiked into the flight recorder before any
ladder rung.  With ``telemetry=None`` and ``numerics="off"`` (the
defaults) a solve launches what it launches without them: no statistics,
no synchronize but the timing's own.

With a ``policy`` (auto-attached for ``grouped_pallas_bf16``), the engine
call runs under the policy's retry and the result must pass the residual
gate, walking the degradation ladder (``resilience/degrade.py``) when it
does not.  A solve crosses the ``compile``, ``execute`` and
``result_corrupt_nan`` fault points where the JAX package's does
(``resilience/faults.py``).

Complex dtypes (complex64, complex128) run single-device on the augmented
engine, as in the JAX package: ``engine="auto"`` resolves to it and every
real-only engine is refused (:func:`complex_engine`).  Residuals, norms and
κ∞ are real.

``workers=p`` runs the 1D row-block-cyclic engines (``parallel/``) on p
ranks of ``torch.distributed``: spawned here (``parallel/launch.py``), or,
when this process already belongs to a world of p ranks (``--distributed``
under ``torchrun``), as this process's rank.  Each rank generates its
strip, the engine is timed between CUDA events on every rank (``elapsed``
is the slowest rank's), and the residual is the ring GEMM's.  With a
``file`` each rank streams its own strips from it (``parallel/
scatter_stream.py``: one strip of host memory at a time, no scatter from a
root) and re-reads them for the verification.  ``tune=True`` measures the
distributed engines, each in one world of ranks.  ``workers=(pr, pc)``
runs the 2D block-cyclic engines (``parallel/jordan2d_inplace.py``) on a
mesh of pr·pc ranks: each rank generates or streams its (bpr, m, N/pc)
shard, and the residual is the SUMMA residual's.  Every distributed solve
carries the communication and work observatories (``obs/comm.py``,
``obs/work.py``) on ``SolveResult.comm``/``.work`` and its execute span:
the analytical inventories always; under ``obs.comm.recording()`` the
collectives each rank issued, reconciled per rank and for the world, and
the counted GEMM FLOPs of the pin.  Rank 0 assembles them whether the
ranks were spawned here or joined under ``torchrun`` (there the ranks'
records are gathered to every rank).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import torch

from .config import MAX_UNROLL_NR, default_block_size
from .errors import SingularMatrixError, UsageError
from .interop import from_numpy, resolve_device, resolve_dtype
from .io import (MatrixReadError, MatrixStripReader, read_matrix_corner,
                 read_matrix_file)
from .ops import (
    batched_jordan_invert,
    block_jordan_invert,
    block_jordan_invert_inplace,
    block_jordan_invert_inplace_grouped,
    block_jordan_invert_inplace_grouped_lookahead,
    block_jordan_invert_inplace_grouped_pallas,
    block_jordan_invert_inplace_lookahead,
    generate,
    generate_batch,
    inf_norm,
    residual_inf_norm,
)
from .obs import hwcost as _hwcost
from .obs import metrics as _obs_metrics
from .obs.spans import NULL as _NULL_TEL
from .obs.spans import timed_blocking
from .ops.refine import resolve_precision
from .resilience import faults as _faults
from .resilience.degrade import maybe_recover
from .resilience.policy import DEFAULT_POLICY, ResiliencePolicy
from .tuning.registry import (ENGINES, GROUPED_MIN_SINGLE_CHIP_N,
                              PALLAS_ENGINES)
from .tuning.tuner import auto_select

__all__ = ["ENGINES", "GROUPED_MIN_SINGLE_CHIP_N", "MAX_UNROLL_NR",
           "PALLAS_ENGINES", "SingularMatrixError", "SolveResult",
           "UsageError", "batch_metrics", "complex_engine", "invert",
           "resolve_engine", "resolve_invert_engine", "solve",
           "solve_batch"]

# ENGINES (the invert vocabulary, "auto" first), PALLAS_ENGINES (the
# fused-update engines) and GROUPED_MIN_SINGLE_CHIP_N come from the
# registry (tuning/registry.py).

#: Seconds a distributed world may run before its ranks are killed and the
#: solve fails naming the rank (``parallel.launch.WorkerError``).
WORLD_DEADLINE_S = 1800.0


@dataclass
class SolveResult:
    inverse: torch.Tensor | None
    elapsed: float          # seconds, the reference's glob_time (main.cpp:455-458)
    residual: float         # ‖A·A⁻¹ − I‖∞ (main.cpp:490-513)
    n: int
    block_size: int
    gflops: float           # 2n³ / t
    kappa: float | None = None   # κ∞(A) = ‖A‖∞‖A⁻¹‖∞
    engine: str | None = None    # the resolved engine that ran
    group: int = 0               # resolved delayed-group size (0 = ungrouped)
    plan: object | None = None   # tuning.Plan when engine="auto" selected it
    device: str = ""             # where it ran, e.g. "cuda:0" or "cpu"
    _norm_a: float | None = None  # ‖A‖∞, backing rel_residual
    # One dict per degradation-ladder rung walked (policy solves only):
    # rung, steps or dtype, rel_residual_before/after, passed.
    recovery: tuple = ()
    # obs.spans.Span root ("solve"/"solve_batch") when telemetry was
    # passed; its execute span's duration IS ``elapsed``.
    trace: object | None = None
    # obs.numerics.NumericsReport with numerics="summary"/"trace".
    numerics: object | None = None
    # Distributed solves with gather=False: each rank's (bpw, m, N) blocks
    # of the inverse in cyclic row order (rank order), and their layout.
    inverse_blocks: list | None = None
    layout: object | None = None
    # Distributed solves: this process's rank (0 when the ranks were
    # spawned here) and one summary a rank (pivots, the steps it probed,
    # its kernels' launches, elapsed, backend and the backend rule's
    # reason, device).
    rank: int = 0
    ranks: list | None = None
    # Distributed solves: the obs.comm.CommReport and obs.work.WorkReport
    # (None on one device).
    comm: object | None = None
    work: object | None = None

    @property
    def rel_residual(self) -> float | None:
        """‖A·X−I‖∞ / ‖A‖∞."""
        return None if self._norm_a is None else self.residual / self._norm_a


def resolve_engine(engine: str, group: int, n: int | None = None):
    """Shared engine/group flag contract (solve, CLI), as in the JAX
    package.  Returns the ``(engine, group)`` pair; with ``n`` given,
    "auto" (with group 0) is what :func:`resolve_invert_engine` picks for
    an fp32 CPU call at the default block size with no plan cache.  The
    fused-update engines are grouped engines with the same default k=2."""
    if engine not in ENGINES:
        raise UsageError(f"unknown engine {engine!r}; choose from "
                         f"{'/'.join(ENGINES)}")
    if group < 0:
        raise UsageError("group must be >= 0")
    if group == 1:
        raise UsageError("group=1 is the plain in-place engine; use "
                         "engine='inplace' (or group >= 2)")
    if group > 1 and engine == "inplace":
        raise UsageError("group > 1 requires engine='grouped' (or 'auto')")
    if group > 1 and engine == "augmented":
        raise UsageError("the augmented reference-parity engine has no "
                         "grouped variant")
    if group > 1 and engine == "swapfree":
        raise UsageError("the swap-free engine has no grouped variant")
    if engine == "lookahead":
        # group >= 2 selects the grouped probe-ahead twin.
        return "lookahead", (group if group > 1 else 0)
    if engine in PALLAS_ENGINES:
        return engine, (group if group > 1 else 2)
    if engine == "grouped" or (engine == "auto" and group > 1):
        return "grouped", (group if group > 1 else 2)
    if engine == "auto" and n is not None:
        return resolve_invert_engine(engine, group, n, device="cpu")[:2]
    return engine, 0


def resolve_invert_engine(engine: str, group: int, n: int,
                          block_size: int | None = None,
                          dtype=torch.float32, *, tune: bool = False,
                          plan_cache: str | None = None, workers=1,
                          gather: bool = True, device=None, telemetry=None):
    """The engine of an invert call (``solve``, ``JordanSolver``,
    ``profile_solve``): the flag contract (:func:`resolve_engine`), a
    complex dtype's routing (:func:`complex_engine`), the refusal of
    ``tune``/``plan_cache`` beside an explicit engine, and for "auto" the
    tuner's selection ladder on ``device`` (``tuning.auto_select``: the
    plan cache, the cost ranking, measurement with ``tune=True``; a
    complex point resolves to the augmented engine by legality), as a
    ``select`` span of ``telemetry``.  Returns ``(engine, group, plan)``,
    ``plan`` None for an explicit engine."""
    engine, group = resolve_engine(engine, group)
    if engine == "swapfree" and workers == 1:
        raise UsageError("engine='swapfree' is a distributed engine (its win "
                         "is collective bytes, ROADMAP.md Queue A item "
                         "15a); use workers=p")
    if resolve_dtype(dtype).is_complex and engine != "auto":
        engine, group = complex_engine(engine, group)
    refuse_tune_for_explicit_engine(engine, tune, plan_cache)
    if engine != "auto":
        return engine, group, None
    return auto_select(n, block_size or default_block_size(n), dtype,
                       workers, gather, tune=tune, plan_cache=plan_cache,
                       telemetry=telemetry, device=device)


def invert(a: torch.Tensor, engine: str, group: int, block_size: int,
           refine: int = 0, collect_stats: bool = False):
    """Run the resolved engine (see resolve_engine) on ``a``; returns
    ``(x, singular)``, or with ``collect_stats=True`` (``numerics=
    "trace"``) ``(x, singular, stats)``, the engine's per-superstep record.
    The fused-update and lookahead engines take Nr <= MAX_UNROLL_NR block
    rows, as in the JAX package; so does a trace, which the augmented and
    the bf16 fused engines refuse in the JAX package's words."""
    n = a.shape[-1]
    Nr = -(-n // min(block_size, n))
    if engine == "lookahead" and Nr > MAX_UNROLL_NR:
        raise UsageError(
            f"engine='lookahead' is unrolled-only (the critical-panel "
            f"split needs static column offsets) and Nr={Nr} exceeds "
            f"MAX_UNROLL_NR={MAX_UNROLL_NR}; use engine='inplace' (its "
            f"fori twin) or a larger block_size")
    stats_kw = {}
    if collect_stats:
        refuse_trace(engine, Nr)
        stats_kw = {"collect_stats": True}
    if engine == "lookahead":
        if group > 1:
            return block_jordan_invert_inplace_grouped_lookahead(
                a, block_size=block_size, refine=refine, group=group,
                **stats_kw)
        return block_jordan_invert_inplace_lookahead(
            a, block_size=block_size, refine=refine, **stats_kw)
    if engine in PALLAS_ENGINES:
        if Nr > MAX_UNROLL_NR:
            raise UsageError(
                f"engine={engine!r} is unrolled-only in the JAX package, "
                f"whose limit the port keeps, and Nr={Nr} exceeds "
                f"MAX_UNROLL_NR={MAX_UNROLL_NR}; use engine='grouped' or "
                "a larger block_size")
        return block_jordan_invert_inplace_grouped_pallas(
            a, block_size=block_size, refine=refine, group=group,
            mode="bf16" if engine.endswith("bf16") else "fp32", **stats_kw)
    if engine == "grouped":
        return block_jordan_invert_inplace_grouped(
            a, block_size=block_size, refine=refine, group=group,
            **stats_kw)
    if engine == "augmented":
        # The reference's exact rule: every inner pivot thresholded
        # against eps·‖A‖∞ of the whole matrix (main.cpp:972/1046).
        return block_jordan_invert(a, block_size=block_size, refine=refine,
                                   global_scale=True)
    return block_jordan_invert_inplace(a, block_size=block_size,
                                       refine=refine, **stats_kw)


def refuse_trace(engine: str, Nr: int) -> None:
    """The engines ``numerics="trace"`` cannot instrument, refused in the
    JAX package's words: the augmented engine, the bf16 fused engine and
    Nr > MAX_UNROLL_NR."""
    if engine == "augmented":
        raise UsageError(
            "numerics='trace' has no instrumented twin for the "
            "augmented reference-parity engine; use "
            "engine='inplace'/'grouped' or numerics='summary'")
    if engine == "grouped_pallas_bf16":
        raise UsageError(
            "numerics='trace' cannot instrument the bf16 fused "
            "kernel (its rounded dots have no bit-matching "
            "host-visible twin); use numerics='summary', or trace "
            "the fp32 sibling engine='grouped_pallas'")
    if Nr > MAX_UNROLL_NR:
        raise UsageError(
            f"numerics='trace' instruments the unrolled engines "
            f"only and Nr={Nr} exceeds MAX_UNROLL_NR="
            f"{MAX_UNROLL_NR}; use a larger block_size or "
            f"numerics='summary'")


def complex_engine(engine: str, group: int):
    """The engine of a complex solve, as the JAX package's ``_solve_impl``
    routes it: the flags checked by :func:`resolve_engine`, then "auto" and
    "augmented" run the augmented engine and every other engine is
    refused.  Returns ``("augmented", 0)``."""
    engine, group = resolve_engine(engine, group)
    if engine not in ("auto", "augmented"):
        raise UsageError(
            f"complex dtype requires engine='augmented' (or 'auto'); "
            f"engine={engine!r} is a real-dtype engine — for X = A⁻¹B use "
            f"linalg.solve_system, which is complex-native")
    return "augmented", 0


def refuse_tune_for_explicit_engine(engine: str, tune, plan_cache):
    """``tune``/``plan_cache`` belong to ``engine="auto"``, in the JAX
    package's words."""
    if (tune or plan_cache is not None) and engine != "auto":
        raise UsageError("tune/plan_cache apply to engine='auto' only "
                         "(an explicit engine leaves nothing to tune)")


def check_entry_options(workers, gather, policy, dtype):
    """The option checks the JAX package's entries share: complex dtypes
    run single-device, ``gather=False`` needs a distributed path, a
    policy is a ``ResiliencePolicy``."""
    distributed = isinstance(workers, tuple) or workers != 1
    if distributed and dtype is not None and resolve_dtype(dtype).is_complex:
        raise UsageError("complex dtypes run single-device (the distributed "
                         "scatter/collective paths are real-dtype, as in the "
                         "JAX package; ROADMAP.md Queue A item 15 ports no "
                         "complex path); workers must be 1")
    if not gather and not distributed:
        raise UsageError("gather=False is only supported on distributed "
                         "paths (workers > 1; ROADMAP.md Queue A item "
                         "15a)")
    if policy is not None and not isinstance(policy, ResiliencePolicy):
        raise UsageError("policy must be a tpu_jordan_torch.resilience."
                         "ResiliencePolicy")


def _lookahead_headroom(tel, esp, engine: str, n: int, block_size: int,
                        dev) -> None:
    """A retained lookahead ``execute`` span carries the cost model's
    ``probe_overlap_headroom`` beside its measured steps."""
    if engine == "lookahead" and tel.retain:
        from .tuning.registry import TunePoint, probe_overlap_headroom

        pt = TunePoint.create(n, block_size, device=dev)
        esp.attrs["probe_overlap_headroom"] = float(
            f"{probe_overlap_headroom(pt):.4g}")


def _solve_metrics(n: int, elapsed: float, exec_span,
                   singular: bool = False, batch: int = 1) -> None:
    """The registry's solve bookkeeping; GFLOP/s by 2n³·batch rides the
    execute span."""
    _obs_metrics.counter("tpu_jordan_torch_solves_total",
                         "driver solves executed").inc()
    _obs_metrics.histogram(
        "tpu_jordan_torch_solve_seconds",
        "timed elimination seconds (the glob_time analog)",
    ).observe(elapsed)
    if elapsed > 0:
        exec_span.attrs["gflops"] = round(
            2.0 * n**3 * batch / elapsed / 1e9, 3)
    if singular:
        _obs_metrics.counter("tpu_jordan_torch_singular_total",
                             "solves/requests flagged singular"
                             ).inc(component="solve")


def _numerics_report(numerics: str, *, n, block_size, engine, residual,
                     norm_a, kappa, dtype, policy, nstats=None):
    """Build, observe and spike one solve's numerics record.  It runs
    BEFORE the ladder, so every ``recovery_rung`` event has its cause on
    record; with a policy the residual spike's threshold is the policy's
    gate.  The trace engine is the engine that ran: each engine,
    ``grouped_pallas`` included, instruments itself."""
    from .obs import numerics as _numerics

    rel = residual / norm_a if norm_a else residual
    kw = dict(n=n, block_size=block_size, engine=engine,
              rel_residual=rel, kappa=kappa, norm_a=norm_a, dtype=dtype)
    if numerics == "trace":
        report = _numerics.trace_report(nstats, trace_engine=engine, **kw)
    else:
        report = _numerics.summary_report(**kw)
    _numerics.observe(report)
    thresholds = None
    if policy is not None:
        from .resilience.degrade import gate_threshold

        gd = policy.gate_dtype if policy.gate_dtype is not None else dtype
        thresholds = _numerics.SpikeThresholds(
            residual=gate_threshold(policy, n, kappa, gd))
    _numerics.record_spikes(report, thresholds)
    return report


def solve(
    n: int,
    block_size: int | None = None,
    file: str | None = None,
    generator: str = "absdiff",
    dtype=torch.float32,
    refine: int = 0,
    workers=1,
    device=None,
    verbose: bool = False,
    gather: bool = True,
    precision: str = "highest",
    engine: str = "auto",
    group: int = 0,
    tune: bool = False,
    plan_cache: str | None = None,
    telemetry=None,
    policy=None,
    numerics: str = "off",
) -> SolveResult:
    """Invert an n x n matrix from a file or a generator and verify it.

    Runs on the CUDA card unless ``device="cpu"``; without a card it
    raises DeviceUnavailableError.  ``workers=p`` runs the 1D
    row-block-cyclic engines on p ranks (module docstring; ``engine``
    "auto", "inplace", "lookahead", "grouped" or "swapfree"): the gathered
    inverse comes back on the CPU, ``gather=False`` leaves it in
    ``inverse_blocks`` (one CPU tensor a rank) with its ``layout``, and
    ``ranks`` holds each rank's pivots, probe steps, launches and time.
    ``workers=(pr, pc)`` runs the 2D engines on a mesh (the same engines,
    ``parallel/jordan2d_inplace.py``); ``inverse_blocks`` are then the
    ranks' 2D shards.  ``dtype`` may be complex64 or
    complex128 (then ``engine`` is "auto" or "augmented", which run the
    augmented engine).  ``engine="auto"`` resolves through the tuner
    (``tuning.auto_select``): a hit in the JSON plan cache ``plan_cache``,
    else the registry's cost ranking on this device, else, with
    ``tune=True``, a measurement of the cost-pruned survivors; the plan is
    on ``SolveResult.plan``.  ``engine``: "auto" | "inplace" |
    "grouped" | "augmented" | "lookahead" | "grouped_pallas" |
    "grouped_pallas_bf16" (see resolve_engine; "augmented" is the ~4N³
    reference-parity engine with the global singularity scale;
    "lookahead" the probe-ahead twin of "inplace", or of "grouped" with
    group >= 2, Nr <= MAX_UNROLL_NR).  ``policy`` (a
    ``resilience.ResiliencePolicy``) retries the engine call per
    ``policy.retry`` and guards the result with the residual gate and its
    ladder (rungs on ``SolveResult.recovery``, spans under ``recover``; an
    exhausted ladder raises ResidualGateError).  ``grouped_pallas_bf16``
    never runs without one: it attaches ``DEFAULT_POLICY`` when none is
    given and judges the gate at bf16 eps, escalating its re-solve to
    ``grouped_pallas``.

    ``telemetry`` (an ``obs.Telemetry``) records the solve as a span tree
    on ``SolveResult.trace`` (module docstring); the solves, timings and
    singular flags land in ``obs.metrics.REGISTRY`` either way.
    ``numerics``: "off" (the default, no cost), "summary" (a
    ``NumericsReport`` from what the solve returns) or "trace" (the
    engine's per-superstep record: chosen pivot block, its inverse's
    ∞-norm, the candidate spread, the growth watermark; the unrolled
    engines at Nr <= MAX_UNROLL_NR, not the augmented or the bf16 fused
    engine).  Raises SingularMatrixError like the reference's -2 path
    (main.cpp:435-437); file errors propagate from read_matrix_file.
    """
    check_entry_options(workers, gather, policy, dtype)
    dev = resolve_device(device)
    if workers != 1:
        tel = telemetry if telemetry is not None else _NULL_TEL
        with tel.span("solve", n=n, workers=str(workers),
                      generator=generator) as root:
            res = _solve_distributed(
                n, block_size, generator, file=file, dtype=dtype,
                refine=refine, workers=workers, device=dev, verbose=verbose,
                gather=gather, precision=precision, engine=engine,
                group=group, plan_cache=plan_cache, tune=tune, tel=tel,
                numerics=numerics, policy=policy)
        if telemetry is not None:
            res.trace = root
        return res

    def load(dt):
        if file is not None:
            return from_numpy(read_matrix_file(file, n), dev, dt)
        return generate(generator, (n, n), dt, device=dev)

    return _solve_traced(
        n, block_size, load, None if file else generator, dtype=dtype,
        refine=refine, device=dev, verbose=verbose, precision=precision,
        engine=engine, group=group, tune=tune, plan_cache=plan_cache,
        telemetry=telemetry, policy=policy, numerics=numerics)


def observatories(summaries, *, engine: str, lay, dtype, group: int = 0,
                  gather: bool = True, refine: int = 0, rhs: int = 0,
                  storage_dtype=None, elapsed: float, span=None,
                  record: bool = False):
    """The comm and work reports of one distributed solve from the ranks'
    outcomes ``summaries`` (rank order when recorded; otherwise any rank's
    pivot record serves): built, observed (with ``record``), put on the
    execute ``span``, into the metrics, the drift record and the
    ``--comm-report``/``--work-report`` snapshots.  Returns (comm, work)."""
    from .obs import comm as _comm
    from .obs import work as _work

    head = summaries[0]
    crep = _comm.engine_report(
        engine=engine, lay=lay, dtype=dtype, pivots=head["pivots"],
        pinned=head.get("pinned", ()), gather=gather, refine=refine,
        group=group, rhs=rhs, storage_dtype=storage_dtype,
        singular=head["singular"])
    wrep = _work.engine_report(engine=engine, lay=lay, dtype=dtype, k=rhs,
                               group=group)
    if record:
        crep.attach_observed({r["rank"]: r["observed"] for r in summaries})
        wrep.attach_counted([r["gemm_flops"] for r in summaries], span=span)
    else:
        wrep.attach_counted(None)
    crep.observe_metrics()
    wrep.observe_metrics()
    crep.attach_span(span)
    wrep.attach_span(span)
    _comm.observe_drift(crep, elapsed, head["backend"], span=span)
    _comm.set_last_report(crep)
    _work.set_last_report(wrep)
    return crep, wrep


def _solve_distributed(n, block_size, generator, *, file, dtype, refine,
                       workers, device, verbose, gather, precision, engine,
                       group, plan_cache, tune, tel, numerics, policy=None):
    """:func:`solve` at ``workers=p`` or ``workers=(pr, pc)``: the JAX
    package's ``_solve_distributed_core`` on the 1D layout or the 2D mesh
    (its ``_Dist1D`` and ``_Dist2D`` backends), one process per rank.
    As there, the ``compile`` fault point fires under the policy's retry
    and ``execute`` fires unretried; no residual gate (the JAX distributed
    core has none).  A ``file`` is opened here first (FileNotFoundError
    before any rank starts); a rank that cannot parse its strips fails the
    world, which surfaces as MatrixReadError, the reference's -2."""
    import torch.distributed as dist

    from .obs.comm import recording_active
    from .obs.numerics import resolve_mode
    from .parallel.dist_solve import DistSpec, share_outcomes, solve_rank
    from .parallel.launch import WorkerError, run_workers

    mesh = None
    if isinstance(workers, tuple):
        from .parallel.group import check_mesh

        mesh = (int(workers[0]), int(workers[1]))
        check_mesh(mesh[0], mesh[1], mesh[0] * mesh[1])
        p = mesh[0] * mesh[1]
    else:
        p = int(workers)
    if p < 1:
        raise UsageError("workers must be >= 1")
    numerics = resolve_mode(numerics)
    if numerics == "trace":
        raise UsageError(
            "numerics='trace' instruments the single-device unrolled "
            "engines (the per-superstep stats are host-visible there); "
            "distributed solves support numerics='summary'")
    if precision == "mixed" and not gather:
        raise UsageError(
            "precision='mixed' requires gather=True: it implies >=2 "
            "Newton-Schulz steps, which run on the gathered inverse")
    if refine and not gather:
        raise UsageError("refine requires gather=True (it runs on the "
                         "gathered inverse)")
    dtype = resolve_dtype(dtype)
    if block_size is None:
        block_size = default_block_size(n)
    _, refine = resolve_precision(precision, refine)
    if file is not None:
        # The reference's -1 "cannot open", before any rank starts.
        MatrixStripReader(file, n).close()
    engine, group, plan = resolve_invert_engine(
        engine, group, n, block_size, dtype, tune=tune,
        plan_cache=plan_cache, workers=mesh or p, gather=gather,
        device=device, telemetry=tel)
    if engine in PALLAS_ENGINES:
        raise UsageError(
            f"engine={engine!r} is a single-device fused-kernel engine (the "
            "fused update kernel has no sharded variant); use "
            "engine='grouped' on distributed meshes")
    check_entry_options(mesh or p, gather, None, dtype)
    m = min(block_size, n)
    if mesh is not None and engine != "augmented":
        from .parallel.jordan2d_inplace import check_engine_2d
        from .parallel.layout import CyclicLayout2D

        check_engine_2d(CyclicLayout2D.create(n, m, *mesh), engine, group)
    if engine == "lookahead" and group > 1:
        raise UsageError("the grouped lookahead engine is single-device; "
                         "lookahead at workers > 1 is the plain 1D engine's "
                         "probe-ahead twin")
    if -(-n // m) > MAX_UNROLL_NR and engine == "lookahead":
        raise UsageError(
            f"engine='lookahead' is unrolled-only in the JAX package, whose "
            f"limit the port keeps, and Nr={-(-n // m)} exceeds "
            f"MAX_UNROLL_NR={MAX_UNROLL_NR}; use engine='inplace'")
    spec = DistSpec(n=n, m=m, generator=generator,
                    dtype=str(dtype).removeprefix("torch."), engine=engine,
                    group_k=group, gather=gather, refine=refine,
                    file=None if file is None else os.path.abspath(file),
                    mesh=mesh, record=recording_active())
    if verbose:
        from .utils.printing import print_corner

        print("A")
        print_corner(
            from_numpy(read_matrix_corner(file, n), "cpu", dtype)
            if file is not None
            else generate(generator, (min(n, 10), min(n, 10)), dtype))
    def ready():
        # The compile analogue (resilience/faults.py): the world's spec.
        _faults.fire("compile")
        return spec

    spec = (policy.retry.call(ready, component="solve.compile")
            if policy is not None else ready())
    _faults.fire("execute")
    with tel.span("world", workers=p) as wsp:
        if dist.is_initialized():
            from .parallel.group import current_group

            grp = current_group(device.type)
            if mesh is not None:
                from .parallel.group import check_mesh

                check_mesh(mesh[0], mesh[1], grp.world_size)
            if grp.world_size != p:
                from .parallel.group import MeshSizeError

                raise MeshSizeError(
                    f"workers={p} but this process's world has "
                    f"{grp.world_size} ranks")
            results = [solve_rank(grp, spec)]
            summaries = (share_outcomes(results[0]) if spec.record
                         else None)
        else:
            try:
                results = run_workers(p, solve_rank, spec,
                                      deadline_s=WORLD_DEADLINE_S,
                                      device_type=device.type)
            except WorkerError as e:
                if file is not None and e.detail.startswith(
                        MatrixReadError.__name__):
                    raise MatrixReadError(f"cannot read {file}") from e
                raise
            summaries = [{k: v for k, v in r.items()
                          if k not in ("inverse", "blocks")}
                         for r in results]
    head = results[0]
    elapsed = max(r["elapsed"] for r in results)
    wsp.attrs["backend"] = head["backend"]
    esp = wsp.child("execute", wsp.t_start, wsp.t_start + elapsed,
                    clock="cuda_event" if device.type == "cuda" else "host",
                    engine=engine)
    from .parallel.layout import CyclicLayout, CyclicLayout2D

    lay = (CyclicLayout2D.create(n, m, *mesh) if mesh is not None
           else CyclicLayout.create(n, m, p))
    comm, work = observatories(
        summaries or [head], engine=engine, lay=lay,
        dtype=torch.float32 if dtype.itemsize < 4 else dtype, group=group,
        gather=gather, refine=refine, storage_dtype=dtype, elapsed=elapsed,
        span=esp, record=spec.record)
    _solve_metrics(n, elapsed, esp, singular=head["singular"])
    if head["singular"]:
        raise SingularMatrixError("singular matrix")
    blocks = None
    if not gather and results[0]["blocks"] is not None:
        blocks = [r["blocks"] for r in results]
    else:
        lay = None
    norm_a = head["norm_a"]
    kappa = norm_a * head["norm_x"]
    inv = head["inverse"]
    if verbose:
        from .parallel.sharded_inplace import inverse_corner_1d
        from .utils.printing import print_corner

        print(f"glob_time: {elapsed:.2f}")
        print("inverse matrix:\n")
        if inv is not None:
            print_corner(inv)
        elif blocks is not None and mesh is not None:
            from .parallel.jordan2d_inplace import inverse_corner_2d

            print_corner(inverse_corner_2d(blocks, lay, n))
        elif blocks is not None:
            print_corner(inverse_corner_1d(blocks, lay, n))
        print(f"residual: {head['residual']:e}")
        print(f"kappa_inf: {kappa:e}")
    res = SolveResult(
        inverse=inv, elapsed=elapsed, residual=head["residual"], n=n,
        block_size=m,
        gflops=(2.0 * n**3 / elapsed / 1e9) if elapsed > 0 else 0.0,
        kappa=kappa, engine=engine, group=group, plan=plan,
        device=(f"{device.type} x{p} ({head['backend']})" if mesh is None
                else f"{device.type} {mesh[0]}x{mesh[1]} "
                     f"({head['backend']})"), _norm_a=norm_a,
        inverse_blocks=blocks, layout=lay, rank=head["rank"],
        ranks=summaries or [{k: v for k, v in head.items()
                             if k not in ("inverse", "blocks")}],
        comm=comm, work=work)
    if numerics != "off":
        res.numerics = _numerics_report(
            "summary", n=n, block_size=m, engine=engine,
            residual=res.residual, norm_a=norm_a, kappa=kappa, dtype=dtype,
            policy=None)
    return res


def _solve_traced(n, block_size, load, generator, *, dtype, device,
                  refine=0, verbose=False, precision="highest",
                  engine="auto", group=0, tune=False, plan_cache=None,
                  telemetry=None, policy=None, numerics="off"):
    """:func:`solve` from ``load(dtype)``, the source of A (re-read for
    the residual and every re-solve), under the ``solve`` root span."""
    tel = telemetry if telemetry is not None else _NULL_TEL
    with tel.span("solve", n=n, workers="1", generator=generator) as root:
        res = _solve_impl(n, block_size, load, dtype, refine, device,
                          verbose, precision, engine, group, tune,
                          plan_cache, tel, policy, numerics)
    if telemetry is not None:
        res.trace = root
    return res


def _solve_impl(n, block_size, load, dtype, refine, dev, verbose,
                precision, engine, group, tune, plan_cache, tel,
                policy=None, numerics="off") -> SolveResult:
    from .obs.numerics import resolve_mode

    numerics = resolve_mode(numerics)
    dtype = resolve_dtype(dtype)
    if block_size is None:
        block_size = default_block_size(n)
    _, refine = resolve_precision(precision, refine)
    # Before any matrix is made.
    engine, group, plan = resolve_invert_engine(
        engine, group, n, block_size, dtype, tune=tune,
        plan_cache=plan_cache, device=dev, telemetry=tel)
    if engine == "grouped_pallas_bf16" and policy is None:
        # The bf16 path never runs unguarded: a bf16-grade miss walks
        # refine -> fp32 re-solve instead of reaching the caller.
        policy = DEFAULT_POLICY
    if dev.type == "cuda":
        # Full fp32 products on the card: the reference runs its fp32
        # matmuls at Precision.HIGHEST, and TF32 keeps ~3 digits.
        torch.backends.cuda.matmul.allow_tf32 = False

    with tel.span("load"):
        a = load(dtype)
    if verbose:
        from .utils.printing import print_corner

        print("A")
        print_corner(a)

    collect = numerics == "trace"

    def ready():
        # The compile analogue (resilience/faults.py): the engine callable.
        _faults.fire("compile")
        return partial(invert, engine=engine, group=group,
                       block_size=block_size, refine=refine,
                       collect_stats=collect)

    run = (policy.retry.call(ready, component="solve.compile")
           if policy is not None else ready())

    def execute():
        _faults.fire("execute")
        return timed_blocking(run, a, telemetry=tel, name="execute",
                              device=dev, engine=engine)

    def reload(_exc, _attempt):
        # A retry starts from a fresh load, as the JAX package's does.
        nonlocal a
        a = load(dtype)

    out, esp = (policy.retry.call(execute, on_retry=reload,
                                  component="solve.execute")
                if policy is not None else execute())
    del a  # the residual runs on a fresh load; free the card's copy first
    inv, singular = out[:2]
    nstats = out[2] if collect else None
    elapsed = esp.duration
    _lookahead_headroom(tel, esp, engine, n, block_size, dev)
    _solve_metrics(n, elapsed, esp, singular=bool(singular))
    _hwcost.attach_execute_cost(esp, analytical_flops=2.0 * float(n) ** 3)
    if _faults.corrupt("result_corrupt_nan"):
        # Silent corruption: the residual on a fresh A goes NaN, so the
        # policy's gate, not a lucky caller, must catch it.
        inv[0, 0] = float("nan")

    if bool(singular):
        raise SingularMatrixError("singular matrix")

    if verbose:
        print(f"glob_time: {elapsed:.2f}")
        print("inverse matrix:\n")
        print_corner(inv)

    # Re-load A (the reference re-reads/regenerates, main.cpp:463-488) and
    # verify independently.
    with tel.span("residual"):
        a_fresh = load(dtype)
        residual = float(residual_inf_norm(a_fresh, inv))
        norm_a = float(inf_norm(a_fresh))
        kappa = norm_a * float(inf_norm(inv))

    # Built, observed and spiked before the ladder: a recovery_rung event
    # must follow the evidence that explains it.
    nreport = None
    if numerics != "off":
        nreport = _numerics_report(
            numerics, n=n, block_size=block_size, engine=engine,
            residual=residual, norm_a=norm_a, kappa=kappa, dtype=dtype,
            policy=policy, nstats=nstats)

    recovery = ()
    if policy is not None:
        def escalated_resolve():
            # Sub-fp32 storage goes to fp32; the bf16 fused-update engine
            # to its fp32 sibling (same pivots and kernel, fp32 operands).
            # Under the same telemetry: its spans nest under "resolve".
            esc_dtype = (torch.float32 if dtype.itemsize < 4 else dtype)
            esc_engine = ("grouped_pallas"
                          if engine == "grouped_pallas_bf16" else engine)
            return _solve_impl(n, block_size, load, esc_dtype, refine, dev,
                               False, "highest", esc_engine, group, False,
                               None, tel)

        # A bf16-computed inverse is judged at bf16 eps unless the policy
        # pins a gate_dtype.
        gate_dtype = (torch.bfloat16 if engine == "grouped_pallas_bf16"
                      else dtype)
        inv, residual, norm_a, kappa, recovery = maybe_recover(
            policy, tel, a_fresh=a_fresh, inv=inv, residual=residual,
            norm_a=norm_a, kappa=kappa, n=n, dtype=gate_dtype,
            resolve=escalated_resolve)
    if verbose:
        print(f"residual: {residual:e}")
        print(f"kappa_inf: {kappa:e}")

    return SolveResult(
        inverse=inv,
        elapsed=elapsed,
        residual=residual,
        n=n,
        block_size=block_size,
        gflops=(2.0 * n**3 / elapsed / 1e9) if elapsed > 0 else 0.0,
        kappa=kappa,
        engine=engine,
        group=group,
        plan=plan,
        device=str(inv.device),
        _norm_a=norm_a,
        recovery=recovery,
        numerics=nreport,
    )


def batch_metrics(a: torch.Tensor, x: torch.Tensor, n_real=None) -> dict:
    """Per-element accuracy of a (B, N, N) stack ``x`` of inverses of
    ``a``: a dict of (B,) tensors ``residual`` ‖A·X−I‖∞, ``norm_a`` ‖A‖∞,
    ``norm_x`` ‖X‖∞, ``kappa`` = ‖A‖∞‖X‖∞ and ``rel_residual`` =
    residual/‖A‖∞, the conventions of ``SolveResult``.

    ``n_real`` ((B,) ints) masks the norms to each element's real rows
    when the stack is identity-padded: pad rows abs-sum to exactly 1 and
    would cap a small true norm.  The residual needs no mask (a pad row of
    A·X−I is zero).  An all-masked element (n_real = 0) reports 0, not NaN.
    Counterpart of the JAX package's ``batch_metrics``."""
    N = a.shape[-1]
    r = a @ x
    r.diagonal(dim1=-2, dim2=-1).sub_(1)
    r_sums = r.abs().sum(dim=-1)
    a_sums = a.abs().sum(dim=-1)
    x_sums = x.abs().sum(dim=-1)
    if n_real is not None:
        rows = torch.arange(N, device=a.device)
        mask = rows[None, :] < torch.as_tensor(n_real,
                                               device=a.device)[:, None]
        r_sums = torch.where(mask, r_sums, 0)
        a_sums = torch.where(mask, a_sums, 0)
        x_sums = torch.where(mask, x_sums, 0)
    residual = r_sums.amax(dim=-1)
    norm_a = a_sums.amax(dim=-1)
    norm_x = x_sums.amax(dim=-1)
    positive = norm_a > 0
    return {
        "residual": residual,
        "norm_a": norm_a,
        "norm_x": norm_x,
        "kappa": norm_a * norm_x,
        "rel_residual": torch.where(
            positive, residual / torch.where(positive, norm_a, 1), residual),
    }


def solve_batch(
    n: int,
    block_size: int | None = None,
    batch: int = 1,
    generator: str = "absdiff",
    dtype=torch.float32,
    refine: int = 0,
    precision: str = "highest",
    verbose: bool = False,
    device=None,
    telemetry=None,
) -> SolveResult:
    """Invert ``batch`` generated n×n matrices through the batched engine
    (``ops/batched.py``; one device), on the CUDA card unless
    ``device="cpu"``.

    Element b is the generator's window at offset b·n on both axes
    (``generate_batch``): distinct matrices for ``rand``, copies for
    translation-invariant generators like ``absdiff``.  The engine call is
    timed as ``solve`` times it; ``gflops`` counts 2n³·batch.
    ``telemetry`` records a ``solve_batch`` root with ``load``,
    ``execute`` and ``residual`` children (``SolveResult.trace``).  Raises
    SingularMatrixError naming how many elements were flagged.
    ``residual``, ``kappa`` and ``rel_residual`` are element 0's, on a
    freshly generated copy of it.  A complex dtype is a UsageError: the
    batched engine is the real-dtype in-place engine (the JAX package's
    ``solve_batch`` fails on one too, in its in-place engine's pivot
    comparisons).  Counterpart of the JAX package's ``solve_batch``."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if dtype.is_complex:
        raise UsageError("solve_batch runs the batched in-place engine, a "
                         "real-dtype engine; invert complex matrices one at "
                         "a time with solve (the augmented engine)")
    if block_size is None:
        block_size = default_block_size(n)
    _, refine = resolve_precision(precision, refine)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    tel = telemetry if telemetry is not None else _NULL_TEL
    with tel.span("solve_batch", n=n, batch=batch) as root:
        with tel.span("load"):
            a = generate_batch(generator, n, batch, dtype, device=dev)
        (inv, singular), esp = timed_blocking(
            lambda: batched_jordan_invert(a, block_size=block_size,
                                          refine=refine),
            telemetry=tel, name="execute", device=dev, batch=batch)
        del a
        elapsed = esp.duration
        nsing = int(singular.sum())
        _solve_metrics(n, elapsed, esp, singular=bool(nsing), batch=batch)
        _hwcost.attach_execute_cost(
            esp, analytical_flops=2.0 * float(n) ** 3 * batch)
        if nsing:
            raise SingularMatrixError(
                f"singular matrix ({nsing}/{batch} elements flagged)")
        with tel.span("residual"):
            a0 = generate(generator, (n, n), dtype, device=dev)
            met = batch_metrics(a0[None], inv[:1])
            residual = float(met["residual"][0])
    if verbose:
        print(f"glob_time: {elapsed:.2f} ({batch} matrices)")
        print(f"residual[0]: {residual:e}")
    return SolveResult(
        inverse=inv,
        elapsed=elapsed,
        residual=residual,
        n=n,
        block_size=block_size,
        gflops=((2.0 * n**3 * batch / elapsed / 1e9)
                if elapsed > 0 else 0.0),
        kappa=float(met["kappa"][0]),
        engine="batched",
        device=str(inv.device),
        _norm_a=float(met["norm_a"][0]),
        trace=root if telemetry is not None else None,
    )
