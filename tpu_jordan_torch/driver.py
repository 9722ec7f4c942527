"""End-to-end solve driver: the single-device core of the JAX package's
``driver.solve``, and its ``solve_batch``.

Rebuild of ``solve`` (main.cpp:343-519): generate or read A, time the
inversion, then verify independently with the residual ‖A·A⁻¹ − I‖∞ on a
freshly regenerated/re-read A (the reference destroys A and reloads it,
main.cpp:463-488, so verification never trusts state left over from the
algorithm).

On the card the inversion is timed with CUDA events around the engine call
(the first call of a process also builds the kernels, so callers that
want a steady-state time run it twice).  fp32 products run in full fp32:
``solve`` turns TF32 off for cuBLAS, the counterpart of the JAX package's
``Precision.HIGHEST``.

With a ``policy`` (auto-attached for ``grouped_pallas_bf16``), the engine
call runs under the policy's retry and the result must pass the residual
gate, walking the degradation ladder (``resilience/degrade.py``) when it
does not.

Complex dtypes (complex64, complex128) run single-device on the augmented
engine, as in the JAX package: ``engine="auto"`` resolves to it and every
real-only engine is refused (:func:`complex_engine`).  Residuals, norms and
κ∞ are real.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from .config import MAX_UNROLL_NR, default_block_size
from .errors import SingularMatrixError, UsageError
from .interop import from_numpy, resolve_device, resolve_dtype
from .io import read_matrix_file
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
from .ops.refine import resolve_precision
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
# registry (tuning/registry.py).  The JAX package's other engines arrive
# with later slices of the port (ROADMAP.md, Queue A).
LATER_ENGINES = {
    "swapfree": "Queue A item 15",
}


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
    if engine in LATER_ENGINES:
        raise UsageError(
            f"engine={engine!r} is not ported yet (ROADMAP.md "
            f"{LATER_ENGINES[engine]}); choose from {'/'.join(ENGINES)}")
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
                          gather: bool = True, device=None):
    """The engine of an invert call (``solve``, ``JordanSolver``,
    ``profile_solve``): the flag contract (:func:`resolve_engine`), a
    complex dtype's routing (:func:`complex_engine`), the refusal of
    ``tune``/``plan_cache`` beside an explicit engine, and for "auto" the
    tuner's selection ladder on ``device`` (``tuning.auto_select``: the
    plan cache, the cost ranking, measurement with ``tune=True``; a
    complex point resolves to the augmented engine by legality).  Returns
    ``(engine, group, plan)``, ``plan`` None for an explicit engine."""
    engine, group = resolve_engine(engine, group)
    if resolve_dtype(dtype).is_complex and engine != "auto":
        engine, group = complex_engine(engine, group)
    refuse_tune_for_explicit_engine(engine, tune, plan_cache)
    if engine != "auto":
        return engine, group, None
    return auto_select(n, block_size or default_block_size(n), dtype,
                       workers, gather, tune=tune, plan_cache=plan_cache,
                       device=device)


def invert(a: torch.Tensor, engine: str, group: int, block_size: int,
           refine: int = 0):
    """Run the resolved engine (see resolve_engine) on ``a``; returns
    ``(x, singular)``.  The fused-update and lookahead engines take
    Nr <= MAX_UNROLL_NR block rows, as in the JAX package."""
    n = a.shape[-1]
    Nr = -(-n // min(block_size, n))
    if engine == "lookahead":
        if Nr > MAX_UNROLL_NR:
            raise UsageError(
                f"engine='lookahead' is unrolled-only (the critical-panel "
                f"split needs static column offsets) and Nr={Nr} exceeds "
                f"MAX_UNROLL_NR={MAX_UNROLL_NR}; use engine='inplace' (its "
                f"fori twin) or a larger block_size")
        if group > 1:
            return block_jordan_invert_inplace_grouped_lookahead(
                a, block_size=block_size, refine=refine, group=group)
        return block_jordan_invert_inplace_lookahead(
            a, block_size=block_size, refine=refine)
    if engine in PALLAS_ENGINES:
        if Nr > MAX_UNROLL_NR:
            raise UsageError(
                f"engine={engine!r} is unrolled-only in the JAX package, "
                f"whose limit the port keeps, and Nr={Nr} exceeds "
                f"MAX_UNROLL_NR={MAX_UNROLL_NR}; use engine='grouped' or "
                "a larger block_size")
        return block_jordan_invert_inplace_grouped_pallas(
            a, block_size=block_size, refine=refine, group=group,
            mode="bf16" if engine.endswith("bf16") else "fp32")
    if engine == "grouped":
        return block_jordan_invert_inplace_grouped(
            a, block_size=block_size, refine=refine, group=group)
    if engine == "augmented":
        # The reference's exact rule: every inner pivot thresholded
        # against eps·‖A‖∞ of the whole matrix (main.cpp:972/1046).
        return block_jordan_invert(a, block_size=block_size, refine=refine,
                                   global_scale=True)
    return block_jordan_invert_inplace(a, block_size=block_size,
                                       refine=refine)


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


def refuse_later_options(workers, gather, telemetry, policy, numerics,
                         dtype):
    """Options of the JAX package's solve that later slices bring: each
    is refused with the slice that brings it, never silently ignored."""
    distributed = isinstance(workers, tuple) or workers != 1
    if distributed and dtype is not None and resolve_dtype(dtype).is_complex:
        raise UsageError("complex dtypes run single-device (the distributed "
                         "scatter/collective paths are real-dtype); workers "
                         "must be 1 (ROADMAP.md Queue A item 15)")
    if distributed:
        raise UsageError("workers > 1 is the distributed path, not ported "
                         "yet (ROADMAP.md Queue A item 15)")
    if not gather:
        raise UsageError("gather=False is only supported on distributed "
                         "paths (ROADMAP.md Queue A item 15)")
    if telemetry is not None:
        raise UsageError("telemetry is not ported yet (ROADMAP.md Queue A "
                         "item 12)")
    if policy is not None and not isinstance(policy, ResiliencePolicy):
        raise UsageError("policy must be a tpu_jordan_torch.resilience."
                         "ResiliencePolicy")
    if numerics != "off":
        raise UsageError("numerics reports are not ported yet (ROADMAP.md "
                         "Queue A item 12); the engines' collect_stats=True "
                         "gives the per-superstep record")


def _timed(dev, fn):
    """Run ``fn()``; returns (its result, seconds): CUDA events around it on
    the card, the host clock on the CPU."""
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            stop.synchronize()
            return out, start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def solve(
    n: int,
    block_size: int | None = None,
    file: str | None = None,
    generator: str = "absdiff",
    dtype=torch.float32,
    refine: int = 0,
    workers: int = 1,
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
    raises DeviceUnavailableError.  ``dtype`` may be complex64 or
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
    ladder (rungs on ``SolveResult.recovery``; an exhausted ladder raises
    ResidualGateError).  ``grouped_pallas_bf16`` never runs without one:
    it attaches ``DEFAULT_POLICY`` when none is given and judges the gate
    at bf16 eps, escalating its re-solve to ``grouped_pallas``.  Raises
    SingularMatrixError like the reference's -2 path (main.cpp:435-437);
    file errors propagate from read_matrix_file.
    """
    refuse_later_options(workers, gather, telemetry, policy, numerics,
                         dtype)
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if block_size is None:
        block_size = default_block_size(n)
    _, refine = resolve_precision(precision, refine)
    # Before any matrix is made.
    engine, group, plan = resolve_invert_engine(
        engine, group, n, block_size, dtype, tune=tune,
        plan_cache=plan_cache, workers=workers, gather=gather, device=dev)
    if engine == "grouped_pallas_bf16" and policy is None:
        # The bf16 path never runs unguarded: a bf16-grade miss walks
        # refine -> fp32 re-solve instead of reaching the caller.
        policy = DEFAULT_POLICY
    if dev.type == "cuda":
        # Full fp32 products on the card: the reference runs its fp32
        # matmuls at Precision.HIGHEST, and TF32 keeps ~3 digits.
        torch.backends.cuda.matmul.allow_tf32 = False

    def load():
        if file is not None:
            return from_numpy(read_matrix_file(file, n), dev, dtype)
        return generate(generator, (n, n), dtype, device=dev)

    a = load()
    if verbose:
        from .utils.printing import print_corner

        print("A")
        print_corner(a)

    def execute():
        (inv, singular), elapsed = _timed(dev, lambda: invert(
            a, engine, group, block_size, refine))
        return inv, singular, elapsed

    def reload(_exc, _attempt):
        # A retry starts from a fresh load, as the JAX package's does.
        nonlocal a
        a = load()

    inv, singular, elapsed = (
        policy.retry.call(execute, on_retry=reload)
        if policy is not None else execute())
    del a  # the residual runs on a fresh load; free the card's copy first

    if bool(singular):
        raise SingularMatrixError("singular matrix")

    if verbose:
        print(f"glob_time: {elapsed:.2f}")
        print("inverse matrix:\n")
        print_corner(inv)

    # Re-load A (the reference re-reads/regenerates, main.cpp:463-488) and
    # verify independently.
    a_fresh = load()
    residual = float(residual_inf_norm(a_fresh, inv))
    norm_a = float(inf_norm(a_fresh))
    kappa = norm_a * float(inf_norm(inv))

    recovery = ()
    if policy is not None:
        def escalated_resolve():
            # Sub-fp32 storage goes to fp32; the bf16 fused-update engine
            # to its fp32 sibling (same pivots and kernel, fp32 operands).
            esc_dtype = (torch.float32 if dtype.itemsize < 4 else dtype)
            esc_engine = ("grouped_pallas"
                          if engine == "grouped_pallas_bf16" else engine)
            return solve(n, block_size, file, generator, esc_dtype, refine,
                         device=dev, engine=esc_engine, group=group)

        # A bf16-computed inverse is judged at bf16 eps unless the policy
        # pins a gate_dtype.
        gate_dtype = (torch.bfloat16 if engine == "grouped_pallas_bf16"
                      else dtype)
        inv, residual, norm_a, kappa, recovery = maybe_recover(
            policy, a_fresh=a_fresh, inv=inv, residual=residual,
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
    timed as ``solve`` times it; ``gflops`` counts 2n³·batch.  Raises
    SingularMatrixError naming how many elements were flagged.
    ``residual``, ``kappa`` and ``rel_residual`` are element 0's, on a
    freshly generated copy of it.  A complex dtype is a UsageError: the
    batched engine is the real-dtype in-place engine (the JAX package's
    ``solve_batch`` fails on one too, in its in-place engine's pivot
    comparisons).  Counterpart of the JAX package's ``solve_batch``."""
    if telemetry is not None:
        raise UsageError("telemetry is not ported yet (ROADMAP.md Queue A "
                         "item 12)")
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
    a = generate_batch(generator, n, batch, dtype, device=dev)
    (inv, singular), elapsed = _timed(dev, lambda: batched_jordan_invert(
        a, block_size=block_size, refine=refine))
    del a
    nsing = int(singular.sum())
    if nsing:
        raise SingularMatrixError(
            f"singular matrix ({nsing}/{batch} elements flagged)")
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
    )
