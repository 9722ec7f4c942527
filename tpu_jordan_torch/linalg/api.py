"""``solve_system`` and ``lstsq``: the solve workloads as typed results.

The single-device part of the JAX package's ``linalg/api.py``, for real and
complex dtypes:
the engine choice (``resolve_solve_engine``, with "auto" resolved by the
tuner at a workload-scoped point: plan cache, cost ranking, measurement
with ``tune=True``), the solve timed with
CUDA events on the card, the verification ‖A·X − B‖∞ against the caller's
A and B, the κ-free backward-error gate and its recovery ladder when a
policy is attached (``resilience/degrade.py``), and the results
:class:`SolveSystemResult` and :class:`LstsqResult`.  Entry points run on
the card unless ``device="cpu"``.  The JAX package's distributed solves (complex
ones included), telemetry and numerics reports are refused by name
(ROADMAP.md Queue A items 15 and 12).  Complex A and B flow through the
engine, the residual (every norm is of |z|) and the gate; lstsq forms the
conjugate transpose.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import default_block_size
from ..driver import (_timed, refuse_later_options,
                      refuse_tune_for_explicit_engine)
from ..errors import SingularMatrixError, UsageError
from ..interop import from_numpy, resolve_device, resolve_dtype
from ..ops.norms import inf_norm
from ..ops.residual import solve_residual_stats
from ..resilience.degrade import backward_error, solve_recover
from ..tuning.registry import SOLVE_ENGINES, TunePoint, select_by_cost
from ..tuning.tuner import auto_select
from .engine import block_jordan_solve, block_jordan_solve_fori

ASSUME = ("general", "spd")
# SOLVE_ENGINES comes from the registry; the distributed engines arrive
# with item 15.
_LATER_SOLVE_ENGINES = {"solve_sharded": "Queue A item 15",
                        "solve_lookahead": "Queue A item 15"}


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
    if engine in _LATER_SOLVE_ENGINES:
        raise UsageError(
            f"engine={engine!r} is the distributed [A | B] elimination, "
            f"not ported yet (ROADMAP.md {_LATER_SOLVE_ENGINES[engine]}); "
            f"choose from {'/'.join(SOLVE_ENGINES)}")
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
    ``ResidualGateError`` when the ladder runs out.  ``check=False``
    reports a singular system on ``result.singular`` with ``x=None``
    instead of raising SingularMatrixError.  ``workers``, ``gather``,
    ``telemetry`` and ``numerics`` other than "off" are refused by name
    (later slices of the port).  A and B may be
    complex64 or complex128.  Counterpart of the JAX package's
    ``solve_system``."""
    refuse_later_options(workers, gather, telemetry, policy, numerics,
                         dtype if dtype is not None else getattr(a, "dtype",
                                                                 None))
    dev = resolve_device(device)
    a = from_numpy(a, dev, None if dtype is None else resolve_dtype(dtype))
    dtype = a.dtype
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise UsageError(f"expected a square (n, n) matrix, got shape "
                         f"{tuple(a.shape)}")
    n = int(a.shape[0])
    b2, squeezed = _as_2d_rhs(b, dtype, n, "b", dev)
    k = int(b2.shape[1])
    m = min(block_size or default_block_size(n), n)
    engine, workload = resolve_solve_engine(engine, assume)
    refuse_tune_for_explicit_engine(engine, tune, plan_cache)
    plan = None
    if engine == "auto":
        engine, _, plan = auto_select(n, m, dtype, workers, gather,
                                      tune=tune, plan_cache=plan_cache,
                                      workload=workload, device=dev)
    spd = engine == "solve_spd"
    run = solve_engine_fn(engine, m)
    if dev.type == "cuda":
        # Full fp32 products on the card (the JAX package's HIGHEST).
        torch.backends.cuda.matmul.allow_tf32 = False

    def execute():
        return _timed(dev, lambda: run(a, b2))

    (x, singular), elapsed = (policy.retry.call(execute)
                              if policy is not None else execute())
    if bool(singular):
        if check:
            raise SingularMatrixError("singular matrix")
        return SolveSystemResult(
            x=None, elapsed=elapsed, residual=float("inf"), n=n, k=k,
            block_size=m, gflops=0.0, engine=engine, workload=workload,
            singular=True, plan=plan, device=str(dev))

    stats = solve_residual_stats(a, x, b2)
    recovery = ()
    if policy is not None:
        def fresh(aa, bb, pivot_free):
            # A fresh re-solve on the engine auto picks (the unrolled
            # engines within MAX_UNROLL_NR, solve_fori beyond).
            return solve_engine_fn(auto_solve_engine(
                n, m, "solve_spd" if pivot_free else "solve"), m)(aa, bb)

        x, stats, recovery = solve_recover(
            policy, a=a, b=b2, x=x, stats=stats, n=n, dtype=dtype, spd=spd,
            rerun=run, fresh=fresh)
    residual, norm_a, norm_x, norm_b = stats
    if verbose:
        print(f"glob_time: {elapsed:.2f}")
        print(f"residual: {residual:e}")
    flops = float(n) ** 3 + float(n) ** 2 * k
    return SolveSystemResult(
        x=x[:, 0] if squeezed else x, elapsed=elapsed, residual=residual,
        n=n, k=k, block_size=m,
        gflops=(flops / elapsed / 1e9) if elapsed > 0 else 0.0,
        engine=engine, workload=workload, singular=False, plan=plan,
        kappa_est=(norm_a * norm_x / norm_b) if norm_b else None,
        recovery=recovery, device=str(x.device),
        _norm_a=norm_a, _norm_x=norm_x, _norm_b=norm_b)


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
    solve, whose plan is on ``result.plan``.  Counterpart of the JAX package's ``lstsq``."""
    refuse_later_options(1, True, telemetry, policy, numerics,
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
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ah = a.T.conj() if a.is_complex() else a.T
    gram = ah @ a
    rhs = ah @ b2
    inner = solve_system(gram, rhs, block_size=block_size, assume=assume,
                         engine=engine, tune=tune, plan_cache=plan_cache,
                         policy=policy, check=False, device=dev)
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
