"""End-to-end solve driver: the single-device core of the JAX package's
``driver.solve``.

Rebuild of ``solve`` (main.cpp:343-519): generate or read A, time the
inversion, then verify independently with the residual ‖A·A⁻¹ − I‖∞ on a
freshly regenerated/re-read A (the reference destroys A and reloads it,
main.cpp:463-488, so verification never trusts state left over from the
algorithm).

On the card the inversion is timed with CUDA events around the engine call
(the first call of a process also builds the probe kernel, so callers that
want a steady-state time run it twice).  fp32 products run in full fp32:
``solve`` turns TF32 off for cuBLAS, the counterpart of the JAX package's
``Precision.HIGHEST``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from .config import default_block_size
from .errors import SingularMatrixError, UsageError
from .interop import from_numpy, resolve_device, resolve_dtype
from .io import read_matrix_file
from .ops import (
    block_jordan_invert_inplace,
    block_jordan_invert_inplace_grouped,
    generate,
    inf_norm,
    residual_inf_norm,
)
from .ops.refine import resolve_precision

__all__ = ["ENGINES", "GROUPED_MIN_SINGLE_CHIP_N", "SingularMatrixError",
           "SolveResult", "UsageError", "invert", "resolve_engine", "solve"]

# The engines this slice ports.  The JAX package's other engines arrive
# with later slices of the port (ROADMAP.md, Queue A).
ENGINES = ("auto", "inplace", "grouped")
_LATER_ENGINES = {
    "augmented": "Queue A item 6",
    "lookahead": "Queue A item 8",
    "grouped_pallas": "Queue A item 9",
    "grouped_pallas_bf16": "Queue A item 9",
    "swapfree": "Queue A item 15",
}

# The JAX package's registry cost rule (tuning/registry.py:38,243-246),
# written out: the delayed-group-update engine with k=2 from n = 8192 on,
# the plain in-place engine below.
GROUPED_MIN_SINGLE_CHIP_N = 8192


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
    device: str = ""             # where it ran, e.g. "cuda:0" or "cpu"
    _norm_a: float | None = None  # ‖A‖∞, backing rel_residual

    @property
    def rel_residual(self) -> float | None:
        """‖A·X−I‖∞ / ‖A‖∞."""
        return None if self._norm_a is None else self.residual / self._norm_a


def resolve_engine(engine: str, group: int, n: int | None = None):
    """Shared engine/group flag contract (solve, CLI), as in the JAX
    package.  Returns the ``(engine, group)`` pair; with ``n`` given,
    "auto" is resolved by the cost rule (grouped k=2 at
    n >= GROUPED_MIN_SINGLE_CHIP_N, inplace below)."""
    if engine in _LATER_ENGINES:
        raise UsageError(
            f"engine={engine!r} is not ported yet (ROADMAP.md "
            f"{_LATER_ENGINES[engine]}); choose from {'/'.join(ENGINES)}")
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
    if engine == "grouped" or (engine == "auto" and group > 1):
        return "grouped", (group if group > 1 else 2)
    if engine == "auto" and n is not None:
        if n >= GROUPED_MIN_SINGLE_CHIP_N:
            return "grouped", 2
        return "inplace", 0
    return engine, 0


def invert(a: torch.Tensor, engine: str, group: int, block_size: int,
           refine: int = 0):
    """Run the resolved engine (see resolve_engine) on ``a``; returns
    ``(x, singular)``."""
    if engine == "grouped":
        return block_jordan_invert_inplace_grouped(
            a, block_size=block_size, refine=refine, group=group)
    return block_jordan_invert_inplace(a, block_size=block_size,
                                       refine=refine)


def _refuse_later_options(workers, gather, telemetry, policy, numerics,
                          tune, plan_cache, dtype):
    """Options of the JAX package's solve that later slices bring: each
    is refused with the slice that brings it, never silently ignored."""
    if isinstance(workers, tuple) or workers != 1:
        raise UsageError("workers > 1 is the distributed path, not ported "
                         "yet (ROADMAP.md Queue A item 15)")
    if not gather:
        raise UsageError("gather=False is only supported on distributed "
                         "paths (ROADMAP.md Queue A item 15)")
    if telemetry is not None:
        raise UsageError("telemetry is not ported yet (ROADMAP.md Queue A "
                         "item 12)")
    if policy is not None:
        raise UsageError("policy (the resilience layer) is not ported yet "
                         "(ROADMAP.md Queue A item 13)")
    if numerics != "off":
        raise UsageError("numerics reports are not ported yet (ROADMAP.md "
                         "Queue A item 12); the engines' collect_stats=True "
                         "gives the per-superstep record")
    if tune or plan_cache is not None:
        raise UsageError("tune/plan_cache (the autotuner) is not ported "
                         "yet (ROADMAP.md Queue A item 11)")
    if "complex" in str(dtype):
        raise UsageError("complex dtypes are not ported yet (ROADMAP.md "
                         "Queue A item 7)")


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
    raises DeviceUnavailableError.  ``engine``: "auto" | "inplace" |
    "grouped" (see resolve_engine).  Raises SingularMatrixError like the
    reference's -2 path (main.cpp:435-437); file errors propagate from
    read_matrix_file.
    """
    _refuse_later_options(workers, gather, telemetry, policy, numerics,
                          tune, plan_cache, dtype)
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if block_size is None:
        block_size = default_block_size(n)
    _, refine = resolve_precision(precision, refine)
    engine, group = resolve_engine(engine, group, n)
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

    def run():
        return invert(a, engine, group, block_size, refine)

    if dev.type == "cuda":
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            inv, singular = run()
            stop.record()
            stop.synchronize()
            elapsed = start.elapsed_time(stop) / 1e3
    else:
        t0 = time.perf_counter()
        inv, singular = run()
        elapsed = time.perf_counter() - t0
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
        device=str(inv.device),
        _norm_a=norm_a,
    )
