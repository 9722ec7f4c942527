"""The engine registry: every engine configuration the port runs, in one
place, each with the ``(engine, group)`` pair it resolves to, a legality
predicate over the tuning point and a cost hook on the H100 cost model
(``cost_model.py``).  Counterpart of the JAX package's
``tuning/registry.py``.

The legality predicates and the cost multipliers are the JAX package's.
The driver's and the CLI's engine vocabularies derive from this registry.
The distributed configurations (``swapfree``, ``solve_sharded``,
``solve_lookahead_sharded``) and the distributed cost floor
(``COST_MODEL_FLOOR_N``) come with ROADMAP.md Queue A item 15: their JAX
predicates are false at every single-device point, so no candidate set
changes without them.

Cost hooks rank; they are not wall-clock truth.  The tuner records
measured/projected drift whenever it measures.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

from ..config import MAX_UNROLL_NR
from . import cost_model as _cost_model

# The single-device dispatch prior of the JAX package: below this n the
# delayed-group-update engine gets an infinite cost (its per-launch costs
# are outside the model), so cost-only ranking keeps the plain engine and
# the measuring tuner never measures it there.
GROUPED_MIN_SINGLE_CHIP_N = 8192

# The workloads a tuning point selects an engine for.  lstsq routes
# through solve_system on the normal equations, so its choice is a solve
# choice.
WORKLOADS: tuple[str, ...] = ("invert", "solve", "solve_spd", "update")


def _chip_name(device) -> str | None:
    """"h100" when the CUDA device is an H100, else None."""
    import torch

    name = torch.cuda.get_device_name(device)
    return "h100" if "H100" in name else None


@dataclass(frozen=True)
class TunePoint:
    """One tuning point: everything an engine choice may depend on.
    ``dtype`` is the canonical name ("float32", "complex64", ...),
    ``backend`` "cuda" or "cpu", ``chip`` the card's cost-model name
    ("h100") or None, so the point round-trips through plan-cache keys."""

    n: int
    block_size: int
    dtype: str
    workers: Any = 1
    gather: bool = True
    backend: str = "cpu"
    chip: str | None = None
    batch: int = 1
    workload: str = "invert"

    @classmethod
    def create(cls, n: int, block_size: int | None = None, dtype="float32",
               workers: Any = 1, gather: bool = True,
               backend: str | None = None, chip: str | None = None,
               batch: int = 1, workload: str = "invert",
               device=None) -> "TunePoint":
        """The point of a call.  ``backend`` and ``chip`` come from
        ``device``, the call's resolved device ("cuda" with the card's
        chip, or "cpu"); with neither a device nor a backend the point is
        a CPU point.  ``workers`` other than 1 is refused (item 15)."""
        import torch

        from ..config import default_block_size
        from ..errors import UsageError
        from ..interop import resolve_dtype

        if block_size is None:
            block_size = default_block_size(n)
        if isinstance(workers, tuple) or int(workers) != 1:
            raise UsageError("workers > 1 is the distributed path, not "
                             "ported yet (ROADMAP.md Queue A item 15)")
        if backend is None:
            backend = (torch.device(device).type if device is not None
                       else "cpu")
        if chip is None and backend == "cuda" and torch.cuda.is_available():
            chip = _chip_name(device)
        if workload not in WORKLOADS:
            raise ValueError(f"unknown workload {workload!r}; choose "
                             f"from {'/'.join(WORKLOADS)}")
        return cls(n=int(n), block_size=int(min(block_size, n)),
                   dtype=str(resolve_dtype(dtype)).removeprefix("torch."),
                   workers=1, gather=bool(gather), backend=backend,
                   chip=chip, batch=int(batch), workload=str(workload))

    @property
    def distributed(self) -> bool:
        return isinstance(self.workers, tuple) or self.workers > 1

    @property
    def topology(self) -> str:
        """Cache-key mesh label: "single", "p8" (1D) or "2x4" (2D)."""
        if isinstance(self.workers, tuple):
            return f"{self.workers[0]}x{self.workers[1]}"
        return "single" if self.workers == 1 else f"p{self.workers}"


@dataclass(frozen=True)
class EngineConfig:
    """One registered configuration: ``engine``/``group`` are what
    ``driver.solve`` (or ``linalg.solve_system``) accepts, ``legal`` gates
    candidacy at a point, ``cost`` is the projected seconds (``math.inf``:
    legal, but never cost-preferred nor measured), ``workload`` the
    workload it serves."""

    name: str
    engine: str
    group: int
    legal: Callable[[TunePoint], bool]
    cost: Callable[[TunePoint], float]
    note: str
    workload: str = "invert"


def _chip_for(point: TunePoint) -> _cost_model.Chip:
    name = point.chip or _cost_model.BACKEND_CHIP.get(point.backend, "h100")
    return _cost_model.CHIPS[name]


def _predict(point: TunePoint, group: int = 1) -> dict:
    return _cost_model.predict(point.n, point.block_size, _chip_for(point),
                               group=group)


def projected_seconds(point: TunePoint, group: int = 1) -> float:
    """The cost model's projected seconds for one engine at a point: the
    backing of every cost hook below."""
    return _predict(point, group)["total"]


def probe_overlap_headroom(point: TunePoint) -> float:
    """The projected share of the wall the probe-ahead schedule can hide,
    min(probe, eliminate)/total."""
    r = _predict(point)
    return min(r["probe"], r["elim"]) / r["total"]


def _nr(pt: TunePoint) -> int:
    return -(-pt.n // min(pt.block_size, pt.n))


def _cost_inplace(pt: TunePoint) -> float:
    return projected_seconds(pt)


def _cost_grouped(pt: TunePoint) -> float:
    if not pt.distributed and pt.n < GROUPED_MIN_SINGLE_CHIP_N:
        return math.inf                      # the dispatch prior
    return projected_seconds(pt, group=2)


def _cost_augmented(pt: TunePoint) -> float:
    # The [A | B] working set: ~4N³ flops and twice the bytes of the
    # in-place engines; registered so the tuner can measure it, never
    # cost-preferred.
    return 2.0 * projected_seconds(pt)


def _cost_grouped_pallas(pt: TunePoint) -> float:
    # The fused-update engine runs its kernel (csrc/fused_update.cu) only
    # on the card; on the CPU it runs the plain twin, never
    # cost-preferred.  m % 128 == 0 and n >= 8192 are the JAX package's
    # envelope.  Priced just above the grouped engine: a new kernel does
    # not displace the measured champion by the model's say-so, but stays
    # inside tune=True's survivor cut.
    if (pt.backend != "cuda"
            or pt.block_size % 128 != 0
            or pt.n < GROUPED_MIN_SINGLE_CHIP_N):
        return math.inf
    return 1.02 * projected_seconds(pt, group=2)


def _cost_grouped_pallas_bf16(pt: TunePoint) -> float:
    # Sub-fp32 storage points only, at 0.75× the fp32 fused path.
    base = _cost_grouped_pallas(pt)
    return math.inf if math.isinf(base) else 0.75 * base


def _legal_grouped_pallas(pt: TunePoint) -> bool:
    # Single-device unbatched solves, <= 4-byte float storage, a
    # probe-legal block size, unrolled-reach Nr.
    m = min(pt.block_size, pt.n)
    return (not pt.distributed
            and pt.batch == 1
            and pt.dtype in ("float32", "bfloat16", "float16")
            and m % 8 == 0 and m >= 32
            and _nr(pt) <= MAX_UNROLL_NR)


def _legal_grouped_pallas_bf16(pt: TunePoint) -> bool:
    # bf16 compute is a candidate only when the storage is sub-fp32
    # already: an fp32 request is never served by rounded operands.
    return (_legal_grouped_pallas(pt)
            and pt.dtype in ("bfloat16", "float16"))


def _always(pt: TunePoint) -> bool:
    return True


def _real_dtype(pt: TunePoint) -> bool:
    # Complex dtypes run on the augmented family only.
    return not pt.dtype.startswith("complex")


def _legal_solve(pt: TunePoint) -> bool:
    # The [A | B] solve engine: single-device, unrolled reach, any dtype.
    return not pt.distributed and _nr(pt) <= MAX_UNROLL_NR


def _cost_solve(pt: TunePoint) -> float:
    # ~n³(1 + k/n) flops against the in-place inversion's 2n³.
    return 0.55 * projected_seconds(pt)


def _cost_solve_spd(pt: TunePoint) -> float:
    # assume="spd" skips the pivot probe: one candidate a superstep.
    return 0.45 * projected_seconds(pt)


def _legal_solve_fori(pt: TunePoint) -> bool:
    # The live-window loop: single-device, any Nr, any dtype.
    return not pt.distributed


def _cost_solve_fori(pt: TunePoint) -> float:
    # Full-width updates (~2n³ + 2n²k): above both unrolled flavors
    # wherever they are legal.
    return 1.1 * projected_seconds(pt)


def _legal_lookahead(pt: TunePoint) -> bool:
    # Pivoting flavors, real dtypes, unrolled-reach Nr.
    return _real_dtype(pt) and _nr(pt) <= MAX_UNROLL_NR


def _cost_lookahead(pt: TunePoint) -> float:
    # Single device: priced just above the plain engine until measured
    # evidence promotes it; inside tune=True's survivor cut.
    return 1.01 * projected_seconds(pt)


def _legal_update(pt: TunePoint) -> bool:
    return not pt.distributed


def _cost_update(pt: TunePoint) -> float:
    # O(n²k) correction plus the O(n³) verification against a fresh
    # elimination; the one update-workload engine.
    return 0.45 * projected_seconds(pt)


CONFIGS: tuple[EngineConfig, ...] = (
    EngineConfig(
        "inplace", "inplace", 0, _real_dtype, _cost_inplace,
        "in-place 2N^3 elimination, the conservative default"),
    EngineConfig(
        "grouped2", "grouped", 2, _real_dtype, _cost_grouped,
        "delayed group updates, k=2"),
    EngineConfig(
        "augmented", "augmented", 0, _always, _cost_augmented,
        "~4N^3 reference-parity path (global singularity scale); the one "
        "complex-capable invert engine"),
    EngineConfig(
        "grouped_pallas", "grouped_pallas", 2, _legal_grouped_pallas,
        _cost_grouped_pallas,
        "delayed group updates with the group close fused into one "
        "kernel (csrc/fused_update.cu); fp32 bit-matches grouped"),
    EngineConfig(
        "grouped_pallas_bf16", "grouped_pallas_bf16", 2,
        _legal_grouped_pallas_bf16, _cost_grouped_pallas_bf16,
        "the fused kernel with bf16 operands and fp32 sums; a candidate "
        "only at sub-fp32 storage points, always behind the residual "
        "gate"),
    EngineConfig(
        "lookahead", "lookahead", 0, _legal_lookahead, _cost_lookahead,
        "probe-ahead in-place elimination: step t+1's probe on a side "
        "stream before step t's trailing GEMMs; unrolled-reach Nr"),
    EngineConfig(
        "solve_aug", "solve_aug", 0, _legal_solve, _cost_solve,
        "Gauss-Jordan on [A | B] with the pivot probe, no inverse formed",
        workload="solve"),
    EngineConfig(
        "solve_spd", "solve_spd", 0, _legal_solve, _cost_solve_spd,
        "pivot-free SPD path under assume='spd': the probe is skipped",
        workload="solve_spd"),
    EngineConfig(
        "solve_aug_spd", "solve_aug", 0, _legal_solve, _cost_solve,
        "the pivoting solve engine at SPD points, the fallback",
        workload="solve_spd"),
    EngineConfig(
        "solve_fori", "solve_fori", 0, _legal_solve_fori,
        _cost_solve_fori,
        "the live-window [A | B] loop: any Nr, full-width updates",
        workload="solve"),
    EngineConfig(
        "solve_fori_spd", "solve_fori", 0, _legal_solve_fori,
        _cost_solve_fori,
        "the pivoting live-window loop at SPD points, beyond the "
        "unrolled reach",
        workload="solve_spd"),
    EngineConfig(
        "smw_update", "smw_update", 0, _legal_update, _cost_update,
        "Sherman-Morrison-Woodbury rank-k update of a resident inverse, "
        "with its verification (linalg/update.py)",
        workload="update"),
)

REGISTRY: dict[str, EngineConfig] = {c.name: c for c in CONFIGS}
assert len(REGISTRY) == len(CONFIGS), "duplicate registry names"

#: The invert vocabulary of driver.solve and the CLI ("auto" = the tuner).
ENGINES: tuple[str, ...] = ("auto",) + tuple(
    dict.fromkeys(c.engine for c in CONFIGS if c.workload == "invert"))

#: The solve vocabulary of linalg.solve_system.
SOLVE_ENGINES: tuple[str, ...] = ("auto",) + tuple(
    dict.fromkeys(c.engine for c in CONFIGS
                  if c.workload in ("solve", "solve_spd")))

#: The single-device fused-update engines.
PALLAS_ENGINES: tuple[str, ...] = ("grouped_pallas", "grouped_pallas_bf16")


def get(name: str) -> EngineConfig:
    return REGISTRY[name]


def candidates(point: TunePoint) -> list[EngineConfig]:
    """The legal configurations of the point's workload, cheapest
    projected first (ties by name)."""
    legal = [c for c in CONFIGS
             if c.workload == point.workload and c.legal(point)]
    return sorted(legal, key=lambda c: (c.cost(point), c.name))


def select_by_cost(point: TunePoint) -> EngineConfig:
    """The cost-model pick: what ``engine="auto"`` runs with no plan in
    the cache and no measurement asked for."""
    cands = candidates(point)
    if not cands:
        raise ValueError(f"no legal engine at {point}")
    return cands[0]
