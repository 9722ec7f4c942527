"""One rank's part of the distributed workloads: the bodies that
``driver.solve(workers=...)``, ``linalg.solve_system(workers=...)`` and the
tuner's distributed measurement run on each rank, on the 1D layout (p
ranks) or the 2D layout (a (pr, pc) mesh, ``spec.mesh``).  Counterpart of the JAX
package's ``driver._solve_distributed_core`` with its ``_Dist1D`` backend,
of ``linalg.api._solve_system_dist_impl`` and of ``tuning.tuner.
measure_config``'s distributed branches, as seen from one rank.  On a mesh
(the JAX ``_Dist2D`` backend) a rank generates or streams its (bpr, m,
N/pc) shard, runs the 2D engine (``jordan2d_inplace.py``), and verifies
on the SUMMA residual (``jordan2d.py``).

:func:`solve_rank` (invert): the rank generates its own cyclic strip
(init_matrix, main.cpp:128-149), or with a file streams it
(``scatter_stream.stream_scatter_1d``: the rank reads the file up to its
last strip, holding one strip at a time), runs the engine between CUDA
events after a barrier (the reference's glob_time, main.cpp:427-450: the
elimination alone), sends its inverse blocks to rank 0 (``gather``) or
keeps them, then regenerates (re-reads) its strip of A and verifies on the
ring residual (main.cpp:463-513), never on engine state, with ‖A‖∞ and
‖A⁻¹‖∞ reduced by ``all_reduce(MAX)`` of row sums (κ∞).  ``refine`` runs
Newton–Schulz on rank 0's gathered inverse against the full matrix, and its
residual there, as the JAX package's refine branch does.  Everything it
returns is on the CPU.

:func:`solve_system_rank` (solve): the rank's strips of the caller's A and
B arrive as its own arguments (``run_workers(per_rank=...)``); it solves
between CUDA events and returns its rows of X.

:func:`measure_rank` (tuning): one configuration's warm-up and every timed
sample in one world, each sample the slowest rank's time.

With ``spec.record`` (``obs.comm.recording()`` in the caller) a rank runs
under a ``group.RankLog``: the collectives it issues are noted by section
("timing": the barrier and the elapsed max around the engine; "engine";
"gather"; "residual"), with the engine's GEMM FLOPs, and come back in its
outcome as ``observed`` and ``gemm_flops``.  Every outcome carries the
record the comm inventory is derived from: ``pivots`` and, on a mesh,
``pinned`` (the swap-free steps whose window was all singular).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

import torch

from ..interop import resolve_dtype
from .generate import sharded_generate
from .group import RankLog, collecting, section
from .layout import CyclicLayout
from .ring_gemm import distributed_residual_blocks
from .sharded_inplace import gather_inverse_inplace, invert_blocks


@dataclass(frozen=True)
class DistSpec:
    """What every rank of one distributed invert needs (picklable)."""

    n: int
    m: int
    generator: str
    dtype: str
    engine: str
    group_k: int = 0
    gather: bool = True
    refine: int = 0
    file: str | None = None
    #: A (pr, pc) mesh of the 2D layout; None for the 1D layout.
    mesh: tuple | None = None
    probe_layout: str = "auto"
    #: Run the rank under a ``RankLog`` (module docstring).
    record: bool = False


def _launches() -> dict:
    from ..ops import gj_fused_panel, gj_probe

    return {"gj_probe": gj_probe.launches,
            "gj_probe_fused_panel": gj_fused_panel.launches}


def gather_parts(blocks, group) -> list | None:
    """Rank 0 receives every rank's blocks (point to point, each of the
    shape of its own) and returns them in rank order; the other ranks
    return None."""
    if group.rank != 0:
        group.exchange([(blocks, 0)], [])
        return None
    parts = [blocks] + [torch.empty_like(blocks)
                        for _ in range(1, group.world_size)]
    group.exchange([], [(parts[r], r)
                        for r in range(1, group.world_size)])
    return parts


def share_outcomes(out: dict, drop=("inverse", "blocks")) -> list:
    """Every rank's outcome (less the keys ``drop``) in rank order, on
    every rank of this process's joined world: one ``all_gather_object``,
    outside the recording point (it carries the records, it is not part of
    what they record)."""
    import torch.distributed as dist

    mine = {k: v for k, v in out.items() if k not in drop}
    peers = [None] * dist.get_world_size()
    dist.all_gather_object(peers, mine)
    return peers


def _row_sum_max(blocks, group, lay: CyclicLayout) -> float:
    """‖·‖∞ of the distributed matrix: the max of every rank's row sums
    over its real rows (an identity-pad row sums to exactly 1 and must not
    cap a small true norm)."""
    p, m, bpw = lay.p, lay.m, lay.blocks_per_worker
    gi = ((torch.arange(bpw, device=blocks.device) * p + group.rank)[:, None]
          * m + torch.arange(m, device=blocks.device)[None, :])
    sums = torch.where(gi < lay.n, blocks.abs().sum(dim=2), 0)
    return float(group.all_reduce(sums.amax().reshape(1), "max").item())


def _timed(group, fn):
    """``fn()`` after a barrier, timed with CUDA events on the card (the
    host clock on the CPU); returns (result, the slowest rank's seconds).
    The barrier and the max are the "timing" section, ``fn`` the
    "engine" section."""
    dev = group.device
    with section("timing"):
        group.all_reduce(torch.zeros(1, dtype=torch.float32, device=dev),
                         "sum")                             # barrier
    with section("engine"):
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in "se")
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            elapsed = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn()
            elapsed = time.perf_counter() - t0
    with section("timing"):
        return out, float(group.all_reduce(
            torch.tensor([elapsed], dtype=torch.float64, device=dev),
            "max").item())


def _logged(record: bool, body):
    """``body()`` under a fresh ``RankLog`` when ``record``; the log's
    ``observed`` records and ``gemm_flops`` join the outcome."""
    if not record:
        return body()
    log = RankLog()
    with collecting(log):
        out = body()
    out["observed"] = log.records
    out["gemm_flops"] = log.gemm_flops
    return out


def _rank_info(group) -> dict:
    dev = group.device
    return {"rank": group.rank, "backend": group.backend,
            "backend_reason": group.backend_reason, "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")}


class _Rows1D:
    """A rank's view of the 1D layout in :func:`solve_rank` (the JAX
    ``_Dist1D`` backend): its (bpw, m, N) strip, the 1D engine, the ring
    residual, the row-sum norm."""

    def __init__(self, group, spec: DistSpec):
        self.group, self.spec = group, spec
        self.lay = CyclicLayout.create(spec.n, spec.m, group.world_size)
        self.info = {"pinned": []}

    def load(self, dtype, in_dtype):
        """The strip of A: generated, or streamed from ``spec.file``
        (rounded to a sub-fp32 storage dtype first)."""
        spec, group = self.spec, self.group
        if spec.file is None:
            return sharded_generate(spec.generator, self.lay, group.rank,
                                    dtype, group.device)
        from .scatter_stream import stream_scatter_1d

        return stream_scatter_1d(
            spec.file, self.lay, group.rank, dtype,
            storage_dtype=in_dtype if in_dtype != dtype else None,
            device=group.device)

    def invert(self, W):
        """(inverse blocks, singular, pivots, probe steps)."""
        if self.spec.engine == "augmented":
            from .sharded_jordan import invert_augmented_1d

            return invert_augmented_1d(W, self.group, self.lay)
        return invert_blocks(W, self.group, self.lay,
                             engine=self.spec.engine,
                             group_k=self.spec.group_k)

    def natural(self, parts):
        return gather_inverse_inplace(torch.cat(parts), self.lay,
                                      self.spec.n)

    def residual(self, a_b, inv_f) -> float:
        return distributed_residual_blocks(a_b, inv_f, self.group, self.lay)

    def norm(self, blocks) -> float:
        return _row_sum_max(blocks, self.group, self.lay)


class _Mesh2D(_Rows1D):
    """A rank's view of the 2D layout (the JAX ``_Dist2D`` backend): its
    (bpr, m, N/pc) shard of the mesh ``spec.mesh``, the 2D engine (with
    ``spec.probe_layout``), the SUMMA residual, the row sums over the
    mesh."""

    def __init__(self, group, spec: DistSpec):
        from .group import mesh_group
        from .layout import CyclicLayout2D

        pr, pc = spec.mesh
        self.spec = spec
        self.mg = mesh_group(group, pr, pc)
        self.group = self.mg.world          # the world, named "pr,pc"
        self.lay = CyclicLayout2D.create(spec.n, spec.m, pr, pc)
        self.info = {"mesh": [pr, pc], "kr": self.mg.kr, "kc": self.mg.kc,
                     "pinned": []}

    def load(self, dtype, in_dtype):
        from .jordan2d import sharded_generate_2d
        from .scatter_stream import stream_scatter_2d

        spec, mg = self.spec, self.mg
        if spec.file is None:
            return sharded_generate_2d(spec.generator, self.lay, mg.kr,
                                       mg.kc, dtype, augmented=False,
                                       device=mg.device)
        return stream_scatter_2d(
            spec.file, self.lay, mg.kr, mg.kc, dtype,
            storage_dtype=in_dtype if in_dtype != dtype else None,
            device=mg.device)

    def invert(self, W):
        from .jordan2d_inplace import invert_blocks_2d

        if self.spec.engine == "augmented":
            from .jordan2d import invert_augmented_2d

            inv, singular, pivots, probed = invert_augmented_2d(
                W, self.mg, self.lay, probe_layout=self.spec.probe_layout)
        else:
            inv, singular, pivots, probed = invert_blocks_2d(
                W, self.mg, self.lay, engine=self.spec.engine,
                group_k=self.spec.group_k,
                probe_layout=self.spec.probe_layout,
                pinned=self.info["pinned"])
        self.info["probed"] = _probed_rows(probed)
        return inv, singular, pivots, [t for t, _ in probed]

    def natural(self, parts):
        from .jordan2d_inplace import gather_inverse_inplace_2d

        return gather_inverse_inplace_2d(parts, self.lay, self.spec.n)

    def residual(self, a_b, inv_f) -> float:
        from .jordan2d import distributed_residual_2d

        return distributed_residual_2d(a_b, inv_f, self.mg, self.lay)

    def norm(self, blocks) -> float:
        from .jordan2d import row_sum_max_2d

        return row_sum_max_2d(blocks, self.mg, self.lay)


def _probed_rows(probed) -> list:
    """The (t, global rows) record as JSON-friendly lists."""
    return [[t, rows] for t, rows in probed]


def solve_rank(group, spec: DistSpec) -> dict:
    """Run one rank of a distributed invert, on the 1D layout or the mesh
    ``spec.mesh``; every rank of ``group`` calls it together.
    ``strip_rows_max`` is the most rows of the file this rank's strip
    readers held at once (0 for a generator; the refine branch's rank 0
    reads the whole file, as the JAX package's does) and ``parser`` the
    parser they used ("native" or "python"; None for a generator).  ``inverse_sha256``
    is the rank's inverse blocks' digest, to hold two runs bit for bit
    without moving them; on a mesh ``probed`` lists (t, global rows) of
    every step this rank probed.  With ``spec.record`` it runs under a
    ``RankLog`` (module docstring)."""
    return _logged(spec.record, lambda: _solve_rank(group, spec))


def _solve_rank(group, spec: DistSpec) -> dict:
    from ..io import parser_in_use, reset_strip_peak, strip_peak_rows
    from ..ops import newton_schulz, residual_inf_norm
    from ..ops.generators import generate
    from ..ops.norms import inf_norm

    be = _Mesh2D(group, spec) if spec.mesh is not None else _Rows1D(group,
                                                                     spec)
    group = be.group
    dev = group.device
    in_dtype = resolve_dtype(spec.dtype)
    # Sub-fp32 storage computes in fp32 and rounds once at the end.
    dtype = torch.float32 if in_dtype.itemsize < 4 else in_dtype
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    reset_strip_peak()
    W = be.load(dtype, in_dtype)
    before = _launches()
    (inv_b, singular, pivots, steps), elapsed = _timed(
        group, lambda: be.invert(W))
    after = _launches()
    del W
    out = {**_rank_info(group), **be.info, "elapsed": elapsed,
           "singular": bool(singular.item()), "pivots": pivots,
           "probe_steps": steps,
           "launches": {k: after[k] - before[k] for k in after},
           "strip_rows_max": strip_peak_rows(),
           "parser": parser_in_use() if spec.file is not None else None,
           "inverse": None, "blocks": None}
    if out["singular"]:
        return out
    if in_dtype != dtype:
        inv_b = inv_b.to(in_dtype)
    out["inverse_sha256"] = hashlib.sha256(
        inv_b.contiguous().cpu().view(torch.uint8).numpy().tobytes()
    ).hexdigest()
    with section("gather"):
        parts = gather_parts(inv_b, group) if spec.gather else None
    if spec.refine:
        if group.rank == 0:
            if spec.file is not None:
                from ..interop import from_numpy
                from ..io import read_matrix_file

                a = from_numpy(read_matrix_file(spec.file, spec.n), dev,
                               in_dtype).to(dtype)
            else:
                a = generate(spec.generator, (spec.n, spec.n), dtype,
                             device=dev)
            inv = be.natural(parts).to(dtype)
            inv = newton_schulz(a, inv, spec.refine).to(in_dtype)
            inv_f = inv.to(dtype)
            out["residual"] = float(residual_inf_norm(a, inv_f))
            out["norm_a"] = float(inf_norm(a))
            out["norm_x"] = float(inf_norm(inv_f))
            out["inverse"] = inv.cpu()
        return out
    if parts is not None:
        out["inverse"] = be.natural(parts).cpu()
    elif not spec.gather:
        out["blocks"] = inv_b.cpu()
    # Verification on a freshly generated (re-read) strip, never on engine
    # state.
    a_b = be.load(dtype, in_dtype)
    inv_f = inv_b.to(dtype)
    with section("residual"):
        out["residual"] = be.residual(a_b, inv_f)
        out["norm_a"] = be.norm(a_b)
        out["norm_x"] = be.norm(inv_f)
    out["strip_rows_max"] = max(out["strip_rows_max"], strip_peak_rows())
    return out


def solve_rank_summary(group, spec: DistSpec) -> dict:
    """:func:`solve_rank` without the inverse and the blocks: what a
    measured row keeps of a rank (pivots, probe steps, launches, elapsed,
    residual, norms, backend)."""
    out = solve_rank(group, spec)
    out.pop("inverse")
    out.pop("blocks")
    return out


@dataclass(frozen=True)
class DistSolveSpec:
    """What every rank of one distributed [A | B] solve needs (picklable):
    ``dtype`` is the compute dtype, ``engine`` "solve_sharded" or
    "solve_lookahead"."""

    n: int
    m: int
    dtype: str
    engine: str
    mesh: tuple | None = None
    #: Run the rank under a ``RankLog`` (module docstring).
    record: bool = False


def solve_system_rank(group, spec: DistSolveSpec, a_blocks,
                      b_blocks) -> dict:
    """Run one rank of a distributed solve on its own (bpw, m, N) strip of
    A and (bpw, m, k) strip of B (numpy arrays in the compute dtype);
    every rank of ``group`` calls it together.  Returns the rank's CPU
    outcome: ``x_blocks`` (its rows of X, cyclic order), ``singular``,
    ``pivots``, ``probe_steps``, ``launches`` and ``elapsed`` (the slowest
    rank's).  With ``spec.record`` it runs under a ``RankLog``."""
    return _logged(spec.record, lambda: _solve_system_rank(
        group, spec, a_blocks, b_blocks))


def _solve_system_rank(group, spec: DistSolveSpec, a_blocks,
                       b_blocks) -> dict:
    from ..interop import from_numpy
    from .sharded_inplace import compile_sharded_jordan_solve

    dev = group.device
    dtype = resolve_dtype(spec.dtype)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    W = from_numpy(a_blocks, dev, dtype)
    X = from_numpy(b_blocks, dev, dtype)
    lookahead = spec.engine == "solve_lookahead"
    extra = {}
    if spec.mesh is None:
        lay = CyclicLayout.create(spec.n, spec.m, group.world_size)
        run = compile_sharded_jordan_solve(lay, lookahead=lookahead)

        def fn():
            return run(group, W, X)
    else:
        from .group import mesh_group
        from .jordan2d_inplace import compile_sharded_jordan_solve_2d
        from .layout import CyclicLayout2D

        pr, pc = spec.mesh
        mg = mesh_group(group, pr, pc)
        lay = CyclicLayout2D.create(spec.n, spec.m, pr, pc)
        run = compile_sharded_jordan_solve_2d(lay, lookahead=lookahead)
        extra = {"mesh": [pr, pc], "kr": mg.kr, "kc": mg.kc}
        group = mg.world

        def fn():
            return run(mg, W, X)
    before = _launches()
    (xb, singular, pivots, steps), elapsed = _timed(group, fn)
    after = _launches()
    if spec.mesh is not None:
        extra["probed"] = _probed_rows(steps)
        steps = [t for t, _ in steps]
    return {**_rank_info(group), **extra, "elapsed": elapsed,
            "singular": bool(singular.item()), "pivots": pivots,
            "pinned": [], "probe_steps": steps,
            "launches": {k: after[k] - before[k] for k in after},
            "x_blocks": xb.cpu()}


@dataclass(frozen=True)
class MeasureSpec:
    """One configuration to time at a distributed point (picklable):
    ``workload`` "invert" (``engine``/``group_k`` an invert engine) or a
    solve workload (``engine`` "solve_sharded"/"solve_lookahead")."""

    n: int
    m: int
    dtype: str
    workload: str
    engine: str
    group_k: int = 0
    mesh: tuple | None = None


def measure_rank(group, spec: MeasureSpec, samples: int,
                 warmup: int = 1) -> list:
    """Time one configuration on this rank: the ``rand`` matrix's strip
    (and one ``rand`` right-hand side for a solve), ``warmup`` untimed runs
    and ``samples`` timed ones, each after a barrier and each the slowest
    rank's CUDA-event (host, on the CPU) seconds.  Every rank returns the
    same list."""
    from ..ops.generators import generate
    from .sharded_inplace import compile_sharded_jordan_solve, scatter_rhs_1d

    dev = group.device
    dtype = resolve_dtype(spec.dtype)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if spec.mesh is not None:
        return _measure_rank_2d(group, spec, samples, warmup)
    lay = CyclicLayout.create(spec.n, spec.m, group.world_size)
    W = sharded_generate("rand", lay, group.rank, dtype, dev)
    if spec.workload == "invert" and spec.engine == "augmented":
        from .sharded_jordan import invert_augmented_1d

        def fn():
            return invert_augmented_1d(W, group, lay)
    elif spec.workload == "invert":
        def fn():
            return invert_blocks(W, group, lay, engine=spec.engine,
                                 group_k=spec.group_k)
    else:
        X = scatter_rhs_1d(generate("rand", (spec.n, 1), dtype, device=dev),
                           lay, group.rank)
        run = compile_sharded_jordan_solve(
            lay, lookahead=spec.engine == "solve_lookahead")

        def fn():
            return run(group, W, X)
    for _ in range(warmup):
        _timed(group, fn)
    return [_timed(group, fn)[1] for _ in range(samples)]


def _measure_rank_2d(group, spec: MeasureSpec, samples: int,
                     warmup: int) -> list:
    """:func:`measure_rank` on the (pr, pc) mesh ``spec.mesh``."""
    from ..ops.generators import generate
    from .group import mesh_group
    from .jordan2d import sharded_generate_2d
    from .jordan2d_inplace import (compile_sharded_jordan_solve_2d,
                                   invert_blocks_2d, scatter_rhs_2d)
    from .layout import CyclicLayout2D

    pr, pc = spec.mesh
    mg = mesh_group(group, pr, pc)
    dev = group.device
    dtype = resolve_dtype(spec.dtype)
    lay = CyclicLayout2D.create(spec.n, spec.m, pr, pc)
    W = sharded_generate_2d("rand", lay, mg.kr, mg.kc, dtype,
                            augmented=False, device=dev)
    if spec.workload == "invert" and spec.engine == "augmented":
        from .jordan2d import invert_augmented_2d

        def fn():
            return invert_augmented_2d(W, mg, lay)
    elif spec.workload == "invert":
        def fn():
            return invert_blocks_2d(W, mg, lay, engine=spec.engine,
                                    group_k=spec.group_k)
    else:
        X = scatter_rhs_2d(generate("rand", (spec.n, 1), dtype, device=dev),
                           lay, mg.kr)
        run = compile_sharded_jordan_solve_2d(
            lay, lookahead=spec.engine == "solve_lookahead")

        def fn():
            return run(mg, W, X)
    for _ in range(warmup):
        _timed(group, fn)
    return [_timed(group, fn)[1] for _ in range(samples)]


def _backend_of(group, spec: DistSpec):
    return _Mesh2D(group, spec) if spec.mesh is not None else _Rows1D(
        group, spec)


def invert_strip_rank(group, spec: DistSpec, a_blocks,
                      keep: str | None = None) -> dict:
    """One rank of an invert on a given strip: ``a_blocks`` is this rank's
    (bpw, m, N) strip (or (bpr, m, N/pc) shard on the mesh ``spec.mesh``)
    of the identity-padded A in the compute dtype ``spec.dtype``, handed
    over by the caller (the mesh lanes, ``JordanSolver``); ``spec.engine``
    runs between CUDA events after a barrier.  The rank's inverse blocks
    come back on the CPU as ``blocks``, or with ``keep`` stay on its
    device in the persistent world's rank state under that key
    (``parallel.world.rank_state``) for a later job
    (:func:`residual_strip_rank`); no gather collective, no residual.
    With ``spec.record`` it runs under a ``RankLog``."""
    return _logged(spec.record, lambda: _invert_strip_rank(
        group, spec, a_blocks, keep))


def _invert_strip_rank(group, spec, a_blocks, keep):
    from ..interop import from_numpy

    be = _backend_of(group, spec)
    group = be.group
    dev = group.device
    dtype = resolve_dtype(spec.dtype)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    W = from_numpy(a_blocks, dev, dtype)
    before = _launches()
    (inv_b, singular, pivots, steps), elapsed = _timed(
        group, lambda: be.invert(W))
    after = _launches()
    out = {**_rank_info(group), **be.info, "elapsed": elapsed,
           "singular": bool(singular.item()), "pivots": pivots,
           "probe_steps": steps,
           "launches": {k: after[k] - before[k] for k in after},
           "blocks": None}
    if keep is not None:
        from .world import rank_state

        rank_state()[keep] = inv_b
    else:
        out["blocks"] = inv_b.cpu()
    return out


def residual_strip_rank(group, spec: DistSpec, a_blocks, inv) -> dict:
    """‖A·A⁻¹ − I‖∞ and the κ∞ norms on the ranks: ``a_blocks`` is this
    rank's strip (shard) of the identity-padded A, ``inv`` its strip of the
    inverse, or the key under which :func:`invert_strip_rank` kept the
    rank's inverse blocks; the ring residual (1D) or SUMMA (mesh), the
    "residual" section of the comm inventory.  Nothing n×n is formed in
    any process."""
    return _logged(spec.record, lambda: _residual_strip_rank(
        group, spec, a_blocks, inv))


def _residual_strip_rank(group, spec, a_blocks, inv):
    from ..interop import from_numpy
    from .world import rank_state

    be = _backend_of(group, spec)
    if isinstance(inv, str):
        key, inv = inv, rank_state().get(inv)
        if inv is None:
            raise KeyError(f"no inverse blocks kept under {key!r} on rank "
                           f"{be.group.rank}")
    a_b = from_numpy(a_blocks, be.group.device, resolve_dtype(spec.dtype))
    inv = from_numpy(inv, be.group.device)
    with section("residual"):
        res = be.residual(a_b, inv.to(a_b.dtype))
        norm_a = be.norm(a_b)
        norm_x = be.norm(inv.to(a_b.dtype))
    return {**_rank_info(be.group), "residual": res, "norm_a": norm_a,
            "norm_x": norm_x}


def drop_state(group, keys) -> int:
    """Forget the rank-state entries ``keys``; returns how many there
    were."""
    from .world import rank_state

    state = rank_state()
    return sum(state.pop(k, None) is not None for k in keys)


def split_strips(a, lay) -> list:
    """Every rank's strip (1D) or shard (2D) of the identity-padded (n, n)
    ``a`` (a CPU tensor), in rank order: what each rank of a world is
    handed (``per_rank``), never the whole matrix."""
    from ..ops.padding import pad_with_identity

    ap = pad_with_identity(a, lay.N)
    if hasattr(lay, "pc"):
        from .jordan2d import _own_blocks

        ap = ap.reshape(lay.Nr, lay.m, lay.Nr, lay.m)
        return [_own_blocks(ap, lay, *divmod(r, lay.pc))
                for r in range(lay.pr * lay.pc)]
    ap = ap.reshape(lay.Nr, lay.m, lay.N)
    return [ap[r::lay.p].contiguous() for r in range(lay.p)]


def join_strips(blocks, lay, n: int) -> torch.Tensor:
    """The (n, n) matrix from the ranks' inverse blocks in rank order (the
    inverse of :func:`split_strips`, padding stripped)."""
    if hasattr(lay, "pc"):
        from .jordan2d import gather_matrix_2d

        return gather_matrix_2d(list(blocks), lay, n)
    return gather_inverse_inplace(list(blocks), lay, n)


def split_rhs(b, lay) -> list:
    """Every rank's (bpw, m, k) rows of the (n, k) right-hand side ``b``
    (on the mesh: its mesh row's, replicated along pc), in rank order."""
    if hasattr(lay, "pc"):
        from .jordan2d_inplace import scatter_rhs_2d

        return [scatter_rhs_2d(b, lay, r // lay.pc)
                for r in range(lay.pr * lay.pc)]
    from .sharded_inplace import scatter_rhs_1d

    return [scatter_rhs_1d(b, lay, r) for r in range(lay.p)]


def join_rhs(blocks, lay, n: int) -> torch.Tensor:
    """The (n, k) solution from the ranks' X rows in rank order (the
    inverse of :func:`split_rhs`)."""
    if hasattr(lay, "pc"):
        from .jordan2d_inplace import gather_solution_2d

        return gather_solution_2d(list(blocks), lay, n)
    from .sharded_inplace import gather_solution_1d

    return gather_solution_1d(list(blocks), lay, n)
