"""One rank's part of a distributed invert: the body ``driver.solve(workers=
p)`` runs on each rank.  Counterpart of the JAX package's
``driver._solve_distributed_core`` with its ``_Dist1D`` backend, as seen
from one rank.

The rank generates its own cyclic strip (init_matrix, main.cpp:128-149),
runs the engine between CUDA events after a barrier (the reference's
glob_time, main.cpp:427-450: the elimination alone), sends its inverse
blocks to rank 0 (``gather``) or keeps them, then regenerates its strip of
A and verifies on the ring residual (main.cpp:463-513), with ‖A‖∞ and
‖A⁻¹‖∞ reduced by ``all_reduce(MAX)`` of row sums (κ∞).  ``refine`` runs
Newton–Schulz on rank 0's gathered inverse against the full matrix, and its
residual there, as the JAX package's refine branch does.  Everything it
returns is on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..interop import resolve_dtype
from .generate import sharded_generate
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


def _launches() -> dict:
    from ..ops import gj_fused_panel, gj_probe

    return {"gj_probe": gj_probe.launches,
            "gj_probe_fused_panel": gj_fused_panel.launches}


def gather_to_root(blocks, group, lay: CyclicLayout):
    """Rank 0 receives every rank's blocks (point to point) and returns the
    (Nr, m, N) cyclic storage tensor; the other ranks return None."""
    if group.rank != 0:
        group.exchange([(blocks, 0)], [])
        return None
    parts = [blocks] + [torch.empty_like(blocks) for _ in range(1, lay.p)]
    group.exchange([], [(parts[r], r) for r in range(1, lay.p)])
    return torch.cat(parts)


def _row_sum_max(blocks, group, lay: CyclicLayout) -> float:
    """‖·‖∞ of the distributed matrix: the max of every rank's row sums
    over its real rows (an identity-pad row sums to exactly 1 and must not
    cap a small true norm)."""
    p, m, bpw = lay.p, lay.m, lay.blocks_per_worker
    gi = ((torch.arange(bpw, device=blocks.device) * p + group.rank)[:, None]
          * m + torch.arange(m, device=blocks.device)[None, :])
    sums = torch.where(gi < lay.n, blocks.abs().sum(dim=2), 0)
    return float(group.all_reduce(sums.amax().reshape(1), "max").item())


def solve_rank(group, spec: DistSpec) -> dict:
    """Run one rank of a distributed invert; every rank of ``group`` calls
    it together."""
    from ..ops import newton_schulz, residual_inf_norm
    from ..ops.generators import generate
    from ..ops.norms import inf_norm

    dev = group.device
    in_dtype = resolve_dtype(spec.dtype)
    # Sub-fp32 storage computes in fp32 and rounds once at the end.
    dtype = torch.float32 if in_dtype.itemsize < 4 else in_dtype
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    lay = CyclicLayout.create(spec.n, spec.m, group.world_size)
    W = sharded_generate(spec.generator, lay, group.rank, dtype, dev)
    before = _launches()
    group.all_reduce(torch.zeros(1, device=dev), "sum")     # barrier
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        inv_b, singular, pivots, steps = invert_blocks(
            W, group, lay, engine=spec.engine, group_k=spec.group_k)
        end.record()
        end.synchronize()
        elapsed = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        inv_b, singular, pivots, steps = invert_blocks(
            W, group, lay, engine=spec.engine, group_k=spec.group_k)
        elapsed = time.perf_counter() - t0
    after = _launches()
    del W
    # Every rank reports the slowest rank's time.
    elapsed = float(group.all_reduce(
        torch.tensor([elapsed], dtype=torch.float64, device=dev),
        "max").item())
    out = {"rank": group.rank, "elapsed": elapsed,
           "singular": bool(singular.item()), "pivots": pivots,
           "probe_steps": steps,
           "launches": {k: after[k] - before[k] for k in after},
           "backend": group.backend, "backend_reason": group.backend_reason,
           "device": str(dev),
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "inverse": None, "blocks": None}
    if out["singular"]:
        return out
    if in_dtype != dtype:
        inv_b = inv_b.to(in_dtype)
    full = gather_to_root(inv_b, group, lay) if spec.gather else None
    if spec.refine:
        if group.rank == 0:
            a = generate(spec.generator, (spec.n, spec.n), dtype,
                         device=dev)
            inv = gather_inverse_inplace(full, lay, spec.n).to(dtype)
            inv = newton_schulz(a, inv, spec.refine).to(in_dtype)
            inv_f = inv.to(dtype)
            out["residual"] = float(residual_inf_norm(a, inv_f))
            out["norm_a"] = float(inf_norm(a))
            out["norm_x"] = float(inf_norm(inv_f))
            out["inverse"] = inv.cpu()
        return out
    if full is not None:
        out["inverse"] = gather_inverse_inplace(full, lay, spec.n).cpu()
    elif not spec.gather:
        out["blocks"] = inv_b.cpu()
    # Verification on a freshly generated strip, never on engine state.
    a_b = sharded_generate(spec.generator, lay, group.rank, dtype, dev)
    inv_f = inv_b.to(dtype)
    out["residual"] = distributed_residual_blocks(a_b, inv_f, group, lay)
    out["norm_a"] = _row_sum_max(a_b, group, lay)
    out["norm_x"] = _row_sum_max(inv_f, group, lay)
    return out


def solve_rank_summary(group, spec: DistSpec) -> dict:
    """:func:`solve_rank` without the inverse and the blocks: what a
    measured row keeps of a rank (pivots, probe steps, launches, elapsed,
    residual, norms, backend)."""
    out = solve_rank(group, spec)
    out.pop("inverse")
    out.pop("blocks")
    return out
