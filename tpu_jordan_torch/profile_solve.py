"""Where a solve's device time goes: one traced engine call per row.

    python -m tpu_jordan_torch.profile_solve [--rows 4096:128:absdiff:float32,...]
        [--engine auto|inplace|grouped|augmented|lookahead|grouped_pallas|
                  grouped_pallas_bf16] [--group K] [--batch B]
        [--workload invert|solve|spd|lstsq|update] [--rhs K]
        [--dtype float32|float64|complex64|complex128]

For each row (n:m:generator:dtype) the matrix is generated on the card, and
the engine (the one ``driver.solve`` picks for ``--engine`` and
``--group``, by default ``auto``; with ``--batch B`` > 1, the batched
engine on the stack of B matrices that ``driver.solve_batch`` inverts; with
``--workload``, the engine ``linalg.solve_system`` picks for A·X = B with
the CLI's B of K columns: ``spd`` under the assume="spd" promise,
``lstsq`` the Gram product of the CLI's n × n//2 A and its solve;
``update`` the rank-K SMW update of the row's resident inverse,
``linalg.smw_update_with_metrics`` with its verification against the
mutated matrix, the inverse made once outside the timed calls) runs once
to warm up, then once untraced and once under ``torch.profiler``, each
between CUDA events.  Prints one JSON line a row: both wall times, the
device time of the probe kernel, of the fused update kernel, of the GEMMs
and of everything else, the idle share of the traced wall (the part during
which no kernel ran; tracing slows the host, so this share is an upper
bound for the untraced run) and the overlap (the sum of the kernels' times
less the union of their intervals: the time kernels ran beside each other,
as the lookahead engines' probe beside their GEMMs on another stream).
``--dtype`` replaces every row's dtype (complex64 and complex128 invert on
the augmented engine, and B is ``crand`` for them).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .driver import ENGINES, invert, resolve_invert_engine
from .linalg import auto_solve_engine, reinvert_fresh, smw_update_with_metrics
from .linalg.api import solve_engine_fn
from .ops import batched_jordan_invert, generate, generate_batch

WORKLOADS = ("invert", "solve", "spd", "lstsq", "update")
DTYPES = ("float32", "float64", "complex64", "complex128")

DEFAULT_ROWS = ("4096:128:absdiff:float32,8192:384:absdiff:float64,"
                "8192:384:rand:float32,16384:128:rand:float32")
# Device-time buckets: the two hand-written kernels, cuBLAS, the rest.
KINDS = ("probe", "update", "gemm", "other")


def _kind(name: str) -> str:
    low = name.lower()
    if "gj_probe" in low:
        return "probe"
    if "fused_update" in low:
        return "update"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    return "other"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def rhs_generator(dtype) -> str:
    """The generator of the CLI's right-hand sides for ``dtype``."""
    return "crand" if dtype.is_complex else "rand"


def update_factors(n: int, k: int, dtype, device="cuda", step: int = 0):
    """The (n, k) factors U and V of a rank-k update of an n × n matrix:
    the ``rand`` (``crand``) windows at row offsets (2·step + 1)·n and
    (2·step + 2)·n, scaled by 1/sqrt(n·k) so that U·Vᵀ is small beside the
    matrix; ``step`` numbers the updates of a chain."""
    gen, scale = rhs_generator(dtype), (n * k) ** -0.5
    return tuple(generate(gen, (n, k), dtype, row_offset=off * n,
                          device=device) * scale
                 for off in (2 * step + 1, 2 * step + 2))


def _workload_run(n: int, m: int, gen: str, dtype, workload: str,
                  rhs: int):
    """(engine, run) of a solve workload row, on the CLI's inputs."""
    if workload == "update":
        a = generate(gen, (n, n), dtype, device="cuda")
        inv = reinvert_fresh(a, m)[0]
        u, v = update_factors(n, rhs, dtype)
        return "smw_update", lambda: smw_update_with_metrics(a, inv, u, v)
    b = generate(rhs_generator(dtype), (n, rhs), dtype, row_offset=n,
                 device="cuda")
    if workload == "lstsq":
        a = generate(gen, (n, max(1, n // 2)), dtype, device="cuda")
        cols = a.shape[1]
        engine = auto_solve_engine(cols, min(m, cols), "solve_spd")
        solve = solve_engine_fn(engine, m)
        ah = a.T.conj() if a.is_complex() else a.T
        return engine, lambda: solve(ah @ a, ah @ b)
    a = generate(gen, (n, n), dtype, device="cuda")
    engine = auto_solve_engine(n, min(m, n), "solve_spd" if workload == "spd"
                               else "solve")
    solve = solve_engine_fn(engine, m)
    return engine, lambda: solve(a, b)


def profile_row(n: int, m: int, gen: str, dtype: torch.dtype,
                engine: str = "auto", batch: int = 1, group: int = 0,
                workload: str = "invert", rhs: int = 1) -> dict:
    from torch.profiler import ProfilerActivity, profile

    if workload != "invert":
        group = 0
        engine, run = _workload_run(n, m, gen, dtype, workload, rhs)
    elif batch > 1:
        engine, group = "batched", 0
        a = generate_batch(gen, n, batch, dtype, device="cuda")

        def run():
            return batched_jordan_invert(a, block_size=m)
    else:
        # What driver.solve runs here with no plan cache.
        engine, group, _ = resolve_invert_engine(engine, group, n, m, dtype,
                                                 device="cuda")
        a = generate(gen, (n, n), dtype, device="cuda")

        def run():
            return invert(a, engine, group, m)

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    stop.synchronize()
    untraced_ms = start.elapsed_time(stop)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        stop.record()
        stop.synchronize()
    wall_ms = start.elapsed_time(stop)
    by_kind = dict.fromkeys(KINDS, 0.0)
    launches = dict.fromkeys(KINDS, 0)
    spans = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = evt.time_range.start, evt.time_range.end
        kind = _kind(evt.name)
        by_kind[kind] += (t1 - t0) / 1e3
        launches[kind] += 1
        spans.append((t0, t1))
    busy_ms = _union_us(spans) / 1e3
    return {"n": n, "m": m, "generator": gen, "dtype": str(dtype)[6:],
            "workload": workload, "rhs": rhs if workload != "invert" else 0,
            "engine": engine, "group": group, "batch": batch,
            "wall_ms": wall_ms,
            "untraced_wall_ms": untraced_ms,
            **{f"{kind}_ms": by_kind[kind] for kind in KINDS},
            "kernels": launches,
            "busy_ms": busy_ms,
            "overlap_ms": sum(by_kind.values()) - busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default=DEFAULT_ROWS,
                    help="comma-separated n:m:generator:dtype rows")
    ap.add_argument("--engine", default="auto", choices=ENGINES,
                    help="the engine of every row (default auto)")
    ap.add_argument("--group", type=int, default=0,
                    help="the delayed-group size of the engine (the "
                         "grouped lookahead twin from 2 on)")
    ap.add_argument("--batch", type=int, default=1,
                    help="invert a stack of B matrices a row through the "
                         "batched engine (--engine does not apply)")
    ap.add_argument("--workload", default="invert", choices=WORKLOADS,
                    help="solve A·X = B (spd: under the assume='spd' "
                         "promise) or fit lstsq in place of inverting "
                         "(--engine does not apply)")
    ap.add_argument("--rhs", type=int, default=1,
                    help="right-hand-side columns of a solve workload, the "
                         "rank of an update")
    ap.add_argument("--dtype", default=None, choices=DTYPES,
                    help="the dtype of every row, in place of the rows' "
                         "own")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_solve: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for row in args.rows.split(","):
        n, m, gen, dname = row.split(":")
        print(json.dumps(profile_row(int(n), int(m), gen,
                                     getattr(torch, args.dtype or dname),
                                     args.engine,
                                     args.batch, args.group, args.workload,
                                     args.rhs)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
