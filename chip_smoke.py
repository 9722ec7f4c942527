#!/usr/bin/env python3
"""Drive the PyTorch port (``tpu_jordan_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases toolchain,kernel_vs_plain

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. ``toolchain``: torch and CUDA versions, ``nvcc --version``, the card's
   name and power limit; builds every kernel under ``tpu_jordan_torch/csrc``
   (one ``nvcc`` per source, started together) with ``-Xptxas -v``.
2. ``kernel_vs_plain``: each kernel against its plain PyTorch version on the
   card, on stacks that mix random blocks with a zero, a rank-deficient and a
   NaN block: flags equal; on each regular block the kernel's residual
   ‖B·inv − I‖∞ within 10× the plain version's plus eps·m, and the relative
   ∞-norm difference of the inverses below REL_LIMIT of the dtype.  It
   prints the kernel's, the plain version's and ``torch.linalg.inv_ex``'s
   times (the last is a yardstick only; the port never calls it).
3. ``reference``: solves on the card with the kernel against the same
   solves with the plain probe (the engines' ``probe`` argument), at
   512/m64 fp32 (W in shared memory) and at the main path's 8192/m384
   fp64 (W in global memory): equal pivot sequences, neither singular,
   inverses within min(eps·n·κ∞, 0.05) of each other.  At 8192/m384 fp32
   the two runs part by rounding (eps32·κ∞ ≈ 0.3 there), so the kernel's
   run is checked step by step instead: on every superstep's candidate
   stack the plain probe must pick the kernel's pivot.
4. ``solve``: the main path, ``driver.solve(engine="auto")`` at
   4096/m128/absdiff fp32, 8192/m384/absdiff fp64, 8192/m384/rand fp32 and
   16384/m128/rand fp32, each timed on a warm run, held to the residual gate
   ``rel_residual < min(3·eps·n·κ∞/‖A‖∞, 0.5)`` (eps of the dtype), and
   required to launch the probe kernel once per superstep.  absdiff at
   8192 runs in fp64: in fp32 it sits on the knife edge the JAX package
   records (benchmarks/PHASES.md), and on this card it lands on the
   singular side with the kernel and with the plain probe alike.
5. ``kernels``: every ported kernel with its launches on the main path.

``--phases knife_edge`` (not run by default) records that fp32 absdiff
8192/m384 elimination through the grouped engine, with the kernel and with
the plain probe: which side of the knife edge each lands on.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("toolchain", "kernel_vs_plain", "reference", "solve")
EXTRA_PHASES = ("knife_edge",)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
# fp32 outside the tensor cores, fp64 through the tensor cores (the
# card's highest fp64 rate), and device memory.
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12

# Largest relative ∞-norm difference between the kernel's and the plain
# version's inverse of one regular block.  The readings on these stacks
# stay below 3e-3 (fp32) and 1e-12 (fp64); any inverse of the wrong values
# reads of order 1.
REL_LIMIT = {"float32": 1e-2, "float64": 1e-9}

# (m, nc, dtype): every m the probe meets, at the main path's stack sizes
# (nc = Nr at the first superstep: 32 at 4096/m128, 22 at 8192/m384 in fp32
# and fp64, 128 at 16384/m128).  The first case is the representative for the kernels line.
PROBE_CASES = (
    (128, 32, "float32"),
    (64, 16, "float32"),
    (128, 128, "float32"),
    (256, 16, "float32"),
    (384, 22, "float32"),
    (512, 8, "float32"),
    (128, 32, "float64"),
    (384, 22, "float64"),
)

# (n, m, generator, dtype, engine): the kernel's solves held against the
# plain probe's.  8192/m384 is the main path's grouped row, W in global
# memory; 512/m64 keeps W in shared memory.
REFERENCE_ROWS = ((512, 64, "rand", "float32", "inplace"),
                  (512, 64, "rand", "float32", "grouped"),
                  (8192, 384, "absdiff", "float64", "grouped"))
# (n, m, generator, dtype): the kernel's run checked step by step.
STEPWISE_ROW = (8192, 384, "rand", "float32")

# (n, m, generator, dtype): the main path on engine="auto".
SOLVE_ROWS = ((4096, 128, "absdiff", "float32"),
              (8192, 384, "absdiff", "float64"),
              (8192, 384, "rand", "float32"),
              (16384, 128, "rand", "float32"))

KERNELS = {
    "gj_probe": {
        "route": "cuda",
        "source": "tpu_jordan_torch/csrc/gj_probe.cu",
        "replaces": "tpu_jordan/ops/pallas_block_inverse.py:689",
    },
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, by
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def phase_toolchain(torch):
    from tpu_jordan_torch import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    names = sorted(p[:-3] for p in os.listdir(_build.CSRC)
                   if p.endswith(".cu"))
    t0 = time.perf_counter()
    logs = _build.build(names, verbose=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for text in logs.values()
             for ln in text.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "toolchain", "python": sys.version.split()[0],
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "nvcc": nvcc.splitlines()[-1], "gpu": smi(),
          "kernels_built": names, "build_s": round(build_s, 3),
          "ptxas": ptxas})


def make_stack(torch, nc: int, m: int, dtype, seed: int):
    """Random blocks with a zero block (1), a duplicated row (2, rank
    m-1) and a NaN (3) mixed in; made with numpy from ``seed``."""
    import numpy as np

    b = np.random.default_rng(seed).standard_normal((nc, m, m))
    b[1] = 0.0
    b[2, m - 1] = b[2, 0]
    b[3, m // 2, m // 3] = np.nan
    return torch.from_numpy(b).to(device="cuda", dtype=dtype)


def phase_kernel_vs_plain(torch):
    from tpu_jordan_torch.ops import batched_block_inverse, block_inf_norms
    from tpu_jordan_torch.ops.gj_probe import gj_probe

    rows = []
    for i, (m, nc, dname) in enumerate(PROBE_CASES):
        dtype = getattr(torch, dname)
        blocks = make_stack(torch, nc, m, dtype, seed=i)
        inv_k, sing_k = gj_probe(blocks)
        inv_p, sing_p = batched_block_inverse(blocks)
        torch.cuda.synchronize()
        flags_equal = bool(torch.equal(sing_k, sing_p))
        expected = torch.zeros(nc, dtype=torch.bool, device="cuda")
        expected[1:4] = True
        ok = ~sing_p
        eps = torch.finfo(dtype).eps
        b_ok = blocks[ok]
        eye = torch.eye(m, dtype=dtype, device="cuda")
        res_k = block_inf_norms(b_ok @ inv_k[ok] - eye)
        res_p = block_inf_norms(b_ok @ inv_p[ok] - eye)
        rel = (block_inf_norms(inv_k[ok] - inv_p[ok])
               / block_inf_norms(inv_p[ok]))
        within = bool((res_k <= 10 * res_p + eps * m).all()
                      and (rel <= REL_LIMIT[dname]).all())
        max_abs = float((inv_k[ok] - inv_p[ok]).abs().max())
        reps_k = 20 if m <= 256 else 5
        ms = cuda_ms(torch, lambda: gj_probe(blocks), reps_k)
        plain_ms = cuda_ms(torch, lambda: batched_block_inverse(blocks), 2)
        lib_ms = cuda_ms(torch, lambda: torch.linalg.inv_ex(blocks), 20)
        elem = blocks.element_size()
        t_ops = 2.0 * m**3 * nc / PEAK_FLOPS[dname]
        t_bytes = (2.0 * nc * m * m * elem + nc) / PEAK_BYTES
        row = {"phase": "kernel_vs_plain", "kernel": "gj_probe", "m": m,
               "nc": nc, "dtype": dname,
               "w_in": "shared" if _w_in_smem(m, elem) else "global",
               "flags_equal": flags_equal,
               "flags_expected": bool(torch.equal(sing_k, expected)),
               "max_rel_err": float(rel.max()),
               "rel_limit": REL_LIMIT[dname],
               "max_residual": [float(res_k.max()), float(res_p.max())],
               "max_residual_ratio": float((res_k / res_p).max()),
               "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        emit(row)
        if not (flags_equal and row["flags_expected"] and within):
            raise AssertionError(f"gj_probe disagrees with the plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


def _w_in_smem(m: int, elem: int) -> bool:
    from tpu_jordan_torch.ops.gj_probe import _lib

    return bool(_lib().gj_probe_w_in_smem(m, elem))


def phase_reference(torch):
    """Engines on the card with the kernel against the same engines with
    the plain probe: equal pivot sequences, neither singular, inverses
    within min(eps·n·κ∞, 0.05) (eps of the dtype, κ∞ from the plain
    probe's inverse).  The readings stay below 0.1·eps·n·κ∞ and 3e-3; the
    cap keeps the check from passing X = 0, whose difference reads 1."""
    from tpu_jordan_torch.ops import batched_block_inverse, generate
    from tpu_jordan_torch.ops import block_jordan_invert_inplace
    from tpu_jordan_torch.ops import block_jordan_invert_inplace_grouped
    from tpu_jordan_torch.ops import condition_inf, inf_norm, probe_blocks
    from tpu_jordan_torch.ops.jordan_inplace import _select as select

    def plain(cands, eps):
        return batched_block_inverse(cands, None, eps)

    engines = {"inplace": block_jordan_invert_inplace,
               "grouped": block_jordan_invert_inplace_grouped}
    for n, m, gen, dname, name in REFERENCE_ROWS:
        dtype = getattr(torch, dname)
        a = generate(gen, (n, n), dtype, device="cuda")
        eng = engines[name]
        kw = {"group": 2} if name == "grouped" else {}
        x_k, s_k, st_k = eng(a, block_size=m, collect_stats=True, **kw)
        x_p, s_p, st_p = eng(a, block_size=m, collect_stats=True,
                             probe=plain, **kw)
        pivots_equal = bool(torch.equal(st_k["pivot_block"],
                                        st_p["pivot_block"]))
        kappa = float(condition_inf(a, x_p))
        rel = float(inf_norm(x_k - x_p) / inf_norm(x_p))
        limit = min(torch.finfo(dtype).eps * n * kappa, 0.05)
        row = {"phase": "reference", "engine": name, "n": n, "m": m,
               "generator": gen, "dtype": dname,
               "pivots_equal": pivots_equal,
               "singular": [bool(s_k), bool(s_p)], "kappa_inf": kappa,
               "rel_diff": rel, "limit": limit}
        emit(row)
        del x_k, x_p, a
        torch.cuda.empty_cache()
        if not (pivots_equal and rel <= limit and not (s_k or s_p)):
            raise AssertionError(f"kernel and plain probe disagree: {row}")

    n, m, gen, dname = STEPWISE_ROW
    picks = []

    def both(cands, eps):
        invs, sing = probe_blocks(cands, eps)
        picks.append([int(select(i, s, 0)[1])
                      for i, s in (batched_block_inverse(cands, None, eps),
                                   (invs, sing))])
        return invs, sing

    a = generate(gen, (n, n), getattr(torch, dname), device="cuda")
    _, singular = block_jordan_invert_inplace_grouped(a, block_size=m,
                                                      group=2, probe=both)
    row = {"phase": "reference", "engine": "grouped", "n": n, "m": m,
           "generator": gen, "dtype": dname, "stepwise": True,
           "steps": len(picks),
           "pivots_equal": all(p == k for p, k in picks),
           "singular": bool(singular)}
    emit(row)
    del a
    torch.cuda.empty_cache()
    if not (row["pivots_equal"] and row["steps"] == -(-n // m)
            and not row["singular"]):
        raise AssertionError(f"kernel and plain probe disagree: {row}")


def phase_solve(torch):
    from tpu_jordan_torch.driver import solve
    from tpu_jordan_torch.ops import gj_probe as probe_mod

    # Warm runs first (kernel loading, cuBLAS handles, the allocator);
    # then the counts go to 0 and the main path runs once more, timed.
    for n, m, gen, dname in SOLVE_ROWS:
        solve(n, m, generator=gen, dtype=dname, engine="auto",
              device="cuda")
        torch.cuda.empty_cache()
    probe_mod.reset_launches()
    total = 0
    for n, m, gen, dname in SOLVE_ROWS:
        eps = float(torch.finfo(getattr(torch, dname)).eps)
        before = probe_mod.launches
        wall0 = time.perf_counter()
        res = solve(n, m, generator=gen, dtype=dname, engine="auto",
                    device="cuda")
        wall = time.perf_counter() - wall0
        launches = probe_mod.launches - before
        nr = -(-n // m)
        predicted = eps * n * res.kappa / res._norm_a
        gate = min(3.0 * predicted, 0.5)
        row = {"phase": "solve", "n": n, "m": m, "generator": gen,
               "dtype": dname, "engine": res.engine,
               "group": res.group, "seconds": res.elapsed,
               "gflops": res.gflops, "wall_s": wall,
               "rel_residual": res.rel_residual, "kappa_inf": res.kappa,
               "gate": gate, "probe_launches": launches, "supersteps": nr,
               "finite": bool(torch.isfinite(res.inverse).all()),
               "shape": list(res.inverse.shape)}
        emit(row)
        del res
        torch.cuda.empty_cache()
        if not (row["rel_residual"] < gate and launches == nr
                and row["finite"] and row["shape"] == [n, n]):
            raise AssertionError(f"solve failed its checks: {row}")
        total += launches
    if probe_mod.launches != total:
        raise AssertionError("probe launches outside the solves")
    return {"gj_probe": probe_mod.launches}


def phase_knife_edge(torch):
    """absdiff 8192/m384 in fp32 through the grouped engine, once with the
    kernel and once with the plain probe on the card: which side of the
    fp32 knife edge each lands on, and the first superstep at which every
    candidate was flagged singular (-1 if none)."""
    from tpu_jordan_torch.ops import batched_block_inverse, generate
    from tpu_jordan_torch.ops import block_jordan_invert_inplace_grouped
    from tpu_jordan_torch.ops import probe_blocks

    def plain(cands, eps):
        return batched_block_inverse(cands, None, eps)

    n, m = 8192, 384
    a = generate("absdiff", (n, n), torch.float32, device="cuda")
    nc = torch.arange(-(-n // m), 0, -1)
    for name, probe in (("kernel", probe_blocks), ("plain", plain)):
        _, singular, stats = block_jordan_invert_inplace_grouped(
            a, block_size=m, group=2, collect_stats=True, probe=probe)
        flagged = (stats["singular_candidates"].cpu() == nc).nonzero()
        emit({"phase": "knife_edge", "probe": name, "n": n, "m": m,
              "generator": "absdiff", "dtype": "float32",
              "engine": "grouped", "singular": bool(singular),
              "first_all_singular_step": (int(flagged[0]) if len(flagged)
                                          else -1),
              "pivot_inv_norm": [float(v)
                                 for v in stats["pivot_inv_norm"]]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                         + ",".join(PHASES + EXTRA_PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "tpu_jordan_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "tpu_jordan_torch/ beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_toolchain(torch)
    probe_rows = (phase_kernel_vs_plain(torch)
                  if "kernel_vs_plain" in phases else [])
    if "reference" in phases:
        phase_reference(torch)
    launches = phase_solve(torch) if "solve" in phases else {}
    if "knife_edge" in phases:
        phase_knife_edge(torch)

    kernels = []
    for name, info in KERNELS.items():
        rep = probe_rows[0] if probe_rows else {}
        kernels.append({
            "name": name, **info, "launches": launches.get(name),
            "max_abs_err": max((r["max_abs_err"] for r in probe_rows),
                               default=None),
            "ms": rep.get("ms"), "plain_ms": rep.get("plain_ms"),
            "bound_ms": rep.get("bound_ms"),
            "bound_by": rep.get("bound_by"),
            "library_ms": rep.get("library_ms"),
            "shape": [rep.get("nc"), rep.get("m"), rep.get("m")],
            "dtype": rep.get("dtype")})
    print(smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
