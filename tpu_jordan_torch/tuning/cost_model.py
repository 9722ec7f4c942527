"""The analytic single-device cost model behind the registry's cost hooks:
the eliminate, probe and glue terms of the JAX package's comm model
(``benchmarks/comm_model.py::predict`` at one device, group 1 and group
k), with the constants of one H100 measured by the port.

Per superstep t of Nr (N = Nr·m, k the delayed-group size, j = t mod k):
  * eliminate: the GEMM's 2·N·m·N flops at the card's fp32 GEMM rate,
    floored by the read-modify-write of the N×N state (8·N² bytes) over
    HBM; a group closes that pass once per k steps, and its eager side
    updates (2·N·(j·m)·m + 2·m·(j·m)·N flops) are charged per step;
  * probe: ``probe_seconds_per_pass(m)`` · (Nr − t) candidates · m³;
  * glue (swaps, normalize, row writes): half a state pass, or in a group
    half a pass per k steps plus 12·m·N bytes a step.

The terms rank engines; they are not a wall-clock promise.  The tuner
records measured/projected drift on every trial, so a constant that goes
stale shows.  The mesh terms (collectives, link bandwidth) come with the
distributed engines (ROADMAP.md Queue A item 15).  The CPU backend ranks
with the same H100 model, as the JAX package ranks the CPU with its one
calibrated chip.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Chip:
    name: str
    gemm: float      # fp32 GEMM rate with TF32 off, FLOP/s
    hbm: float       # device memory rate, bytes/s
    #: ((m, seconds per candidate-element pass), ...), two or more by
    #: ascending m: the probe's measured time of one m×m candidate over m³.
    probe: tuple


# One NVIDIA H100 80GB HBM3 at a 700.00 W power limit, the port's own rows:
H100 = Chip(
    "h100",
    # PERF.md §5, the row 16384/m128 rand fp32, grouped k=2: 222.01 ms of
    # GEMMs for 2·16384³ flops (H100 80GB HBM3, 700.00 W).
    gemm=2.0 * 16384**3 / 222.01e-3,
    # The card's data sheet (H100 SXM5 80 GB): 3.35 TB/s.
    hbm=3.35e12,
    # PERF.md §6 row 1, the panel probe at the default block sizes (H100
    # 80GB HBM3, 700.00 W): (32, 128) fp32 0.2051 ms and (22, 384) fp32
    # 1.2548 ms, over nc·m³.
    probe=((128, 0.2051e-3 / (32 * 128**3)),
           (384, 1.2548e-3 / (22 * 384**3))))

CHIPS = {H100.name: H100}

#: The chip model each backend ranks with when the point names none.
BACKEND_CHIP = {"cuda": "h100", "cpu": "h100"}


def probe_seconds_per_pass(chip: Chip, m: int) -> float:
    """The probe constant at block size ``m``: log-log interpolation
    between the chip's calibration rows, the end segments extended."""
    pts = chip.probe
    i = 1
    while i < len(pts) - 1 and m > pts[i][0]:
        i += 1
    (m0, c0), (m1, c1) = pts[i - 1], pts[i]
    slope = math.log(c1 / c0) / math.log(m1 / m0)
    return c0 * (m / m0) ** slope


def predict(n: int, m: int, chip: Chip, group: int = 1) -> dict:
    """Projected seconds of one single-device elimination of an n×n matrix
    with block size m: ``{"elim", "probe", "glue", "total"}``.
    ``group=k > 1`` models the delayed-group-update engines."""
    Nr = -(-n // m)
    N = Nr * m
    k = max(1, min(group, Nr))
    c_probe = probe_seconds_per_pass(chip, m)
    elim = probe = glue = 0.0
    for t in range(Nr):
        j = t % k
        fl = 2.0 * N * m * N
        rmw = 2.0 * N * N * 4
        if k == 1:
            elim += max(fl / chip.gemm, rmw / chip.hbm)
            glue += 0.5 * rmw / chip.hbm
        else:
            elim += max(fl / chip.gemm, rmw / k / chip.hbm)
            eager = 2.0 * N * (j * m) * m + 2.0 * m * (j * m) * N
            elim += eager / chip.gemm
            glue += (0.5 * rmw / k + 3 * 4 * m * N) / chip.hbm
        probe += c_probe * (Nr - t) * m**3
    return {"elim": elim, "probe": probe, "glue": glue,
            "total": elim + probe + glue}
