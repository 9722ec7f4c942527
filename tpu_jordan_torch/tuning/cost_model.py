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

On p ranks of the 1D layout (the JAX comm model's pc = 1 terms) each rank
eliminates N/p rows and probes max(1, (Nr − t)//p) candidates a step, and
the collectives add, per step, three latency-only scalar reductions, the
(m, m) H and the two (m, N) row broadcasts (the grouped engines: one
stacked (2m, N + k·m + m) row buffer; the swap-free engine: the pivot row
alone, then one point-to-point row permutation and twice the probe), each
``S·(p − 1)/p`` bytes over the link rate plus a latency.

On a (pr, pc) mesh of the 2D layout (the JAX comm model's pc > 1 terms)
each rank eliminates (N/pr)×(N/pc), probes max(1, (Nr − t)//(pr·pc))
candidates a step, its rows travel (m, N/pc) on the column communicator
(pr ranks), and each step adds on the row communicator (pc ranks) the
(N/pr, m) chunk broadcast and, on the swap engines, the (m, m) swap fix-up
(plain engine only, as in the JAX model) and the two (N/pr, m) panels of
the JAX package's per-step unscramble; the swap-free engine's permutations
move one shard along each mesh axis.

The terms rank engines; they are not a wall-clock promise.  The tuner
records measured/projected drift on every trial, so a constant that goes
stale shows.  The link constants are the data sheet's NVLink rate and the
JAX model's per-collective latency: no multi-card run has measured them
(ROADMAP.md Queue B).  The CPU backend ranks with the same H100 model, as
the JAX package ranks the CPU with its one calibrated chip.
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
    link: float = 450e9      # per-direction bytes/s to a peer card
    latency: float = 2e-6    # seconds per collective


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
           (384, 1.2548e-3 / (22 * 384**3))),
    # NVLink 4 on the H100 SXM data sheet: 900 GB/s to the host's other
    # cards, 450 GB/s each way; the latency is the JAX comm model's
    # (benchmarks/comm_model.py LATENCY), not measured on a card.
    link=450e9,
    latency=2e-6)

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


def _allreduce(nbytes: float, p: int, chip: Chip) -> float:
    """A collective of ``nbytes`` over p ranks (0 on one rank)."""
    return 0.0 if p == 1 else nbytes * (p - 1) / p / chip.link + chip.latency


def _permute(nbytes: float, a: int, chip: Chip) -> float:
    """The swap-free engine's one permutation along an axis of ``a`` ranks
    (the JAX model's bucketed rotation rounds)."""
    return 0.0 if a == 1 else (a // 2) * (nbytes / chip.link + chip.latency)


def predict(n: int, m: int, chip: Chip, group: int = 1, p: int = 1,
            swapfree: bool = False, pc: int = 1) -> dict:
    """Projected seconds of one elimination of an n×n matrix with block
    size m on p ranks of the 1D layout (p = 1: one device), or on a
    (p, pc) mesh of the 2D layout:
    ``{"elim", "probe", "comm", "glue", "total"}``.  ``group=k > 1``
    models the delayed-group-update engines, ``swapfree`` the swap-free
    engine (no grouped variant).  Counterpart of the JAX package's
    ``benchmarks/comm_model.py::predict`` with this card's constants."""
    if swapfree and group > 1:
        raise ValueError("swapfree has no grouped variant")
    Nr = -(-n // m)
    N = Nr * m
    P = p * pc
    rows, cols = N / p, N / pc
    k = max(1, min(group, Nr))
    c_probe = probe_seconds_per_pass(chip, m)
    elim = probe = comm = glue = 0.0
    for t in range(Nr):
        j = t % k
        fl = 2.0 * rows * m * cols
        rmw = 2.0 * rows * cols * 4
        if k == 1:
            elim += max(fl / chip.gemm, rmw / chip.hbm)
            glue += 0.5 * rmw / chip.hbm
        else:
            elim += max(fl / chip.gemm, rmw / k / chip.hbm)
            eager = 2.0 * rows * (j * m) * m + 2.0 * m * (j * m) * cols
            elim += eager / chip.gemm
            glue += (0.5 * rmw / k + 3 * 4 * m * cols) / chip.hbm
        probe += c_probe * max(1, (Nr - t) // P) * m**3
        if P > 1:
            comm += 3 * chip.latency               # the pivot reduction
            comm += _allreduce(4 * m * m, P, chip)  # H
            if swapfree:
                comm += _allreduce(4 * m * cols, p, chip)
            elif k == 1:
                comm += 2 * _allreduce(4 * m * cols, p, chip)
            else:
                comm += _allreduce(4 * 2 * m * (cols + k * m + m), p, chip)
        if pc > 1:
            comm += _allreduce(4 * rows * m, pc, chip)     # the chunk
            if k == 1 and not swapfree:
                comm += _allreduce(4 * m * m, pc, chip)    # swap fix-up
            if not swapfree:
                comm += 2 * _allreduce(4 * rows * m, pc, chip)  # unscramble
    if swapfree and P > 1:
        # The permutations after the loop (rows along the column
        # communicator, column chunks along the row communicator), and
        # the full-window probe of the alive rows.
        shard = 4.0 * rows * cols
        comm += _permute(shard, p, chip) + _permute(shard, pc, chip)
        probe *= 2.0
    return {"elim": elim, "probe": probe, "comm": comm, "glue": glue,
            "total": elim + probe + comm + glue}
