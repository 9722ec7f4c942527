#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from; not part of a run.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 2]

In one process (the program's set-up paid once), for each seed: the pool
drawn from the seed, a short closed-loop window through the cell's own
entry at the cell's own sizes (at least as many calls as a run judges),
and the reference's judgement, as a benchmark run makes them.  Then the
same for the control: the plain reference put in the program's place, in
the configuration's next-lower arithmetic (``control_arith``).  Prints
one JSON line a seed: who ran, the residual ratio (and the worst), the singular
mismatches, the calls judged.
"""

from __future__ import annotations

import json
import os
import sys

import torch

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from gpubench import core, reference, spec  # noqa: E402


class Control:
    """The reference in the program's place: a call returns its inverse
    of the pool stack in ``arith`` and its singular flags."""

    def __init__(self, cell: spec.Cell, arith: str):
        self.block = cell.block_size
        self.arith = arith
        self.eps = float(cell.config["singular_eps"])

    def __call__(self, a):
        x, margin = reference.invert(a, self.block, self.arith, self.eps)
        return x.to(a.dtype), margin < 1.0


def readings(session: core.Session, seeds, seconds: float, who: str):
    """One reading a seed through ``session``'s entry."""
    cell = session.cell
    keep = int(cell.traffic["judge_sample"])
    out = []
    for seed in seeds:
        pool = session.pool(seed)
        w = session.window(pool, seconds, seed, min_calls=keep)
        del pool
        checks = core.judge(cell, seed, w, session.device)
        out.append({"cell": cell.name, "who": who, "seed": seed,
                    "residual_ratio": checks.residual_ratio,
                    "worst_ratio": checks.worst_ratio,
                    "residual": checks.residual,
                    "reference_residual": checks.reference_residual,
                    "singular_mismatches": checks.singular_mismatches,
                    "margins": checks.margins,
                    "judged": checks.judged, "calls": w.calls,
                    "correct": checks.correct})
        del w
    return out


def control_readings(cell: spec.Cell, seeds, seconds: float,
                     device="cuda"):
    """The control's readings on ``seeds``, at the cell's own sizes."""
    arith = cell.config["control_arith"]
    session = core.Session(cell, device, entry=Control(cell, arith))
    try:
        return readings(session, seeds, seconds, f"control:{arith}")
    finally:
        session.close()


def program_readings(cell: spec.Cell, seeds, seconds: float,
                     device="cuda"):
    """The program's readings on ``seeds``, through the cell's entry."""
    session = core.Session(cell, device)
    try:
        session.warm(session.pool(seeds[0]))
        return readings(session, seeds, seconds, "program")
    finally:
        session.close()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="",
                    help="comma-separated seeds of the program's readings")
    ap.add_argument("--control-seeds", default="",
                    help="comma-separated seeds of the control's readings")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    core.require_cards(1)
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    lines = []
    if seeds:
        lines += program_readings(cell, seeds, args.seconds)
        torch.cuda.empty_cache()
    if cseeds:
        lines += control_readings(cell, cseeds, args.seconds)
    for line in lines:
        print(json.dumps(line), flush=True)
    found = core.forbidden_modules()
    if found:
        print("forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
