"""Entry ``solver_invert``: ``tpu_jordan_torch.models.JordanSolver.invert``,
one matrix a call.

The solver is built once, at set-up, as a user builds it: n, the block
size m of the traffic, the storage dtype and the engine of the
configuration ("auto": the tuner's cost ranking, no measurement and no
plan-cache file).  A call takes a (1, n, n) pool stack and returns the
(n, n) inverse and the 0-d singular flag, both on the device.
"""

from __future__ import annotations

import sys


class SolverInvert:
    def __init__(self, solver):
        self.solver = solver

    def __call__(self, a):
        return self.solver.invert(a[0])

    def close(self) -> None:
        self.solver.close()


def make(cell, device):
    from tpu_jordan_torch.models import JordanSolver

    solver = JordanSolver(n=cell.n, block_size=cell.block_size,
                          dtype=cell.dtype_name,
                          engine=cell.config["engine"],
                          device=device.type)
    print(f"entry: JordanSolver.invert n={cell.n} m={solver.block_size} "
          f"dtype={cell.dtype_name} engine={solver.engine} "
          f"group={solver.group}", file=sys.stderr)
    return SolverInvert(solver)
