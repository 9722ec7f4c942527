"""Entry ``solver_invert_batch``:
``tpu_jordan_torch.models.JordanSolver.invert_batch``, a (batch, n, n)
stack a call, through the batched engine.

The solver is built once, at set-up, with n, the block size m of the
traffic and the storage dtype of the configuration.  A call takes a pool
stack and returns the (batch, n, n) inverses and the (batch,) singular
flags, on the device.
"""

from __future__ import annotations

import sys


class SolverInvertBatch:
    def __init__(self, solver):
        self.solver = solver

    def __call__(self, a):
        return self.solver.invert_batch(a)

    def close(self) -> None:
        self.solver.close()


def make(cell, device):
    from tpu_jordan_torch.models import JordanSolver

    solver = JordanSolver(n=cell.n, block_size=cell.block_size,
                          dtype=cell.dtype_name,
                          engine=cell.config["engine"],
                          device=device.type)
    print(f"entry: JordanSolver.invert_batch batch={cell.batch} n={cell.n} "
          f"m={solver.block_size} dtype={cell.dtype_name} (batched engine)",
          file=sys.stderr)
    return SolverInvertBatch(solver)
