"""The solve workloads: ``solve_system`` (X = A⁻¹B by Gauss–Jordan on
[A | B], no inverse formed), ``lstsq`` (the normal equations through the
pivot-free SPD path) and their engines (``engine.py``).  Counterpart of the
JAX package's ``linalg/``, single device and real dtypes; its SMW updates
(``linalg/update.py``) come with ROADMAP.md Queue A item 10."""

from .api import (ASSUME, SOLVE_ENGINES, LstsqResult, SolveSystemResult,
                  auto_solve_engine, lstsq, resolve_solve_engine,
                  solve_system)
from .engine import (block_jordan_solve, block_jordan_solve_fori,
                     solve_batch_metrics)

__all__ = [
    "ASSUME", "LstsqResult", "SOLVE_ENGINES", "SolveSystemResult",
    "auto_solve_engine", "block_jordan_solve", "block_jordan_solve_fori",
    "lstsq", "resolve_solve_engine", "solve_batch_metrics", "solve_system",
]
