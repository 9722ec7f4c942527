"""The solve workloads: ``solve_system`` (X = A⁻¹B by Gauss–Jordan on
[A | B], no inverse formed), ``lstsq`` (the normal equations through the
pivot-free SPD path), their engines (``engine.py``) and the
Sherman–Morrison–Woodbury updates of a resident inverse (``update.py``).
Counterpart of the JAX package's ``linalg/``, single device, real and
complex dtypes."""

from .api import (ASSUME, SOLVE_ENGINES, LstsqResult, SolveSystemResult,
                  auto_solve_engine, lstsq, resolve_solve_engine,
                  solve_system)
from .engine import (block_jordan_solve, block_jordan_solve_batched,
                     block_jordan_solve_fori,
                     solve_batch_metrics)
from .update import (DRIFT_BUDGET_FACTOR, UpdateResult, as_update_factors,
                     drift_budget, drift_exceeded, reinvert_fresh,
                     smw_update, smw_update_batched_with_metrics,
                     smw_update_with_metrics, solve_update, update_flops)

__all__ = [
    "ASSUME", "DRIFT_BUDGET_FACTOR", "LstsqResult", "SOLVE_ENGINES",
    "SolveSystemResult", "UpdateResult", "as_update_factors",
    "auto_solve_engine", "block_jordan_solve", "block_jordan_solve_batched",
    "block_jordan_solve_fori",
    "drift_budget", "drift_exceeded", "lstsq", "reinvert_fresh",
    "resolve_solve_engine", "smw_update", "smw_update_batched_with_metrics",
    "smw_update_with_metrics",
    "solve_batch_metrics", "solve_system", "solve_update", "update_flops",
]
