"""The tuner and its persistent plan cache: engine selection by legality,
the H100 cost model and measurement on the card.  Counterpart of the JAX
package's ``tuning/``:

  * ``registry``: every engine configuration the port runs (legality
    predicates, cost hooks); the driver's ``ENGINES`` derives from it;
  * ``cost_model``: the single-device terms of the cost model, with the
    H100's measured constants;
  * ``measure``: the robust measurement core (warm-up, median-of-k with
    IQR rejection, variance flag, transient retry);
  * ``tuner``: the cache → cost ranking → measured tuning ladder, with
    measured-against-projected drift;
  * ``plan_cache``: the versioned JSON plan store keyed by (backend and
    chip, topology, n bucket, dtype, memory mode).

Product surface: ``solve(engine="auto", tune=..., plan_cache=...)``,
``linalg.solve_system``/``lstsq``, ``JordanSolver``, and the CLI's
``--tune --plan-cache PATH``.
"""

from .measure import (Measurement, is_transient, measure_direct,
                      measure_slope, retry_transient, robust_stats)
from .plan_cache import CACHE_VERSION, Plan, PlanCache, n_bucket, plan_key
from .registry import (CONFIGS, ENGINES, PALLAS_ENGINES, REGISTRY,
                       SOLVE_ENGINES, WORKLOADS, EngineConfig,
                       TunePoint, candidates, select_by_cost)
from .tuner import Tuner, auto_select, measure_config

__all__ = [
    "Measurement", "is_transient", "measure_direct", "measure_slope",
    "retry_transient", "robust_stats",
    "CACHE_VERSION", "Plan", "PlanCache", "n_bucket", "plan_key",
    "CONFIGS", "ENGINES", "PALLAS_ENGINES", "REGISTRY", "EngineConfig",
    "SOLVE_ENGINES", "TunePoint", "WORKLOADS", "candidates",
    "select_by_cost",
    "Tuner", "auto_select", "measure_config",
]
