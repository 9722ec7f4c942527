"""LP/QP optimization drivers: the downstream workload the invert, verify
and update machinery serves.  Counterpart of the JAX package's ``lpqp/``
(ROADMAP.md Queue A item 14c): ``problem`` makes seeded,
certificate-carrying LP/QP instances; ``driver`` runs the optimization
loops through a :class:`~..fleet.pool.JordanFleet` as correlated invert,
update and solve traffic; ``demo`` is the ``--lp-demo`` run."""

from .driver import OptimizeError, OptimizeReport, solve_lp, solve_qp
from .problem import (LPInstance, QPInstance, kkt_converged, kkt_gate,
                      lp_instance, lp_kkt_residual, qp_instance,
                      qp_kkt_residual)

__all__ = [
    "LPInstance", "QPInstance", "lp_instance", "qp_instance",
    "lp_kkt_residual", "qp_kkt_residual", "kkt_gate", "kkt_converged",
    "solve_lp", "solve_qp", "OptimizeReport", "OptimizeError",
]
