"""The supervised serving replica pool.  Counterpart of the JAX package's
``fleet/`` (ROADMAP.md Queue A item 14d):

  * ``replica``: one worker wrapping its own
    :class:`~..serve.service.JordanService` (dispatcher, bounded queue,
    lane breakers, heartbeat) with kill/drain hooks and the seeded
    ``replica_kill`` fault point on its admission path;
  * ``router``: bucket-affinity dispatch with breaker-aware shedding;
    fleet-wide saturation is typed backpressure, never a silent drop, and
    a dead replica's queued work re-queues within the retry and deadline
    budget;
  * ``supervisor``: liveness and wedge detection, warm rolling restarts
    against the shared executor store, handle store and read-only plan
    cache (a replacement builds and measures nothing), and a per-slot
    restart breaker;
  * ``pool``: :class:`JordanFleet`, the ``JordanService`` surface
    fleet-wide (``submit``, ``invert(resident=)``, ``update``,
    ``solve_system``, ``warmup``, ``close``) with the request ledger,
    per-slot lineage and the cross-replica spread in ``stats()``;
  * ``demo``: ``fleet_demo``, the ``--fleet-demo`` run, judged by
    ``tools/check_fleet.py`` (and its ``slo`` block by
    ``tools/check_slo.py``);
  * ``autoscaler``: :class:`FleetAutoscaler`, the SLO-driven control loop
    over the pool's ``grow``/``drain_slot`` and the router's pre-shed
    flag, and ``autoscale_demo``, the ``--autoscale-demo`` run, judged by
    ``tools/check_autoscale.py``.
"""

from .autoscaler import FleetAutoscaler, autoscale_demo
from .demo import fleet_demo
from .pool import JordanFleet
from .replica import Replica, ReplicaKilledError
from .router import Router
from .supervisor import Supervisor

__all__ = [
    "FleetAutoscaler", "JordanFleet", "Replica", "ReplicaKilledError", "Router", "Supervisor",
    "autoscale_demo", "fleet_demo",
]
