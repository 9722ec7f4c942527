"""Timing scoreboard and profiler hooks: a thin layer over ``obs/``.
Counterpart of the JAX package's ``utils/profiling.py``, a compatibility
surface whose work is done by the telemetry layer:

  * ``Scoreboard``: the glob_time report (main.cpp:427-458) with GFLOP/s;
  * ``timed``: a block timed as an ``obs.spans`` span on ``telemetry`` (the
    discard-only sink by default), its GFLOP/s on the span and its
    duration on the scoreboard, so the two cannot disagree;
  * ``trace``: ``obs.export.profiler_trace``;
  * ``invert_flops``, ``workload_flops``: ``obs.hwcost``'s conventions.

New code uses ``tpu_jordan_torch.obs`` directly.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

from ..obs.export import profiler_trace as trace  # noqa: F401
from ..obs.spans import NULL


@dataclass
class Scoreboard:
    """Wall-clock + GFLOP/s record (the glob_time analog)."""

    label: str
    elapsed: float = 0.0
    flops: float | None = None

    @property
    def gflops(self) -> float | None:
        if self.flops is None or self.elapsed <= 0:
            return None
        return self.flops / self.elapsed / 1e9

    def report(self) -> str:
        s = f"glob_time: {self.elapsed:.2f}"
        if self.gflops is not None:
            s += f"  ({self.gflops:.1f} GFLOP/s)"
        return s


@contextlib.contextmanager
def timed(label: str, flops: float | None = None, sync=None,
          telemetry=None):
    """Time a block as span ``label`` of ``telemetry``.  ``sync`` (a tensor)
    names the device to synchronize before the clock stops, the
    single-process analog of the MAX all-reduce over the ranks' times
    (main.cpp:455).  Yields the :class:`Scoreboard`, filled on exit."""
    tel = telemetry if telemetry is not None else NULL
    sb = Scoreboard(label, flops=flops)
    with tel.span(label) as sp:
        yield sb
        if sync is not None and sync.device.type == "cuda":
            import torch

            torch.cuda.synchronize(sync.device)
    sb.elapsed = sp.duration
    if sb.gflops is not None:
        sp.attrs["gflops"] = round(sb.gflops, 3)


def invert_flops(n: int) -> float:
    """The 2n³ Gauss–Jordan inversion convention
    (``obs.hwcost.baseline_invert_flops``)."""
    from ..obs.hwcost import baseline_invert_flops

    return baseline_invert_flops(n)


def workload_flops(n: int, workload: str = "invert", k: int = 1,
                   rows: int | None = None) -> float:
    """The workload-aware count (``obs.hwcost.baseline_workload_flops``):
    n³(1 + k/n) for a solve with k right-hand sides, the Gram and
    projection products on top for lstsq."""
    from ..obs.hwcost import baseline_workload_flops

    return baseline_workload_flops(n, workload, k=k, rows=rows)
