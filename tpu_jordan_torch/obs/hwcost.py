"""Hardware cost: flop conventions, the executable-cost record, the
device-memory watermark and the runtime fingerprint.  Counterpart of the
JAX package's ``obs/hwcost.py``.

Honesty contract, the JAX package's own: every number here is read from
the runtime or counted by a published convention, and nothing is modeled
in the place of a measurement.  The JAX package reads XLA's
``cost_analysis``/``memory_analysis`` off each compiled executable; eager
PyTorch compiles no executable and has no such analysis, so
:func:`executable_cost` reports :data:`UNAVAILABLE` (``available=False``,
every field None) on every backend, never a hand count in its place.
:func:`attach_execute_cost` still puts the analytical rate beside the
measured wall (``achieved_tflops_analytical``: the 2n³ invert convention
or :func:`baseline_workload_flops`).

:func:`device_memory_stats` reads ``torch.cuda.memory_stats`` (the caching
allocator's live and peak bytes, as ``bytes_in_use`` and
``peak_bytes_in_use``) and is None on the CPU, so :data:`WATERMARK` there
stays ``available=False`` for good: absent, never zeroed.
:func:`observe_device_memory` samples it into the same gauges on demand
(the serving demo's report), :func:`observe_cost` mirrors an available
cost into the ``tpu_jordan_torch_executable_*`` gauges (a no-op on
:data:`UNAVAILABLE`, so on every lane of this port), and
:func:`runtime_env` names the torch and CUDA versions and the device a
report was taken on.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from . import metrics as _metrics

_M_FLOPS = _metrics.gauge(
    "tpu_jordan_torch_executable_flops",
    "compiler cost-analysis FLOPs of an executable, per serve lane (set "
    "only where a compiler reports it)")
_M_BYTES = _metrics.gauge(
    "tpu_jordan_torch_executable_bytes_accessed",
    "compiler cost-analysis bytes accessed of an executable, per serve lane")
_M_HBM = _metrics.gauge(
    "tpu_jordan_torch_executable_hbm_bytes",
    "compiler memory-analysis footprint (arguments + outputs + temps) of "
    "an executable, per serve lane")
_M_DEV_USED = _metrics.gauge(
    "tpu_jordan_torch_device_bytes_in_use",
    "live bytes of the CUDA caching allocator (absent on the CPU)")
_M_DEV_PEAK = _metrics.gauge(
    "tpu_jordan_torch_device_peak_bytes_in_use",
    "peak live bytes of the CUDA caching allocator (absent on the CPU)")


def baseline_invert_flops(n: int) -> float:
    """The 2n³ Gauss–Jordan convention of every invert GFLOP/s figure."""
    return 2.0 * float(n) ** 3


def gauss_jordan_flops(n: int) -> float:
    """The (8/3)n³ analytical count of the blocked in-place Gauss–Jordan
    inversion including the probe's block inverses and the normalize
    side-products (the JAX package's count of what its compiled executable
    does); the rates use the 2n³ convention of
    :func:`baseline_invert_flops`."""
    return (8.0 / 3.0) * float(n) ** 3


def baseline_workload_flops(n: int, workload: str = "invert",
                            k: int = 1, rows: int | None = None) -> float:
    """The workloads' flop conventions: ``invert`` 2n³; ``solve`` and
    ``solve_spd`` n³(1 + k/n) for k right-hand sides (the shrinking
    [A | B] live window); ``update`` 4n²k + 2nk² (the rank-k SMW update);
    ``lstsq`` 2·rows·n² + 2·rows·n·k for the Gram matrix and Aᴴb, plus the
    n-sized solve.  A complex flop counts as one."""
    n = float(n)
    k = float(max(1, k))
    if workload == "invert":
        return baseline_invert_flops(int(n))
    if workload in ("solve", "solve_spd"):
        return n ** 3 * (1.0 + k / n)
    if workload == "update":
        return 4.0 * n * n * k + 2.0 * n * k * k
    if workload == "lstsq":
        r = n if rows is None else float(rows)
        return (2.0 * r * n * n + 2.0 * r * n * k
                + n ** 3 * (1.0 + k / n))
    raise ValueError(f"unknown workload {workload!r}")


@dataclass(frozen=True)
class ExecutableCost:
    """A compiler's cost and memory analysis of one executable;
    ``available=False`` leaves every field None."""

    available: bool
    flops: float | None = None
    bytes_accessed: float | None = None
    argument_bytes: int | None = None
    output_bytes: int | None = None
    temp_bytes: int | None = None
    generated_code_bytes: int | None = None
    source: str = "xla_cost_analysis"

    @property
    def hbm_bytes(self) -> int | None:
        """Arguments + outputs + temps, where any is known."""
        parts = [self.argument_bytes, self.output_bytes, self.temp_bytes]
        if all(p is None for p in parts):
            return None
        return sum(int(p) for p in parts if p is not None)

    @property
    def arithmetic_intensity(self) -> float | None:
        """FLOPs per byte accessed."""
        if not self.flops or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed

    def to_json(self) -> dict:
        return {
            "available": self.available,
            "source": self.source,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "hbm_bytes": self.hbm_bytes,
            "arithmetic_intensity": (
                None if self.arithmetic_intensity is None
                else round(self.arithmetic_intensity, 2)),
        }


UNAVAILABLE = ExecutableCost(available=False, source="unavailable")


def executable_cost(compiled=None) -> ExecutableCost:
    """The compiler's cost of ``compiled``: :data:`UNAVAILABLE` on every
    backend, since eager PyTorch runs no compiled executable with an
    analysis to read (a missing number is reported missing)."""
    return UNAVAILABLE


def _sig(v: float) -> float:
    # 4 significant digits, never rounded to zero: a small solve's rate
    # is micro-TFLOP/s and must survive rounding.
    return float(f"{v:.4g}")


def attach_execute_cost(span, cost: ExecutableCost,
                        analytical_flops: float | None = None) -> None:
    """Rate attributes on an ``execute`` span: ``achieved_tflops_
    analytical`` (``analytical_flops`` over the span's duration) always
    where both are positive, and, only where ``cost`` is available, the
    compiler's ``xla_flops``/``xla_bytes``, ``achieved_tflops_xla``,
    ``arithmetic_intensity`` and ``xla_vs_analytical``."""
    el = span.duration
    if analytical_flops and el > 0:
        span.attrs["achieved_tflops_analytical"] = _sig(
            analytical_flops / el / 1e12)
    if not cost.available:
        return
    if cost.flops:
        span.attrs["xla_flops"] = cost.flops
        if el > 0:
            span.attrs["achieved_tflops_xla"] = _sig(cost.flops / el / 1e12)
        if analytical_flops:
            span.attrs["xla_vs_analytical"] = _sig(
                cost.flops / analytical_flops)
    if cost.bytes_accessed:
        span.attrs["xla_bytes"] = cost.bytes_accessed
    ai = cost.arithmetic_intensity
    if ai is not None:
        span.attrs["arithmetic_intensity"] = _sig(ai)


def observe_cost(cost: ExecutableCost, **labels) -> None:
    """Mirror an executable's cost into the ``tpu_jordan_torch_executable_*``
    gauges; an unavailable cost sets nothing (absent, never zero)."""
    if not cost.available:
        return
    if cost.flops is not None:
        _M_FLOPS.set(cost.flops, **labels)
    if cost.bytes_accessed is not None:
        _M_BYTES.set(cost.bytes_accessed, **labels)
    hbm = cost.hbm_bytes
    if hbm is not None:
        _M_HBM.set(hbm, **labels)


def device_memory_stats(device=None) -> dict | None:
    """The CUDA caching allocator's counters for ``device`` (the current
    card by default), with ``allocated_bytes.all.current``/``.peak``
    normalized to ``bytes_in_use``/``peak_bytes_in_use``; None on the CPU
    or without a card."""
    import torch

    try:
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        stats = torch.cuda.memory_stats(dev)
    except Exception:                            # noqa: BLE001
        return None
    if not stats:
        return None
    out = dict(stats)
    if "allocated_bytes.all.current" in stats:
        out["bytes_in_use"] = int(stats["allocated_bytes.all.current"])
    if "allocated_bytes.all.peak" in stats:
        out["peak_bytes_in_use"] = int(stats["allocated_bytes.all.peak"])
    return out


def _set_watermark(stats: dict, labels: dict) -> None:
    used = stats.get("bytes_in_use")
    peak = stats.get("peak_bytes_in_use")
    if used is not None:
        _M_DEV_USED.set(float(used), **labels)
    if peak is not None:
        _M_DEV_PEAK.set(float(peak), **labels)


def observe_device_memory(device=None, **labels) -> dict | None:
    """Sample ``device``'s allocator into the watermark gauges and return
    its stats; None (gauges untouched) on the CPU or without a card."""
    stats = device_memory_stats(device)
    if stats is not None:
        _set_watermark(stats, labels)
    return stats


def runtime_env() -> dict:
    """The fingerprint a report carries so its numbers can be read: the
    torch and CUDA versions, the device's name and count, the host's core
    count.  Context, never a gate; the CUDA fields are None without a
    card."""
    import os

    import torch

    env = {"host_cpu_count": os.cpu_count(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "device_kind": None,
           "device_count": 0}
    if torch.cuda.is_available():
        env["device_kind"] = torch.cuda.get_device_name(0)
        env["device_count"] = torch.cuda.device_count()
    return env


class DeviceMemoryWatermark:
    """The sticky live-bytes probe: the FIRST probe decides availability
    for good.  A process that reported no allocator stats then (the CPU)
    stays ``available=False``: every later :meth:`sample` is a no-op and
    the gauges are never set.  One that did is re-probed at every sample,
    and a transient empty read returns None without touching the gauges
    or the verdict.  ``sampler`` is injectable."""

    def __init__(self, sampler=None):
        self._sampler = (sampler if sampler is not None
                         else device_memory_stats)
        self._lock = threading.Lock()
        #: None = never probed; the first probe's verdict is final.
        self.available: bool | None = None

    def sample(self, **labels) -> dict | None:
        with self._lock:
            if self.available is False:
                return None
        stats = self._sampler()
        with self._lock:
            if self.available is None:
                self.available = stats is not None
        if stats is None:
            return None
        _set_watermark(stats, labels)
        return stats


#: The process-wide watermark: the capacity snapshot and the metrics
#: exporter sample through it.
WATERMARK = DeviceMemoryWatermark()

