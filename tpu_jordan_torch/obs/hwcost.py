"""Hardware cost: flop conventions, the analytical rate of an execute
span, the device-memory watermark and the runtime fingerprint.
Counterpart of the JAX package's ``obs/hwcost.py``.

Honesty contract, the JAX package's own: every number here is read from
the runtime or counted by a published convention, and nothing is modeled
in the place of a measurement.  The JAX package reads XLA's
``cost_analysis``/``memory_analysis`` off each compiled executable; eager
PyTorch compiles no executable and has no such analysis, so the port
carries no executable cost at all.  :func:`attach_execute_cost` puts the
analytical rate beside the measured wall (``achieved_tflops_analytical``:
the 2n³ invert convention or :func:`baseline_workload_flops`).

:func:`device_memory_stats` reads ``torch.cuda.memory_stats`` (the caching
allocator's live and peak bytes, as ``bytes_in_use`` and
``peak_bytes_in_use``) and is None on the CPU, so :data:`WATERMARK` there
stays ``available=False`` for good: absent, never zeroed.
:func:`observe_device_memory` samples it into the same gauges on demand
(the serving demo's report), and :func:`runtime_env` names the torch and
CUDA versions and the device a report was taken on.
"""

from __future__ import annotations

import threading

from . import metrics as _metrics

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


def _sig(v: float) -> float:
    # 4 significant digits, never rounded to zero: a small solve's rate
    # is micro-TFLOP/s and must survive rounding.
    return float(f"{v:.4g}")


def attach_execute_cost(span, analytical_flops: float | None = None
                        ) -> None:
    """The analytical rate on an ``execute`` span: ``achieved_tflops_
    analytical``, ``analytical_flops`` over the span's duration, where
    both are positive."""
    el = span.duration
    if analytical_flops and el > 0:
        span.attrs["achieved_tflops_analytical"] = _sig(
            analytical_flops / el / 1e12)


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

