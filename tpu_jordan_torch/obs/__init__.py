"""Observability of the port.  Counterpart of the JAX package's ``obs/``:

  * ``spans``: the span tree with an injectable clock (``solve`` roots
    with select/load/execute/residual children, the hot-loop phases under
    ``execute``), and ``timed_blocking``, the one timing bracket;
  * ``metrics``: the process-wide registry of ``tpu_jordan_torch_*``
    counters, gauges and reservoir histograms (p50/p95/p99);
  * ``export``: Prometheus text and Chrome trace-event JSON (Perfetto);
  * ``numerics``: per-superstep numerical health behind ``numerics=``
    (off/summary/trace), with ``numerics_spike`` events recorded before
    any recovery rung (``tools/check_numerics.py``);
  * ``hwcost``: the flop conventions, the executable-cost record
    (unavailable in eager PyTorch, never modeled) and the CUDA
    allocator's watermark;
  * ``capacity``: the ledger of resident bytes per class;
  * ``recorder``: the always-on bounded flight recorder;
  * ``journey``: per-request journeys of the serving stack, their outcome
    ledger and their Chrome-trace lanes;
  * ``slo``: declarative SLOs and the multi-window burn-rate monitor the
    fleet demo's ``--slo-report`` leg evaluates.

The communication and work inventories come with the distributed engines
(ROADMAP.md Queue A item 15).
"""

from . import (capacity, export, hwcost, journey, metrics, numerics,
               recorder, slo, spans)
from .export import (to_chrome_trace, to_json_line, to_prometheus,
                     write_chrome_trace, write_metrics)
from .hwcost import (ExecutableCost, attach_execute_cost, executable_cost,
                     runtime_env)
from .journey import JourneyLog, RequestContext, outcome_ledger
from .metrics import (NAME_RE, REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, Reservoir, counter, gauge, histogram,
                      percentiles)
from .numerics import (NumericsReport, SpikeThresholds, numerics_demo,
                       record_spikes)
from .recorder import RECORDER, FlightRecorder, record
from .slo import SLOMonitor, SLOSpec, bucket_specs
from .spans import (NULL, NullTelemetry, Span, Telemetry, attribute_phases,
                    attribute_phases_measured, timed_blocking)

__all__ = [
    "capacity", "export", "hwcost", "journey", "metrics", "numerics",
    "recorder", "slo", "spans",
    "to_chrome_trace", "to_json_line", "to_prometheus",
    "write_chrome_trace", "write_metrics",
    "ExecutableCost", "attach_execute_cost", "executable_cost",
    "runtime_env", "JourneyLog", "RequestContext", "outcome_ledger",
    "NumericsReport", "SpikeThresholds", "numerics_demo", "record_spikes",
    "NAME_RE", "REGISTRY", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "Reservoir", "counter", "gauge", "histogram",
    "percentiles",
    "RECORDER", "FlightRecorder", "record",
    "SLOMonitor", "SLOSpec", "bucket_specs",
    "NULL", "NullTelemetry", "Span", "Telemetry", "attribute_phases",
    "attribute_phases_measured", "timed_blocking",
]
