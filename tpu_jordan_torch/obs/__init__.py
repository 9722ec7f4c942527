"""Observability of the port.  Counterpart of the JAX package's ``obs/``:

  * ``spans``: the span tree with an injectable clock (``solve`` and
    ``invert`` roots with select/load/execute/residual children, the
    engines' measured steps and hot-loop phases under ``execute``), on
    the profiler's timeline while one collects, and ``timed_blocking``,
    the one synchronising timing bracket;
  * ``metrics``: the process-wide registry of ``tpu_jordan_torch_*``
    counters, gauges and reservoir histograms (p50/p95/p99);
  * ``export``: Prometheus text and Chrome trace-event JSON (Perfetto);
  * ``numerics``: per-superstep numerical health behind ``numerics=``
    (off/summary/trace), with ``numerics_spike`` events recorded before
    any recovery rung (``tools/check_numerics.py``);
  * ``hwcost``: the flop conventions, the analytical rate of an execute
    span and the CUDA allocator's watermark;
  * ``capacity``: the ledger of resident bytes per class;
  * ``recorder``: the always-on bounded flight recorder;
  * ``journey``: per-request journeys of the serving stack, their outcome
    ledger and their Chrome-trace lanes;
  * ``slo``: declarative SLOs and the multi-window burn-rate monitor the
    fleet demo's ``--slo-report`` leg evaluates;
  * ``comm``: the communication observatory of the distributed paths (the
    collective inventory each rank issues, reconciled at the recording
    point per rank and for the world, and its drift against the H100 cost
    model; ``tools/check_comm.py``);
  * ``work``: the work observatory (per-worker FLOP shares, the counted
    GEMM pin, and the fleet skew judge; ``tools/check_work.py``).
"""

from . import (capacity, comm, export, hwcost, journey, metrics, numerics,
               recorder, slo, spans, work)
from .comm import (CommReport, DriftPolicy, ReconciliationError,
                   comm_demo, recording, set_drift_policy)
from .export import (to_chrome_trace, to_json_line, to_prometheus,
                     write_chrome_trace, write_metrics)
from .hwcost import attach_execute_cost, runtime_env
from .journey import JourneyLog, RequestContext, outcome_ledger
from .metrics import (NAME_RE, REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, Reservoir, counter, gauge, histogram,
                      percentiles)
from .numerics import (NumericsReport, SpikeThresholds, numerics_demo,
                       record_spikes)
from .recorder import RECORDER, FlightRecorder, record
from .slo import SLOMonitor, SLOSpec, bucket_specs
from .spans import NULL, NullTelemetry, Span, Telemetry, timed_blocking
from .work import (FleetSkewJudge, WorkReport, expected_latency_factor,
                   work_demo)

__all__ = [
    "capacity", "comm", "export", "hwcost", "journey", "metrics",
    "numerics", "recorder", "slo", "spans", "work",
    "CommReport", "DriftPolicy", "ReconciliationError", "comm_demo",
    "recording", "set_drift_policy",
    "FleetSkewJudge", "WorkReport", "expected_latency_factor", "work_demo",
    "to_chrome_trace", "to_json_line", "to_prometheus",
    "write_chrome_trace", "write_metrics",
    "attach_execute_cost", "runtime_env",
    "JourneyLog", "RequestContext", "outcome_ledger",
    "NumericsReport", "SpikeThresholds", "numerics_demo", "record_spikes",
    "NAME_RE", "REGISTRY", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "Reservoir", "counter", "gauge", "histogram",
    "percentiles",
    "RECORDER", "FlightRecorder", "record",
    "SLOMonitor", "SLOSpec", "bucket_specs",
    "NULL", "NullTelemetry", "Span", "Telemetry", "timed_blocking",
]
