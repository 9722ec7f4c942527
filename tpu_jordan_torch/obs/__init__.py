"""Telemetry of the port, the part of the JAX package's ``obs/`` that the
tuner reaches:

  * ``metrics``: the process-wide registry of ``tpu_jordan_torch_*``
    counters, gauges and reservoir histograms (p50/p95/p99);
  * ``recorder``: the always-on bounded flight recorder.

Spans, exporters, the numerics and hardware-cost observatories, capacity
metering, journeys and SLOs come with ROADMAP.md Queue A item 12; the
communication and work inventories with item 15.
"""

from . import metrics, recorder
from .metrics import (NAME_RE, REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, Reservoir, counter, gauge, histogram,
                      percentiles)
from .recorder import RECORDER, FlightRecorder, record

__all__ = ["Counter", "FlightRecorder", "Gauge", "Histogram",
           "MetricsRegistry", "NAME_RE", "RECORDER", "REGISTRY",
           "Reservoir", "counter", "gauge", "histogram", "metrics",
           "percentiles", "record", "recorder"]
