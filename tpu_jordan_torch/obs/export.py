"""Telemetry exporters.  Counterpart of the JAX package's ``obs/export.py``:

  * **One-line JSON** (:func:`to_json_line`): the metrics snapshot and the
     span trees, with a caller's extras, as one ``json.dumps`` line.
  * **Prometheus text** (:func:`to_prometheus`, :func:`write_metrics`):
     ``# HELP``/``# TYPE`` and sample lines; histograms export in summary
     form (quantile lines, ``_sum`` and ``_count``).  The CLI's
     ``--metrics-out``.
  * **Chrome trace-event JSON** (:func:`to_chrome_trace`,
     :func:`write_chrome_trace`): one complete ("X") event per span, and
     one async lane per request from journey events
     (``obs/journey.async_trace_events``), for Perfetto
     (https://ui.perfetto.dev) or ``chrome://tracing``.  The CLI's
     ``--trace-json``.
  * **Profiler capture** (:func:`profiler_trace`): a ``torch.profiler``
     trace of a block (CPU activity, and the card's kernels when there is
     a card), written as Chrome trace JSON; the JAX package's
     ``jax.profiler`` tier.

``tools/check_telemetry.py`` validates the first two.
"""

from __future__ import annotations

import contextlib
import json
import os

from . import metrics as _metrics

_PROM_TYPE = {"counter": "counter", "gauge": "gauge",
              "histogram": "summary"}

_QUANTILES = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def to_prometheus(registry: "_metrics.MetricsRegistry | None" = None
                  ) -> str:
    """The registry in Prometheus text exposition format (one trailing
    newline; an empty registry exports the empty string).  Every family
    has a ``# HELP`` line beside its ``# TYPE``; a family registered
    without help text exports ``(no help registered)``."""
    reg = registry if registry is not None else _metrics.REGISTRY
    lines: list[str] = []
    for m in reg.collect():
        help_text = " ".join((m.help or "(no help registered)").split())
        lines.append(f"# HELP {m.name} {help_text}")
        lines.append(f"# TYPE {m.name} {_PROM_TYPE[m.kind]}")
        series = m.series() or {(): (0.0 if m.kind != "histogram"
                                     else _metrics.Reservoir())}
        for key, val in sorted(series.items()):
            labels = dict(key)
            if isinstance(val, _metrics.Reservoir):
                pct = val.percentiles()
                for pk, q in _QUANTILES.items():
                    if pct[pk] is not None:
                        qlab = dict(labels, quantile=q)
                        lines.append(f"{m.name}{_fmt_labels(qlab)} "
                                     f"{_fmt_value(pct[pk])}")
                lines.append(f"{m.name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(val.total)}")
                lines.append(f"{m.name}_count{_fmt_labels(labels)} "
                             f"{val.count}")
            else:
                lines.append(f"{m.name}{_fmt_labels(labels)} "
                             f"{_fmt_value(val)}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_chrome_trace(telemetry, journey_events=None) -> dict:
    """The span trees as a Chrome trace-event document: one complete ("X")
    event per finished span, microsecond timestamps on the telemetry's
    clock.  Modeled and measured phase children carry their attributes in
    ``args``.  ``journey_events`` (flight-recorder ``journey`` events) are
    appended as one async lane per ``request_id``.  ``telemetry`` may be
    None for a journeys-only trace."""
    events = []
    roots = telemetry.roots if telemetry is not None else []
    for root in roots:
        for sp in root.walk():
            events.append({
                "name": sp.name,
                "cat": "tpu_jordan_torch",
                "ph": "X",
                "ts": round(sp.t_start * 1e6, 3),
                "dur": round(sp.duration * 1e6, 3),
                "pid": 0,
                "tid": sp.thread,
                "args": {k: (v if isinstance(v, (str, int, float, bool,
                                                 type(None)))
                             else str(v))
                         for k, v in sp.attrs.items()},
            })
    if journey_events is not None:
        from .journey import async_trace_events

        events.extend(async_trace_events(journey_events))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def to_json_line(registry=None, telemetry=None, **extra) -> str:
    """One JSON line: the metrics snapshot and/or the span trees, with the
    caller's extras.  An extra may not reuse a payload key (``metric``,
    ``metrics``, ``spans``): that is a ``UsageError``, never a silent
    overwrite."""
    doc: dict = {"metric": "telemetry"}
    if registry is not None:
        doc["metrics"] = registry.snapshot()
    if telemetry is not None:
        doc["spans"] = [r.to_dict() for r in telemetry.roots]
    clash = sorted(set(extra) & set(doc))
    if clash:
        from ..errors import UsageError

        raise UsageError(
            f"to_json_line extra key(s) {clash} collide with the telemetry "
            f"payload keys {sorted(doc)}; rename the extras")
    doc.update(extra)
    return json.dumps(doc)


def write_metrics(path: str, registry=None) -> None:
    """Write the Prometheus text to ``path`` (``--metrics-out``), after
    re-sampling the device watermark (``hwcost.WATERMARK``), so the
    scraped gauges are current where the device reports memory."""
    from . import hwcost as _hwcost

    _hwcost.WATERMARK.sample()
    with open(path, "w") as f:
        f.write(to_prometheus(registry))


def write_chrome_trace(path: str, telemetry, journey_events=None) -> None:
    """Write the Chrome trace-event JSON to ``path`` (``--trace-json``),
    with one lane per request where ``journey_events`` is given."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(telemetry,
                                  journey_events=journey_events), f)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None = None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (``<tmp>/tpu_jordan_torch_trace`` by default) as ``trace.json``;
    yields the directory.  The device tier: real kernel times, the ground
    truth the modeled phase spans approximate."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "tpu_jordan_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
