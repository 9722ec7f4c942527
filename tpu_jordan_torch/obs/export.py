"""Telemetry exporters.  Counterpart of the JAX package's ``obs/export.py``
(its tiers 2 and 3; the one-line JSON of the serve report comes with the
serving stack, ROADMAP Queue A item 14, and the kernel-level profiler
capture with the first caller that reads it):

  * **Prometheus text** (:func:`to_prometheus`, :func:`write_metrics`):
     ``# HELP``/``# TYPE`` and sample lines; histograms export in summary
     form (quantile lines, ``_sum`` and ``_count``).  The CLI's
     ``--metrics-out``.
  * **Chrome trace-event JSON** (:func:`to_chrome_trace`,
     :func:`write_chrome_trace`): one complete ("X") event per span, for
     Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.  The
     CLI's ``--trace-json``.

``tools/check_telemetry.py`` validates both.
"""

from __future__ import annotations

import json

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
    ``args``.  ``journey_events`` (per-request lanes) come with the
    serving stack (ROADMAP.md Queue A item 14): until then only an empty
    list is taken, and a non-empty one is refused rather than dropped.
    ``telemetry`` may be None."""
    if journey_events:
        from ..errors import UsageError

        raise UsageError("journey lanes come with the serving stack "
                         "(ROADMAP.md Queue A item 14)")
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
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_metrics(path: str, registry=None) -> None:
    """Write the Prometheus text to ``path`` (``--metrics-out``), after
    re-sampling the device watermark (``hwcost.WATERMARK``), so the
    scraped gauges are current where the device reports memory."""
    from . import hwcost as _hwcost

    _hwcost.WATERMARK.sample()
    with open(path, "w") as f:
        f.write(to_prometheus(registry))


def write_chrome_trace(path: str, telemetry, journey_events=None) -> None:
    """Write the Chrome trace-event JSON to ``path`` (``--trace-json``)."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(telemetry,
                                  journey_events=journey_events), f)
