"""The process-wide metrics registry: counters, gauges and histograms over
bounded recent-sample reservoirs (p50/p95/p99), readable as one plain-JSON
``snapshot``.  Counterpart of the JAX package's ``obs/metrics.py``.

Naming contract: every metric name matches ``NAME_RE``
(``^tpu_jordan_torch_[a-z0-9_]+$``), the port's own namespace beside the
JAX package's ``tpu_jordan_*``; registration raises on a violation.
Counters end in ``_total``, timings in ``_seconds``.

Labels are keyword arguments at mutation time (``inc(1, bucket="512")``);
each distinct label set is one series.  ``counter(...)`` is idempotent per
name, so a call site may fetch at use; a kind conflict (a counter and a
gauge under one name) raises.  ``Counter.inc(..., exemplar=request_id)``
keeps the last request id per series (``exemplar``, ``exemplars``, and the
``exemplar`` key of ``snapshot``), so a counter that moved leads to one
journey in the flight recorder.  ``obs/export.py`` writes the registry as
Prometheus text.
"""

from __future__ import annotations

import re
import threading

NAME_RE = re.compile(r"^tpu_jordan_torch_[a-z0-9_]+$")

#: Most recent samples kept per histogram series; older ones drop first.
MAX_RESERVOIR_SAMPLES = 4096

_PCTS = (50.0, 95.0, 99.0)


def percentiles(samples) -> dict:
    """p50/p95/p99 by the nearest-rank method on a sorted copy; None for
    each when there is no sample."""
    if not samples:
        return {"p50": None, "p95": None, "p99": None}
    s = sorted(samples)
    out = {}
    for p in _PCTS:
        rank = max(0, min(len(s) - 1, int(round(p / 100.0 * len(s))) - 1))
        out[f"p{p:.0f}"] = s[rank]
    return out


class Reservoir:
    """The bounded recent-sample window behind a histogram series, with
    lifetime ``count`` and ``total``.  Not thread-safe alone: the owning
    metric holds the lock."""

    def __init__(self, maxlen: int = MAX_RESERVOIR_SAMPLES):
        self.maxlen = int(maxlen)
        self._samples: list[float] = []
        self.count = 0
        self.total = 0.0

    def add(self, value: float) -> None:
        self._samples.append(float(value))
        del self._samples[:-self.maxlen]
        self.count += 1
        self.total += float(value)

    def extend(self, values) -> None:
        for v in values:
            self.add(v)

    @property
    def samples(self) -> list[float]:
        return list(self._samples)

    def percentiles(self) -> dict:
        return percentiles(self._samples)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """One named metric with one series per label set; every mutation
    under the metric's lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the namespace contract "
                f"{NAME_RE.pattern}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}
        #: the last exemplar (a request id) per series.
        self._exemplars: dict[tuple, str] = {}

    def series(self) -> dict:
        """{label_key_tuple: value or reservoir}, a copy."""
        with self._lock:
            return dict(self._series)

    def exemplar(self, **labels) -> str | None:
        """The most recent exemplar of the series, or None."""
        with self._lock:
            return self._exemplars.get(_label_key(labels))

    def exemplars(self) -> dict:
        with self._lock:
            return dict(self._exemplars)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, *, exemplar: str | None = None,
            **labels) -> None:
        """``exemplar`` (keyword-only, never a label) records the request
        id of the mutation as the series' latest exemplar."""
        if value < 0:
            raise ValueError("counters only go up; use a gauge")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(value)
            if exemplar is not None:
                self._exemplars[key] = str(exemplar)

    def total(self) -> float:
        """The sum over every label series."""
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)


class Histogram(Metric):
    """Per-series reservoirs: nearest-rank p50/p95/p99 of the recent
    samples, lifetime count and sum."""

    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            res = self._series.get(key)
            if res is None:
                res = self._series[key] = Reservoir()
            res.add(value)

    def value(self, **labels) -> float:
        """The lifetime sum of the series' observations."""
        with self._lock:
            res = self._series.get(_label_key(labels))
        return 0.0 if res is None else res.total

    def percentiles(self, **labels) -> dict:
        with self._lock:
            res = self._series.get(_label_key(labels))
        return res.percentiles() if res is not None else percentiles(())


class MetricsRegistry:
    """A named metric store; ``counter``/``gauge``/``histogram`` return the
    registered object of that name, creating it on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def collect(self) -> list[Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """{name: {type, help, series: [{labels, value} or {labels,
        count, sum, p50, p95, p99}, with ``exemplar`` where one was
        recorded]}}, plain JSON."""
        out = {}
        for m in self.collect():
            series = []
            exemplars = m.exemplars()
            for key, val in m.series().items():
                entry: dict = {"labels": dict(key)}
                if isinstance(val, Reservoir):
                    entry["count"] = val.count
                    entry["sum"] = val.total
                    entry.update(val.percentiles())
                else:
                    entry["value"] = val
                if key in exemplars:
                    entry["exemplar"] = exemplars[key]
                series.append(entry)
            out[m.name] = {"type": m.kind, "help": m.help,
                           "series": series}
        return out

    def reset(self) -> None:
        """Drop every registered metric (tests only: a process's counters
        are monotone for its whole life)."""
        with self._lock:
            self._metrics.clear()


#: The process-wide registry the port's modules register into.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "") -> Histogram:
    return REGISTRY.histogram(name, help)
