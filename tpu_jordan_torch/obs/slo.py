"""Declarative SLOs with multi-window burn-rate evaluation.  Counterpart of
the JAX package's ``obs/slo.py``, over the port's registry.

  * :class:`SLOSpec`: one objective per bucket (or fleet-wide), an
    **availability** target over the journey-derived
    ``tpu_jordan_torch_request_outcome_total`` series and an optional **p99
    latency** bound over ``tpu_jordan_torch_request_latency_seconds``
    (submit to terminal outcome: queue, execute and any reroute hops).
  * :class:`SLOMonitor`: samples timestamped registry snapshots (counter
    deltas, never lifetime totals) and evaluates **multi-window burn
    rates**: for an error budget ``1 - availability`` the burn rate of a
    window is ``error_rate / budget``.  An objective *pages* only when both
    windows of a pair burn above the pair's threshold: the long window
    proves the problem material, the short one that it is still happening.

Windows are configurable because a demo lives seconds, not weeks: the fleet
demo's ``--slo-report`` leg passes demo-scaled pairs, a deployment the
production ones (:data:`DEFAULT_WINDOWS`).  ``tools/check_slo.py`` judges a
written report.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

from . import metrics as _metrics

#: The two classic pairs of the SRE workbook, (long_window_s,
#: short_window_s, burn_threshold): page when both windows of a pair burn
#: above the threshold.
DEFAULT_WINDOWS = (
    (3600.0, 300.0, 14.4),     # 1h/5m at 14.4x: 2% of a 30d budget/hour
    (21600.0, 1800.0, 6.0),    # 6h/30m at 6x: 5% of a 30d budget/6h
)

OUTCOME_SERIES = "tpu_jordan_torch_request_outcome_total"
LATENCY_SERIES = "tpu_jordan_torch_request_latency_seconds"


@dataclass(frozen=True)
class SLOSpec:
    """One objective.  ``bucket`` None = fleet-wide (all buckets summed);
    availability in (0, 1); ``p99_latency_ms`` None = no latency
    objective."""

    name: str
    bucket: str | None = None
    availability: float = 0.999
    p99_latency_ms: float | None = None

    def __post_init__(self):
        if not (0.0 < self.availability < 1.0):
            raise ValueError("availability must be in (0, 1) — an SLO "
                             "of 1.0 has zero error budget and every "
                             "burn rate is infinite")

    @property
    def budget(self) -> float:
        return 1.0 - self.availability


def _outcome_counts(snapshot: dict, bucket: str | None) -> tuple[int, int]:
    """(ok, error) from a registry snapshot's request-outcome series,
    summed fleet-wide or filtered to one bucket."""
    ok = err = 0.0
    for entry in snapshot.get(OUTCOME_SERIES, {}).get("series", []):
        labels = entry.get("labels", {})
        if bucket is not None and labels.get("bucket") != bucket:
            continue
        if labels.get("outcome") == "ok":
            ok += entry.get("value", 0.0)
        elif labels.get("outcome") == "error":
            err += entry.get("value", 0.0)
    return int(ok), int(err)


def _latency_p99_ms(snapshot: dict, bucket: str | None) -> float | None:
    """The worst per-bucket p99 (ms) of the request-latency histogram
    (fleet-wide: the max across buckets)."""
    worst = None
    for entry in snapshot.get(LATENCY_SERIES, {}).get("series", []):
        labels = entry.get("labels", {})
        if bucket is not None and labels.get("bucket") != bucket:
            continue
        p99 = entry.get("p99")
        if p99 is not None:
            p99_ms = float(p99) * 1e3
            worst = p99_ms if worst is None else max(worst, p99_ms)
    return worst


class SLOMonitor:
    """Timestamped snapshot sampler and burn-rate evaluator.

    ``windows`` is a tuple of ``(long_s, short_s, threshold)`` pairs;
    ``clock`` an injectable monotonic callable.  ``sample()`` appends one
    (t, snapshot) observation; ``evaluate()`` computes, per spec and window
    pair, each window's burn rate (delta errors / delta total, over the
    budget) and the page decision."""

    def __init__(self, specs, registry=None, clock=None,
                 windows=DEFAULT_WINDOWS, max_samples: int = 512):
        self.specs = tuple(specs)
        if not self.specs:
            raise ValueError("at least one SLOSpec is required")
        self.registry = (registry if registry is not None
                         else _metrics.REGISTRY)
        self.clock = clock if clock is not None else time.monotonic
        self.windows = tuple((float(a), float(b), float(c))
                             for a, b, c in windows)
        for long_s, short_s, thr in self.windows:
            if not (long_s > short_s > 0) or thr <= 0:
                raise ValueError(
                    f"bad window ({long_s}, {short_s}, {thr}): need "
                    f"long > short > 0 and threshold > 0")
        self.max_samples = int(max_samples)
        self._samples: list[tuple[float, dict]] = []

    def sample(self) -> float:
        """Take one timestamped registry snapshot; returns its t."""
        t = self.clock()
        self._samples.append((t, self.registry.snapshot()))
        del self._samples[:-self.max_samples]
        return t

    def _window_burn(self, spec: SLOSpec, window_s: float) -> dict:
        """The burn rate over the trailing window: the delta between the
        newest sample and the newest one at or before the window's edge
        (the oldest sample when none is: a truncated window, said so).  A
        window with no traffic burns 0."""
        t_now, snap_now = self._samples[-1]
        t_edge = t_now - window_s
        older = [s for s in self._samples[:-1] if s[0] <= t_edge]
        truncated = not older
        t_then, snap_then = (older[-1] if older else self._samples[0])
        ok0, err0 = _outcome_counts(snap_then, spec.bucket)
        ok1, err1 = _outcome_counts(snap_now, spec.bucket)
        d_ok, d_err = max(0, ok1 - ok0), max(0, err1 - err0)
        total = d_ok + d_err
        error_rate = (d_err / total) if total else 0.0
        burn = error_rate / spec.budget
        return {
            "window_s": window_s,
            "span_s": round(t_now - t_then, 6),
            "truncated": truncated,
            "requests": total,
            "errors": d_err,
            "error_rate": round(error_rate, 6),
            "burn_rate": round(burn, 4),
        }

    def evaluate(self) -> dict:
        """The SLO report (the ``--slo-report`` document): per spec, every
        window pair's burn rates and page decision, the latest p99 against
        the objective, and the overall ``healthy`` verdict."""
        if len(self._samples) < 2:
            self.sample()
        if len(self._samples) < 2:
            raise RuntimeError("need >= 2 samples to evaluate: call "
                               "sample() before the window opens")
        results = []
        for spec in self.specs:
            pairs = []
            paging = False
            for long_s, short_s, thr in self.windows:
                long_b = self._window_burn(spec, long_s)
                short_b = self._window_burn(spec, short_s)
                page = (long_b["burn_rate"] > thr
                        and short_b["burn_rate"] > thr)
                paging = paging or page
                pairs.append({"threshold": thr, "long": long_b,
                              "short": short_b, "page": page})
            p99 = _latency_p99_ms(self._samples[-1][1], spec.bucket)
            p99_ok = (spec.p99_latency_ms is None or p99 is None
                      or (math.isfinite(p99)
                          and p99 <= spec.p99_latency_ms))
            results.append({
                "name": spec.name,
                "bucket": spec.bucket,
                "availability_target": spec.availability,
                "error_budget": round(spec.budget, 6),
                "windows": pairs,
                "p99_ms": None if p99 is None else round(p99, 3),
                "p99_target_ms": spec.p99_latency_ms,
                "p99_ok": p99_ok,
                "paging": paging,
                "healthy": (not paging) and p99_ok,
            })
        return {
            "metric": "slo_report",
            "samples": len(self._samples),
            "window_pairs": [list(w) for w in self.windows],
            "objectives": results,
            "healthy": all(r["healthy"] for r in results),
        }


def bucket_specs(buckets, availability: float = 0.9,
                 p99_latency_ms: float | None = None) -> list[SLOSpec]:
    """One spec per bucket plus the fleet-wide rollup: the fleet demo's
    objective set."""
    specs = [SLOSpec(name="fleet", bucket=None,
                     availability=availability,
                     p99_latency_ms=p99_latency_ms)]
    specs += [SLOSpec(name=f"bucket_{b}", bucket=str(b),
                      availability=availability,
                      p99_latency_ms=p99_latency_ms)
              for b in sorted(int(b) for b in buckets)]
    return specs
