"""The measurement core of the tuner: warm-up, median-of-k with Tukey-fence
outlier rejection, a spread and a variance flag, and one retry on a
transient failure.  Counterpart of the JAX package's
``tuning/measure.py``.

  * **Warm-up**: the first call of a measured callable is never timed (it
    absorbs kernel builds and allocator growth).
  * **Median-of-k with IQR rejection**: ``robust_stats`` drops samples
    outside [q1 − 1.5·IQR, q3 + 1.5·IQR] and reports the median of the
    rest.  The fence rejects a lone wild sample only from k >= 5; below
    that the median is the damper, and the polluted spread trips the
    flag.  The tuner takes k = 5.
  * **Spread and variance flag**: (max − min)/median of the accepted
    samples rides every measurement; above ``VARIANCE_FLAG_PCT`` a
    ``variance_flag`` says the median is noisy.
  * **Transient retry**: one retry of the transient class only
    (``resilience.policy.is_transient``).  The ``measure`` fault point
    (``resilience/faults.py``) fires inside every timed call, so the
    retry path is testable.

``measure_direct`` times a whole call on the host clock; the caller's
callable ends in a synchronize on the card, so each sample is the time the
caller waits for, launch-bound host time included.  ``measure_slope``
times one operation by the slope of ``utils/benchmarking.slope_time``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..resilience import faults as _faults
from ..resilience.policy import (RetryPolicy, is_transient,  # noqa: F401
                                 retry_transient)

VARIANCE_FLAG_PCT = 10.0     # accepted-sample spread above this is noisy

# One retry, no backoff, strict transient classification.
MEASURE_RETRY = RetryPolicy(max_retries=1, backoff_s=0.0,
                            classify=is_transient)


@dataclass(frozen=True)
class Measurement:
    """One robust timing: ``seconds`` is the median of the accepted
    samples; the raw, accepted and rejected samples and the spread ride
    along."""

    seconds: float
    samples: tuple[float, ...]
    accepted: tuple[float, ...]
    rejected: tuple[float, ...] = ()
    spread_pct: float = 0.0
    variance_flag: str | None = field(default=None)


def robust_stats(samples, flag_pct: float = VARIANCE_FLAG_PCT
                 ) -> Measurement:
    """Median-of-k with Tukey-fence (1.5×IQR) rejection over raw timing
    ``samples`` (seconds).  The fence is computed on the raw set (k >= 3);
    the median, spread and flag on the survivors.  A fence that would
    reject everything keeps the raw set."""
    raw = tuple(float(s) for s in samples)
    if not raw:
        raise ValueError("no samples")
    accepted, rejected = raw, ()
    if len(raw) >= 3:
        q1, q3 = np.percentile(raw, [25.0, 75.0])
        iqr = q3 - q1
        lo, hi = q1 - 1.5 * iqr, q3 + 1.5 * iqr
        accepted = tuple(s for s in raw if lo <= s <= hi)
        rejected = tuple(s for s in raw if not (lo <= s <= hi))
        if not accepted:
            accepted, rejected = raw, ()
    med = float(np.median(accepted))
    # abs(): a slope of a noise-floor operation may come out negative; the
    # spread stays a magnitude.
    spread = (0.0 if med == 0.0
              else 100.0 * (max(accepted) - min(accepted)) / abs(med))
    flag = None
    if spread > flag_pct:
        flag = (f"session spread {spread:.1f}% > {flag_pct:.0f}% — treat "
                f"the median as noisy")
    return Measurement(seconds=med, samples=raw, accepted=accepted,
                       rejected=rejected, spread_pct=round(spread, 1),
                       variance_flag=flag)


def measure_direct(fn, samples: int = 5, warmup: int = 1) -> Measurement:
    """Time ``fn()``, which returns only when its work is done (on the
    card: after a synchronize), ``samples`` times after ``warmup`` untimed
    calls.  Each call crosses the ``measure`` fault point and gets one
    retry on a transient failure."""
    def call():
        _faults.fire("measure")
        return fn()

    for _ in range(warmup):
        MEASURE_RETRY.call(call)
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        MEASURE_RETRY.call(call)
        ts.append(time.perf_counter() - t0)
    return robust_stats(ts)


def measure_slope(fn, args, r1: int, r2: int, samples: int = 3,
                  **slope_kw) -> Measurement:
    """``samples`` slope timings of ``fn(*args)``
    (``utils/benchmarking.slope_time``: fixed costs cancel between the two
    trip counts) through ``robust_stats``."""
    from ..utils.benchmarking import slope_time

    slopes = retry_transient(
        lambda: slope_time(fn, args, r1=r1, r2=r2, samples=samples,
                           **slope_kw))
    if samples == 1:
        slopes = [slopes]
    return robust_stats(slopes)
