"""``call_p95_ms`` (end to end, device clock): the 95th percentile of the
latency of every call in the window, each timed by CUDA events recorded on
the stream around it (from the call's first launch to its last result;
the host's clock is too coarse for calls of tens of milliseconds)."""

import statistics


def read(run):
    ms = run.window.event_ms
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
