"""``engine_ms`` (layer: engine): the median over the window of the
CUDA-event time around each solver call."""

import statistics


def read(run):
    ms = run.window.event_ms
    return statistics.median(ms) if ms else None
