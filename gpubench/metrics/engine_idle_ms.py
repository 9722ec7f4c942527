"""``engine_idle_ms`` (layer: engine): device-idle ms a call in the gaps
between the traced stretch's merged device intervals whose middle lies
inside a ``tj::execute`` profiler range: the idle that the engine's own
host path causes (launch gaps, the read-back, the unscramble), as against
idle between calls.  None where the program opens no such range."""

import bisect

from gpubench import trace


def read(run):
    p = run.profile
    if p is None or not p.calls or not p.device:
        return None
    execs = trace.merged((a, b) for name, a, b in p.host
                         if name == "tj::execute")
    if not execs:
        return None
    starts = [a for a, _ in execs]
    busy = trace.merged((a, b) for _, a, b in p.device)
    idle_us = 0.0
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and execs[i][1] >= mid:
            idle_us += start - end
    return idle_us / 1e3 / p.calls
