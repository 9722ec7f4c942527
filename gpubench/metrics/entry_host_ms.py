"""``entry_host_ms`` (layer: entry): host time a call spends outside the
stream's span, the host wall less the CUDA-event time around the same
call, summed over the window and divided by its calls (a sum over the
whole window, so that the host clock's resolution does not weigh)."""


def read(run):
    w = run.window
    if not w.calls:
        return None
    return (sum(w.host_s) * 1e3 - sum(w.event_ms)) / w.calls
