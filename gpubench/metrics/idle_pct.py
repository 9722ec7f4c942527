"""``idle_pct`` (layer: device): the share of the traced stretch in which
no operation ran on the device, 1 − union of the device intervals over the
stretch's host-clock length, in %."""


def read(run):
    p = run.profile
    if p is None or not p.device or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
