"""``probe_ms`` (layer: probe): device time a call of the kernels named
``gj_probe*`` in the traced stretch."""


def read(run):
    p = run.profile
    if p is None or not p.calls:
        return None
    spent = p.seconds_by_kind()["probe"]
    return spent * 1e3 / p.calls if spent > 0 else None
