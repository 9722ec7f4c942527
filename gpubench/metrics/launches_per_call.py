"""``launches_per_call`` (layer: engine): kernels in the traced stretch
over the calls traced."""


def read(run):
    p = run.profile
    if p is None or not p.calls or not p.kernels:
        return None
    return len(p.kernels) / p.calls
