"""``probe_roofline`` (layer: probe): the probe's least time a call, from
the cell's shapes (``work.probe_bound_s``: Σ over steps of the larger of
2k³·nc flops over the peak and 2·nc·k²·bytes over the bandwidth), over its
traced device time, in %."""

from gpubench import work


def read(run):
    p, peaks = run.profile, run.peaks
    if p is None or not p.calls or peaks is None:
        return None
    spent = p.seconds_by_kind()["probe"]
    if spent <= 0:
        return None
    c = run.cell
    bound, _ = work.probe_bound_s(c.n, c.block_size, c.batch, c.dtype_name,
                                  peaks["flops"][c.dtype_name],
                                  peaks["bytes_per_s"])
    return 100.0 * bound / (spent / p.calls)
