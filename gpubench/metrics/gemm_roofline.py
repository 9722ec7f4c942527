"""``gemm_roofline`` (layer: products): the products' least time a call,
from the cell's shapes (``work.gemm_bound_s``: the larger of 2n³·batch
flops over the peak and 2n²·batch·bytes over the bandwidth), over the
traced device time of the gemm, cutlass and xmma kernels, in %."""

from gpubench import work


def read(run):
    p, peaks = run.profile, run.peaks
    if p is None or not p.calls or peaks is None:
        return None
    spent = p.seconds_by_kind()["gemm"]
    if spent <= 0:
        return None
    c = run.cell
    bound, _ = work.gemm_bound_s(c.n, c.batch, c.dtype_name,
                                 peaks["flops"][c.dtype_name],
                                 peaks["bytes_per_s"])
    return 100.0 * bound / (spent / p.calls)
