"""Work counts from the cell's shapes, and the device's peaks.

Counts follow the repository's conventions: an inversion is 2n³ useful
flops (the ``hwcost`` convention), a stack of B is B times that.  The
bounds are the least time the device could take, the larger of flops over
the peak rate and bytes over the peak bandwidth, whichever kernel does the
work.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"

BYTES = {"float64": 8, "float32": 4}


def invert_flops(n: int, batch: int = 1) -> float:
    """Useful flops of inverting ``batch`` n×n matrices: 2n³ each."""
    return 2.0 * float(n) ** 3 * batch


def num_blocks(n: int, m: int) -> int:
    """Block rows Nr = ⌈n/m⌉ (the last one ragged where m ∤ n)."""
    m = min(m, n)
    return -(-n // m)


def probe_terms(n: int, m: int, batch: int, dtype: str):
    """Per step t of the elimination, the probe's (flops, bytes): the
    candidate blocks (× batch), each inverted at 2k³ flops for its k×k,
    each read once and its inverse written once.  Where m divides n the
    candidates of step t are the Nr − t blocks m×m.  Where the last block
    row is ragged (height l = n − (Nr − 1)·m), it holds no m×m candidate:
    steps t < Nr − 1 have Nr − 1 − t, and the last step one l×l block (the
    paper's program, main.cpp:133-137; identity padding adds no useful
    work)."""
    m = min(m, n)
    nr = num_blocks(n, m)
    last = n - (nr - 1) * m
    b = BYTES[dtype]
    for t in range(nr):
        if last == m:
            nc, k = nr - t, m
        elif t < nr - 1:
            nc, k = nr - 1 - t, m
        else:
            nc, k = 1, last
        nc *= batch
        yield 2.0 * k ** 3 * nc, 2.0 * nc * k * k * b


def probe_bound_s(n: int, m: int, batch: int, dtype: str, peak_flops: float,
                  peak_bytes: float) -> tuple[float, str]:
    """The probe's least time over a whole inversion, and which term bounds
    it most ("flops" or "bytes", by the larger share of the sum)."""
    total, by_flops, by_bytes = 0.0, 0.0, 0.0
    for flops, nbytes in probe_terms(n, m, batch, dtype):
        f, b = flops / peak_flops, nbytes / peak_bytes
        total += max(f, b)
        if f >= b:
            by_flops += f
        else:
            by_bytes += b
    return total, ("flops" if by_flops >= by_bytes else "bytes")


def gemm_bound_s(n: int, batch: int, dtype: str, peak_flops: float,
                 peak_bytes: float) -> tuple[float, str]:
    """The products' least time over a whole inversion: 2n³·batch flops,
    or 2n²·batch elements moved (A read once, X written once)."""
    f = invert_flops(n, batch) / peak_flops
    b = 2.0 * float(n) ** 2 * batch * BYTES[dtype] / peak_bytes
    return max(f, b), ("flops" if f >= b else "bytes")


def peaks(device_name: str, path: Path = PEAKS) -> dict | None:
    """The data sheet's peaks of ``device_name``, or None for a device the
    table does not list (then no roofline share is reported)."""
    table = json.loads(Path(path).read_text())["devices"]
    return table.get(device_name)
