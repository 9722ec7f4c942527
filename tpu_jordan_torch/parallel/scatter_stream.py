"""The streamed file scatter of the 1D and 2D layouts: host memory O(n·m),
never O(n²).  Counterpart of the JAX package's
``parallel/scatter_stream.py`` (``stream_scatter_1d``,
``stream_scatter_2d``).

The reference's root rank reads one block-row buffer at a time and sends
it to its cyclic owner (read_matrix, main.cpp:242-276).  Here each rank
reads the file itself: rank k walks it in global block order through an
``io.MatrixStripReader``, skips the strips another rank owns (their tokens
are consumed, no buffer is built) and turns each of its own into the
identity-padded (m, W) strip, which goes to the rank's device at once.  No
strip is sent from a root, and no rank holds more than one strip of the
file on the host.  The shard is the one ``to_identity_padded_blocks`` (or,
with ``augmented``, the [A | I] scatter) makes of the whole matrix, bit for
bit.  On the 2D layout rank (kr, kc) walks the file the same way, skips the
strips of the other mesh rows (r % pr ≠ kr), and keeps of each of its own
only its pc-th share of the column blocks, in ``col_perm`` storage order:
its shard of ``jordan2d.scatter_matrix_2d``, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io import MatrixStripReader
from .layout import CyclicLayout, CyclicLayout2D


def _padded_strip(reader, r: int, lay: CyclicLayout, dtype,
                  augmented: bool, storage_dtype=None) -> np.ndarray:
    """Global block row ``r`` as a host (m, W) strip: the file's rows in the
    top left, identity on the padding diagonal, and with ``augmented`` the
    B half's identity block.  ``storage_dtype`` (a sub-fp32 torch dtype)
    rounds the file's values to it before the upcast to ``dtype``: the
    matrix being inverted is the rounded one, as on one device."""
    n, m, N = lay.n, lay.m, lay.N
    W = 2 * N if augmented else N
    out = np.zeros((m, W), dtype)
    g0 = r * m
    rows = max(0, min(m, n - g0))        # file rows in this block
    if rows:
        strip = reader.read_rows(rows)
        if storage_dtype is not None:
            work = torch.from_numpy(out).dtype
            strip = torch.from_numpy(strip).to(storage_dtype).to(work).numpy()
        out[:rows, :n] = strip
    # Identity padding rows: global row g >= n carries a 1 at column g.
    for i in range(rows, m):
        out[i, g0 + i] = 1
    if augmented:
        # The B half starts as I: row g carries a 1 at column N + g.
        for i in range(m):
            out[i, N + g0 + i] = 1
    return out


def _skip_strip(reader, r: int, lay: CyclicLayout) -> None:
    """Consume block row ``r``'s tokens without building its strip."""
    rows = max(0, min(lay.m, lay.n - r * lay.m))
    if rows:
        reader.read_rows(rows)


def stream_scatter_1d(path: str, lay: CyclicLayout, rank: int,
                      dtype=torch.float32, augmented: bool = False,
                      storage_dtype=None, device="cpu") -> torch.Tensor:
    """Rank ``rank``'s (bpw, m, W) shard of the identity-padded matrix in
    ``path`` (W = N, or 2N with ``augmented``), built strip by strip on
    ``device``.  The file is read up to the rank's last block row."""
    from ..interop import resolve_dtype

    dtype = resolve_dtype(dtype)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    if storage_dtype is not None:
        storage_dtype = resolve_dtype(storage_dtype)
    strips = []
    last = max(r for r in range(lay.Nr) if lay.owner(r) == rank)
    with MatrixStripReader(path, lay.n, np_dtype) as reader:
        # File order is global block order; rank k owns block r = s·p + k
        # at slot s, so appending in r-order fills its slots in order.
        for r in range(last + 1):
            if lay.owner(r) != rank:
                _skip_strip(reader, r, lay)
                continue
            strip = _padded_strip(reader, r, lay, np_dtype, augmented,
                                  storage_dtype)
            strips.append(torch.from_numpy(strip).to(device))
            del strip
    return torch.stack(strips)


def stream_scatter_2d(path: str, lay: CyclicLayout2D, kr: int, kc: int,
                      dtype=torch.float32, augmented: bool = False,
                      storage_dtype=None, device="cpu") -> torch.Tensor:
    """Rank (kr, kc)'s (bpr, m, W/pc) shard of the identity-padded matrix
    in ``path`` (W = N, or 2N with ``augmented``), built strip by strip on
    ``device``; the file is read up to the mesh row's last block row."""
    from ..interop import resolve_dtype

    dtype = resolve_dtype(dtype)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    if storage_dtype is not None:
        storage_dtype = resolve_dtype(storage_dtype)
    m, pc = lay.m, lay.pc
    ncb = 2 * lay.Nr if augmented else lay.Nr
    # This rank's column blocks, in storage order: u·pc + kc.
    own_cols = np.arange(ncb // pc) * pc + kc
    strips = []
    last = max(r for r in range(lay.Nr) if r % lay.pr == kr)
    with MatrixStripReader(path, lay.n, np_dtype) as reader:
        for r in range(last + 1):
            if r % lay.pr != kr:
                _skip_strip(reader, r, lay)
                continue
            strip = _padded_strip(reader, r, lay, np_dtype, augmented,
                                  storage_dtype)
            piece = np.ascontiguousarray(
                strip.reshape(m, ncb, m)[:, own_cols, :].reshape(m, -1))
            strips.append(torch.from_numpy(piece).to(device))
            del strip, piece
    return torch.stack(strips)


def stream_strip_rank(group, path: str, n: int, m: int,
                      dtype: str = "float64") -> dict:
    """One rank's streamed read of its 1D strip of the (n, n) matrix file
    ``path`` (:func:`stream_scatter_1d`, block size ``m``, on the CPU):
    the parser that read it, the seconds it took, the most rows held at
    once, and the sha256 of the strip's bytes (to hold it bit for bit
    against another parse without moving it)."""
    import hashlib
    import time

    from ..interop import resolve_dtype
    from ..io import parser_in_use, reset_strip_peak, strip_peak_rows

    lay = CyclicLayout.create(n, m, group.world_size)
    reset_strip_peak()
    t0 = time.perf_counter()
    strip = stream_scatter_1d(path, lay, group.rank, resolve_dtype(dtype))
    seconds = time.perf_counter() - t0
    return {"rank": group.rank, "parser": parser_in_use(),
            "seconds": seconds, "strip_rows_max": strip_peak_rows(),
            "sha256": hashlib.sha256(
                strip.contiguous().numpy().tobytes()).hexdigest()}
