"""Framework-wide numeric configuration.

The reference hard-codes ``EPS = 1e-15`` (main.cpp:7) as the *relative*
singularity threshold for fp64: a pivot is singular when
``|pivot| < EPS * norm(A)`` (main.cpp:782).  The threshold scales with the
working precision; fp64 keeps the reference value exactly.  The values
are the JAX package's (``tpu_jordan/config.py``), so both packages pick the
same pivots and block sizes.
"""

from __future__ import annotations

import torch

# Relative singularity thresholds per dtype: fp64 matches the reference
# (main.cpp:7); the others keep the same ~4.5x-machine-eps margin.  A
# complex dtype's pivot magnitudes are |z| (real), so its threshold is its
# component dtype's: complex64 carries fp32 rounding, complex128 fp64.
_EPS_BY_DTYPE = {
    torch.float64: 1e-15,
    torch.float32: 5e-7,
    torch.bfloat16: 4e-2,
    torch.float16: 4e-3,
    torch.complex64: 5e-7,
    torch.complex128: 1e-15,
}

# The JAX package's limit on unrolled engines (parallel/sharded_inplace.py:
# MAX_UNROLL_NR).  Its fused-update, lookahead and unrolled solve engines
# take at most this many block rows; the port's eager engines have no
# unroll, but keep the same limit so that both packages accept the same
# solves.
MAX_UNROLL_NR = 64

# Matches MAX_P in the reference (main.cpp:6): pretty-printers show at most
# this many rows/cols of a matrix corner.
MAX_PRINT = 10


def eps_for(dtype: torch.dtype) -> float:
    """Relative singularity threshold for ``dtype`` (the role of ``EPS``
    in the reference, main.cpp:7 and 782)."""
    try:
        return _EPS_BY_DTYPE[dtype]
    except KeyError:
        raise ValueError(
            f"no singularity threshold known for dtype {dtype}") from None


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of |z| for a ``dtype`` value: the component dtype of a
    complex dtype, the dtype itself otherwise.  Keys, thresholds, norms and
    κ∞ live in it."""
    return torch.empty((), dtype=dtype).real.dtype


def default_block_size(n: int) -> int:
    """The pivot block size ``m`` for an n x n problem when none is given.

    Same values as the JAX package: m=128 for 512 <= n < 8192, and m=384
    at n >= 8192, where smaller pivot blocks push the late Schur-complement
    pivots of ill-conditioned fixtures under the fp32 noise floor and the
    probe (correctly) flags them singular.  Small problems use small
    powers of two.
    """
    if n >= 8192:
        return 384
    if n >= 512:
        return 128
    if n >= 128:
        return 64
    return max(8, 1 << max(0, (n // 4).bit_length() - 1))
