"""Matrix generators (the reference's ``f`` / ``f_i``, main.cpp:47-64).

Generators are functions of integer index grids; ``generate`` materializes
any rectangular window of the global grid on the requested device.  Every
generator gives the same bits as the JAX package's fixture of the same name,
in fp32 and fp64 (``crand`` in complex64 and complex128).
"""

from __future__ import annotations

from typing import Callable

import torch

GeneratorFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_U32 = 0xFFFFFFFF


def abs_diff(i, j):
    """Default generator ``f(i,j) = |i - j|`` (main.cpp:47-57).  Zero
    diagonal: inverting it requires pivoting."""
    return (i - j).abs()


def hilbert(i, j):
    """Hilbert matrix ``1 / (i + j + 1)`` (-DHILBERT, main.cpp:49-51).

    Divided in fp64 and rounded once to the requested dtype: that is the
    JAX package's arithmetic with x64 enabled, and (fp64 having more than
    2·24+2 significand bits) the correctly rounded fp32 quotient too."""
    return 1.0 / (i + j + 1).to(torch.float64)


def identity(i, j):
    """Identity generator ``f_i`` (main.cpp:59-64)."""
    return (i == j).to(torch.float32)


def rand_uniform(i, j):
    """Deterministic pseudo-random uniform in [-1, 1): a stateless uint32
    hash of (i, j) (lowbias32-style avalanche), a well-conditioned fixture
    for scale runs.

    The hash runs in int64 with a ``& 0xFFFFFFFF`` after each multiply,
    which is uint32 arithmetic exactly; the int64 -> float32 conversion
    rounds to nearest, as the uint32 -> float32 one does."""
    i = i.to(torch.int64) & _U32
    j = j.to(torch.int64) & _U32
    x = ((i * 73856093) & _U32) ^ ((j * 19349663) & _U32)
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (2.0 / 4294967296.0) - 1.0


def kms(i, j):
    """Kac–Murdock–Szegő matrix ``rho^|i-j|`` with rho = 0.25: symmetric
    positive definite and strongly diagonally dominant."""
    base = torch.tensor(0.25, dtype=torch.float32, device=i.device)
    return torch.pow(base, (i - j).abs().to(torch.float32))


def crand(i, j):
    """Deterministic complex uniform: ``rand_uniform`` for the real part,
    its hash at the indices shifted by (0x5BF0, 0x2C1B) for the imaginary
    part.  Complex dtypes only: :func:`generate` refuses to cast it to a
    real one."""
    im = rand_uniform(i + 0x5BF0, j + 0x2C1B)
    return torch.complex(rand_uniform(i, j), im)


GENERATORS: dict[str, GeneratorFn] = {
    "absdiff": abs_diff,
    "hilbert": hilbert,
    "identity": identity,
    "rand": rand_uniform,
    "kms": kms,
    "crand": crand,
}


def generate(
    fn: GeneratorFn | str,
    shape: tuple[int, int],
    dtype: torch.dtype = torch.float32,
    *,
    row_offset: int = 0,
    col_offset: int = 0,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Materialize ``fn`` over a window of the global index grid, on
    ``device``.  The index grids are int32, as in the JAX package."""
    if isinstance(fn, str):
        try:
            fn = GENERATORS[fn]
        except KeyError:
            raise ValueError(f"unknown generator {fn!r}; choose from "
                             f"{'/'.join(GENERATORS)}") from None
    h, w = shape
    ii = row_offset + torch.arange(h, dtype=torch.int32, device=device)
    jj = col_offset + torch.arange(w, dtype=torch.int32, device=device)
    ii, jj = torch.meshgrid(ii, jj, indexing="ij")
    vals = fn(ii, jj)
    if vals.is_complex() and not dtype.is_complex:
        # A complex generator cast to a real dtype would drop the imaginary
        # part: a caller bug, never a half-real fixture (the JAX rule).
        raise ValueError(
            f"complex-valued generator cast to real dtype "
            f"{str(dtype)[6:]} would discard the imaginary part; request "
            f"a complex dtype")
    return vals.to(dtype)


def generate_batch(
    fn: GeneratorFn | str,
    n: int,
    batch: int,
    dtype: torch.dtype = torch.float32,
    *,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """A (batch, n, n) stack whose element b is ``fn``'s window at offset
    b·n on both axes (the JAX package's ``solve_batch`` inputs).  Made one
    element at a time, so the index grids' temporaries stay n×n."""
    out = torch.empty((batch, n, n), dtype=dtype, device=device)
    for b in range(batch):
        out[b] = generate(fn, (n, n), dtype, row_offset=b * n,
                          col_offset=b * n, device=device)
    return out
