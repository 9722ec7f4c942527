"""Devices, dtypes and the hand-over of state from numpy.

The system has no parameters: its state is the matrix.  ``from_numpy`` is
the one way the port takes an array it did not generate itself, so tests
give it the same numpy arrays they give the JAX package.

Entry points run on ``cuda`` unless the caller asks for the CPU; without a
card they raise :class:`DeviceUnavailableError` instead of quietly running
on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import DeviceUnavailableError

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  Raises DeviceUnavailableError when a
    CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; choose from "
                         f"{'/'.join(_DTYPES)}") from None


def from_numpy(arrays, device=None, dtype=None):
    """Move a numpy array (or a tensor), or a tuple/list of them, onto
    ``device`` (the card unless given) as tensors of ``dtype`` (the arrays'
    own unless given).  Returns a tensor, or a tuple of tensors."""
    dev = resolve_device(device)

    def one(x):
        t = (x if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(x)))
        return t.to(device=dev,
                    dtype=None if dtype is None else resolve_dtype(dtype))

    if isinstance(arrays, (tuple, list)):
        return tuple(one(x) for x in arrays)
    return one(arrays)


def split_cyclic_blocks(blocks, p: int) -> list:
    """The JAX package's (Nr, m, N) cyclic block tensor (worker-major
    storage, ``parallel/layout.py``), as a numpy array, split into the p
    ranks' (Nr/p, m, N) shards in rank order: rank k's blocks are rows
    ``[k·Nr/p, (k+1)·Nr/p)``."""
    blocks = np.asarray(blocks)
    if blocks.shape[0] % p:
        raise ValueError(f"{blocks.shape[0]} block rows do not split over "
                         f"{p} ranks")
    return list(np.split(blocks, p, axis=0))


def join_cyclic_blocks(shards) -> np.ndarray:
    """The inverse of :func:`split_cyclic_blocks`: the ranks' shards (numpy
    arrays or tensors, rank order) as one (Nr, m, N) numpy array in the JAX
    package's cyclic storage order."""
    return np.concatenate([s.detach().cpu().numpy()
                           if isinstance(s, torch.Tensor) else np.asarray(s)
                           for s in shards], axis=0)
