"""The sub-fp32 storage policy of the distributed invert entries.
Counterpart of the JAX package's ``parallel/upcast.py``.

bf16/fp16 elimination state diverges, so an invert entry computes in fp32
and rounds once at the end: the single-device engines' policy
(``ops/jordan_inplace._upcast_call``), applied to the per-rank entries.
"""

from __future__ import annotations

import functools

import torch


def upcast_sub_fp32(fn):
    """Wrap an ``(blocks, ...) -> (inv_blocks, singular, ...)`` entry:
    sub-fp32 blocks run in fp32 and the inverse is rounded back to the
    storage dtype."""

    @functools.wraps(fn)
    def wrapper(blocks, *args, **kwargs):
        if blocks.dtype.itemsize < 4:
            out = fn(blocks.float(), *args, **kwargs)
            return (out[0].to(blocks.dtype),) + tuple(out[1:])
        return fn(blocks, *args, **kwargs)

    return wrapper
