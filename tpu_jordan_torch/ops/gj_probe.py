"""The pivot-candidate probe on the card: the dispatch of
``tpu_jordan/ops/pallas_block_inverse.py::pallas_batched_block_inverse``.

For a (nc, m, m) stack it returns each block's inverse and a singular flag,
from one of two hand-written CUDA bodies, as the JAX dispatch picks one of
its two Pallas bodies:

- every m with a panel width (``gj_fused_panel.takes_panel_body``: m = 16,
  48, 64, 128, 384, 512, ...) runs ``csrc/gj_probe_fused_panel.cu``, the
  port of ``_gj_fused_panel_kernel`` (``ops/gj_fused_panel.py`` says more);
- every other m (8, 50, ...) runs ``csrc/gj_probe.cu``, the port of
  ``_gj_probe_kernel``: one thread block per candidate runs the m
  normalized rank-1 steps, with the block's working copy in shared memory
  where it fits (in an L2-resident global scratch where it does not,
  m > ~232 in fp32); the source says more.

On a CPU tensor the wrapper runs the plain version
(``block_inverse.batched_block_inverse``); on a CUDA tensor it launches one
of the kernels or raises.  ``launches`` counts the launches of
``csrc/gj_probe.cu`` made here, ``gj_fused_panel.launches`` those of the
panel body, and nothing else counts in either.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import eps_for
from ..errors import KernelLaunchError
from .block_inverse import batched_block_inverse
from .gj_fused_panel import (check_cuda_stack, launch_fused_panel,
                             takes_panel_body)

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache
def _lib():
    from .._build import load

    lib = load("gj_probe")
    ptrs = [ctypes.c_void_p] * 4
    tail = [ctypes.c_int, ctypes.c_int]
    lib.gj_probe_f32.argtypes = ptrs + tail + [ctypes.c_float,
                                               ctypes.c_void_p]
    lib.gj_probe_f64.argtypes = ptrs + tail + [ctypes.c_double,
                                               ctypes.c_void_p]
    lib.gj_probe_f32.restype = ctypes.c_int
    lib.gj_probe_f64.restype = ctypes.c_int
    lib.gj_probe_w_in_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gj_probe_w_in_smem.restype = ctypes.c_int
    return lib


def probe_body(m: int) -> str:
    """The kernel ``gj_probe`` launches on the card for block size m."""
    return "gj_probe_fused_panel" if takes_panel_body(m) else "gj_probe"


def gj_probe(blocks: torch.Tensor, eps: float | None = None):
    """Invert an (nc, m, m) stack; returns (inverses, singular_flags).

    Sub-fp32 inputs are inverted in fp32 (the engines' policy).  ``eps``
    defaults to the compute dtype's threshold (``config.eps_for``)."""
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"expected an (nc, m, m) stack, got "
                         f"{tuple(blocks.shape)}")
    if blocks.dtype in (torch.float16, torch.bfloat16):
        blocks = blocks.float()
    if blocks.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {blocks.dtype}")
    if eps is None:
        eps = eps_for(blocks.dtype)
    if blocks.device.type == "cpu":
        return batched_block_inverse(blocks, None, eps)
    if takes_panel_body(blocks.shape[1]):
        return launch_fused_panel(blocks, eps)
    inv, sing = launch_kernel(blocks, eps)
    global launches
    launches += 1
    return inv, sing


def launch_kernel(blocks: torch.Tensor, eps: float):
    """Launch ``csrc/gj_probe.cu`` on a CUDA stack of fp32 or fp64 blocks
    and return (inverses, singular_flags); counts nothing."""
    check_cuda_stack(blocks)
    nc, m, _ = blocks.shape
    inv = torch.empty_like(blocks)
    sing = torch.empty(nc, dtype=torch.uint8, device=blocks.device)
    if nc == 0:
        return inv, sing.bool()
    lib = _lib()
    f64 = blocks.dtype == torch.float64
    with torch.cuda.device(blocks.device):
        scratch = (None if lib.gj_probe_w_in_smem(m, 8 if f64 else 4)
                   else torch.empty_like(blocks))
        fn = lib.gj_probe_f64 if f64 else lib.gj_probe_f32
        err = fn(blocks.data_ptr(), inv.data_ptr(), sing.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 nc, m, eps, torch.cuda.current_stream().cuda_stream)
    if err:
        raise KernelLaunchError(
            f"gj_probe launch failed with CUDA error {err} "
            f"(nc={nc}, m={m}, {blocks.dtype})")
    return inv, sing.bool()
