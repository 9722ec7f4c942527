"""The pivot-candidate probe on the card: wrapper of ``csrc/gj_probe.cu``.

Replaces ``tpu_jordan/ops/pallas_block_inverse.py::
pallas_batched_block_inverse`` (its ``_gj_fused_panel_kernel`` and
``_gj_probe_kernel`` bodies) with one hand-written CUDA kernel for every m:
for a (nc, m, m) stack, each block's inverse and a singular flag.

The kernel is latency-bound: a block needs ≈ 2m³ flops, but its m
elimination steps run one after another inside one thread block, each closed
by barriers, and only nc ≤ Nr blocks exist, so few SMs work.  The design keeps
a block's working copy in shared memory where it fits (in an L2-resident
global scratch where it does not, m > ~232 in fp32) so that no step leaves
the SM; the source says more.

On a CPU tensor the wrapper runs the plain version
(``block_inverse.batched_block_inverse``); on a CUDA tensor it launches the
kernel or raises.  ``launches`` counts the kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import eps_for
from .block_inverse import batched_block_inverse

launches = 0


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused or failed a kernel launch."""


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
    inv, sing = launch_kernel(blocks, eps)
    global launches
    launches += 1
    return inv, sing


def check_cuda_stack(blocks: torch.Tensor) -> None:
    """Raise unless ``blocks`` is a contiguous stack on a CUDA device."""
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if not blocks.is_contiguous():
        raise ValueError("the probe kernels take a contiguous stack")


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
