"""The pivot-candidate probe on the card: the dispatch of
``tpu_jordan/ops/pallas_block_inverse.py::pallas_batched_block_inverse``.

For a (nc, m, m) stack it returns each block's inverse and a singular flag,
from one of two hand-written CUDA bodies, as the JAX dispatch picks one of
its two Pallas bodies:

- every m with a panel width (``gj_fused_panel.takes_panel_body``: m = 16,
  48, 64, 128, 384, 512, ...) runs ``csrc/gj_probe_fused_panel.cu``, the
  port of ``_gj_fused_panel_kernel`` (``ops/gj_fused_panel.py`` says more);
- every other m (8, 12, 50, 100, 300, 1100, 1536, ...) runs
  ``csrc/gj_probe.cu``, the port of ``_gj_probe_kernel``: the m normalized
  rank-1 steps at two barriers a step, on one of three schedules that
  :func:`probe_schedule` picks by (m, dtype) and, for C, by the stack's
  size and the card's occupancy: ``block`` (m ≤ 128: one thread block a
  candidate, W in its registers), ``cluster`` (a cluster of C blocks a
  candidate, each holding ⌈m/C⌉ rows of W in its shared memory) or
  ``global`` (the same with each block's rows split: as many as its shared
  memory holds stay there, the rest in an L2-resident global scratch).
  The source says more.

With a global ``scale`` (the augmented engine's ‖A‖∞, the JAX package's
``batched_block_inverse(blocks, scale_norm, eps)``) every m runs
``csrc/gj_probe.cu``, whose C entries take the scale as a pointer to one
device value: the JAX engine's ``global_scale`` probe is that rank-1
algebra, never the panel body's.

A complex64 or complex128 stack runs ``csrc/gj_probe.cu``'s complex bodies
for every m, with or without a scale (the JAX package probes complex
blocks with its plain ``batched_block_inverse``, through XLA; the panel
body is real-only).  Keys, thresholds and the scale are real: the scale
goes to the kernel as one value of the component dtype.

On a CPU tensor the wrapper runs the plain version
(``block_inverse.batched_block_inverse``); on a CUDA tensor it launches one
of the kernels or raises.  ``launches`` counts the launches of
``csrc/gj_probe.cu``'s real bodies made here, ``complex_launches`` those of
its complex64 and complex128 bodies, ``gj_fused_panel.launches`` those of
the panel body, and nothing else counts in any.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import eps_for, real_dtype
from ..errors import KernelLaunchError
from .block_inverse import batched_block_inverse
from .gj_fused_panel import (check_cuda_stack, launch_fused_panel,
                             takes_panel_body)

launches = 0
complex_launches = {"c64": 0, "c128": 0}
# The complex bodies by dtype, as ``complex_launches`` and ``probe_body``
# name them.
COMPLEX_BODIES = {torch.complex64: "c64", torch.complex128: "c128"}


def reset_launches() -> None:
    global launches
    launches = 0
    for body in complex_launches:
        complex_launches[body] = 0


# Shared memory one block may take on an H100 (the opt-in limit, 227 KB).
SMEM_LIMIT = 232448
# Largest cluster the card schedules (16 with the non-portable opt-in).
MAX_CLUSTER = 16
# Codes of the kernel's schedule argument.
SCHEDULES = {"block": 0, "cluster": 1, "global": 2}
# The kernel's answer when a schedule does not fit the card.
REFUSED = 1000
# Largest block size whose W the registers of one block hold (the block
# schedule), for elements of up to 8 bytes; complex128's 16-byte elements
# stop at half of it (``reg_max_m``).
REG_MAX_M = 128


@functools.cache
def _lib():
    from .._build import load

    lib = load("gj_probe")
    ptrs = [ctypes.c_void_p] * 4
    tail = [ctypes.c_int, ctypes.c_int]
    sched = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gj_probe_f32.argtypes = ptrs + tail + [ctypes.c_float] + sched
    lib.gj_probe_f64.argtypes = ptrs + tail + [ctypes.c_double] + sched
    lib.gj_probe_c64.argtypes = ptrs + tail + [ctypes.c_float] + sched
    lib.gj_probe_c128.argtypes = ptrs + tail + [ctypes.c_double] + sched
    for fn in (lib.gj_probe_f32, lib.gj_probe_f64, lib.gj_probe_c64,
               lib.gj_probe_c128):
        fn.restype = ctypes.c_int
    lib.gj_probe_active_clusters.argtypes = [ctypes.c_int] * 5
    lib.gj_probe_active_clusters.restype = ctypes.c_int
    return lib


def reg_max_m(elem_bytes: int) -> int:
    """Largest m of the block schedule for elements of ``elem_bytes``:
    REG_MAX_M, and 64 for complex128 (16 bytes), whose 32 values a thread
    at m = 128 would take all 128 registers a thread of a 512-thread block
    has."""
    return REG_MAX_M if elem_bytes <= 8 else REG_MAX_M // 2


def probe_smem_bytes(m: int, elem_bytes: int, cluster: int = 1,
                     w_rows: int = 0, key_bytes: int | None = None) -> int:
    """Dynamic shared memory of one block of ``csrc/gj_probe.cu`` with
    ``w_rows`` rows of W in it: those rows, the pivot row and the slots,
    both double-buffered, the warps' slots, the rows' factors and flags,
    the permutation.  Values take ``elem_bytes``, keys and row sums
    ``key_bytes`` (the component's size; ``elem_bytes`` for a real dtype).
    Mirrors ``layout`` in the source."""
    e, k = elem_bytes, key_bytes or elem_bytes
    rows, slots = -(-m // cluster), 32 * cluster
    sizes = (w_rows * m * e, 2 * m * e, rows * e, 2 * slots * k,
             2 * slots * e, 2 * slots * 4, 32 * k, 32 * e, 32 * 4,
             slots * k, slots * 4, rows * 4, m * 4, m * 4)
    return sum(-(-s // 16) * 16 for s in sizes)


def smem_rows(m: int, elem_bytes: int, cluster: int,
              smem_limit: int = SMEM_LIMIT,
              key_bytes: int | None = None) -> int:
    """How many of a block's ⌈m/cluster⌉ rows of W its shared memory holds
    beside the rest (the global schedule keeps those there)."""
    rows = -(-m // cluster)
    base = probe_smem_bytes(m, elem_bytes, cluster, key_bytes=key_bytes)
    n = min(rows, max(0, smem_limit - base) // (m * elem_bytes))
    while n > 0 and probe_smem_bytes(m, elem_bytes, cluster, n,
                                     key_bytes) > smem_limit:
        n -= 1
    return n


def probe_schedule(m: int, elem_bytes: int, nc: int, active,
                   smem_limit: int = SMEM_LIMIT,
                   key_bytes: int | None = None) -> tuple[str, int]:
    """The schedule of ``csrc/gj_probe.cu`` for an (nc, m, m) stack of
    ``elem_bytes`` values (``key_bytes`` their component's size, for a
    complex dtype), where ``active(kind, C)`` is how many clusters of C
    blocks of that schedule the card holds at once:

    - ("block", 1) up to m = ``reg_max_m(elem_bytes)``: W in one block's
      registers;
    - ("cluster", C): W's rows in the shared memory of C blocks
      (2 ≤ C ≤ 16);
    - ("global", C): W's rows over C blocks (2 ≤ C ≤ 16), as many as their
      shared memory holds there and the rest in an L2-resident scratch.

    Where clusters of C blocks hold W, C is the most blocks that run all nc
    candidates in one wave.  Where none does, the global schedule with the
    most blocks that do and keep three quarters of their rows in shared
    memory; else the cluster schedule in the fewest waves, with the most
    blocks among those.  Where no cluster holds W, the global schedule over
    the most blocks.  Raises ValueError when no schedule fits
    ``smem_limit``."""
    def smem(c=1, w_rows=0):
        return probe_smem_bytes(m, elem_bytes, c, w_rows, key_bytes)

    if m <= reg_max_m(elem_bytes) and smem() <= smem_limit:
        return "block", 1
    cand = [c for c in range(2, MAX_CLUSTER + 1) if c <= m]
    fits = [c for c in cand if smem(c, -(-m // c)) <= smem_limit]
    spill = [c for c in cand if smem(c) <= smem_limit]
    waves = {c: -(-nc // n) if (n := active("cluster", c)) > 0 else nc + 1
             for c in fits}
    if fits and min(waves.values()) == 1:
        return "cluster", max(c for c in fits if waves[c] == 1)
    # A global schedule in one wave, if shared memory still holds at least
    # three quarters of each block's rows.
    one_wave = [c for c in spill if active("global", c) >= nc
                and 4 * smem_rows(m, elem_bytes, c, smem_limit, key_bytes)
                >= 3 * -(-m // c)]
    if one_wave:
        return "global", one_wave[-1]
    if fits:
        fewest = min(waves.values())
        return "cluster", max(c for c in fits if waves[c] == fewest)
    if spill:
        return "global", spill[-1]
    raise ValueError(f"no gj_probe schedule fits m={m} in {smem_limit} "
                     f"bytes of shared memory")


def value_sizes(dtype: torch.dtype) -> tuple[int, int]:
    """(element bytes, key bytes) of a probe dtype: a complex value's key
    is its real component."""
    elem = torch.empty((), dtype=dtype).element_size()
    return elem, elem // 2 if dtype.is_complex else elem


@functools.cache
def active_clusters(m: int, elem_bytes: int, kind: str, cluster: int,
                    key_bytes: int | None = None) -> int:
    """How many clusters of ``cluster`` blocks of the ``kind`` schedule at
    block size m the card holds at once (the CUDA occupancy answer for
    their shared memory)."""
    return _lib().gj_probe_active_clusters(
        m, elem_bytes, key_bytes or elem_bytes, SCHEDULES[kind], cluster)


@functools.cache
def _card_schedule(nc: int, m: int, elem_bytes: int,
                   key_bytes: int) -> tuple[str, int]:
    return probe_schedule(
        m, elem_bytes, nc,
        lambda kind, c: active_clusters(m, elem_bytes, kind, c, key_bytes),
        key_bytes=key_bytes)


def schedule_for(blocks: torch.Tensor) -> tuple[str, int]:
    """:func:`probe_schedule` for a CUDA stack, with its nc and the card's
    occupancy answers (worked out once per shape)."""
    nc, m, _ = blocks.shape
    return _card_schedule(nc, m, *value_sizes(blocks.dtype))


def probe_body(m: int, dtype: torch.dtype = torch.float32) -> str:
    """The kernel ``gj_probe`` launches on the card for block size m and
    a stack of ``dtype`` without a scale: ``gj_probe[c64]`` and
    ``gj_probe[c128]`` are the complex bodies of ``csrc/gj_probe.cu``."""
    if dtype in COMPLEX_BODIES:
        return f"gj_probe[{COMPLEX_BODIES[dtype]}]"
    return "gj_probe_fused_panel" if takes_panel_body(m) else "gj_probe"


def gj_probe(blocks: torch.Tensor, eps: float | None = None, scale=None):
    """Invert an (nc, m, m) stack; returns (inverses, singular_flags).

    Sub-fp32 inputs are inverted in fp32 (the engines' policy).  ``eps``
    defaults to the compute dtype's threshold (``config.eps_for``).
    ``scale`` (a number or a one-element tensor) replaces each block's
    ‖block‖∞ as the singularity scale of every block; on the card it then
    runs ``csrc/gj_probe.cu`` whatever m is, as a complex stack does."""
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"expected an (nc, m, m) stack, got "
                         f"{tuple(blocks.shape)}")
    if blocks.dtype in (torch.float16, torch.bfloat16):
        blocks = blocks.float()
    if blocks.dtype not in (torch.float32, torch.float64,
                            *COMPLEX_BODIES):
        raise TypeError(f"unsupported dtype {blocks.dtype}")
    if eps is None:
        eps = eps_for(blocks.dtype)
    if blocks.device.type == "cpu":
        return batched_block_inverse(blocks, scale, eps)
    complex_body = COMPLEX_BODIES.get(blocks.dtype)
    if scale is None and complex_body is None and takes_panel_body(
            blocks.shape[1]):
        return launch_fused_panel(blocks, eps)
    inv, sing = launch_kernel(blocks, eps, scale=scale)
    if complex_body is None:
        global launches
        launches += 1
    else:
        complex_launches[complex_body] += 1
    return inv, sing


def launch_kernel(blocks: torch.Tensor, eps: float,
                  schedule: tuple[str, int] | None = None, scale=None):
    """Launch ``csrc/gj_probe.cu`` on a CUDA stack of fp32, fp64,
    complex64 or complex128 blocks and return (inverses, singular_flags);
    counts nothing.  ``schedule`` forces a (name, cluster size) in place of
    :func:`probe_schedule`'s, for checks and measurements; the kernel
    refuses one that does not fit (:class:`KernelLaunchError`).  ``scale``
    (a number or a one-element tensor) is the singularity scale of every
    block; it goes to the kernel as a device value of the real (component)
    dtype, |scale| of a complex one, so a CUDA tensor is never read by the
    host."""
    check_cuda_stack(blocks)
    nc, m, _ = blocks.shape
    if scale is not None:
        scale = torch.as_tensor(scale).to(device=blocks.device)
        if scale.is_complex():
            scale = scale.abs()
        scale = scale.to(real_dtype(blocks.dtype)).reshape(1)
    inv = torch.empty_like(blocks)
    sing = torch.empty(nc, dtype=torch.uint8, device=blocks.device)
    if nc == 0:
        return inv, sing.bool()
    name, cluster = schedule or schedule_for(blocks)
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}")
    lib = _lib()
    with torch.cuda.device(blocks.device):
        scratch = torch.empty_like(blocks) if name == "global" else None
        fn = {torch.float32: lib.gj_probe_f32,
              torch.float64: lib.gj_probe_f64,
              torch.complex64: lib.gj_probe_c64,
              torch.complex128: lib.gj_probe_c128}[blocks.dtype]
        err = fn(blocks.data_ptr(), inv.data_ptr(), sing.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 nc, m, eps, None if scale is None else scale.data_ptr(),
                 SCHEDULES[name], cluster,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        what = ("the schedule does not fit this card" if err == REFUSED
                else f"CUDA error {err}")
        raise KernelLaunchError(
            f"gj_probe launch failed: {what} (nc={nc}, m={m}, "
            f"{blocks.dtype}, schedule={name}, cluster={cluster})")
    return inv, sing.bool()
