"""The dispatch probe's panel body on the card: wrapper of
``csrc/gj_probe_fused_panel.cu``, and its plain twin.

Replaces ``tpu_jordan/ops/pallas_block_inverse.py::_gj_fused_panel_kernel``
(:363), the body that ``pallas_batched_block_inverse`` dispatches to when
the block size has a panel width.  For a (nc, m, m) stack it computes each
block's inverse and a singular flag by the JAX kernel's algebra:

- width-m storage W (no [A | I]), implicit pivoting (no row is moved);
- per panel of b = :func:`panel_width` columns, b serial micro-steps on the
  (m, b) strip S and the transform U: the pivot r is the unused row with
  the largest |S[r, j]| (lowest row on ties), and the step is the
  unnormalized E_j = I + v·e_rᵀ with v = −S[:, j]/piv and v[r] = 0, so the
  pivot rows keep their raw scale (S += v ⊗ S[r]; U += v ⊗ U[r]; U[:, j] =
  v);
- then one deferred update W += U·(R·W) with R·W the b raw pivot rows, and
  the panel's freed columns T[:, r_j] = e_{r_j} + U[:, j];
- the raw pivots are recorded, and the store gives
  inv[a][c] = W[perm[a]][pinv[c]]·(1/piv_a), that is D⁻¹·M·W·M.

The CUDA body keeps W, the strip, U and the pivots in fp64 for fp32 and
fp64 input alike and rounds the output once; the twin computes in the
stack's dtype, as the JAX kernel does.  Both hold the algebra; the kernel's
residuals are the smaller (the source says why).

The flag is raised when the input holds a non-finite value, when
‖block‖∞ < eps, or when a raw pivot has |piv| < eps·‖block‖∞, and goes
straight out (the JAX kernel signals it by poisoning the block to inf and
recovers it with ``isfinite``; the port needs no poison).

The JAX dispatch also asks for ``m % 128 == 0`` and a VMEM budget
(``pallas_block_inverse.py:674-679``).  Those are limits of Mosaic's lane
layout and of the TPU's VMEM, not semantics, and have no counterpart here.
This card's own limit is :data:`MAX_M`: the kernel runs one thread per
matrix row, and a thread block holds at most 1024 threads.

``launches`` counts the kernel's launches (one a call) and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..errors import KernelLaunchError
from .norms import block_inf_norms

# Largest block size the CUDA body takes: one thread per row.
MAX_M = 1024

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def panel_width(m: int) -> int | None:
    """Largest panel width b in (32, 16, 8) with m % b == 0 and m > b, else
    None (no panel split); ``_panel_width`` of the JAX package."""
    for b in (32, 16, 8):
        if m % b == 0 and m > b:
            return b
    return None


def require_panel_width(m: int) -> int:
    b = panel_width(m)
    if b is None:
        raise ValueError(f"no panel width divides m={m}")
    return b


def takes_panel_body(m: int) -> bool:
    """Whether ``gj_probe`` runs this body on the card for block size m."""
    return panel_width(m) is not None and m <= MAX_M


def check_cuda_stack(blocks: torch.Tensor) -> None:
    """Raise unless ``blocks`` is a contiguous stack on a CUDA device."""
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if not blocks.is_contiguous():
        raise ValueError("the probe kernels take a contiguous stack")


def gj_fused_panel_plain(blocks: torch.Tensor, eps: float):
    """The plain twin of ``_gj_fused_panel_kernel``, step for step, batched
    over the stack (module docstring).  Computes in the stack's dtype.
    Returns (inverses, singular_flags); raises ValueError when no panel
    width divides m."""
    nc, m, _ = blocks.shape
    b = require_panel_width(m)
    dev, dtype = blocks.device, blocks.dtype
    norms = block_inf_norms(blocks)
    thresh = eps * norms
    sing = ~torch.isfinite(blocks).all(dim=2).all(dim=1) | (norms < eps)
    used = torch.zeros((nc, m), dtype=torch.bool, device=dev)
    perm = torch.empty((nc, m), dtype=torch.long, device=dev)
    pivs = torch.ones((nc, m), dtype=dtype, device=dev)
    rows = torch.arange(nc, device=dev)
    row_ids = torch.arange(m, device=dev)
    W = blocks.clone()
    for k0 in range(0, m, b):
        S = W[:, :, k0:k0 + b].clone()                        # (nc, m, b)
        U = torch.zeros_like(S)
        pivot_rows = torch.empty((nc, b), dtype=torch.long, device=dev)
        for j in range(b):
            col = S[:, :, j].clone()
            r = torch.where(used, -1.0, col.abs()).argmax(dim=1)
            piv = col[rows, r]
            used[rows, r] = True
            perm[:, k0 + j] = r
            pivs[:, k0 + j] = piv
            pivot_rows[:, j] = r
            safe = torch.where(piv == 0, torch.ones_like(piv), piv)
            v = -col / safe[:, None]
            v[rows, r] = 0
            S = S + v[:, :, None] * S[rows, r][:, None, :]
            upd = U + v[:, :, None] * U[rows, r][:, None, :]
            upd[:, :, j] = U[:, :, j] + v
            U = upd
        P = W[rows[:, None], pivot_rows]                      # R·W (nc, b, m)
        W = W + U @ P
        R_t = (row_ids[None, :, None] == pivot_rows[:, None, :]).to(dtype)
        W[:, :, k0:k0 + b] = U + R_t          # columns e_{r_j} + U[:, j]
    sing |= (pivs.abs() < thresh[:, None]).any(dim=1)
    pivs = torch.where(pivs == 0, torch.ones_like(pivs), pivs)
    pinv = torch.argsort(perm, dim=1)
    inv = W.gather(1, perm[:, :, None].expand(nc, m, m))      # M·W
    inv = inv * (1.0 / pivs)[:, :, None]                      # D⁻¹·M·W
    inv = inv.gather(2, pinv[:, None, :].expand(nc, m, m))    # (D⁻¹·M·W)·M
    return inv, sing


@functools.cache
def _lib():
    from .._build import load

    lib = load("gj_probe_fused_panel")
    ptrs = [ctypes.c_void_p] * 4
    ints = [ctypes.c_int] * 3
    lib.gj_probe_fused_panel_f32.argtypes = ptrs + ints + [ctypes.c_float,
                                                           ctypes.c_void_p]
    lib.gj_probe_fused_panel_f64.argtypes = ptrs + ints + [ctypes.c_double,
                                                           ctypes.c_void_p]
    lib.gj_probe_fused_panel_f32.restype = ctypes.c_int
    lib.gj_probe_fused_panel_f64.restype = ctypes.c_int
    lib.gj_probe_fused_panel_work_bytes.argtypes = [ctypes.c_int] * 3
    lib.gj_probe_fused_panel_work_bytes.restype = ctypes.c_size_t
    return lib


def launch_fused_panel(blocks: torch.Tensor, eps: float):
    """Launch ``csrc/gj_probe_fused_panel.cu`` on a CUDA stack of fp32 or
    fp64 blocks whose m :func:`takes_panel_body`; returns (inverses,
    singular_flags) and counts the launch.  Raises
    :class:`KernelLaunchError` when the CUDA runtime refuses it."""
    check_cuda_stack(blocks)
    nc, m, _ = blocks.shape
    if not takes_panel_body(m):
        raise ValueError(f"the panel probe takes m with a panel width and "
                         f"m <= {MAX_M}, got m={m}")
    b = panel_width(m)
    if blocks.data_ptr() % 16:
        blocks = blocks.clone()    # the kernel reads rows as 16-byte vectors
    inv = torch.empty_like(blocks)
    sing = torch.empty(nc, dtype=torch.uint8, device=blocks.device)
    if nc == 0:
        return inv, sing.bool()
    lib = _lib()
    f64 = blocks.dtype == torch.float64
    with torch.cuda.device(blocks.device):
        work = torch.empty(lib.gj_probe_fused_panel_work_bytes(nc, m, b),
                           dtype=torch.uint8, device=blocks.device)
        fn = lib.gj_probe_fused_panel_f64 if f64 else \
            lib.gj_probe_fused_panel_f32
        err = fn(blocks.data_ptr(), inv.data_ptr(), sing.data_ptr(),
                 work.data_ptr(), nc, m, b, eps,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise KernelLaunchError(
            f"gj_probe_fused_panel launch failed with CUDA error {err} "
            f"(nc={nc}, m={m}, b={b}, {blocks.dtype})")
    global launches
    launches += 1
    return inv, sing.bool()
