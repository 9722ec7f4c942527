"""The group-closing update on the card: wrapper of ``csrc/fused_update.cu``.

Replaces ``tpu_jordan/ops/pallas_update.py::fused_normalize_eliminate`` (its
``_fused_update_kernel`` body).  At the last step j of a group of the
delayed-group-update engine, the freshly normalized pivot row joins the
pending panels and the group-end trailing update retires at once:

    prow = H @ rows_p, with prow[:, t·m:(t+1)·m] = H exactly;
    V ← V' − U·[P with row block j = prow], V' = V with its pivot column
    block zeroed;
    V[t·m:(t+1)·m] ← prow.

``mode="bf16"`` rounds the operands of both products (H, rows_p, U and the
assembled P) to bf16 and accumulates in fp32, the mixed-precision recipe of
the JAX package; the H insertion and the stored values stay fp32.

It is almost all of a grouped solve's 2n³ flops.  fp32 runs outside the
tensor cores (no TF32), on SIMT FMAs, and is bound by operations; bf16 mode
runs the product on the tensor cores (``mma.sync``) from bf16 copies of the
operands, and is bound by V's bytes.  The source says more.

On a CPU tensor the wrapper runs the plain version
(:func:`fused_normalize_eliminate_plain`); on a CUDA tensor it launches the
kernel or raises.  ``launches`` counts group-closing calls that launched the
kernel, and nothing else.  The TPU kernel's tile and VMEM budget
(``_UPD_BUDGET``, ``_update_tiles``) are limits of that chip, not semantics,
and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..errors import KernelLaunchError

MODES = ("fp32", "bf16")

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache
def _lib():
    from .._build import load

    lib = load("fused_update")
    lib.fused_update_f32.argtypes = ([ctypes.c_void_p] * 7
                                     + [ctypes.c_int] * 6
                                     + [ctypes.c_void_p])
    lib.fused_update_f32.restype = ctypes.c_int
    lib.fused_update_work_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_update_work_bytes.restype = ctypes.c_size_t
    return lib


def _check(V, U, P, H, rows_p, t: int, j: int, m: int, mode: str):
    """The caller contract of the JAX kernel: shapes, fp32 operands (the
    JAX engine refuses fp64, ``jordan_inplace.py:754-758``), one device."""
    if mode not in MODES:
        raise ValueError(f"unknown kernel precision mode {mode!r}")
    ops = (V, U, P, H, rows_p)
    if any(x.dtype != torch.float32 for x in ops):
        raise TypeError("the fused update takes float32 operands only, got "
                        f"{[str(x.dtype) for x in ops]}")
    if len({x.device for x in ops}) != 1:
        raise ValueError("the fused update's operands lie on different "
                         "devices")
    N, KM = U.shape if U.dim() == 2 else (-1, -1)
    if (m <= 0 or N <= 0 or KM <= 0 or N % m or KM % m
            or V.shape != (N, N) or P.shape != (KM, N)
            or H.shape != (m, m) or rows_p.shape != (m, N)):
        raise ValueError(
            f"shapes do not fit the fused update at m={m}: V "
            f"{tuple(V.shape)}, U {tuple(U.shape)}, P {tuple(P.shape)}, "
            f"H {tuple(H.shape)}, rows_p {tuple(rows_p.shape)}")
    if not (0 <= t < N // m and 0 <= j < KM // m):
        raise ValueError(f"t={t}, j={j} outside the {N // m} block rows "
                         f"and {KM // m} group slots")
    return N, KM


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back: the kernel's staged operand."""
    return x.bfloat16().float()


def fused_normalize_eliminate_plain(V, U, P, H, rows_p, *, t: int, j: int,
                                    m: int, mode: str = "fp32"):
    """Plain PyTorch version of the group-closing update (the sequence
    ``tests/test_pallas_update.py::_reference_update`` writes out).  Updates
    ``V`` in place and returns it.

    In bf16 mode ``prow`` is summed in ascending order of the contraction,
    one exact bf16 product at a time, as the kernel sums it: so ``prow``,
    and its rounding to bf16 as an operand of the update, match the
    kernel's bit for bit, and only the update's summation order differs."""
    _check(V, U, P, H, rows_p, t, j, m, mode)
    s = slice(t * m, (t + 1) * m)
    if mode == "bf16":
        hb, rb = _bf16(H), _bf16(rows_p)
        prow = torch.zeros_like(rows_p)
        for k in range(m):
            prow.addcmul_(hb[:, k:k + 1], rb[k:k + 1])
    else:
        prow = H @ rows_p
    prow[:, s] = H
    p_eff = P.clone()
    p_eff[j * m:(j + 1) * m] = prow
    u = U
    if mode == "bf16":
        u, p_eff = _bf16(U), _bf16(p_eff)
    V[:, s] = 0
    V.addmm_(u, p_eff, alpha=-1)
    V[s] = prow
    return V


def fused_normalize_eliminate(V, U, P, H, rows_p, *, t: int, j: int, m: int,
                              mode: str = "fp32"):
    """The group-closing update (module docstring).  ``V`` (N, N), ``U``
    (N, kg·m) with its pivot rows zero, ``P`` (kg·m, N) with row block
    ``j`` zero and the pivot column block of earlier rows zero, ``H``
    (m, m), ``rows_p`` (m, N); all float32 on one device.

    Updates ``V`` in place and returns it: each output element reads only
    its own element of V, so no element is read after it is written.
    On the CPU it runs the plain version; on the card it launches the
    kernel or raises :class:`KernelLaunchError`."""
    N, KM = _check(V, U, P, H, rows_p, t, j, m, mode)
    if V.device.type == "cpu":
        return fused_normalize_eliminate_plain(V, U, P, H, rows_p, t=t, j=j,
                                               m=m, mode=mode)
    if V.device.type != "cuda":
        raise ValueError(f"unsupported device {V.device}")
    if not all(x.is_contiguous() for x in (V, U, P, H, rows_p)):
        raise ValueError("the fused update kernel takes contiguous operands")
    prow = torch.empty_like(rows_p)
    bf16 = int(mode == "bf16")
    lib = _lib()
    with torch.cuda.device(V.device):
        # The bf16 operands (bf16 mode): rounded once, read by the tensor
        # cores.
        size = lib.fused_update_work_bytes(N, KM, bf16)
        work = (torch.empty(size, dtype=torch.uint8, device=V.device)
                if size else None)
        err = lib.fused_update_f32(
            V.data_ptr(), U.data_ptr(), P.data_ptr(), H.data_ptr(),
            rows_p.data_ptr(), prow.data_ptr(),
            None if work is None else work.data_ptr(), N, KM, m, t, j,
            bf16, torch.cuda.current_stream().cuda_stream)
    if err:
        raise KernelLaunchError(
            f"fused_update launch failed with CUDA error {err} (N={N}, "
            f"KM={KM}, m={m}, t={t}, j={j}, mode={mode})")
    global launches
    launches += 1
    return V
