"""The probe's two schedule variants: v3 (width-m in place) and v2 (panels).

Replaces the forced entry points of ``tpu_jordan/ops/pallas_block_inverse.py
:755-814``: ``pallas_batched_block_inverse_inplace`` (its
``_gj_inplace_kernel`` body, :159) and ``pallas_batched_block_inverse_panel``
(``_gj_panel_kernel``, :250), with ``_panel_width`` (:588).  Both compute the
dispatch probe's function (``gj_probe.gj_probe``) by another schedule: for a
(nc, m, m) stack, each block's inverse and a singular flag, raised when the
input holds a non-finite value, when ‖block‖∞ < eps, or when a pivot has
|piv| < eps·‖block‖∞.  No engine dispatches to them; they are reached through
their own wrappers and through the engines' ``probe=`` argument.

Each variant has a plain PyTorch twin that follows its JAX kernel step for
step, batched over the leading dimension, and a wrapper that runs the twin on
a CPU tensor and a CUDA kernel on a CUDA tensor (or raises; nothing falls
back).  As in the JAX entry points, the computation is fp32: an fp64 or
sub-fp32 input is cast to fp32 first.

**v3 on the card is ``csrc/gj_probe.cu``**, the dispatch probe's kernel,
which already runs v3's algebra; step k of ``_gj_inplace_kernel`` maps onto
it as follows:

- pivot: the unused row r with the largest |W[r, k]|, lowest row on ties
  (the kernel: a warp-shuffle argmax over the rows with ``used[r] == 0``);
- singular test ``|piv| < eps·‖block‖∞`` at each step, ``‖block‖∞ < eps``
  once (the kernel: the same, into ``hd->bad``);
- ``prow = W[r, :] / piv``; every other row ``W[i, :] −= W[i, k]·prow``; row
  r ← prow (the kernel: ``prow[j] = W[r][j] / piv``, ``wi[j] − f·prow[j]``,
  row r ← prow);
- the freed column k ← ``ucol`` = 1/piv at r, −W[i, k]/piv elsewhere (the
  kernel: ``prow[k] = 1/piv`` and column k of the other rows taken as 0
  before the update, so it becomes ``−W[i, k]·(1/piv)``: the same value,
  rounded once more);
- A⁻¹ = M·W·M with M[j, :] = onehot(perm[j]), two exact one-hot dots (the
  kernel: the gather ``inv[a][b] = W[perm[a]][pinv[b]]`` in its store).

So ``gj_probe_inplace`` launches that kernel; it is one kernel for rows 1–3
of the kernel table, and the twin holds it to v3's own arithmetic.

**v2 on the card is ``csrc/gj_probe_panel.cu``**, on one of two schedules
that :func:`panel_schedule` picks by m.  ``cluster`` where the (m, 2m)
state fits the shared memory of a cluster of C ≤ 16 blocks (m ≤ ~600): one
launch a call, each block owning ⌈m/C⌉ rows; per panel the leader block
gathers the (m, b) strip over distributed shared memory and runs the b
micro-steps at one barrier each, then every block applies the deferred
W += U·P to its own rows from pivot-row chunks copied out of their owners'
shared memory.  ``l2`` beyond that: per panel b micro-steps one block per
candidate, then the deferred update by blocks over (candidate, column tile,
row chunk), with W in an L2-resident global scratch (1 + 2·m/b launches).
The source says more.

Launch counts: ``launches["inplace"]`` and ``launches["panel"]`` count the
wrappers' kernel launches and nothing else (``gj_probe.launches`` keeps
counting the dispatch probe alone).  The TPU-only parts of
``_run_probe_kernel`` (padding to 8 candidates, ``cg`` chunking against the
VMEM budgets, ``_MAX_GRID``) are limits, not semantics, and have no
counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import eps_for
from ..errors import KernelLaunchError
from .gj_fused_panel import (check_cuda_stack, panel_width,
                             require_panel_width)
from .gj_probe import MAX_CLUSTER, REFUSED, SMEM_LIMIT, launch_kernel
from .norms import block_inf_norms

launches = {"inplace": 0, "panel": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _start(blocks: torch.Tensor, eps: float):
    """The state both twins start from: per-block threshold, the initial
    singular flags (non-finite input, or ‖block‖∞ < eps), no row used."""
    norms = block_inf_norms(blocks)
    sing = ~torch.isfinite(blocks).all(dim=2).all(dim=1) | (norms < eps)
    used = torch.zeros(blocks.shape[:2], dtype=torch.bool,
                       device=blocks.device)
    return eps * norms, sing, used


def _pick(col, used, thresh, sing):
    """One pivot choice on a (B, m) column: the unused row with the largest
    |col| (lowest row on ties, NaN highest); marks it used and raises the
    flag of a pivot below the threshold.  Returns (r, safe_piv): the pivot
    row and the pivot, with 1 in place of a zero pivot."""
    rows = torch.arange(col.shape[0], device=col.device)
    cand = torch.where(used, -1.0, col.abs())
    r = cand.argmax(dim=1)
    piv = col[rows, r]
    sing |= piv.abs() < thresh
    used[rows, r] = True
    return r, torch.where(piv == 0, torch.ones_like(piv), piv)


def gj_inplace_plain(blocks: torch.Tensor, eps: float):
    """The plain twin of ``_gj_inplace_kernel`` (v3): width-m storage with
    no [A | I], no physical swap, the normalized rank-1 step with the freed
    column k taking ``ucol``, and A⁻¹ = M·W·M as two gathers by ``perm``.
    Computes in the stack's dtype.  Returns (inverses, singular_flags)."""
    nc, m, _ = blocks.shape
    thresh, sing, used = _start(blocks, eps)
    rows = torch.arange(nc, device=blocks.device)
    perm = torch.empty((nc, m), dtype=torch.long, device=blocks.device)
    W = blocks.clone()
    for k in range(m):
        col = W[:, :, k].clone()                              # (nc, m)
        r, safe = _pick(col, used, thresh, sing)
        perm[:, k] = r
        prow = W[rows, r] / safe[:, None]                     # (nc, m)
        ucol = -col / safe[:, None]
        ucol[rows, r] = 1.0 / safe
        factors = col.clone()
        factors[rows, r] = 0
        W = W - factors[:, :, None] * prow[:, None, :]
        W[rows, r] = prow
        W[:, :, k] = ucol
    pinv = torch.argsort(perm, dim=1)
    inv = W.gather(1, perm[:, :, None].expand(nc, m, m))     # M·W
    inv = inv.gather(2, pinv[:, None, :].expand(nc, m, m))   # (M·W)·M
    return inv, sing


def gj_panel_plain(blocks: torch.Tensor, eps: float):
    """The plain twin of ``_gj_panel_kernel`` (v2): [A | I] of width 2m; per
    panel of b = ``panel_width(m)`` columns, b micro-steps on the strip S and
    the transform U (u = 1/piv − 1 at the pivot row, −col/piv elsewhere;
    S += u ⊗ S[r]; U += u ⊗ U[r]; U[:, j] += u), then W += U·P with P the b
    raw pivot rows of W (R·W); finally inv[a] = W[perm[a], m:].  Computes in
    the stack's dtype.  Returns (inverses, singular_flags); raises
    ValueError when no panel width divides m."""
    nc, m, _ = blocks.shape
    b = require_panel_width(m)
    thresh, sing, used = _start(blocks, eps)
    rows = torch.arange(nc, device=blocks.device)
    perm = torch.empty((nc, m), dtype=torch.long, device=blocks.device)
    eye = torch.eye(m, dtype=blocks.dtype, device=blocks.device)
    W = torch.cat([blocks, eye.expand(nc, m, m)], dim=2)     # (nc, m, 2m)
    for k0 in range(0, m, b):
        S = W[:, :, k0:k0 + b].clone()                        # (nc, m, b)
        U = torch.zeros_like(S)
        pivot_rows = torch.empty((nc, b), dtype=torch.long,
                                 device=blocks.device)
        for j in range(b):
            col = S[:, :, j]
            r, safe = _pick(col, used, thresh, sing)
            perm[:, k0 + j] = r
            pivot_rows[:, j] = r
            u = -col / safe[:, None]
            u[rows, r] = 1.0 / safe - 1.0
            S = S + u[:, :, None] * S[rows, r][:, None, :]
            U = U + u[:, :, None] * U[rows, r][:, None, :]
            U[:, :, j] = U[:, :, j] + u
        P = W[rows[:, None], pivot_rows]                      # (nc, b, 2m)
        W = W + U @ P
    inv = W[:, :, m:].gather(1, perm[:, :, None].expand(nc, m, m))
    return inv, sing


def _prepare(blocks: torch.Tensor, eps: float | None):
    """The JAX entry points' contract: an (nc, m, m) stack, computed in
    fp32 (``blocks.astype(jnp.float32)``), eps defaulting to fp32's."""
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"expected an (nc, m, m) stack, got "
                         f"{tuple(blocks.shape)}")
    if not blocks.is_floating_point():
        raise TypeError(f"unsupported dtype {blocks.dtype}")
    blocks = blocks.float()
    return blocks, eps_for(torch.float32) if eps is None else eps


def gj_probe_inplace(blocks: torch.Tensor, eps: float | None = None):
    """v3, the width-m in-place probe: (inverses fp32, singular_flags).
    Any float input is cast to fp32, as the JAX entry point does; eps
    defaults to ``eps_for(torch.float32)``.  On a CPU tensor: the twin
    :func:`gj_inplace_plain`; on a CUDA tensor: ``csrc/gj_probe.cu``."""
    blocks, eps = _prepare(blocks, eps)
    if blocks.device.type == "cpu":
        return gj_inplace_plain(blocks, eps)
    out = launch_kernel(blocks, eps)
    launches["inplace"] += 1
    return out


# Codes of the panel kernel's schedule argument.
PANEL_SCHEDULES = {"l2": 0, "cluster": 1}


@functools.cache
def _panel_lib():
    from .._build import load

    lib = load("gj_probe_panel")
    lib.gj_probe_panel_f32.argtypes = ([ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 3
                                       + [ctypes.c_float, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p])
    lib.gj_probe_panel_f32.restype = ctypes.c_int
    lib.gj_probe_panel_work_words.argtypes = [ctypes.c_int] * 3
    lib.gj_probe_panel_work_words.restype = ctypes.c_size_t
    return lib


def panel_smem_bytes(m: int, b: int, cluster: int) -> int:
    """Dynamic shared memory of one block of v2's cluster schedule: W's
    ⌈m/cluster⌉ rows of width 2m, their rows of U, two pivot-row chunks of
    128 columns, perm, the leader's slots.  Mirrors ``cluster_layout`` in
    the source."""
    rows, slots = -(-m // cluster), 32 * cluster
    sizes = (rows * 2 * m * 4, rows * b * 4, 2 * b * 128 * 4, m * 4,
             rows * 4, 2 * 32 * b * 4, 2 * 32 * 4, 2 * 32 * 4, slots * 4,
             slots * 4)
    return sum(-(-s // 16) * 16 for s in sizes)


@functools.cache
def panel_schedule(m: int, smem_limit: int = SMEM_LIMIT) -> tuple[str, int]:
    """The schedule of ``csrc/gj_probe_panel.cu`` for block size m:
    ("cluster", C) with C the smallest power of two up to 16 whose blocks
    hold the (m, 2m) state (one thread a row, at most 640), else
    ("l2", 1).
    Raises ValueError when no panel width divides m."""
    b = require_panel_width(m)
    if m <= 640:
        for c in (1, 2, 4, 8, MAX_CLUSTER):
            if panel_smem_bytes(m, b, c) <= smem_limit:
                return "cluster", c
    return "l2", 1


def gj_probe_panel(blocks: torch.Tensor, eps: float | None = None,
                   schedule: tuple[str, int] | None = None):
    """v2, the panel probe: (inverses fp32, singular_flags).  Any float
    input is cast to fp32, as the JAX entry point does; eps defaults to
    ``eps_for(torch.float32)``; raises ValueError when no panel width
    divides m.  On a CPU tensor: the twin :func:`gj_panel_plain`; on a
    CUDA tensor: ``csrc/gj_probe_panel.cu`` on :func:`panel_schedule`'s
    schedule, or on ``schedule`` (name, cluster size) where one is forced
    for a check; the kernel refuses one that does not fit
    (:class:`KernelLaunchError`)."""
    blocks, eps = _prepare(blocks, eps)
    nc, m, _ = blocks.shape
    b = require_panel_width(m)
    if blocks.device.type == "cpu":
        return gj_panel_plain(blocks, eps)
    check_cuda_stack(blocks)
    inv = torch.empty_like(blocks)
    sing = torch.empty(nc, dtype=torch.uint8, device=blocks.device)
    if nc == 0:
        return inv, sing.bool()
    name, cluster = schedule or panel_schedule(m)
    if name not in PANEL_SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}")
    lib = _panel_lib()
    with torch.cuda.device(blocks.device):
        work = (torch.empty(lib.gj_probe_panel_work_words(nc, m, b),
                            dtype=torch.float32, device=blocks.device)
                if name == "l2" else None)
        err = lib.gj_probe_panel_f32(
            blocks.data_ptr(), inv.data_ptr(), sing.data_ptr(),
            None if work is None else work.data_ptr(), nc, m, b, eps,
            PANEL_SCHEDULES[name], cluster,
            torch.cuda.current_stream().cuda_stream)
    if err:
        what = ("the schedule does not fit this card" if err == REFUSED
                else f"CUDA error {err}")
        raise KernelLaunchError(
            f"gj_probe_panel launch failed: {what} (nc={nc}, m={m}, b={b}, "
            f"schedule={name}, cluster={cluster})")
    launches["panel"] += 1
    return inv, sing.bool()
