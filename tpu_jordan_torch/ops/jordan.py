"""Augmented [A | I] blocked Gauss–Jordan: the reference-parity engine.

Counterpart of the JAX package's ``ops/jordan.py::block_jordan_invert``
(``_jordan_step``), the reference's ``Jordan`` (main.cpp:953-1204) kept
as written there: the state is W = [A | B] with B starting as I and ending
as A⁻¹ (main.cpp:366-370, 415), so every superstep's eliminate is one
(N, m) × (m, 2N) product, ~4N³ flops in all against the in-place engines'
~2N³.  A superstep:

  * probe the live candidate blocks of column t (rows ≥ t; the JAX engine
    probes all Nr and masks the rows below t, which picks the same pivot),
    pivot = argmin ‖inv‖∞ over the non-singular ones, lowest row on ties;
    ``singular`` latches when none is invertible (main.cpp:1075-1083);
  * swap block rows t and piv of W;
  * normalize the pivot row, prow = H·W[piv] (main.cpp:1133-1159);
  * eliminate every other block row with one ``addmm_`` (main.cpp:1165-1193;
    cuBLAS in full fp32 on the card, TF32 off) and write prow into row t.

``global_scale=True`` thresholds every inner pivot against eps·‖A‖∞ of the
whole unpadded input (main.cpp:782/972), taken once, instead of each
candidate's own ‖block‖∞: the reference's exact rule, which the driver's
``engine="augmented"`` runs.  On the card that probe is ``csrc/gj_probe.cu``
with the scale as a device value (``ops/gj_probe.py``); without it the probe
is the engines' default dispatch.  The pivot index stays on the device and
no step waits for the host.

Complex input (complex64, complex128) runs as it does in the JAX package:
the argmin key ‖inv‖∞ and the global scale ‖A‖∞ are real (|z|), and on
the card every probe is ``gj_probe.cu``'s complex body.
"""

from __future__ import annotations

import torch

from ..config import default_block_size, eps_for
from .block_inverse import probe_blocks
from .jordan_inplace import _SUB_FP32, _select, _swap_rows, _upcast_call
from .norms import inf_norm
from .padding import pad_with_identity, unpad
from .refine import newton_schulz


def block_jordan_invert(
    a: torch.Tensor,
    block_size: int | None = None,
    eps: float | None = None,
    refine: int = 0,
    global_scale: bool = False,
    probe=probe_blocks,
):
    """Invert ``a`` by augmented blocked Gauss–Jordan with condition-based
    pivoting.  Returns ``(x, singular)`` with ``singular`` a bool tensor on
    ``a``'s device.  ``probe(cands, eps)`` inverts the candidate stack
    (default :func:`probe_blocks`); with ``global_scale`` it is called as
    ``probe(cands, eps, scale=norm_a)``, ``norm_a`` a 0-d tensor on the
    device.  Sub-fp32 input is inverted in fp32 and rounded once at the
    end.  Counterpart of the JAX package's ``block_jordan_invert`` (its
    ``use_pallas`` has no meaning here: on a card the probe is a kernel)."""
    if a.dtype in _SUB_FP32:
        return _upcast_call(block_jordan_invert, a, block_size, eps, refine,
                            global_scale, probe)
    n = a.shape[-1]
    if block_size is None:
        block_size = default_block_size(n)
    m = min(block_size, n)
    if eps is None:
        eps = eps_for(a.dtype)
    # ‖A‖∞ of the unpadded input, once (main.cpp:972, 1046): identity pad
    # rows do not count.
    kw = {"scale": inf_norm(a)} if global_scale else {}
    Nr = -(-n // m)
    N = Nr * m
    W = torch.cat([pad_with_identity(a, N),
                   torch.eye(N, dtype=a.dtype, device=a.device)], dim=1)
    Wb = W.view(Nr, m, 2 * N)
    singular = torch.zeros((), dtype=torch.bool, device=a.device)
    for t in range(Nr):
        s = slice(t * m, (t + 1) * m)
        # --- PROBE the live candidate blocks of column t.
        cands = W[t * m:, s].reshape(Nr - t, m, m).contiguous()
        invs, sing = probe(cands, eps, **kw)
        H, piv, _ = _select(invs, sing, t)
        singular |= sing.all()

        # --- SWAP block rows t <-> piv (main.cpp:1093-1131), then
        # NORMALIZE the pivot row.
        prow = H @ _swap_rows(Wb, t, piv)                     # (m, 2N)

        # --- ELIMINATE every other block row with one product; the
        # multipliers are column t after the swap, row block t zeroed.
        E = W[:, s].clone()                                   # (N, m)
        E[s] = 0
        W.addmm_(E, prow, alpha=-1)
        W[s] = prow
    x = unpad(W[:, N:], n).contiguous()
    return newton_schulz(a, x, refine), singular
