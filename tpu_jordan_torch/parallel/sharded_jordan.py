"""The 1D augmented engine on p ranks: the pre-shard_map reference-parity
engine.  Counterpart of the JAX package's ``parallel/sharded_jordan.py``
(the reference's distributed ``Jordan``, main.cpp:953-1204), over
``torch.distributed`` instead of ``shard_map``.

Each rank holds its (bpw, m, 2N) slots of the identity-padded [A | I] in
cyclic storage order (global block row ``s·p + k`` at slot s of rank k;
:func:`augment_blocks` appends the rank's rows of I to its strip of A).  A
superstep t:

  * **probe** (main.cpp:1026-1074): the rank inverts its live candidates
    of column block t, the slots holding rows ≥ t, on
    ``ops.block_inverse.probe_blocks`` (the panel kernel or
    ``gj_probe.cu`` on the card) **without** a global singularity scale,
    as the JAX engine probes (only the single-device augmented engine
    passes ‖A‖∞).  The JAX engine probes every slot (or the upper half,
    under its ``lax.cond`` cut) and masks the dead ones; the port probes
    only the live slots, which gives the same candidate.  A rank with no
    live candidate launches nothing and offers +∞;
  * **pivot reduction**: the two-stage ``all_reduce(MIN)`` on (key, global
    row) of the in-place engines (``sharded_inplace._reduce``), ties to
    the lowest global row; the all-singular agreement comes out of the
    reduction itself (main.cpp:1075-1083);
  * **broadcasts**: the owner broadcasts the pivot row with H (one (m, 2N
    + m) buffer), the owner of row t broadcasts row t unless the pivot is
    row t: broadcasts where the JAX package psums one-hot rows;
  * **swap-by-copy, normalize, eliminate**: the pivot's owner stores row t
    in the pivot's slot; prow = H·row_piv over the whole 2N width; every
    local row but row t takes −E·prow in one (bpw·m, m)×(m, 2N) ``addmm_``;
    row t's owner writes prow.

After Nr steps the A half is the identity and the B half the inverse, in
cyclic row order (:func:`inverse_half`); no column permutation is needed.
The engine costs 4N³ FLOPs against the in-place engines' 2N³, so the cost
ranking never picks it; it is the reference's own algorithm, kept for
parity.
"""

from __future__ import annotations

import torch

from ..config import eps_for
from ..ops.block_inverse import probe_blocks
from .layout import CyclicLayout
from .sharded_inplace import (_eliminate, _matmul, _no_singular, _reduce,
                              _row_broadcast, _run_steps)
from .upcast import upcast_sub_fp32


def augment_blocks(blocks: torch.Tensor, lay: CyclicLayout,
                   rank: int) -> torch.Tensor:
    """Rank ``rank``'s (bpw, m, 2N) strip of [A | I] from its (bpw, m, N)
    strip of the identity-padded A."""
    bpw, m, N = blocks.shape
    dev = blocks.device
    gi = ((torch.arange(bpw, device=dev) * lay.p + rank)[:, None] * m
          + torch.arange(m, device=dev)[None, :])[:, :, None]
    eye = (gi == torch.arange(N, device=dev)[None, None, :]).to(blocks.dtype)
    return torch.cat([blocks, eye], dim=2)


def inverse_half(out: torch.Tensor) -> torch.Tensor:
    """The B half (the inverse's rows, cyclic order) of a rank's
    (bpw, m, 2N) result."""
    return out[:, :, out.shape[-1] // 2:]


def _augmented_step(Wloc, t: int, dec, group, lay: CyclicLayout, singular,
                    pivots: list, ahead=None):
    """Superstep t of the augmented loop on this rank's (bpw, m, 2N) slots,
    in place (module docstring)."""
    p, m, Nr = lay.p, lay.m, lay.Nr
    k = group.rank
    width = Wloc.shape[-1]
    g_piv, kmin = _reduce(dec, group, Nr)
    singular |= ~torch.isfinite(kmin)
    pivots.append(g_piv)
    owner, slot = g_piv % p, g_piv // p
    buf = Wloc.new_empty((m, width + m))
    if k == owner:
        buf[:, :width] = Wloc[slot]
        buf[:, width:] = dec.invs[slot - dec.s_live]
    group.broadcast(buf, owner)
    row_piv, H = buf[:, :width], buf[:, width:]
    if g_piv != t:
        row_t = _row_broadcast([Wloc], t, group, lay)[0]
        if k == owner:
            Wloc[slot] = row_t                      # swap-by-copy
    prow = _matmul(H, row_piv)
    own_t = k == t % p
    E = Wloc[:, :, t * m:(t + 1) * m].clone()
    if own_t:
        E[t // p] = 0
    _eliminate(Wloc, E, prow)
    if own_t:
        Wloc[t // p] = prow
    return None


@upcast_sub_fp32
def augmented_blocks(blocks, group, lay: CyclicLayout,
                     eps: float | None = None, probe=probe_blocks):
    """Run the augmented engine on this rank's (bpw, m, 2N) slots of
    [A | I] (not modified); every rank of ``group`` calls it together.
    Returns ``(out, singular, pivots, probe_steps)``: the rank's (bpw, m,
    2N) result ([I | A⁻¹] rows in cyclic order), the (1,) flag, the pivot
    sequence and the steps this rank probed.  Counterpart of the JAX
    package's ``compile_sharded_jordan(...)(blocks)``."""
    if eps is None:
        eps = eps_for(blocks.dtype)
    W = blocks.clone()
    singular, pivots = _no_singular(W), []
    steps = _run_steps(
        lambda t, dec, ahead: _augmented_step(W, t, dec, group, lay,
                                              singular, pivots),
        W, group, lay, eps, probe, lookahead=False)
    return W, singular, pivots, steps


def invert_augmented_1d(a_blocks, group, lay: CyclicLayout,
                        probe=probe_blocks):
    """The augmented engine from this rank's (bpw, m, N) strip of the
    identity-padded A: ``(inverse blocks, singular, pivots, probe_steps)``
    in the in-place engines' form (the B half, cyclic row order)."""
    out, singular, pivots, steps = augmented_blocks(
        augment_blocks(a_blocks, lay, group.rank), group, lay, probe=probe)
    return inverse_half(out), singular, pivots, steps

