"""The port's fused-update engine (``grouped_pallas``) against the JAX
package's, on the CPU.

The same numpy fixture goes through the JAX
``block_jordan_invert_inplace_grouped_pallas(..., interpret=True)`` (its
Pallas update kernel run in interpret mode) and the port's engine on CPU
tensors (the plain update).  Pivot sequences are decided by no
floating-point tie here and must equal the JAX grouped engine's
(``collect_stats=True``), which the JAX tests pin bitwise to its
``grouped_pallas``.  Inverses agree within min(100·eps·κ∞, 0.1) (relative
∞-norm, κ∞ from the JAX inverse), the tolerance of
``test_torch_engine.py``: the frameworks sum products in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan.ops import generate as jgenerate
from tpu_jordan.ops import jordan_inplace as jj

from tpu_jordan_torch.ops import fused_update as fu
from tpu_jordan_torch.ops import jordan_inplace as tj
from tpu_jordan_torch.ops.block_inverse import probe_blocks
from tpu_jordan_torch.ops.jordan_inplace import _select


def _inf(x):
    return np.abs(x).sum(axis=-1).max()


def _recording_probe(pivots):
    """The default probe, recording each step's pivot block by the
    engines' own key argmin (the call index is the step t)."""
    def probe(cands, eps):
        invs, sing = probe_blocks(cands, eps)
        pivots.append(int(_select(invs, sing, len(pivots))[1]))
        return invs, sing
    return probe


@pytest.mark.parametrize("n,m,k,gen", [
    (64, 16, 2, "rand"),
    (96, 16, 2, "absdiff"),
    (80, 16, 2, "rand"),          # Nr = 5: the last group has kg = 1
])
def test_engine_matches_jax(n, m, k, gen):
    a = np.array(jgenerate(gen, (n, n), np.float32))
    xj, sj = jj.block_jordan_invert_inplace_grouped_pallas(
        jnp.asarray(a), block_size=m, group=k, interpret=True)
    _, _, stj = jj.block_jordan_invert_inplace_grouped(
        jnp.asarray(a), block_size=m, group=k, collect_stats=True)
    pivots = []
    xt, st = tj.block_jordan_invert_inplace_grouped_pallas(
        torch.from_numpy(a), block_size=m, group=k,
        probe=_recording_probe(pivots))
    xj, xt = np.asarray(xj), xt.numpy()
    assert not bool(sj) and not bool(st)
    np.testing.assert_array_equal(pivots, np.asarray(stj["pivot_block"]))
    kappa = _inf(a) * _inf(xj)
    eps = np.finfo(np.float32).eps
    assert _inf(xt - xj) / _inf(xj) <= min(100 * eps * kappa, 0.1)
    assert xt.dtype == np.float32 and xt.shape == (n, n)


def test_fp32_bitmatches_the_grouped_engine():
    """With the plain update on the CPU, the fp32 fused engine computes
    the grouped engine's products in the grouped engine's order: equal
    bits, as the JAX package pins for its pair."""
    a = torch.from_numpy(np.array(jgenerate("rand", (80, 80), np.float32)))
    x0, s0 = tj.block_jordan_invert_inplace_grouped(a, block_size=16,
                                                    group=2)
    x1, s1 = tj.block_jordan_invert_inplace_grouped_pallas(a, block_size=16,
                                                           group=2)
    assert torch.equal(x0, x1) and not bool(s0) and not bool(s1)


def test_singular_input_is_flagged():
    a = np.ones((32, 32), np.float32)
    _, sj = jj.block_jordan_invert_inplace_grouped_pallas(
        jnp.asarray(a), block_size=8, group=2, interpret=True)
    _, st = tj.block_jordan_invert_inplace_grouped_pallas(
        torch.from_numpy(a), block_size=8, group=2)
    assert bool(sj) and bool(st)


def test_bf16_mode_inverts_to_bf16_grade():
    """bf16 operands in the update: rand + n·I at n=64 inverts to a
    relative residual below 0.05 (``test_jordan_inplace.py``'s bound)."""
    n = 64
    a = np.array(jgenerate("rand", (n, n), np.float32)) + n * np.eye(
        n, dtype=np.float32)
    at = torch.from_numpy(a)
    x, s = tj.block_jordan_invert_inplace_grouped_pallas(
        at, block_size=16, group=2, mode="bf16")
    rel = float((at @ x - torch.eye(n)).abs().sum(1).max()
                / at.abs().sum(1).max())
    assert not bool(s) and rel < 0.05
    x32, _ = tj.block_jordan_invert_inplace_grouped_pallas(
        at, block_size=16, group=2)
    assert not torch.equal(x, x32)       # the operands were rounded


def test_update_argument_closes_every_group():
    """``update`` is called once per group, at its last step, with the
    engine's mode; the plain version passed in gives the default's
    result on the CPU."""
    a = torch.from_numpy(np.array(jgenerate("rand", (80, 80), np.float32)))
    calls = []

    def plain(V, U, P, H, rows_p, *, t, j, m, mode):
        calls.append((t, j, U.shape[1] // m, mode))
        return fu.fused_normalize_eliminate_plain(V, U, P, H, rows_p, t=t,
                                                  j=j, m=m, mode=mode)

    x0, _ = tj.block_jordan_invert_inplace_grouped_pallas(
        a, block_size=16, group=2, mode="bf16")
    x1, _ = tj.block_jordan_invert_inplace_grouped_pallas(
        a, block_size=16, group=2, mode="bf16", update=plain)
    assert torch.equal(x0, x1)
    assert calls == [(1, 1, 2, "bf16"), (3, 1, 2, "bf16"),
                     (4, 0, 1, "bf16")]


def test_sub_fp32_input_round_trips_dtype():
    a = torch.from_numpy(np.array(jgenerate("kms", (32, 32), np.float32)))
    x, s = tj.block_jordan_invert_inplace_grouped_pallas(
        a.to(torch.bfloat16), block_size=8, group=2)
    assert x.dtype == torch.bfloat16 and not bool(s)


def test_float64_refused():
    a = torch.eye(16, dtype=torch.float64)
    with pytest.raises(ValueError, match="fp32.*engine='grouped'"):
        tj.block_jordan_invert_inplace_grouped_pallas(a, block_size=8)


def test_unknown_mode_refused():
    with pytest.raises(ValueError, match="precision mode"):
        tj.block_jordan_invert_inplace_grouped_pallas(torch.eye(16),
                                                      block_size=8,
                                                      mode="fp16")
