"""The port's plain probe against the JAX package's probes, on the CPU.

``batched_block_inverse`` (plain PyTorch) is held against the JAX plain
version and against the Pallas probe run in interpret mode: m in {8, 16,
32} reaches the rank-1 body (``_gj_probe_kernel``), m = 128 the fused-panel
body (``_gj_fused_panel_kernel``).  Each stack mixes random blocks with a
zero block, a rank-deficient block (a duplicated row) and non-finite ones.
Flags must be equal; inverses of the regular blocks agree within 1e-10
(fp64, relative ∞-norm) or min(eps32·m·κ∞(block), 1e-3) (fp32).  The fp32
readings stay below 7e-6, under 2 % of eps32·m·κ∞.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan.ops.block_inverse import batched_block_inverse as jplain
from tpu_jordan.ops.pallas_block_inverse import pallas_batched_block_inverse

from tpu_jordan_torch.ops import gj_probe as probe_mod
from tpu_jordan_torch.ops.block_inverse import batched_block_inverse
from tpu_jordan_torch.ops.block_inverse import probe_blocks


def _stack(nc, m, dtype, seed):
    b = np.random.default_rng(seed).standard_normal((nc, m, m))
    b[1] = 0.0                      # zero block
    b[2, m - 1] = b[2, 0]           # duplicated row: rank m-1
    b[3, m // 2, m // 3] = np.nan   # non-finite
    b[4, 0, m - 1] = np.inf
    return b.astype(dtype)


def _inf(x):
    return np.abs(x).sum(axis=-1).max(axis=-1)


def _check(blocks, inv_ref, sing_ref, inv, sing, rel_tol, expect_flags=True):
    np.testing.assert_array_equal(sing, sing_ref)
    if expect_flags:
        np.testing.assert_array_equal(sing[1:5], True)
    ok = ~sing_ref
    rel = _inf(inv[ok] - inv_ref[ok]) / _inf(inv_ref[ok])
    assert np.all(rel <= rel_tol(blocks[ok], inv_ref[ok])), rel


def _tol(dtype):
    if dtype == np.float64:
        return lambda b, x: 1e-10
    eps = np.finfo(np.float32).eps
    return lambda b, x: np.minimum(eps * b.shape[-1] * _inf(b) * _inf(x),
                                   1e-3)


@pytest.mark.parametrize("m", [8, 16, 32, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_probe_matches_jax_plain(m, dtype):
    nc = 6 if m < 128 else 5
    b = _stack(nc, m, dtype, seed=m)
    inv_ref, sing_ref = jplain(jnp.asarray(b))
    inv, sing = batched_block_inverse(torch.from_numpy(b))
    _check(b, np.asarray(inv_ref), np.asarray(sing_ref), inv.numpy(),
           sing.numpy(), _tol(dtype))


@pytest.mark.parametrize("m", [8, 16, 32, 128])
def test_plain_probe_matches_pallas_interpret(m):
    nc = 6 if m < 128 else 5
    b = _stack(nc, m, np.float32, seed=100 + m)
    inv_ref, sing_ref = pallas_batched_block_inverse(jnp.asarray(b),
                                                     interpret=True)
    inv, sing = batched_block_inverse(torch.from_numpy(b))
    _check(b, np.asarray(inv_ref), np.asarray(sing_ref), inv.numpy(),
           sing.numpy(), _tol(np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_single_block_inverse_matches_jax(dtype):
    from tpu_jordan.ops.block_inverse import gauss_jordan_inverse as jgj
    from tpu_jordan_torch.ops import gauss_jordan_inverse as tgj

    b = _stack(5, 16, dtype, seed=9)
    for i in range(5):
        inv_ref, sing_ref = jgj(jnp.asarray(b[i]))
        inv, sing = tgj(torch.from_numpy(b[i]))
        _check(b[i:i + 1], np.asarray(inv_ref)[None],
               np.asarray(sing_ref)[None], inv.numpy()[None],
               sing.numpy()[None], _tol(dtype), expect_flags=False)


def test_scale_norm_argument_matches_jax():
    """An explicit scale (the reference's whole-strip norm) raises the
    threshold: a block that passes on its own norm is flagged."""
    b = np.random.default_rng(7).standard_normal((3, 8, 8))
    b[1] *= 1e-14
    ref = np.asarray(jplain(jnp.asarray(b), 1e3)[1])
    got = batched_block_inverse(torch.from_numpy(b), 1e3)[1].numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.tolist() == [False, True, False]


def test_cpu_probe_runs_plain_and_counts_no_launch():
    probe_mod.reset_launches()
    b = torch.from_numpy(_stack(6, 16, np.float32, seed=3))
    inv, sing = probe_blocks(b)
    inv_p, sing_p = batched_block_inverse(b)
    assert torch.equal(sing, sing_p)
    assert torch.equal(inv.nan_to_num(), inv_p.nan_to_num())
    assert probe_mod.launches == 0


def test_sub_fp32_stack_is_probed_in_fp32():
    b = torch.from_numpy(_stack(6, 8, np.float32, seed=4))
    inv, sing = probe_mod.gj_probe(b.to(torch.bfloat16))
    assert inv.dtype == torch.float32
    assert sing[1:5].all()


@pytest.mark.parametrize("shape", [(4, 4), (2, 4, 5)])
def test_probe_rejects_bad_shapes(shape):
    with pytest.raises(ValueError):
        probe_mod.gj_probe(torch.zeros(shape))
