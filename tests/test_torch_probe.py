"""The port's plain probe against the JAX package's probes, on the CPU.

``batched_block_inverse`` (plain PyTorch) is held against the JAX plain
version and against the Pallas probe run in interpret mode: m in {8, 12,
16, 32, 50} reaches the rank-1 body (``_gj_probe_kernel``), m = 128 the
fused-panel body (``_gj_fused_panel_kernel``).  The schedule that
``csrc/gj_probe.cu`` runs for an m is a plain function, held here on either
side of each of its limits.  Each stack mixes random blocks with a
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


@pytest.mark.parametrize("m", [8, 12, 16, 32, 50, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_probe_matches_jax_plain(m, dtype):
    nc = 6 if m < 128 else 5
    b = _stack(nc, m, dtype, seed=m)
    inv_ref, sing_ref = jplain(jnp.asarray(b))
    inv, sing = batched_block_inverse(torch.from_numpy(b))
    _check(b, np.asarray(inv_ref), np.asarray(sing_ref), inv.numpy(),
           sing.numpy(), _tol(dtype))


@pytest.mark.parametrize("m", [8, 12, 16, 32, 50, 128])
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


# A card that holds 132 // C clusters of C blocks, and a stack of 1000
# candidates: no schedule runs it in one wave, and the fewest waves are
# those of the fewest blocks that hold W.
def _packed(kind, c):
    return 132 // c


# (m, element bytes, schedule) on that card: either side of the block
# schedule's register limit (m = 128) and of what a 16-block cluster's
# shared memory holds (fp32 896/897, fp64 609/610), and the main path's
# m = 50, 300, 384 and 1100.
SCHEDULE_CASES = [
    (8, 4, ("block", 1)), (50, 4, ("block", 1)), (128, 4, ("block", 1)),
    (129, 4, ("cluster", 2)), (300, 4, ("cluster", 2)),
    (384, 4, ("cluster", 3)), (512, 4, ("cluster", 5)),
    (896, 4, ("cluster", 16)), (897, 4, ("global", 16)),
    (1100, 4, ("global", 16)),
    (50, 8, ("block", 1)), (128, 8, ("block", 1)), (129, 8, ("cluster", 2)),
    (300, 8, ("cluster", 4)), (384, 8, ("cluster", 6)),
    (609, 8, ("cluster", 16)), (610, 8, ("global", 16)),
    (1100, 8, ("global", 16)),
]


@pytest.mark.parametrize("m,elem,expected", SCHEDULE_CASES)
def test_probe_schedule_by_shape(m, elem, expected):
    name, c = probe_mod.probe_schedule(m, elem, 1000, _packed)
    assert (name, c) == expected
    smem = probe_mod.probe_smem_bytes
    limit = probe_mod.SMEM_LIMIT
    if name == "cluster":
        assert smem(m, elem, c, -(-m // c)) <= limit
        assert c == 2 or smem(m, elem, c - 1, -(-m // (c - 1))) > limit
    if name == "global":
        assert smem(m, elem, 16, -(-m // 16)) > limit
        rows = probe_mod.smem_rows(m, elem, c)
        assert 0 < rows < -(-m // c)
        assert smem(m, elem, c, rows) <= limit < smem(m, elem, c, rows + 1)


# Clusters of C blocks the card holds at once (as an H100 answered for the
# cluster schedule at m = 384 in fp32, and the same for the global one),
# and the schedule picked for a stack of nc candidates: the cluster one
# with the most blocks that run them in one wave, else the global one that
# does with three quarters of its rows in shared memory, else the cluster
# one in the fewest waves with the most blocks among those.
ACTIVE = {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
          10: 7, 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}


@pytest.mark.parametrize("m,elem,nc,expected", [
    (256, 4, 16, ("cluster", 6)), (300, 4, 20, ("cluster", 5)),
    (384, 4, 22, ("cluster", 5)), (384, 8, 22, ("global", 5)),
    (512, 4, 8, ("cluster", 9)), (300, 4, 1, ("cluster", 16)),
    (896, 4, 22, ("cluster", 16)), (1100, 4, 4, ("global", 16)),
    (384, 8, 40, ("cluster", 8)), (300, 4, 40, ("cluster", 2)),
    (300, 4, 80, ("cluster", 2)), (300, 4, 200, ("cluster", 2))])
def test_probe_schedule_by_occupancy(m, elem, nc, expected):
    assert probe_mod.probe_schedule(
        m, elem, nc, lambda kind, c: ACTIVE.get(c, 132)) == expected


@pytest.mark.parametrize("m,limit,expected", [
    (300, 10**6, ("cluster", 2)), (300, 100_000, ("cluster", 4)),
    (300, 20_000, ("global", 14)), (1100, 10**6, ("cluster", 5)),
    (1100, 30_000, ("global", 10)), (1100, 25_000, ("global", 5))])
def test_probe_schedule_takes_the_smem_limit(m, limit, expected):
    assert probe_mod.probe_schedule(m, 4, 1000, _packed,
                                    smem_limit=limit) == expected


def test_probe_schedule_refuses_what_fits_nowhere():
    with pytest.raises(ValueError, match="no gj_probe schedule fits"):
        probe_mod.probe_schedule(300, 4, 1, _packed, smem_limit=1000)


def test_probe_smem_of_w_falls_with_the_cluster():
    """W's rows dominate a cluster block's shared memory and shrink as C
    grows; without them (block and global) a block takes tens of KB."""
    sizes = [probe_mod.probe_smem_bytes(300, 8, c, -(-300 // c))
             for c in (2, 4, 8, 16)]
    assert sizes == sorted(sizes, reverse=True)
    assert probe_mod.probe_smem_bytes(1100, 8, 16) < 64_000


@pytest.mark.parametrize("m", [8, 12, 50, 100, 300, 1100, 1536])
def test_probe_body_routes_to_gj_probe(m):
    assert probe_mod.probe_body(m) == "gj_probe"


def test_forced_schedule_needs_a_card():
    with pytest.raises(ValueError, match="unsupported device"):
        probe_mod.launch_kernel(torch.eye(8)[None], 1e-7, ("block", 1))
