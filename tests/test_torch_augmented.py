"""The port's augmented [A | I] engine against the JAX package's, on the CPU.

The same numpy fixture goes through ``tpu_jordan.ops.block_jordan_invert``
(the XLA probe, ``use_pallas=False``) and the port's
``block_jordan_invert``, with the per-block and the global singularity
scale.  Singular verdicts are checked exactly.  Inverses agree within
min(100·eps·κ∞, 0.1) (relative ∞-norm, eps the dtype's machine epsilon, κ∞
from the JAX inverse), the tolerance of ``test_torch_engine.py``: the
frameworks sum products in another order.  The largest reading is 7.4e-3,
at fp32 absdiff (100, 16), where the tolerance is 0.1.

The JAX augmented engine does not expose its pivots.  Its candidate blocks
are the in-place engine's Schur complements, so the port's pivots, taken
through a recording ``probe=``, are held against the JAX in-place engine's
``collect_stats=True`` record.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan.ops import block_jordan_invert as jinvert
from tpu_jordan.ops import generate as jgenerate
from tpu_jordan.ops import jordan_inplace as jj
from tpu_jordan.ops.block_inverse import batched_block_inverse as jplain

from tpu_jordan_torch.ops import batched_block_inverse, probe_blocks
from tpu_jordan_torch.ops.jordan import block_jordan_invert
from tpu_jordan_torch.ops.jordan_inplace import _select

DTYPES = [np.float64, np.float32]
# (generator, n, m): square, ragged n, and m >= n (one block).
CASES = [("absdiff", 64, 16), ("rand", 64, 16), ("absdiff", 100, 16),
         ("rand", 100, 16), ("absdiff", 48, 64)]


def _inf(x):
    return np.abs(x).sum(axis=-1).max(axis=-1)


def _run_both(a, m, **kw):
    xj, sj = jinvert(jnp.asarray(a), block_size=m, use_pallas=False, **kw)
    xt, st = block_jordan_invert(torch.from_numpy(a), block_size=m, **kw)
    return np.asarray(xj), bool(sj), xt.numpy(), bool(st)


def recording_probe(pivots):
    """The default probe, recording each superstep's pivot block (the call
    index is the step)."""
    def probe(cands, eps, scale=None):
        invs, sing = probe_blocks(cands, eps, scale)
        pivots.append(int(_select(invs, sing, len(pivots))[1]))
        return invs, sing
    return probe


@pytest.mark.parametrize("global_scale", [False, True])
@pytest.mark.parametrize("np_dt", DTYPES)
@pytest.mark.parametrize("gen,n,m", CASES)
def test_inverse_matches_jax(gen, n, m, np_dt, global_scale):
    a = np.array(jgenerate(gen, (n, n), np_dt))
    xj, sj, xt, st = _run_both(a, m, global_scale=global_scale)
    assert not sj and not st
    kappa = _inf(a) * _inf(xj)
    eps = np.finfo(np_dt).eps
    assert _inf(xt - xj) / _inf(xj) <= min(100 * eps * kappa, 0.1)
    assert xt.dtype == np_dt and xt.shape == (n, n)


@pytest.mark.parametrize("global_scale", [False, True])
@pytest.mark.parametrize("n", [13, 14, 16])
def test_hilbert_cliff_is_singular(n, global_scale):
    """The JAX goldens (tests/test_jordan.py): Hilbert from n = 13 on is
    singular at EPS = 1e-15 (one block, so both scales coincide)."""
    a = np.array(jgenerate("hilbert", (n, n), np.float64))
    _, sj, _, st = _run_both(a, n, global_scale=global_scale)
    assert sj and st


@pytest.mark.parametrize("n", [10, 12])
def test_hilbert_before_the_cliff_inverts(n):
    a = np.array(jgenerate("hilbert", (n, n), np.float64))
    _, sj, xt, st = _run_both(a, n, refine=2, global_scale=True)
    assert not sj and not st
    assert _inf(a @ xt - np.eye(n)) < 1.0


@pytest.mark.parametrize("global_scale", [False, True])
@pytest.mark.parametrize("a", [np.ones((8, 8)), np.zeros((8, 8))],
                         ids=["rank_one", "zero"])
def test_degenerate_input_is_singular(a, global_scale):
    _, sj, _, st = _run_both(a, 4, global_scale=global_scale)
    assert sj and st


@pytest.mark.parametrize("np_dt,big", [(np.float64, 1e16), (np.float32, 1e7)])
def test_only_the_global_scale_flags(np_dt, big):
    """diag(B1, big·B2): every block is invertible on its own scale, but
    B1's pivots fall under eps·‖A‖∞.  Both packages give the two verdicts
    the two scales call for."""
    rng = np.random.default_rng(3)
    a = np.zeros((16, 16))
    a[:8, :8] = rng.standard_normal((8, 8)) + 4 * np.eye(8)
    a[8:, 8:] = big * (rng.standard_normal((8, 8)) + 4 * np.eye(8))
    a = a.astype(np_dt)
    _, sj, _, st = _run_both(a, 8, global_scale=False)
    assert not sj and not st
    _, sj, _, st = _run_both(a, 8, global_scale=True)
    assert sj and st


@pytest.mark.parametrize("np_dt", DTYPES)
@pytest.mark.parametrize("gen,n,m", CASES)
def test_pivot_sequence_matches_jax_inplace(gen, n, m, np_dt):
    a = np.array(jgenerate(gen, (n, n), np_dt))
    _, _, stats = jj.block_jordan_invert_inplace(
        jnp.asarray(a), block_size=m, collect_stats=True)
    pivots = []
    _, st = block_jordan_invert(torch.from_numpy(a), block_size=m,
                                probe=recording_probe(pivots))
    assert not bool(st)
    assert pivots == np.asarray(stats["pivot_block"]).tolist()


def test_global_scale_reaches_the_probe():
    """With ``global_scale`` every superstep's probe gets ‖A‖∞ of the
    unpadded input (identity pad rows do not count)."""
    a = np.array(jgenerate("absdiff", (20, 20), np.float64))
    scales = []

    def probe(cands, eps, scale=None):
        scales.append(float(scale))
        return batched_block_inverse(cands, scale, eps)

    block_jordan_invert(torch.from_numpy(a), block_size=8, global_scale=True,
                        probe=probe)
    assert scales == [float(_inf(a))] * 3


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 40.0, 1e4])
@pytest.mark.parametrize("np_dt", DTYPES)
def test_plain_probe_with_a_scale_matches_jax(np_dt, scale):
    """The plain probe with a global scale against the JAX one on a stack
    of random blocks with a zero, a rank-deficient (a zero row), a
    non-finite and a scaled-down block: flags equal, inverses of the others
    within 1e-10 (fp64) or 1e-3 (fp32) relative.  (A duplicated row would
    leave a last pivot of rounding noise, ~1e-16·‖block‖∞, which a small
    scale puts on either side of the threshold by the order of the sums.)"""
    b = np.random.default_rng(7).standard_normal((6, 16, 16))
    b[1] = 0.0
    b[2, 15] = 0.0
    b[3, 8, 5] = np.nan
    b[4] *= 1e-6
    b = b.astype(np_dt)
    inv_j, sing_j = jplain(jnp.asarray(b), jnp.asarray(scale, np_dt))
    inv_t, sing_t = batched_block_inverse(torch.from_numpy(b), scale)
    sing_j = np.asarray(sing_j)
    np.testing.assert_array_equal(sing_t.numpy(), sing_j)
    ok = ~sing_j
    inv_j = np.asarray(inv_j)[ok]
    rel = _inf(inv_t.numpy()[ok] - inv_j) / _inf(inv_j)
    assert np.all(rel <= (1e-10 if np_dt == np.float64 else 1e-3))


def test_sub_fp32_input_round_trips_dtype():
    a = torch.from_numpy(np.array(jgenerate("kms", (32, 32), np.float32)))
    x, singular = block_jordan_invert(a.to(torch.bfloat16), block_size=8,
                                      global_scale=True)
    assert x.dtype == torch.bfloat16 and not bool(singular)


def test_engine_leaves_input_untouched():
    a = torch.from_numpy(np.array(jgenerate("rand", (40, 40), np.float64)))
    before = a.clone()
    block_jordan_invert(a, block_size=16, global_scale=True)
    assert torch.equal(a, before)


@pytest.mark.parametrize("m", [16, 50, 128])
def test_cpu_probe_with_a_scale_is_the_plain_version(m):
    """On a CPU stack the wrapper runs the plain version with the scale,
    whatever body m would take on the card, and counts no launch."""
    from tpu_jordan_torch.ops import gj_fused_panel as fp
    from tpu_jordan_torch.ops import gj_probe as probe_mod

    probe_mod.reset_launches()
    fp.reset_launches()
    b = torch.from_numpy(np.random.default_rng(m).standard_normal((5, m, m)))
    b[2] *= 1e-10
    scale = torch.tensor(1e7, dtype=torch.float64)
    inv, sing = probe_mod.gj_probe(b, None, scale)
    inv_p, sing_p = batched_block_inverse(b, scale)
    assert torch.equal(sing, sing_p) and sing.tolist() == [False, False,
                                                           True, False,
                                                           False]
    assert torch.equal(inv, inv_p)
    assert probe_mod.launches == 0 and fp.launches == 0


def test_scaled_launch_refuses_a_cpu_stack():
    from tpu_jordan_torch.ops import gj_probe as probe_mod

    with pytest.raises(ValueError, match="unsupported device"):
        probe_mod.launch_kernel(torch.eye(8)[None], 1e-7, scale=1.0)
