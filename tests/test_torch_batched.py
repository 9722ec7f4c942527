"""The port's batched engine against the JAX package's, on the CPU.

``tpu_jordan.ops.batched_jordan_invert`` picks one of three routes by
(B, Nr): the dedicated small-n engine (Nr ≤ 4, B ≥ 32), the vmapped
unrolled in-place engine, or the vmapped fori engine (Nr > 4 and
B·Nr ≥ 128).  The port has one engine for all; each route's case holds it
to the JAX result.  Flags are checked exactly; inverses agree within
min(100·eps·κ∞, 0.1) per element (relative ∞-norm, κ∞ from the JAX
inverse), the tolerance of ``test_torch_engine.py``.  Per-element pivot
sequences, taken through a recording ``probe=``, must equal the JAX
in-place engine's ``collect_stats=True`` record on the same element.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan import driver as jdriver
from tpu_jordan.ops import batched_jordan_invert as jbatched
from tpu_jordan.ops import jordan_inplace as jj
from tpu_jordan.ops import pad_with_identity as jpad

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.ops import block_inf_norms, probe_blocks
from tpu_jordan_torch.ops.batched import batched_jordan_invert
from tpu_jordan_torch.ops.jordan_inplace import block_jordan_invert_inplace

# (B, n, m, JAX route): smalln, the unrolled vmap, fori (Nr = 66 > 64).
ROUTES = [(32, 64, 16, "smalln"), (4, 96, 16, "unrolled"),
          (2, 132, 2, "fori")]


def _inf(x):
    return np.abs(x).sum(axis=-1).max(axis=-1)


def _stack(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def recording_probe(B, steps):
    """The default probe on the folded (B·nc, m, m) stack, recording each
    element's pivot block per superstep (the call index is the step)."""
    def probe(cands, eps):
        invs, sing = probe_blocks(cands, eps)
        key = torch.where(sing, float("inf"), block_inf_norms(invs))
        rel = torch.argmin(key.view(B, -1), dim=1)
        steps.append((rel + len(steps)).tolist())
        return invs, sing
    return probe


def _check_inverses(a, xj, xt, np_dt):
    eps = np.finfo(np_dt).eps
    for b in range(a.shape[0]):
        kappa = _inf(a[b]) * _inf(xj[b])
        assert (_inf(xt[b] - xj[b]) / _inf(xj[b])
                <= min(100 * eps * kappa, 0.1)), b


@pytest.mark.parametrize("np_dt", [np.float64, np.float32])
@pytest.mark.parametrize("B,n,m,route", ROUTES)
def test_route_matches_jax(B, n, m, route, np_dt):
    a = _stack((B, n, n), seed=B + n).astype(np_dt)
    xj, sj = jbatched(jnp.asarray(a), block_size=m)
    steps = []
    xt, st = batched_jordan_invert(torch.from_numpy(a), block_size=m,
                                   probe=recording_probe(B, steps))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert not st.any()
    assert len(steps) == -(-n // m)          # one probe call a superstep
    _check_inverses(a, np.asarray(xj), xt.numpy(), np_dt)
    assert xt.dtype == torch.from_numpy(a).dtype and xt.shape == (B, n, n)
    if route == "fori":
        return
    for b in range(B):
        _, _, stats = jj.block_jordan_invert_inplace(
            jnp.asarray(a[b]), block_size=m, collect_stats=True)
        assert [s[b] for s in steps] == np.asarray(
            stats["pivot_block"]).tolist(), b


def test_nested_batch_dims_match_jax():
    a = _stack((2, 3, 16, 16), seed=1)
    xj, sj = jbatched(jnp.asarray(a), block_size=8)
    xt, st = batched_jordan_invert(torch.from_numpy(a), block_size=8)
    assert xt.shape == (2, 3, 16, 16) and st.shape == (2, 3)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    _check_inverses(a.reshape(6, 16, 16), np.asarray(xj).reshape(6, 16, 16),
                    xt.numpy().reshape(6, 16, 16), np.float64)


def test_ragged_n_matches_jax():
    a = _stack((3, 50, 50), seed=2)
    xj, sj = jbatched(jnp.asarray(a), block_size=16)
    xt, st = batched_jordan_invert(torch.from_numpy(a), block_size=16)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert not st.any()
    _check_inverses(a, np.asarray(xj), xt.numpy(), np.float64)


def test_mixed_singular_and_regular_elements():
    good = _stack((8, 8), seed=3)
    a = np.stack([good, np.ones((8, 8)), 2 * good, np.zeros((8, 8))])
    xj, sj = jbatched(jnp.asarray(a), block_size=4)
    xt, st = batched_jordan_invert(torch.from_numpy(a), block_size=4)
    assert st.tolist() == np.asarray(sj).tolist() == [False, True, False,
                                                      True]
    _check_inverses(a[[0, 2]], np.asarray(xj)[[0, 2]], xt.numpy()[[0, 2]],
                    np.float64)


@pytest.mark.parametrize("np_dt", [np.float64, np.float32])
def test_one_element_is_the_single_engine(np_dt):
    """B = 1 through the batched engine against the port's in-place engine:
    the same pivots, inverses within 100·eps relative."""
    a = _stack((64, 64), seed=4).astype(np_dt)
    steps = []
    xb, sb = batched_jordan_invert(torch.from_numpy(a)[None], block_size=16,
                                   probe=recording_probe(1, steps))
    xs, ss, stats = block_jordan_invert_inplace(
        torch.from_numpy(a), block_size=16, collect_stats=True)
    assert not bool(sb[0]) and not bool(ss)
    assert [s[0] for s in steps] == stats["pivot_block"].tolist()
    eps = np.finfo(np_dt).eps
    assert _inf(xb[0].numpy() - xs.numpy()) / _inf(xs.numpy()) <= 100 * eps


def test_sub_fp32_input_round_trips_dtype():
    a = torch.from_numpy(_stack((3, 32, 32), seed=5)) + 8 * torch.eye(32)
    x, singular = batched_jordan_invert(a.to(torch.bfloat16), block_size=8)
    assert x.dtype == torch.bfloat16 and not singular.any()


def test_refine_reduces_residuals():
    a = torch.from_numpy(_stack((4, 48, 48), seed=6)).float()
    x0, _ = batched_jordan_invert(a, block_size=16)
    x1, _ = batched_jordan_invert(a, block_size=16, refine=1)
    r0 = tdriver.batch_metrics(a, x0)["residual"]
    r1 = tdriver.batch_metrics(a, x1)["residual"]
    assert bool((r1 < r0).all())


def _rough_inverse(a, seed):
    """inv(a) with a relative error of 1e-3 an entry, so that the residual
    is far above the rounding of either package's product."""
    return np.linalg.inv(a) * (1 + 1e-3 * _stack(a.shape, seed))


def test_batch_metrics_match_jax():
    a = _stack((3, 24, 24), seed=7)
    x = _rough_inverse(a, seed=9)
    ref = jdriver.batch_metrics(jnp.asarray(a), jnp.asarray(x))
    got = tdriver.batch_metrics(torch.from_numpy(a), torch.from_numpy(x))
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-12)


def test_batch_metrics_mask_identity_padding_as_jax():
    """tests/test_batched.py's case through both packages: the n_real mask
    keeps pad rows out of the norms, and an all-masked filler element
    reports zeros, not NaN."""
    a = 0.01 * _stack((24, 24), seed=8)
    pad = np.array(jpad(jnp.asarray(a), 32))[None]
    x = _rough_inverse(pad, seed=10)
    want_norm = float(_inf(a))
    for n_real in ([24], [0]):
        ref = jdriver.batch_metrics(jnp.asarray(pad), jnp.asarray(x),
                                    n_real=jnp.asarray(n_real))
        got = tdriver.batch_metrics(torch.from_numpy(pad),
                                    torch.from_numpy(x), n_real=n_real)
        for key in ref:
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(ref[key]), rtol=1e-12)
    masked = tdriver.batch_metrics(torch.from_numpy(pad),
                                   torch.from_numpy(x), n_real=[24])
    unmasked = tdriver.batch_metrics(torch.from_numpy(pad),
                                     torch.from_numpy(x))
    assert float(masked["norm_a"][0]) == pytest.approx(want_norm)
    assert float(unmasked["norm_a"][0]) == pytest.approx(1.0)
    filler = tdriver.batch_metrics(torch.from_numpy(pad),
                                   torch.from_numpy(x), n_real=[0])
    assert float(filler["rel_residual"][0]) == 0.0
    assert float(filler["kappa"][0]) == 0.0


def test_gate_miss_is_the_algorithms():
    """Element 6 of the 16 × 128² rand fp32 batch (the windows of
    ``solve_batch``) misses the gate min(3·eps·n·κ∞/‖A‖∞, 0.5) in both
    packages, with the same pivots: the condition-based block pivot lets
    the elimination grow, and no tolerance of the port's hides it."""
    from tpu_jordan_torch.ops import generate_batch

    B, n, m, b = 16, 128, 32, 6
    a = generate_batch("rand", n, B, torch.float32)
    steps = []
    xt, st = batched_jordan_invert(a, block_size=m,
                                   probe=recording_probe(B, steps))
    ab = a[b].numpy()
    xj, sj, stats = jj.block_jordan_invert_inplace(
        jnp.asarray(ab), block_size=m, collect_stats=True)
    assert not st.any() and not bool(sj)
    assert [s[b] for s in steps] == np.asarray(
        stats["pivot_block"]).tolist()
    eps = np.finfo(np.float32).eps
    for x in (xt[b].numpy(), np.asarray(xj)):
        rel = _inf(ab @ x.astype(np.float64) - np.eye(n)) / _inf(ab)
        assert rel > min(3 * eps * n * _inf(x), 0.5)
