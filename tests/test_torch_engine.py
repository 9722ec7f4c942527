"""The port's elimination engines against the JAX package's, on the CPU.

The same numpy fixture goes through ``block_jordan_invert_inplace`` /
``_grouped`` of both packages with ``collect_stats=True``.  Pivot sequences
are decided by no floating-point tie here and must be equal; inverses agree
within min(100·eps·κ∞, 0.1) (relative ∞-norm, eps the dtype's machine
epsilon, κ∞ from the reference inverse): the frameworks sum products in
another order.  The readings stay within 20·eps·κ∞.  In fp32 the cap
binds from κ∞ ≈ 8.4e3 up; the largest reading, 0.067, is at (128, 32)
rand, where κ∞ ≈ 1.5e5.
The per-step count of singular candidates is not compared exactly: on
absdiff the late Schur-complement blocks are rank-deficient, their pivots
are rounding noise near eps·‖block‖∞, and at (64, 8) one of them is flagged
on one side only (ROADMAP.md Queue C); its key is far above the pivot's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan.ops import generate as jgenerate
from tpu_jordan.ops import jordan_inplace as jj

from tpu_jordan_torch.ops import jordan_inplace as tj

SHAPES = [(64, 8), (50, 8), (96, 16), (128, 32)]
DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]
ENGINES = {
    "inplace": (jj.block_jordan_invert_inplace, tj.block_jordan_invert_inplace,
                {}),
    "grouped": (jj.block_jordan_invert_inplace_grouped,
                tj.block_jordan_invert_inplace_grouped, {"group": 2}),
}


def _inf(x):
    return np.abs(x).sum(axis=-1).max()


def _run_both(engine, a, m):
    jfn, tfn, kw = ENGINES[engine]
    xj, sj, stj = jfn(jnp.asarray(a), block_size=m, collect_stats=True, **kw)
    xt, st, stt = tfn(torch.from_numpy(a), block_size=m, collect_stats=True,
                      **kw)
    return (np.asarray(xj), bool(sj), {k: np.asarray(v) for k, v in
                                       stj.items()},
            xt.numpy(), bool(st), {k: v.numpy() for k, v in stt.items()})


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
@pytest.mark.parametrize("gen", ["absdiff", "rand"])
@pytest.mark.parametrize("n,m", SHAPES)
def test_engine_matches_jax(engine, np_dt, t_dt, gen, n, m):
    a = np.array(jgenerate(gen, (n, n), np_dt))
    xj, sj, stj, xt, st, stt = _run_both(engine, a, m)
    assert not sj and not st
    np.testing.assert_array_equal(stt["pivot_block"], stj["pivot_block"])
    assert sorted(stt) == sorted(stj)
    eps = np.finfo(np_dt).eps
    kappa = _inf(a) * _inf(xj)
    assert _inf(xt - xj) / _inf(xj) <= min(100 * eps * kappa, 0.1)
    assert xt.dtype == np_dt and xt.shape == (n, n)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_singular_input_is_flagged(engine):
    """A rank-1 matrix: every candidate of the first column is singular."""
    a = np.ones((64, 64))
    _, sj, _, _, st, stt = _run_both(engine, a, 8)
    assert sj and st
    assert stt["singular_candidates"][0] == 8


def test_stats_values_match_jax():
    """Beyond the pivots, the record's values: per-step key minima and
    growth agree to rounding (rtol 1e-8 in fp64)."""
    a = np.array(jgenerate("rand", (64, 64), np.float64))
    for engine in ENGINES:
        _, _, stj, _, _, stt = _run_both(engine, a, 8)
        for key in ("pivot_inv_norm", "cand_norm_max", "growth"):
            np.testing.assert_allclose(stt[key], stj[key], rtol=1e-8)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_probe_argument_is_the_engines_probe(engine):
    """The ``probe`` argument replaces the candidate inverter: passing the
    plain version gives the default's result on the CPU, and every
    superstep goes through the probe it was given."""
    from tpu_jordan_torch.ops import batched_block_inverse

    _, tfn, kw = ENGINES[engine]
    a = torch.from_numpy(np.array(jgenerate("rand", (48, 48), np.float64)))
    calls = []

    def plain(cands, eps):
        calls.append(cands.shape[0])
        return batched_block_inverse(cands, None, eps)

    x0, s0 = tfn(a, block_size=8, **kw)
    x1, s1 = tfn(a, block_size=8, probe=plain, **kw)
    assert torch.equal(x0, x1) and not bool(s0) and not bool(s1)
    assert calls == [6, 5, 4, 3, 2, 1]


def test_engine_leaves_input_untouched():
    a = torch.from_numpy(np.array(jgenerate("rand", (32, 32), np.float64)))
    before = a.clone()
    tj.block_jordan_invert_inplace(a, block_size=8)
    tj.block_jordan_invert_inplace_grouped(a, block_size=8, group=2)
    assert torch.equal(a, before)


def test_sub_fp32_input_round_trips_dtype():
    a = torch.from_numpy(np.array(jgenerate("kms", (32, 32), np.float32)))
    x, singular = tj.block_jordan_invert_inplace(a.to(torch.bfloat16),
                                                 block_size=8)
    assert x.dtype == torch.bfloat16 and not bool(singular)


def test_refine_reduces_residual():
    a = torch.from_numpy(np.array(jgenerate("rand", (64, 64), np.float32)))
    eye = torch.eye(64)

    def res(x):
        return float((a @ x - eye).abs().sum(dim=1).max())

    x0, _ = tj.block_jordan_invert_inplace(a, block_size=16)
    x1, _ = tj.block_jordan_invert_inplace(a, block_size=16, refine=1)
    assert res(x1) < res(x0)


@pytest.mark.parametrize("swaps", [[0, 1, 2, 3], [2, 3, 2, 3], [3, 1, 3, 3]])
def test_swap_perm_and_apply_match_jax(swaps):
    Nr, m = 4, 3
    cols_j = np.asarray(jj.compose_swap_perm(jnp.asarray(swaps), Nr))
    cols_t = tj.compose_swap_perm(swaps, Nr)
    np.testing.assert_array_equal(cols_t, cols_j)
    v = np.arange(2 * Nr * m * Nr * m, dtype=np.float64).reshape(
        2, Nr * m, Nr * m)
    ref = np.asarray(jj.apply_col_perm(jnp.asarray(v), jnp.asarray(cols_j),
                                       m))
    got = tj.apply_col_perm(torch.from_numpy(v), cols_t, m).numpy()
    np.testing.assert_array_equal(got, ref)
