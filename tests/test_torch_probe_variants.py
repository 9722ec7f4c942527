"""The port's probe variants (v3 in place, v2 panels) against the JAX
package's, on the CPU.

``gj_inplace_plain`` and ``gj_panel_plain`` are held against the JAX entry
points ``pallas_batched_block_inverse_inplace`` / ``_panel`` run in
interpret mode, on the seeded stacks of ``test_torch_probe.py`` (random
blocks with a zero block, a duplicated row, NaN and inf): flags equal, and
inverses of the regular blocks within min(eps32·m·κ∞(block), 1e-3) in
relative ∞-norm (the same algebra summed in another order).  Each twin is
also held against the port's ``batched_block_inverse`` at the JAX suite's
tolerance for these kernels (rtol 2e-3, atol 1e-3, ``test_pallas_probe.py``).
The engines run with each variant as their ``probe=`` against the JAX
engines with their plain probe: equal pivot sequences, inverses within
``test_torch_engine.py``'s min(100·eps·κ∞, 0.1).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan.ops import generate as jgenerate
from tpu_jordan.ops import jordan_inplace as jj
from tpu_jordan.ops import pallas_block_inverse as pbi

from test_torch_probe import _check, _inf, _stack, _tol
from tpu_jordan_torch.ops import (
    batched_block_inverse,
    gj_inplace_plain,
    gj_panel_plain,
    gj_probe_inplace,
    gj_probe_panel,
    panel_width,
)
from tpu_jordan_torch.ops import gj_probe as probe_mod
from tpu_jordan_torch.ops import jordan_inplace as tj
from tpu_jordan_torch.ops import probe_variants as pv

EPS32 = 5e-7  # eps_for(float32), the entry points' default

VARIANTS = {
    "inplace": (gj_inplace_plain, gj_probe_inplace,
                pbi.pallas_batched_block_inverse_inplace),
    "panel": (gj_panel_plain, gj_probe_panel,
              pbi.pallas_batched_block_inverse_panel),
}


@pytest.mark.parametrize("name,m", [("inplace", 8), ("inplace", 16),
                                    ("inplace", 32), ("inplace", 128),
                                    ("panel", 16), ("panel", 32),
                                    ("panel", 48), ("panel", 64)])
def test_twin_matches_jax_kernel(name, m):
    twin, _, jkernel = VARIANTS[name]
    b = _stack(6 if m < 128 else 5, m, np.float32, seed=200 + m)
    inv_ref, sing_ref = jkernel(jnp.asarray(b), interpret=True)
    inv, sing = twin(torch.from_numpy(b), EPS32)
    _check(b, np.asarray(inv_ref), np.asarray(sing_ref), inv.numpy(),
           sing.numpy(), _tol(np.float32))


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("m", [16, 64])
def test_twin_matches_plain_probe(name, m):
    twin = VARIANTS[name][0]
    b = torch.from_numpy(_stack(6, m, np.float32, seed=300 + m))
    inv, sing = twin(b, EPS32)
    inv_p, sing_p = batched_block_inverse(b, None, EPS32)
    assert torch.equal(sing, sing_p) and bool(sing[1:5].all())
    ok = ~sing_p
    np.testing.assert_allclose(inv[ok].numpy(), inv_p[ok].numpy(),
                               rtol=2e-3, atol=1e-3)


def test_panel_width_matches_jax():
    assert [panel_width(m) for m in range(1, 521)] == [
        pbi._panel_width(m) for m in range(1, 521)]


@pytest.mark.parametrize("m", [8, 12])
def test_panel_without_width_raises(m):
    b = torch.eye(m)[None]
    with pytest.raises(ValueError, match=f"no panel width divides m={m}"):
        gj_probe_panel(b)
    with pytest.raises(ValueError, match=f"no panel width divides m={m}"):
        gj_panel_plain(b, EPS32)
    with pytest.raises(ValueError, match="panel width"):
        pbi.pallas_batched_block_inverse_panel(jnp.eye(m, dtype=jnp.float32)
                                               [None], interpret=True)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_cpu_wrapper_is_the_twin(name):
    """On the CPU a wrapper returns its twin's result bit for bit, an fp64
    stack comes back fp32 (the JAX entry points cast), and no launch is
    counted."""
    twin, wrapper, _ = VARIANTS[name]
    pv.reset_launches()
    probe_mod.reset_launches()
    b = _stack(6, 16, np.float64, seed=7)
    inv, sing = wrapper(torch.from_numpy(b))
    inv_t, sing_t = twin(torch.from_numpy(b.astype(np.float32)), EPS32)
    assert inv.dtype == torch.float32 and sing.dtype == torch.bool
    assert torch.equal(sing, sing_t)
    assert torch.equal(inv.nan_to_num(), inv_t.nan_to_num())
    assert pv.launches == {"inplace": 0, "panel": 0}
    assert probe_mod.launches == 0


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("shape", [(4, 4), (2, 4, 5)])
def test_wrapper_rejects_bad_shapes(name, shape):
    with pytest.raises(ValueError):
        VARIANTS[name][1](torch.zeros(shape))


ENGINES = {
    "inplace": (jj.block_jordan_invert_inplace, tj.block_jordan_invert_inplace,
                {}),
    "grouped": (jj.block_jordan_invert_inplace_grouped,
                tj.block_jordan_invert_inplace_grouped, {"group": 2}),
}


@functools.cache
def _jax_run(engine, gen, n, m):
    jfn, _, kw = ENGINES[engine]
    a = np.array(jgenerate(gen, (n, n), np.float32))
    x, s, st = jfn(jnp.asarray(a), block_size=m, collect_stats=True, **kw)
    return a, np.asarray(x), bool(s), np.asarray(st["pivot_block"])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("gen", ["rand", "kms"])
@pytest.mark.parametrize("n,m", [(128, 32), (96, 16)])
def test_engine_with_variant_matches_jax(variant, engine, gen, n, m):
    a, xj, sj, pivots_j = _jax_run(engine, gen, n, m)
    _, tfn, kw = ENGINES[engine]
    xt, st, stats = tfn(torch.from_numpy(a), block_size=m,
                        collect_stats=True, probe=VARIANTS[variant][1], **kw)
    assert not sj and not bool(st)
    np.testing.assert_array_equal(stats["pivot_block"].numpy(), pivots_j)
    eps = np.finfo(np.float32).eps
    kappa = _inf(a) * _inf(xj)
    assert _inf(xt.numpy() - xj) / _inf(xj) <= min(100 * eps * kappa, 0.1)


@pytest.mark.parametrize("m,expected", [
    (16, ("cluster", 1)), (128, ("cluster", 1)), (256, ("cluster", 4)),
    (384, ("cluster", 8)), (512, ("cluster", 16)), (600, ("cluster", 16)),
    (768, ("l2", 1)), (1536, ("l2", 1))])
def test_panel_schedule_by_shape(m, expected):
    assert pv.panel_schedule(m) == expected
    b = panel_width(m)
    if expected[0] == "cluster":
        c = expected[1]
        assert pv.panel_smem_bytes(m, b, c) <= probe_mod.SMEM_LIMIT
        assert c == 1 or pv.panel_smem_bytes(m, b, c // 2) > \
            probe_mod.SMEM_LIMIT


@pytest.mark.parametrize("limit,expected", [
    (10**6, ("cluster", 1)), (200_000, ("cluster", 4)),
    (100_000, ("cluster", 16)), (60_000, ("l2", 1))])
def test_panel_schedule_takes_the_smem_limit(limit, expected):
    assert pv.panel_schedule(256, smem_limit=limit) == expected


def test_panel_schedule_needs_a_width():
    with pytest.raises(ValueError, match="no panel width divides m=300"):
        pv.panel_schedule(300)
