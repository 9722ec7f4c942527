"""The dispatch probe's panel body (``ops/gj_fused_panel.py``) against the
JAX package's ``_gj_fused_panel_kernel``, on the CPU.

``gj_fused_panel_plain`` is held against the JAX kernel run in interpret
mode: at m = 128 through ``pallas_batched_block_inverse`` (which dispatches
to that kernel), and at m = 32 and 64 by launching the kernel partial
through ``_run_probe_kernel`` as ``_dispatch_probe`` does.  The stacks are
``test_torch_probe.py``'s (random blocks with a zero block, a duplicated
row, NaN and inf): flags equal, regular inverses within
min(eps32·m·κ∞(block), 1e-3) relative.  Against the plain probe the twin
must give equal flags within the same tolerance, in fp32 and fp64.

Accuracy against the rank-1 algebra (``gj_inplace_plain``, which
``csrc/gj_probe.cu`` runs): per regular block the ratio of the residuals
‖B·inv − I‖∞ reads 0.03–2.0 on these stacks (mean 0.9–1.3), because the
JAX kernel's fp32 deferred product W + U·P rounds where the rank-1 steps do
not; v2's normalized algebra reads 2.7–4.0× on the card.  The test holds
the mean ratio of a stack to 1.5 and every block to 2.5×.

The route, and one inplace-engine run with the twin as ``probe=``, whose
pivot sequence must equal the JAX engine's.
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
from tpu_jordan_torch.ops import batched_block_inverse, gj_fused_panel_plain
from tpu_jordan_torch.ops import gj_inplace_plain
from tpu_jordan_torch.ops import gj_fused_panel as fp
from tpu_jordan_torch.ops import gj_probe as probe_mod
from tpu_jordan_torch.ops import jordan_inplace as tj

EPS32 = 5e-7  # eps_for(float32), the JAX dispatch's default


def test_twin_matches_jax_dispatch_at_m128():
    b = _stack(5, 128, np.float32, seed=500)
    inv_ref, sing_ref = pbi.pallas_batched_block_inverse(jnp.asarray(b),
                                                         interpret=True)
    inv, sing = gj_fused_panel_plain(torch.from_numpy(b), EPS32)
    _check(b, np.asarray(inv_ref), np.asarray(sing_ref), inv.numpy(),
           sing.numpy(), _tol(np.float32))


@pytest.mark.parametrize("m", [32, 64])
def test_twin_matches_jax_panel_kernel(m):
    b = _stack(6, m, np.float32, seed=500 + m)
    kernel = functools.partial(pbi._gj_fused_panel_kernel, m=m,
                               b=pbi._panel_width(m), eps=EPS32, hc=1)
    inv_ref, sing_ref = pbi._run_probe_kernel(
        jnp.asarray(b), kernel, m, True, pbi._fused_budget(m),
        width_factor=1)
    inv, sing = gj_fused_panel_plain(torch.from_numpy(b), EPS32)
    _check(b, np.asarray(inv_ref), np.asarray(sing_ref), inv.numpy(),
           sing.numpy(), _tol(np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [16, 64])
def test_twin_matches_plain_probe(m, dtype):
    eps = EPS32 if dtype == np.float32 else 1e-15
    b = _stack(6, m, dtype, seed=600 + m)
    inv_p, sing_p = batched_block_inverse(torch.from_numpy(b), None, eps)
    inv, sing = gj_fused_panel_plain(torch.from_numpy(b), eps)
    _check(b, inv_p.numpy(), sing_p.numpy(), inv.numpy(), sing.numpy(),
           _tol(dtype))


@pytest.mark.parametrize("m", [16, 64])
def test_twin_residual_beside_rank1(m):
    b = _stack(8, m, np.float32, seed=700 + m)
    inv, sing = gj_fused_panel_plain(torch.from_numpy(b), EPS32)
    inv_r, sing_r = gj_inplace_plain(torch.from_numpy(b), EPS32)
    assert torch.equal(sing, sing_r)
    ok = ~sing.numpy()
    eye = np.eye(m)
    bd = b[ok].astype(np.float64)
    res = _inf(bd @ inv.numpy()[ok].astype(np.float64) - eye)
    res_r = _inf(bd @ inv_r.numpy()[ok].astype(np.float64) - eye)
    ratio = res / res_r
    assert ratio.mean() <= 1.5 and ratio.max() <= 2.5, ratio


@pytest.mark.parametrize("m,body", [
    (8, "gj_probe"), (16, "gj_fused_panel"), (50, "gj_probe"),
    (64, "gj_fused_panel"), (128, "gj_fused_panel"),
    (384, "gj_fused_panel"), (512, "gj_fused_panel")])
def test_route_by_panel_width(m, body):
    expected = "gj_probe_fused_panel" if body == "gj_fused_panel" else body
    assert probe_mod.probe_body(m) == expected
    assert fp.takes_panel_body(m) == (fp.panel_width(m) is not None)
    assert fp.panel_width(m) == pbi._panel_width(m)


def test_route_beyond_one_thread_per_row():
    """A width divides m = 1536, but one thread a row cannot hold it."""
    assert fp.panel_width(1536) == 32
    assert probe_mod.probe_body(1536) == "gj_probe"


def test_cpu_probe_counts_no_launch_of_either_body():
    probe_mod.reset_launches()
    fp.reset_launches()
    b = torch.from_numpy(_stack(6, 64, np.float32, seed=8))
    inv, sing = probe_mod.gj_probe(b)
    inv_p, sing_p = batched_block_inverse(b)
    assert torch.equal(sing, sing_p)
    assert torch.equal(inv.nan_to_num(), inv_p.nan_to_num())
    assert probe_mod.launches == 0 and fp.launches == 0


def test_launch_refuses_a_cpu_stack():
    with pytest.raises(ValueError, match="unsupported device"):
        fp.launch_fused_panel(torch.eye(64)[None], EPS32)


def test_twin_without_width_raises():
    with pytest.raises(ValueError, match="no panel width divides m=12"):
        gj_fused_panel_plain(torch.eye(12)[None], EPS32)


@pytest.mark.parametrize("gen", ["rand", "absdiff"])
def test_inplace_engine_with_twin_matches_jax_pivots(gen):
    n, m = 128, 32
    a = np.array(jgenerate(gen, (n, n), np.float32))
    xj, sj, st = jj.block_jordan_invert_inplace(jnp.asarray(a), block_size=m,
                                                collect_stats=True)
    xt, s, stats = tj.block_jordan_invert_inplace(
        torch.from_numpy(a), block_size=m, collect_stats=True,
        probe=gj_fused_panel_plain)
    assert not bool(sj) and not bool(s)
    np.testing.assert_array_equal(stats["pivot_block"].numpy(),
                                  np.asarray(st["pivot_block"]))
    xj = np.asarray(xj)
    kappa = _inf(a) * _inf(xj)
    eps = np.finfo(np.float32).eps
    assert _inf(xt.numpy() - xj) / _inf(xj) <= min(100 * eps * kappa, 0.1)
