"""The port's fused group-closing update against the JAX package's, on the
CPU.

The same numpy operands, built to the caller contract as
``tests/test_pallas_update.py::_operands`` builds them, go through the JAX
``fused_normalize_eliminate(..., interpret=True)`` (the Pallas kernel run in
interpret mode) and the port's ``fused_normalize_eliminate`` on CPU tensors
(its plain version).  The H block of the output must be exact (atol 0) in
both modes.  Elsewhere the max abs difference, divided by
KM·max|U|·max|P_eff|, stays below 1e-6 in both modes: each output sums KM
products in another order, so the two differ by a few fp32 roundings of
that scale (eps32 ≈ 1.2e-7).  In bf16 mode both sides round the same
operands to bf16 and the products are exact, so the same limit holds; it
would not survive a prow element rounded to bf16 on the other side of a
midpoint (one term moves by 2^-8 relative), which these operands do not
meet.  The readings stay at or below 5.3e-9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan.ops.pallas_update import fused_normalize_eliminate as jfused

from tpu_jordan_torch.ops import fused_update as fu

CASES = [(4, 16, 2, 1, 1), (4, 16, 2, 1, 3), (4, 16, 2, 0, 0),
         (6, 16, 4, 3, 3)]


def _operands(seed, Nr, m, k, j, t):
    """``tests/test_pallas_update.py::_operands``, in numpy: U's pivot rows
    zero, P's closing slot zero, P's earlier pivot-column block zero."""
    rng = np.random.default_rng(seed)
    N, KM = Nr * m, k * m
    V = rng.standard_normal((N, N)).astype(np.float32)
    U = rng.standard_normal((N, KM)).astype(np.float32)
    U[t * m:(t + 1) * m] = 0.0
    P = rng.standard_normal((KM, N)).astype(np.float32)
    P[j * m:(j + 1) * m] = 0.0
    P[:j * m, t * m:(t + 1) * m] = 0.0
    H = rng.standard_normal((m, m)).astype(np.float32)
    rows_p = rng.standard_normal((m, N)).astype(np.float32)
    return V, U, P, H, rows_p


def _scaled_diff(got, ref, U, P, t, j, m):
    """max|got − ref| / (KM·max|U|·max|P_eff|), P_eff = P with slot j
    holding the reference's pivot rows."""
    p_eff = P.copy()
    p_eff[j * m:(j + 1) * m] = ref[t * m:(t + 1) * m]
    scale = U.shape[1] * np.abs(U).max() * np.abs(p_eff).max()
    return float(np.abs(got - ref).max() / scale)


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("Nr,m,k,j,t", CASES)
def test_matches_jax_kernel(Nr, m, k, j, t, mode):
    ops = _operands(Nr * 100 + t * 10 + j, Nr, m, k, j, t)
    V, U, P, H, rows_p = ops
    ref = np.asarray(jfused(*map(jnp.asarray, ops), t=t, j=j, m=m,
                            mode=mode, interpret=True))
    fu.reset_launches()
    got_t = fu.fused_normalize_eliminate(
        *(torch.from_numpy(x.copy()) for x in ops), t=t, j=j, m=m, mode=mode)
    got = got_t.numpy()
    s = slice(t * m, (t + 1) * m)
    np.testing.assert_array_equal(got[s, s], H)
    np.testing.assert_array_equal(ref[s, s], H)
    assert _scaled_diff(got, ref, U, P, t, j, m) <= 1e-6
    assert fu.launches == 0          # the CPU runs the plain version


def test_updates_v_in_place():
    ops = [torch.from_numpy(x) for x in _operands(0, 4, 8, 2, 1, 2)]
    out = fu.fused_normalize_eliminate(*ops, t=2, j=1, m=8)
    assert out is ops[0]


def test_bf16_rounds_the_operands():
    """bf16 mode differs from fp32 mode by bf16-grade amounts, and the
    plain version's sequential prow equals a matmul of the bf16-rounded
    operands within 16·eps32 of the sum of |terms| (summation order)."""
    ops = _operands(7, 4, 16, 2, 1, 1)
    f32 = fu.fused_normalize_eliminate_plain(
        *(torch.from_numpy(x.copy()) for x in ops), t=1, j=1, m=16)
    b16 = fu.fused_normalize_eliminate_plain(
        *(torch.from_numpy(x.copy()) for x in ops), t=1, j=1, m=16,
        mode="bf16")
    diff = float((f32 - b16).abs().max() / f32.abs().max())
    assert 1e-5 < diff < 0.05
    hb, rb = (torch.from_numpy(x).bfloat16().float() for x in ops[3:])
    prow = hb @ rb
    prow[:, 16:32] = torch.from_numpy(ops[3])
    terms = (hb.abs() @ rb.abs()).max()
    assert float((b16[16:32] - prow).abs().max()) <= 16 * 2.0**-23 * terms


def test_unknown_mode_refused():
    ops = [torch.from_numpy(x) for x in _operands(1, 2, 8, 2, 1, 0)]
    with pytest.raises(ValueError, match="precision mode"):
        fu.fused_normalize_eliminate(*ops, t=0, j=1, m=8, mode="fp64")


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4])
def test_non_fp32_operands_refused(which):
    ops = [torch.from_numpy(x) for x in _operands(2, 2, 8, 2, 1, 0)]
    ops[which] = ops[which].double()
    with pytest.raises(TypeError, match="float32"):
        fu.fused_normalize_eliminate(*ops, t=0, j=1, m=8)


@pytest.mark.parametrize("bad", ["t", "j", "m", "shape"])
def test_contract_violations_refused(bad):
    ops = [torch.from_numpy(x) for x in _operands(3, 2, 8, 2, 1, 0)]
    kw = {"t": 0, "j": 1, "m": 8}
    if bad == "shape":
        ops[4] = ops[4][:, :8]
    elif bad == "m":
        kw["m"] = 5
    else:
        kw[bad] = 2
    with pytest.raises(ValueError):
        fu.fused_normalize_eliminate(*ops, **kw)
