"""The port's SMW updates (``linalg/update.py``) and ``JordanSolver``
against the JAX package's, on the CPU.

The same numpy fixtures go through both packages, on the cases of
``tests/test_update.py`` and the single-device cases of
``tests/test_solver.py``.  Updated inverses agree within the JAX tests' own
tolerances (1e-4 absolute against numpy's inverse in fp32, 1e-3 relative
for the verification metrics) and within min(100·eps·κ∞, 0.1) of each
other (relative ∞-norm, eps the component dtype's machine epsilon, κ∞ of
the mutated matrix); singular verdicts, drift arithmetic, ladder rungs and
refusals are compared exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan.driver import SingularMatrixError as JSingular
from tpu_jordan.linalg import update as ju
from tpu_jordan.models import JordanSolver as JSolver
from tpu_jordan.obs.hwcost import baseline_workload_flops
from tpu_jordan.resilience import ResiliencePolicy as JPolicy

from tpu_jordan_torch.errors import SingularMatrixError, UsageError
from tpu_jordan_torch.linalg import (
    DRIFT_BUDGET_FACTOR,
    as_update_factors,
    drift_budget,
    drift_exceeded,
    smw_update,
    smw_update_with_metrics,
    solve_update,
    update_flops,
)
from tpu_jordan_torch.models import JordanSolver
from tpu_jordan_torch.resilience import ResidualGateError, ResiliencePolicy


def _factors(rng, n, k, dtype=np.float32, scale=None):
    s = (1.0 / np.sqrt(float(n) * k)) if scale is None else scale
    u = rng.standard_normal((n, k)) * s
    v = rng.standard_normal((n, k)) * s
    if np.dtype(dtype).kind == "c":
        u = u + 1j * rng.standard_normal((n, k)) * s
        v = v + 1j * rng.standard_normal((n, k)) * s
    return u.astype(dtype), v.astype(dtype)


def _matrix(rng, n, dtype=np.float32):
    a = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((n, n))
    return a.astype(dtype)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _inf(x):
    return np.abs(x).sum(axis=-1).max()


def _close(xt, xj, a_new, np_dt):
    xj = np.asarray(xj)
    kappa = _inf(a_new) * _inf(np.linalg.inv(a_new.astype(np.complex128)))
    tol = min(100 * np.finfo(np_dt).eps * kappa, 0.1)
    return _inf(np.asarray(xt) - xj) / _inf(xj) <= tol


# ---------------------------------------------------------- SMW identity


@pytest.mark.parametrize("np_dt", [np.float32, np.float64, np.complex64])
@pytest.mark.parametrize("n,k", [(40, 3), (64, 16)])
def test_matches_fresh_inverse_and_jax(np_dt, n, k):
    rng = np.random.default_rng(n + k)
    a = _matrix(rng, n, np_dt)
    inv = np.linalg.inv(a).astype(np_dt)
    u, v = _factors(rng, n, k, np_dt)
    got, sing = smw_update(*_t(inv, u, v))
    want_j, sing_j = ju.smw_update(jnp.asarray(inv), jnp.asarray(u),
                                   jnp.asarray(v))
    assert not bool(sing) and not bool(sing_j)
    assert got.dtype == getattr(torch, np.dtype(np_dt).name)
    want = np.linalg.inv(a + u @ v.T)
    assert np.abs(got.numpy() - want).max() < (
        1e-4 if np.finfo(np_dt).eps > 1e-10 else 1e-10)
    assert _close(got.numpy(), want_j, a + u @ v.T, np_dt)


def test_zero_pad_columns_exact():
    """Zero-padded U/V columns change no bits: they add nothing to U·Vᵀ
    and the capacitance's pad block is the identity."""
    rng = np.random.default_rng(0)
    n, k, kb = 24, 3, 8
    a = _matrix(rng, n)
    inv = np.linalg.inv(a).astype(np.float32)
    u, v = _factors(rng, n, k)
    up = np.zeros((n, kb), np.float32)
    vp = np.zeros((n, kb), np.float32)
    up[:, :k], vp[:, :k] = u, v
    bare, s1 = smw_update(*_t(inv, u, v))
    padded, s2 = smw_update(*_t(inv, up, vp))
    assert not bool(s1) and not bool(s2)
    assert torch.equal(bare, padded)


@pytest.mark.parametrize("np_dt", [np.float32, np.complex64])
def test_with_metrics_verifies_against_mutated_matrix(np_dt):
    rng = np.random.default_rng(1)
    n, k = 32, 2
    a = _matrix(rng, n, np_dt)
    inv = np.linalg.inv(a).astype(np_dt)
    u, v = _factors(rng, n, k, np_dt)
    a_new, inv_new, sing, kappa, rel = smw_update_with_metrics(
        *_t(a, inv, u, v))
    _, _, sing_j, kappa_j, rel_j = ju.smw_update_with_metrics(
        *(jnp.asarray(x) for x in (a, inv, u, v)))
    assert not bool(sing) and not bool(sing_j)
    assert np.allclose(a_new.numpy(), a + u @ v.T, atol=1e-6)
    r = np.abs(a_new.numpy() @ inv_new.numpy() - np.eye(n)).sum(-1).max()
    na = np.abs(a_new.numpy()).sum(-1).max()
    assert float(rel) == pytest.approx(r / na, rel=1e-3)
    assert rel.dtype == kappa.dtype == torch.float32
    assert float(kappa) == pytest.approx(float(kappa_j), rel=1e-3)
    assert float(rel) < 100 * np.finfo(np.float32).eps * float(kappa)
    assert float(rel_j) < 100 * np.finfo(np.float32).eps * float(kappa_j)


def test_sub_fp32_storage_rounds_once():
    rng = np.random.default_rng(2)
    n, k = 16, 2
    a = _matrix(rng, n)
    inv = np.linalg.inv(a)
    u, v = _factors(rng, n, k)
    got, sing = smw_update(*(x.to(torch.bfloat16) for x in _t(inv, u, v)))
    want, sing_j = ju.smw_update(jnp.asarray(inv, jnp.bfloat16),
                                 jnp.asarray(u, jnp.bfloat16),
                                 jnp.asarray(v, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and not bool(sing)
    assert not bool(sing_j)
    # fp32 inside, one rounding: within a bf16 ulp of the JAX result.
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-2)


# --------------------------------------------------- typed singularity


def test_rank_destroying_update_flags_capacitance():
    """u = −A·e₀, v = e₀ zeroes column 0: det(S) = 0 exactly; the port
    types it the way the JAX package does (its capacitance flag, or the
    gate)."""
    rng = np.random.default_rng(3)
    n = 12
    a = rng.standard_normal((n, n))
    inv = np.linalg.inv(a)
    u = -a[:, :1]
    v = np.zeros((n, 1))
    v[0, 0] = 1.0
    _, sing = smw_update(*_t(inv, u, v))
    _, sing_j = ju.smw_update(jnp.asarray(inv), jnp.asarray(u),
                              jnp.asarray(v))
    assert bool(sing) == bool(sing_j)
    with pytest.raises(SingularMatrixError):
        solve_update(a, inv, u, v, check=True, device="cpu")
    with pytest.raises(JSingular):
        ju.solve_update(a, inv, u, v, check=True)
    res = solve_update(a, inv, u, v, check=False, device="cpu")
    assert res.singular and res.inverse is None
    assert res.rel_residual == float("inf")


def test_lstsq_rank_deficient_gram_edge_typed():
    """A resident Gram inverse updated by a mutation that destroys A's
    column rank: typed as singular, or refused by the gate, never a
    garbage pseudo-inverse passed off as an inverse."""
    rng = np.random.default_rng(4)
    rows, n = 20, 6
    a = rng.standard_normal((rows, n))
    gram = a.T @ a
    a2 = a.copy()
    a2[:, 1] = a2[:, 0]
    w, q = np.linalg.eigh(a2.T @ a2 - gram)
    keep = np.abs(w) > 1e-12
    u, v = q[:, keep] * w[keep], q[:, keep]
    res = solve_update(gram, np.linalg.inv(gram), u, v, check=False,
                       device="cpu")
    res_j = ju.solve_update(gram, np.linalg.inv(gram), u, v, check=False)
    assert res.singular == res_j.singular
    if res.singular:
        assert res.inverse is None
    else:
        assert not np.isfinite(res.rel_residual) or res.rel_residual > 1e-3


# ----------------------------------------------------------- drift budget


def test_documented_budget_factor():
    assert DRIFT_BUDGET_FACTOR == ju.DRIFT_BUDGET_FACTOR == 4.0
    assert drift_budget(0.25) == ju.drift_budget(0.25) == 4.0 * 0.25


def test_exact_crossing_point():
    """Updates whose summed drift reaches the budget exactly pass (8·d ==
    budget); the first one past it fires, in both packages."""
    fired = []
    for exceeded, budget_of in ((drift_exceeded, drift_budget),
                                (ju.drift_exceeded, ju.drift_budget)):
        budget = budget_of(0.125)
        d, drift = budget / 8.0, 0.0
        for i in range(1, 12):
            drift += d
            if exceeded(drift, budget):
                fired.append(i)
                break
    assert fired == [9, 9]


@pytest.mark.parametrize("drift,budget,exceeded", [
    (float("nan"), 1.0, True), (1.0, float("nan"), True),
    (float("inf"), float("inf"), True), (0.0, 0.0, False),
    (1e-12, 0.0, True)])
def test_nan_hostile(drift, budget, exceeded):
    assert drift_exceeded(drift, budget) is exceeded
    assert ju.drift_exceeded(drift, budget) is exceeded


def test_factor_override():
    assert drift_budget(1.0, factor=0.0) == 0.0
    assert drift_exceeded(1e-12, drift_budget(1.0, factor=0.0))
    assert drift_budget(2.0, factor=3) == ju.drift_budget(2.0, factor=3)


@pytest.mark.parametrize("n,k", [(24, 2), (8192, 64)])
def test_update_flops_is_the_jax_convention(n, k):
    assert update_flops(n, k) == baseline_workload_flops(n, "update", k=k)


# ------------------------------------------------------- solve_update API


@pytest.mark.parametrize("np_dt", [np.float32, np.complex64])
def test_result_surface_and_drift_threading(np_dt):
    rng = np.random.default_rng(5)
    n, k = 24, 2
    a = _matrix(rng, n, np_dt)
    inv = np.linalg.inv(a).astype(np_dt)
    u, v = _factors(rng, n, k, np_dt)
    r1 = solve_update(a, inv, u, v, device="cpu")
    j1 = ju.solve_update(a, inv, u, v)
    assert r1.workload == "update" and r1.engine == "smw_update"
    assert (r1.n, r1.k) == (n, k) and r1.device == "cpu"
    assert r1.drift >= r1.rel_residual >= 0 and r1.gflops >= 0
    assert isinstance(r1.rel_residual, float) and isinstance(r1.kappa,
                                                             float)
    assert r1.kappa == pytest.approx(j1.kappa, rel=1e-3)
    assert _close(r1.inverse.numpy(), j1.inverse, a + u @ v.T, np_dt)
    u2, v2 = _factors(rng, n, k, np_dt)
    r2 = solve_update(r1.a_new, r1.inverse, u2, v2, drift=r1.drift,
                      device="cpu")
    assert r2.drift == pytest.approx(r1.drift + r2.rel_residual)
    assert r2.drift > r1.drift


@pytest.mark.parametrize("np_dt", [np.float32, np.complex64])
def test_policy_gate_and_re_invert_rung(np_dt):
    """A drift doctored past the budget fires the re_invert rung (a fresh
    elimination of the mutated matrix), which passes and resets the drift,
    as in the JAX package (real dtypes; its in-place engine refuses complex
    input, where the port re-inverts with the augmented engine)."""
    rng = np.random.default_rng(6)
    n, k = 24, 2
    a = _matrix(rng, n, np_dt)
    inv = np.linalg.inv(a).astype(np_dt)
    u, v = _factors(rng, n, k, np_dt)
    res = solve_update(a, inv, u, v, policy=ResiliencePolicy(), drift=1e9,
                       device="cpu")
    assert [r["rung"] for r in res.recovery] == ["re_invert"]
    assert res.recovery[0]["cause"] == "drift_budget"
    assert res.recovery[0]["passed"] and res.drift == 0.0
    assert _close(res.inverse.numpy(), np.linalg.inv(a + u @ v.T),
                  a + u @ v.T, np_dt)
    if np_dt == np.float32:
        rj = ju.solve_update(a, inv, u, v, policy=JPolicy(), drift=1e9)
        assert [sorted(r) for r in res.recovery] == [
            sorted(r) for r in rj.recovery]
        assert rj.drift == 0.0
    clean = solve_update(a, inv, u, v, policy=ResiliencePolicy(),
                         device="cpu")
    assert clean.recovery == () and clean.drift == clean.rel_residual


def test_exhausted_update_ladder_raises():
    """A gate no inverse can pass (gate_tol 1e-30): the update fails it,
    the re_invert rung fails it too, and the ladder raises with the rung
    on record, in both packages."""
    rng = np.random.default_rng(7)
    n, k = 24, 2
    a = _matrix(rng, n)
    inv = np.linalg.inv(a).astype(np.float32)
    u, v = _factors(rng, n, k)
    with pytest.raises(ResidualGateError, match="re_invert") as got:
        solve_update(a, inv, u, v, policy=ResiliencePolicy(gate_tol=1e-30),
                     device="cpu")
    from tpu_jordan.resilience import ResidualGateError as JGateError

    with pytest.raises(JGateError) as want:
        ju.solve_update(a, inv, u, v, policy=JPolicy(gate_tol=1e-30))
    rungs = [(r["rung"], r["cause"], r["passed"])
             for r in got.value.recovery]
    assert rungs == [("re_invert", "residual_gate", False)]
    assert rungs == [(r["rung"], r["cause"], r["passed"])
                     for r in want.value.recovery]


def test_shape_and_option_errors_typed():
    n = 8
    a = np.eye(n, dtype=np.float32)
    one = np.zeros((n, 1), np.float32)
    with pytest.raises(UsageError, match="matching"):
        solve_update(a, a, np.zeros((n, 2), np.float32),
                     np.zeros((n, 3), np.float32), device="cpu")
    with pytest.raises(UsageError, match="square"):
        solve_update(np.zeros((4, 8), np.float32), a, one, one,
                     device="cpu")
    with pytest.raises(UsageError, match="inv must match"):
        solve_update(a, np.eye(4, dtype=np.float32), one, one, device="cpu")
    with pytest.raises(UsageError, match="trace.*item 12"):
        solve_update(a, a, one, one, numerics="trace", device="cpu")
    with pytest.raises(UsageError, match="item 12"):
        solve_update(a, a, one, one, telemetry=object(), device="cpu")
    with pytest.raises(UsageError, match="ResiliencePolicy"):
        solve_update(a, a, one, one, policy=object(), device="cpu")


def test_as_update_factors_lifts_vectors():
    u, v, k = as_update_factors(np.ones(5), np.arange(5.0), 5,
                                torch.float32)
    assert k == 1 and u.shape == v.shape == (5, 1)
    assert u.dtype == torch.float32 and v[4, 0] == 4.0
    uj, vj, kj = ju.as_update_factors(np.ones(5), np.arange(5.0), 5,
                                      np.float32)
    assert kj == k and np.array_equal(vj, v.numpy())
    with pytest.raises(ValueError, match="matching"):
        as_update_factors(np.ones((4, 1)), np.ones((4, 1)), 5,
                          torch.float32)


def test_update_needs_a_card():
    from tpu_jordan_torch.errors import DeviceUnavailableError

    a = np.eye(4, dtype=np.float32)
    with pytest.raises(DeviceUnavailableError):
        solve_update(a, a, np.ones(4, np.float32), np.ones(4, np.float32))


# ------------------------------------------------------------ JordanSolver


def test_solver_single_device():
    rng = np.random.default_rng(0)
    s = JordanSolver(n=48, block_size=8, dtype=torch.float64, device="cpu")
    sj = JSolver(n=48, block_size=8, dtype=jnp.float64)
    a = rng.standard_normal((48, 48))
    inv, sing = s.invert(a)
    inv_j, _ = sj.invert(a)
    assert not bool(sing) and inv.dtype == torch.float64
    assert s.residual(a, inv) < 1e-9
    assert s.engine == sj.engine == "inplace"
    assert _close(inv.numpy(), inv_j, a, np.float64)


def test_solver_repeated_solves_reuse_its_engine():
    rng = np.random.default_rng(1)
    s = JordanSolver(n=32, block_size=8, dtype=torch.float64, device="cpu")
    run = s._run
    for _ in range(3):
        a = rng.standard_normal((32, 32))
        inv, sing = s.invert(a)
        assert not bool(sing)
        assert s.residual(a, inv) < 1e-9
    assert s._run is run


def test_solver_residual_before_invert():
    rng = np.random.default_rng(2)
    s = JordanSolver(n=32, block_size=8, dtype=torch.float64, device="cpu")
    a = rng.standard_normal((32, 32))
    assert s.residual(a, np.linalg.inv(a)) < 1e-9


def test_solver_shape_mismatch_raises():
    s = JordanSolver(n=16, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        s.invert(np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError, match="expected"):
        JSolver(n=16).invert(np.zeros((8, 8), np.float32))


def test_solver_sub_fp32_storage_dtype():
    rng = np.random.default_rng(3)
    s = JordanSolver(n=32, block_size=8, dtype="bfloat16", device="cpu")
    a = rng.standard_normal((32, 32)).astype(np.float32)
    inv, sing = s.invert(a)
    assert inv.dtype == torch.bfloat16 and not bool(sing)
    inv_j, _ = JSolver(n=32, block_size=8, dtype=jnp.bfloat16).invert(a)
    np.testing.assert_allclose(inv.float().numpy(),
                               np.asarray(inv_j, np.float32), rtol=2 ** -6,
                               atol=2e-2 * np.abs(np.linalg.inv(a)).max())


def test_solver_invert_batch():
    rng = np.random.default_rng(4)
    s = JordanSolver(n=24, block_size=8, device="cpu")
    a = rng.standard_normal((5, 24, 24)).astype(np.float32)
    inv, sing = s.invert_batch(a)
    inv_j, sing_j = JSolver(n=24, block_size=8).invert_batch(a)
    assert inv.shape == (5, 24, 24) and sing.shape == (5,)
    assert not sing.any() and not np.asarray(sing_j).any()
    np.testing.assert_allclose(inv.numpy(), np.linalg.inv(a), rtol=1e-2,
                               atol=1e-3)
    for b in range(5):
        assert _close(inv[b].numpy(), inv_j[b], a[b], np.float32)
    with pytest.raises(ValueError, match="expected"):
        s.invert_batch(np.zeros((2, 8, 8), np.float32))


def test_solver_complex_runs_augmented():
    rng = np.random.default_rng(5)
    a = _matrix(rng, 32, np.complex64)
    s = JordanSolver(n=32, block_size=8, dtype="complex64", device="cpu")
    assert (s.engine, s.group) == ("augmented", 0)
    inv, sing = s.invert(a)
    assert inv.dtype == torch.complex64 and not bool(sing)
    assert s.residual(a, inv) < 1e-3
    with pytest.raises(UsageError, match="real-dtype"):
        s.invert_batch(a[None])
    with pytest.raises(UsageError, match="complex dtype requires"):
        JordanSolver(n=32, dtype="complex64", engine="inplace",
                     device="cpu")


def test_solver_policy_retries_the_engine_call():
    from tpu_jordan_torch.resilience import RetryPolicy

    calls = []
    s = JordanSolver(n=16, block_size=8, dtype=torch.float64, device="cpu",
                     policy=ResiliencePolicy(retry=RetryPolicy(
                         max_retries=2, classify=lambda e: True,
                         sleep=lambda s: None)))
    run = s._run

    def flaky(a):
        calls.append(1)
        if len(calls) == 1:
            raise TimeoutError("transient")
        return run(a)

    s._run = flaky
    a = np.random.default_rng(6).standard_normal((16, 16))
    inv, sing = s.invert(a)
    assert len(calls) == 2 and not bool(sing)
    assert s.residual(a, inv) < 1e-9


@pytest.mark.parametrize("kwargs,item", [
    ({"workers": 2}, "item 15"), ({"workers": (2, 4)}, "item 15"),
    ({"gather": False}, "item 15"),
    ({"tune": True, "engine": "inplace"}, "engine='auto' only"),
    ({"plan_cache": "plans.json", "engine": "grouped"},
     "engine='auto' only"),
    ({"telemetry": object()}, "item 12")])
def test_solver_refuses_later_options_by_item(kwargs, item):
    with pytest.raises(UsageError, match=item):
        JordanSolver(n=16, device="cpu", **kwargs)


def test_solver_needs_a_card():
    from tpu_jordan_torch.errors import DeviceUnavailableError

    with pytest.raises(DeviceUnavailableError):
        JordanSolver(n=16)
