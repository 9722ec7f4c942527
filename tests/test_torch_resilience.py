"""The port's residual gate, degradation ladder and retry policy against the
JAX package's, on the CPU: the tier-1 cases of
``tests/test_mixed_precision.py::TestGroupedPallasBf16Path`` through both
packages' ``solve``, and the policy's pure functions side by side.

Tolerances are the JAX tests' own: a bf16-grade rel residual below 0.05 on
the well-conditioned file, and below 1e-3 after an fp32 re-solve.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan import driver as jdriver
from tpu_jordan.io import write_matrix_file
from tpu_jordan.resilience import degrade as jdegrade
from tpu_jordan.resilience import policy as jpolicy

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.resilience import degrade as tdegrade
from tpu_jordan_torch.resilience import policy as tpolicy


def _well_conditioned_file(tmp_path, n):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    path = str(tmp_path / "wc.mat")
    write_matrix_file(path, a)
    return path


def test_well_conditioned_bf16_passes_gate_with_zero_rungs(tmp_path):
    """The default policy is attached without a policy argument; the gate
    at bf16 eps passes a bf16-grade residual outright."""
    n = 64
    path = _well_conditioned_file(tmp_path, n)
    ref = jdriver.solve(n, 16, file=path, engine="grouped_pallas_bf16")
    got = tdriver.solve(n, 16, file=path, engine="grouped_pallas_bf16",
                        device="cpu")
    for r in (ref, got):
        assert r.engine == "grouped_pallas_bf16"
        assert r.recovery == ()
        assert r.rel_residual < 0.05


def test_refine_steps_zero_walks_straight_to_resolve():
    """An fp32 accuracy SLO on a bf16 solve with no refine rung: the
    ladder goes straight to the re-solve, which runs the fp32 sibling
    engine and is recorded with its dtype."""
    recs = []
    for mod, drv, kw in ((jpolicy, jdriver, {}),
                         (tpolicy, tdriver, {"device": "cpu"})):
        pol = mod.ResiliencePolicy(gate_dtype="float32", gate_tol=1e-3,
                                   refine_steps=0)
        r = drv.solve(n=96, block_size=16, engine="grouped_pallas_bf16",
                      policy=pol, **kw)
        assert [x["rung"] for x in r.recovery] == ["resolve"]
        assert r.recovery[0]["passed"]
        assert r.recovery[0]["dtype"] == "float32"
        assert r.rel_residual < 1e-3
        recs.append(sorted(r.recovery[0]))
    assert recs[0] == recs[1]             # the same record keys


def test_exhausted_ladder_raises_and_cli_exits_2(monkeypatch, capsys):
    """A gate no rung can pass raises ResidualGateError with the rungs
    walked; the CLI maps it to the runtime-error exit code 2."""
    pol = tpolicy.ResiliencePolicy(gate_tol=0.0, refine_steps=1)
    with pytest.raises(tpolicy.ResidualGateError) as ei:
        tdriver.solve(64, 16, generator="rand", engine="grouped_pallas_bf16",
                      policy=pol, device="cpu")
    assert [r["rung"] for r in ei.value.recovery] == ["refine", "resolve"]
    assert not any(r["passed"] for r in ei.value.recovery)
    monkeypatch.setattr(tdriver, "DEFAULT_POLICY", pol)
    assert tmain(["64", "16", "--engine", "grouped_pallas_bf16",
                  "--device", "cpu"]) == 2
    assert "residual gate failed" in capsys.readouterr().err


@pytest.mark.parametrize("n,kappa,dtype,expect", [
    (96, 1e9, "bfloat16", 0.5),                   # capped
    (96, 2.0, "float32", 16 * 2.0**-23 * 96 * 2.0),
    (96, 0.1, "float32", 16 * 2.0**-23 * 96),     # κ floored at 1
])
def test_gate_threshold_matches_jax(n, kappa, dtype, expect):
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    ref = jdegrade.gate_threshold(jpolicy.DEFAULT_POLICY, n, kappa, jdt)
    for dt in (tdt, dtype):
        got = tdegrade.gate_threshold(tpolicy.DEFAULT_POLICY, n, kappa, dt)
        assert got == ref == pytest.approx(expect, rel=1e-12)


def test_gate_fails_on_nan():
    pol = tpolicy.DEFAULT_POLICY
    assert math.isnan(tdegrade.gate_threshold(pol, 8, float("inf"),
                                              torch.float32))
    assert not tdegrade.gate_passes(float("nan"), 0.5)
    assert not tdegrade.gate_passes(0.1, float("nan"))
    assert tdegrade.gate_passes(0.1, 0.5)


@pytest.mark.parametrize("exc,retried", [
    (OSError("INTERNAL: transport closed"), True),
    (ValueError("INTERNAL: an accuracy error quoting a marker"), False),
    (OSError("disk full"), False),
])
def test_retry_policy_matches_jax(exc, retried):
    """One transient OSError is retried once; a ValueError never, nor an
    OSError without a transient marker."""
    for mod in (jpolicy, tpolicy):
        calls, hooks = [], []

        def fn():
            calls.append(1)
            if len(calls) == 1:
                raise exc
            return "ok"

        pol = mod.RetryPolicy(max_retries=2, backoff_s=0.0)
        if retried:
            assert pol.call(fn, on_retry=lambda e, i: hooks.append(i)) == "ok"
            assert len(calls) == 2
            if mod is tpolicy:
                assert hooks == [0]
        else:
            with pytest.raises(type(exc)):
                pol.call(fn)
            assert len(calls) == 1


def test_retry_delays_match_jax():
    kw = {"max_retries": 3, "backoff_s": 0.01, "max_backoff_s": 0.25}
    jp, tp = jpolicy.RetryPolicy(**kw), tpolicy.RetryPolicy(**kw)
    assert [tp.delay_s(i) for i in range(5)] == [jp.delay_s(i)
                                                 for i in range(5)]
    assert tpolicy.DEFAULT_POLICY == tpolicy.ResiliencePolicy(
        retry=tpolicy.RetryPolicy(**{**kw, "max_retries": 2}))


def test_policy_retries_the_engine_call(monkeypatch):
    """solve(policy=) runs the engine under the policy's retry: a
    transient failure of the first call is retried on a fresh load."""
    calls = []
    real = tdriver.invert

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("INTERNAL: transient")
        return real(*args, **kw)

    monkeypatch.setattr(tdriver, "invert", flaky)
    pol = tpolicy.ResiliencePolicy(retry=tpolicy.RetryPolicy(max_retries=1))
    r = tdriver.solve(32, 8, generator="rand", engine="grouped_pallas",
                      policy=pol, device="cpu")
    assert len(calls) == 2 and r.recovery == ()
