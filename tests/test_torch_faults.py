"""The port's fault points on the solve paths against the JAX package's, on
the CPU.

Twins of ``tests/test_resilience.py``'s fault cases run the same fixtures
through both packages: the retries, ladder rungs and injection logs are
compared exactly, each package's inverse bit-matches its own fault-free
run, and the two packages' inverses agree within min(100·eps·κ∞, 1e-3)
(relative ∞-norm).  A seeded plan driven over the same call sequence
(``solve``, ``solve_system``, ``lstsq``, ``solve_update``,
``JordanSolver``) must count the same calls and fire the same injections
in both packages.
"""

import numpy as np
import pytest
import torch

from tpu_jordan import driver as jdriver
from tpu_jordan.linalg import api as japi
from tpu_jordan.linalg import update as jupdate
from tpu_jordan.models import JordanSolver as JSolver
from tpu_jordan.obs.metrics import REGISTRY as JREGISTRY
from tpu_jordan.resilience import FaultPlan as JPlan
from tpu_jordan.resilience import FaultSpec as JSpec
from tpu_jordan.resilience import ResiliencePolicy as JPolicy
from tpu_jordan.resilience import RetryPolicy as JRetry
from tpu_jordan.resilience import activate as jactivate

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.linalg import lstsq, solve_system, solve_update
from tpu_jordan_torch.models import JordanSolver
from tpu_jordan_torch.obs.metrics import REGISTRY
from tpu_jordan_torch.resilience import (FaultPlan, FaultSpec,
                                         InjectedTransientError,
                                         ResiliencePolicy, RetryPolicy,
                                         activate, faults)


def _total(name):
    return REGISTRY.counter(name).total()


def _jtotal(name):
    return JREGISTRY.counter(name).total()


def _policies(retries):
    return (ResiliencePolicy(retry=RetryPolicy(max_retries=retries,
                                               backoff_s=0.0)),
            JPolicy(retry=JRetry(max_retries=retries, backoff_s=0.0)))


def _close(x, ref, a, dtype=np.float32):
    """Relative ∞-norm agreement within min(100·eps·κ∞, 1e-3)."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    a = np.asarray(a, np.float64)
    kappa = np.linalg.norm(a, np.inf) * np.linalg.norm(ref, np.inf)
    tol = min(100 * np.finfo(dtype).eps * kappa, 1e-3)
    return (np.linalg.norm(x - ref, np.inf)
            <= tol * np.linalg.norm(ref, np.inf))


def test_injections_counted_in_registry():
    before = _total("tpu_jordan_torch_faults_injected_total")
    plan = FaultPlan([FaultSpec("measure", (1,), "transient")])
    with activate(plan):
        with pytest.raises(InjectedTransientError):
            faults.fire("measure")
    assert _total("tpu_jordan_torch_faults_injected_total") == before + 1
    assert REGISTRY.counter("tpu_jordan_torch_faults_injected_total").value(
        point="measure") >= 1
    rep = plan.report()
    assert rep["injected_total"] == 1
    assert rep["injected_by_point"] == {"measure": 1}
    assert rep["log"] == [{"point": "measure", "call": 1,
                           "mode": "transient"}]


def test_transient_compile_and_execute_faults_retried_bitmatch():
    """One solve absorbs a transient compile fault and a transient execute
    fault (two counted retries, labeled by the JAX components) and still
    bit-matches the fault-free solve, in both packages."""
    pol, jpol = _policies(2)
    specs = [("compile", (1,), "transient"), ("execute", (1,), "transient")]
    got = {}
    for name, solve, make, act, total, retries, kw in (
            ("port", tdriver.solve, FaultSpec, activate, _total,
             "tpu_jordan_torch_retries_total", {"device": "cpu"}),
            ("jax", jdriver.solve, JSpec, jactivate, _jtotal,
             "tpu_jordan_retries_total", {})):
        clean = solve(48, 16, generator="rand", engine="inplace", **kw)
        plan = (FaultPlan if name == "port" else JPlan)(
            [make(*s) for s in specs])
        before = total(retries)
        with act(plan):
            r = solve(48, 16, generator="rand", engine="inplace",
                      policy=pol if name == "port" else jpol, **kw)
        assert plan.injected_total == 2
        assert plan.injections == [("compile", 1, "transient"),
                                   ("execute", 1, "transient")]
        assert total(retries) == before + 2
        assert r.recovery == ()
        assert (np.asarray(r.inverse) == np.asarray(clean.inverse)).all()
        got[name] = np.asarray(r.inverse)
    for comp in ("solve.compile", "solve.execute"):
        assert REGISTRY.counter("tpu_jordan_torch_retries_total").value(
            component=comp) >= 1
    a = np.asarray(jdriver.generate("rand", (48, 48), np.float32))
    assert _close(got["port"], got["jax"], a)


def test_nan_corruption_recovers_through_resolve_rung():
    """An injected NaN fails the gate, refine cannot fix NaN, and the
    re-solve rung returns the bit-exact clean inverse, in both packages
    with the same rungs."""
    pol, jpol = _policies(1)
    clean = tdriver.solve(48, 16, generator="rand", engine="inplace",
                          device="cpu")
    plan = FaultPlan([FaultSpec("result_corrupt_nan", (1,), "corrupt")])
    with activate(plan):
        r = tdriver.solve(48, 16, generator="rand", engine="inplace",
                          policy=pol, device="cpu")
    jplan = JPlan([JSpec("result_corrupt_nan", (1,), "corrupt")])
    with jactivate(jplan):
        jr = jdriver.solve(48, 16, generator="rand", engine="inplace",
                           policy=jpol)
    for res in (r, jr):
        assert [x["rung"] for x in res.recovery] == ["refine", "resolve"]
        assert not res.recovery[0]["passed"] and res.recovery[1]["passed"]
    assert plan.calls() == jplan.calls()
    assert plan.injections == jplan.injections
    assert torch.equal(r.inverse, clean.inverse)
    assert _close(r.inverse.numpy(), jr.inverse, np.asarray(
        jdriver.generate("rand", (48, 48), np.float32)))


def test_solver_model_policy_retries_execute():
    pol, jpol = _policies(1)
    a = np.eye(32) * 2.0
    before = _total("tpu_jordan_torch_retries_total")
    sol = JordanSolver(n=32, block_size=8, engine="inplace", policy=pol,
                       device="cpu")
    plan = FaultPlan([FaultSpec("execute", (1,), "transient")])
    with activate(plan):
        inv, sing = sol.invert(a)
    assert not bool(sing)
    assert _total("tpu_jordan_torch_retries_total") == before + 1
    np.testing.assert_allclose(inv.numpy(), np.eye(32) / 2.0)
    jsol = JSolver(n=32, block_size=8, engine="inplace", policy=jpol)
    jplan = JPlan([JSpec("execute", (1,), "transient")])
    with jactivate(jplan):
        jinv, _ = jsol.invert(a)
    assert plan.calls() == jplan.calls() == {"compile": 1, "execute": 2}
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def test_solver_compile_fires_once_per_configuration():
    """The compile point fires at the first invert, where the JAX solver
    compiles, and a retried compile fault leaves the solver usable."""
    pol, _ = _policies(1)
    sol = JordanSolver(n=16, block_size=8, engine="inplace", policy=pol,
                       device="cpu")
    plan = FaultPlan([FaultSpec("compile", (1,), "transient")])
    with activate(plan):
        for _ in range(3):
            sol.invert(np.eye(16) * 4.0)
    assert plan.calls() == {"compile": 2, "execute": 3}


def test_unplanned_solve_reaches_no_plan(monkeypatch):
    """With no active plan a solve pays the ``is None`` check alone: no
    plan method runs, and the result is the planned-but-quiet solve's."""
    def forbidden(self, point):
        raise AssertionError(f"FaultPlan reached at {point!r}")

    clean = tdriver.solve(32, 8, generator="rand", engine="inplace",
                          device="cpu")
    monkeypatch.setattr(FaultPlan, "_hit", forbidden)
    assert faults.active() is None
    r = tdriver.solve(32, 8, generator="rand", engine="inplace",
                      device="cpu")
    assert torch.equal(r.inverse, clean.inverse)


def test_update_corruption_walks_the_re_invert_rung():
    """``solve_update``'s corrupt point poisons the rel_residual; the
    policy's gate fails it and the re_invert rung recovers, as in the JAX
    package."""
    rng = np.random.default_rng(4)
    n, k = 32, 4
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    inv = np.linalg.inv(a)
    u = rng.standard_normal((n, k)) / n
    v = rng.standard_normal((n, k)) / n
    pol, jpol = _policies(1)
    plan = FaultPlan([FaultSpec("result_corrupt_nan", (1,), "corrupt")])
    with activate(plan):
        r = solve_update(a, inv, u, v, policy=pol, device="cpu")
    jplan = JPlan([JSpec("result_corrupt_nan", (1,), "corrupt")])
    with jactivate(jplan):
        jr = jupdate.solve_update(a, inv, u, v, policy=jpol)
    assert [x["rung"] for x in r.recovery] == [x["rung"]
                                               for x in jr.recovery]
    assert r.recovery and r.recovery[-1]["passed"]
    assert plan.calls() == jplan.calls()
    assert plan.injections == jplan.injections
    assert _close(r.inverse.numpy(), jr.inverse, a + u @ v.T, np.float64)


def _sequence(pkg, policy):
    """The same call sequence through one package: solve, solve_system,
    lstsq, solve_update and two JordanSolver inverts.  Returns each call's
    outcome: "ok" or the name of the exception it raised (an exhausted
    ladder ends its call, not the sequence)."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((32, 32)) + 32 * np.eye(32)
    b = rng.standard_normal((32, 2))
    tall = rng.standard_normal((48, 16))
    rhs = rng.standard_normal((48, 1))
    u = rng.standard_normal((32, 2)) / 32
    v = rng.standard_normal((32, 2)) / 32
    inv = np.linalg.inv(a)
    if pkg == "port":
        kw = {"device": "cpu"}
        sol = JordanSolver(n=32, block_size=8, engine="inplace",
                           policy=policy, **kw)
        calls = [
            lambda: tdriver.solve(32, 8, generator="rand", engine="inplace",
                                  policy=policy, **kw),
            lambda: solve_system(a, b, block_size=8, policy=policy, **kw),
            lambda: lstsq(tall, rhs, block_size=8, policy=policy, **kw),
            lambda: solve_update(a, inv, u, v, policy=policy, **kw)]
    else:
        sol = JSolver(n=32, block_size=8, engine="inplace", policy=policy)
        calls = [
            lambda: jdriver.solve(32, 8, generator="rand", engine="inplace",
                                  policy=policy),
            lambda: japi.solve_system(a, b, block_size=8, policy=policy),
            lambda: japi.lstsq(tall, rhs, block_size=8, policy=policy),
            lambda: jupdate.solve_update(a, inv, u, v, policy=policy)]
    calls += [lambda: sol.invert(a)] * 2
    outcomes = []
    for call in calls:
        try:
            call()
            outcomes.append("ok")
        except Exception as e:                    # noqa: BLE001
            outcomes.append(type(e).__name__)
    return outcomes


@pytest.mark.parametrize("seed", [0, 1, 3, 5])
def test_seeded_plan_fires_at_the_same_calls(seed):
    points = {"compile": (1, 6), "execute": (2, 7),
              "result_corrupt_nan": (1, 5)}
    pol, jpol = _policies(3)
    plan = FaultPlan.seeded(seed, points=points)
    jplan = JPlan.seeded(seed, points=points)
    assert ([(s.point, s.calls, s.mode) for s in plan.specs]
            == [(s.point, s.calls, s.mode) for s in jplan.specs])
    with activate(plan):
        got = _sequence("port", pol)
    with jactivate(jplan):
        ref = _sequence("jax", jpol)
    assert got == ref
    assert plan.calls() == jplan.calls()
    assert plan.injections == jplan.injections
    assert plan.injected_total >= 2
