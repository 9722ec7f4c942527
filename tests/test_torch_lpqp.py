"""The port's LP/QP drivers (``tpu_jordan_torch.lpqp``) against the JAX
package's, on the CPU.

The instances are the same numpy arrays in both packages (bit for bit, both
conditionings, several seeds), and so are their KKT residuals and gates.
``solve_lp`` and ``solve_qp`` run every (m, cond) in {8, 12, 16} × {well,
ill}, fp64, through ``tpu_jordan.fleet.JordanFleet`` and
``tpu_jordan_torch.fleet.JordanFleet(device="cpu")``; a proxy records every
``fleet.update`` call, so equal (u, v) bytes mean equal basis (LP) and
toggle (QP) sequences.  Held equal: those sequences, the iterations, the
update outcome ledgers and per-iterate outcomes; objectives within 1e-9
relative of JAX's and of the instance's constructed optimum; ``kkt_rel``
under the solver's gate in both.  (All of m ∈ {8, 12, 16} land in the 64
bucket, so each package builds its lanes once.)  Past the driver's edge,
the ill QP at n ∈ {64, 128} stops short of its own KKT gate in both
packages, after the same toggles and iterations (ROADMAP.md Queue C).

On the port alone: a zero drift budget re_inverts every update (as it does
in JAX), a seeded ``replica_kill`` run bit-matches its fault-free replay
(the fingerprint and every ``kkt_hex``), a preempted checkpointed stream
resumes to the same ``kkt_hex`` trail, and ``lp_demo`` passes
``tools/check_lp.py`` as a subprocess, whose doctored variants exit 2 or 1
as in the JAX tests.

The demo's batched-lane verdict compares two wall-clock medians (the
amortized per-update execute against one launch per update), and the JAX
twin of this test fails under ``-n 6`` on exactly such a ratio, so the CPU
test does not assert it: when the CPU reads speedup ≤ 1, the checker's only
complaints must be that verdict and the silent-divergence flag it sets.
The card holds the verdict through the smoke's full checker exit.
"""

import copy
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_jordan import lpqp as jlpqp
from tpu_jordan.__main__ import main as jmain
from tpu_jordan.fleet import JordanFleet as JFleet
from tpu_jordan.resilience import ResiliencePolicy as JPolicy
from tpu_jordan.resilience.policy import RetryPolicy as JRetry
from tpu_jordan.serve.executors import ExecutorStore as JStore

from tpu_jordan_torch import lpqp
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.fleet import JordanFleet
from tpu_jordan_torch.lpqp.demo import lp_demo
from tpu_jordan_torch.obs.metrics import REGISTRY
from tpu_jordan_torch.resilience import (CheckpointStore, FaultPlan,
                                         FaultSpec, PreemptedError,
                                         ResiliencePolicy, RetryPolicy,
                                         activate)
from tpu_jordan_torch.serve import ExecutorStore

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"
SIZES = (8, 12, 16)
CONDS = ("well", "ill")
CASES = [(kind, m, cond) for kind in ("lp", "qp") for m in SIZES
         for cond in CONDS]


class _Spy:
    """A fleet proxy recording each ``update``'s (u, v) bytes."""

    def __init__(self, fleet):
        self._fleet = fleet
        self.calls = []

    def update(self, handle, u, v, *args, **kwargs):
        self.calls.append((np.asarray(u, np.float64).tobytes(),
                           np.asarray(v, np.float64).tobytes()))
        return self._fleet.update(handle, u, v, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fleet, name)


def _instance(pkg, kind, m, cond, seed=0):
    return (pkg.lp_instance(m=m, seed=seed, cond=cond) if kind == "lp"
            else pkg.qp_instance(n=m, seed=seed, cond=cond))


def _fleet_kw(jax: bool):
    if jax:
        return dict(engine="auto", dtype=jnp.float64, batch_cap=1,
                    max_wait_ms=0.5, stable_after_s=0.2,
                    liveness_deadline_s=30.0, executor_store=JStore(),
                    policy=JPolicy(retry=JRetry(max_retries=4,
                                                backoff_s=0.0)))
    return dict(engine="auto", dtype=torch.float64, batch_cap=1,
                max_wait_ms=0.5, stable_after_s=0.2,
                liveness_deadline_s=30.0, executor_store=ExecutorStore(),
                policy=ResiliencePolicy(retry=RetryPolicy(
                    max_retries=4, backoff_s=0.0)), device=CPU)


def _run_all(fleet_cls, pkg, jax: bool, **extra):
    """Every CASES run through one warmed 2-replica fleet: {case: (report,
    update calls)}."""
    out = {}
    with fleet_cls(replicas=2, **_fleet_kw(jax), **extra) as fleet:
        fleet.warmup([8], update_shapes=[(8, 1), (8, 2)],
                     solve_shapes=[(8, 1)])
        for kind, m, cond in CASES:
            spy = _Spy(fleet)
            solver = pkg.solve_lp if kind == "lp" else pkg.solve_qp
            rep = solver(_instance(pkg, kind, m, cond), spy)
            out[(kind, m, cond)] = (rep, spy.calls)
    return out


@pytest.fixture(scope="module")
def runs():
    return (_run_all(JFleet, jlpqp, True),
            _run_all(JordanFleet, lpqp, False))


# ---------------------------------------------------------------------
# The instances and the judge
# ---------------------------------------------------------------------


@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("seed", [0, 3, 9])
@pytest.mark.parametrize("m", [6, 12])
def test_instances_bit_equal_to_jax(m, seed, cond):
    got, want = (lpqp.lp_instance(m=m, seed=seed, cond=cond),
                 jlpqp.lp_instance(m=m, seed=seed, cond=cond))
    for field in ("a", "b", "c", "x_star"):
        assert getattr(got, field).tobytes() == getattr(want,
                                                        field).tobytes()
    assert (got.basis0, got.obj_star, got.name) == (want.basis0,
                                                    want.obj_star,
                                                    want.name)
    got, want = (lpqp.qp_instance(n=m, seed=seed, cond=cond),
                 jlpqp.qp_instance(n=m, seed=seed, cond=cond))
    for field in ("q", "c", "lo", "hi", "x_star"):
        assert getattr(got, field).tobytes() == getattr(want,
                                                        field).tobytes()
    assert (got.obj_star, got.name) == (want.obj_star, want.name)


@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_kkt_residuals_and_gate_equal_jax(seed, cond):
    rng = np.random.default_rng(seed)
    lp = lpqp.lp_instance(m=8, seed=seed, cond=cond)
    y = np.linalg.solve(lp.a[:, :lp.m].T, lp.c[:lp.m])
    qp = lpqp.qp_instance(n=8, seed=seed, cond=cond)
    for x_lp, x_qp in ((lp.x_star, qp.x_star),
                       (lp.x_star + 1e-3 * rng.standard_normal(lp.n),
                        np.clip(qp.x_star + 0.1 * rng.standard_normal(8),
                                -0.2, 1.2))):
        assert (lpqp.lp_kkt_residual(lp, x_lp, y)
                == jlpqp.lp_kkt_residual(lp, x_lp, y))
        assert (lpqp.qp_kkt_residual(qp, x_qp)
                == jlpqp.qp_kkt_residual(qp, x_qp))
    assert lpqp.lp_kkt_residual(lp, lp.x_star, y) < 1e-9
    assert lpqp.qp_kkt_residual(qp, qp.x_star) < 1e-12
    pol, jpol = ResiliencePolicy(), JPolicy()
    for kappa in (1.0, 1e3, float("nan")):
        got = lpqp.kkt_gate(pol, 16, kappa, np.float64)
        want = jlpqp.kkt_gate(jpol, 16, kappa, jnp.float64)
        assert got == want or (np.isnan(got) and np.isnan(want))
    assert lpqp.kkt_converged(1e-14, 1e-13)
    assert not lpqp.kkt_converged(float("nan"), 1.0)


def test_instance_validation_typed():
    with pytest.raises(ValueError):
        lpqp.lp_instance(m=8, cond="medium")
    with pytest.raises(ValueError):
        lpqp.lp_instance(m=1)
    with pytest.raises(ValueError):
        lpqp.qp_instance(n=1)


# ---------------------------------------------------------------------
# The drivers through both fleets
# ---------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_sequences_iterations_and_ledgers_equal_jax(runs, case):
    (jrep, jcalls), (rep, calls) = runs[0][case], runs[1][case]
    assert calls == jcalls                    # basis / toggle sequences
    assert rep.iterations == jrep.iterations
    assert rep.updates == jrep.updates == len(calls) > 0
    assert rep.ledger == jrep.ledger
    assert ([r.get("outcome") for r in rep.iterates]
            == [r.get("outcome") for r in jrep.iterates])
    assert ([r.get("version") for r in rep.iterates]
            == [r.get("version") for r in jrep.iterates])
    assert rep.solves == jrep.solves
    assert all(r["solve_pass"] and r["agree"] for r in rep.iterates
               if "solve_rel" in r)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_objectives_and_kkt_gate(runs, case):
    (jrep, _), (rep, _) = runs[0][case], runs[1][case]
    assert rep.converged and jrep.converged
    for r in (rep, jrep):
        assert r.kkt_rel_final <= r.kkt_threshold
        assert (abs(r.objective - r.objective_ref)
                <= 1e-9 * (1.0 + abs(r.objective_ref)))
    assert (abs(rep.objective - jrep.objective)
            <= 1e-9 * (1.0 + abs(jrep.objective)))
    assert sum(rep.ledger.values()) == rep.updates
    assert set(rep.timing) == set(lpqp.driver.TIMING_KEYS)
    assert len(rep.timing["iteration_s"]) == rep.iterations


@pytest.mark.parametrize("n", [64, 128])
def test_ill_qp_stops_short_of_its_gate_in_both(n):
    got = {}
    for name, cls, pkg, jax in (("jax", JFleet, jlpqp, True),
                                ("port", JordanFleet, lpqp, False)):
        with cls(replicas=2, **_fleet_kw(jax)) as fleet:
            fleet.warmup([n], update_shapes=[(n, 1), (n, 2)],
                         solve_shapes=[(n, 1)])
            spy = _Spy(fleet)
            got[name] = (pkg.solve_qp(_instance(pkg, "qp", n, "ill"), spy),
                         spy.calls)
    (jrep, jcalls), (rep, calls) = got["jax"], got["port"]
    assert calls == jcalls and len(calls) > 0
    assert rep.iterations == jrep.iterations
    assert rep.ledger == jrep.ledger
    for r in (rep, jrep):
        assert not r.converged
        assert r.kkt_rel_final > r.kkt_threshold
    # The residual is a difference of near-equal terms: 1e-6 relative.
    assert (abs(rep.kkt_rel_final - jrep.kkt_rel_final)
            <= 1e-6 * jrep.kkt_rel_final)


def test_zero_drift_budget_re_inverts_every_update_in_both():
    got = {}
    for name, cls, pkg, jax in (("jax", JFleet, jlpqp, True),
                                ("port", JordanFleet, lpqp, False)):
        with cls(replicas=2, update_drift_budget_factor=0.0,
                 **_fleet_kw(jax)) as fleet:
            fleet.warmup([8], update_shapes=[(8, 1)],
                         solve_shapes=[(8, 1)])
            got[name] = pkg.solve_lp(_instance(pkg, "lp", 8, "well"),
                                     fleet)
    for rep in got.values():
        assert rep.converged
        assert rep.ledger["re_inverted"] == rep.updates > 0
        assert rep.ledger["refreshed"] == 0
    assert got["port"].ledger == got["jax"].ledger
    assert got["port"].iterations == got["jax"].iterations


def test_iteration_cap_typed_with_report():
    with JordanFleet(replicas=2, **_fleet_kw(False)) as fleet:
        fleet.warmup([8], update_shapes=[(8, 1)], solve_shapes=[(8, 1)])
        with pytest.raises(lpqp.OptimizeError) as ei:
            lpqp.solve_lp(lpqp.lp_instance(m=8), fleet, max_iters=1)
    rep = ei.value.report
    assert rep is not None and not rep.converged
    assert rep.iterations == 1 and len(rep.iterates) == 1


# ---------------------------------------------------------------------
# Chaos, resume and the kill boundary, on the port
# ---------------------------------------------------------------------


def _chaos_lp(plan=None):
    faults = REGISTRY.counter("tpu_jordan_torch_faults_injected_total")
    f0 = faults.total()
    kw = _fleet_kw(False)
    kw["policy"] = ResiliencePolicy(retry=RetryPolicy(max_retries=6,
                                                      backoff_s=0.0))
    with JordanFleet(replicas=3, **kw) as fleet:
        fleet.warmup([8], update_shapes=[(8, 1)], solve_shapes=[(8, 1)])
        prob = lpqp.lp_instance(m=8, seed=0, cond="ill")
        if plan is None:
            rep = lpqp.solve_lp(prob, fleet)
        else:
            with activate(plan):
                rep = lpqp.solve_lp(prob, fleet)
        ledger = fleet.stats()["ledger"]
    return rep, faults.total() - f0, ledger


def test_replica_kill_bitmatches_fault_free_replay():
    base, _, _ = _chaos_lp()
    plan = FaultPlan.seeded(0, points={"replica_kill": (2, 16)})
    chaos, injected, ledger = _chaos_lp(plan)
    assert injected == 2 and plan.injected_total == 2
    assert base.converged and chaos.converged
    assert ([r["kkt_hex"] for r in chaos.iterates]
            == [r["kkt_hex"] for r in base.iterates])
    assert ([(r.get("outcome"), r.get("version")) for r in chaos.iterates]
            == [(r.get("outcome"), r.get("version"))
                for r in base.iterates])
    assert chaos.fingerprint == base.fingerprint != ""
    assert ledger["outstanding"] == 0


def test_checkpoint_resume_replays_the_kkt_trail(tmp_path):
    prob = lpqp.lp_instance(m=8, seed=23, cond="well")
    store = CheckpointStore(str(tmp_path))
    with JordanFleet(replicas=2, **_fleet_kw(False)) as fleet:
        fleet.warmup([8], update_shapes=[(8, 1)], solve_shapes=[(8, 1)])
        ref = lpqp.solve_lp(prob, fleet)
        trail = [it["kkt_hex"] for it in ref.iterates]
        assert len(trail) >= 4
        with activate(FaultPlan([FaultSpec("preempt", (len(trail) - 1,),
                                           "permanent")])):
            with pytest.raises(PreemptedError) as ei:
                lpqp.solve_lp(prob, fleet, ckpt_store=store, ckpt_every=2,
                              run_id="t:lp")
        assert ei.value.step is not None
        resumed = lpqp.solve_lp(prob, fleet, ckpt_store=store,
                                ckpt_every=2, run_id="t:lp", resume=True)
    assert [it["kkt_hex"] for it in resumed.iterates] == trail
    assert resumed.fingerprint == ref.fingerprint
    assert resumed.converged == ref.converged
    assert store.ledger()["invariant_holds"]


def test_qp_checkpoint_resume_replays_the_kkt_trail(tmp_path):
    prob = lpqp.qp_instance(n=12, seed=0, cond="ill")
    store = CheckpointStore(str(tmp_path))
    with JordanFleet(replicas=2, **_fleet_kw(False)) as fleet:
        fleet.warmup([8], update_shapes=[(8, 2)], solve_shapes=[(8, 1)])
        ref = lpqp.solve_qp(prob, fleet)
        trail = [it["kkt_hex"] for it in ref.iterates]
        with activate(FaultPlan([FaultSpec("preempt", (len(trail) // 2,),
                                           "permanent")])):
            with pytest.raises(PreemptedError):
                lpqp.solve_qp(prob, fleet, ckpt_store=store, ckpt_every=3,
                              run_id="t:qp")
        resumed = lpqp.solve_qp(prob, fleet, ckpt_store=store,
                                ckpt_every=3, run_id="t:qp", resume=True)
    assert [it["kkt_hex"] for it in resumed.iterates] == trail
    assert resumed.fingerprint == ref.fingerprint
    assert store.ledger()["invariant_holds"]


# ---------------------------------------------------------------------
# lp_demo through tools/check_lp.py, and the CLI's flag contract
# ---------------------------------------------------------------------


def _check_lp(report, tmp_path, name):
    path = tmp_path / name
    path.write_text(json.dumps(report))
    return subprocess.run([sys.executable, str(ROOT / "tools" /
                                                "check_lp.py"), str(path)],
                          capture_output=True, text=True)


@pytest.fixture(scope="module")
def demo_report():
    return lp_demo(n=8, replicas=2, kills=1, batch_cap=2, device=CPU)


def test_lp_demo_passes_its_checker(demo_report, tmp_path):
    rep = demo_report
    assert rep["errors"] == [] and rep["mismatches"] == []
    assert all(leg["converged"] for leg in rep["legs"].values())
    assert rep["compiles_after_warmup"] == 0
    assert rep["measurements_after_warmup"] == 0
    assert rep["chaos"]["kills_injected"] >= 1
    assert rep["chaos"]["fingerprint_bitmatch"]
    assert rep["drift_probe"]["ledger"]["re_inverted"] == (
        rep["drift_probe"]["updates"])
    assert rep["batched"]["occupancy"] > 1
    assert rep["batched"]["compiles_delta"] == 0
    assert rep["fleet_ledger"]["outstanding"] == 0
    out = _check_lp(rep, tmp_path, "ok.json")
    if rep["batched"]["speedup_x"] > 1.0:
        assert out.returncode == 0, out.stderr
        assert not rep["silent_divergence"]
    else:
        # The wall-clock verdict alone (see the module docstring).
        lines = [ln for ln in out.stderr.splitlines() if ln.strip()]
        assert len(lines) == 2, out.stderr
        assert "did not beat one-per-launch" in out.stderr
        assert "silent_divergence flagged by the demo itself" in out.stderr


def test_lp_demo_legs_agree_with_jax_iterations(demo_report):
    jrep = {}
    with JFleet(replicas=2, **_fleet_kw(True)) as fleet:
        fleet.warmup([8], update_shapes=[(8, 1), (8, 2)],
                     solve_shapes=[(8, 1)])
        for name, kind, cond in (("lp_well", "lp", "well"),
                                 ("qp_ill", "qp", "ill")):
            solver = jlpqp.solve_lp if kind == "lp" else jlpqp.solve_qp
            jrep[name] = solver(_instance(jlpqp, kind, 8, cond), fleet)
    for name, r in jrep.items():
        leg = demo_report["legs"][name]
        assert leg["iterations"] == r.iterations
        assert leg["ledger"] == r.ledger


@pytest.mark.parametrize("doctor,rc", [
    ("hex", 2), ("ledger", 2), ("chaos", 2), ("occupancy", 1)])
def test_checker_rejects_doctored_reports(demo_report, tmp_path, doctor,
                                          rc):
    rep = copy.deepcopy(demo_report)
    # Start from a report the checker accepts, whatever the CPU's
    # wall-clock verdict read, then break one claim.
    rep["batched"]["amortized_beats_one_per_launch"] = True
    rep["silent_divergence"] = False
    assert _check_lp(rep, tmp_path, "base.json").returncode == 0
    if doctor == "hex":
        it = rep["legs"]["lp_well"]["iterates"][-1]
        it["kkt_hex"] = float(it["kkt_rel"] * 3.0).hex()
    elif doctor == "ledger":
        rep["legs"]["qp_well"]["ledger"]["refreshed"] += 1
    elif doctor == "chaos":
        rep["chaos"]["fingerprint_bitmatch"] = False
    else:
        rep["batched"]["occupancy"] = 1
    assert _check_lp(rep, tmp_path, f"{doctor}.json").returncode == rc


LP_BASE = ["16", "8", "--lp-demo", "--dtype", "float64", "--quiet"]


@pytest.mark.parametrize("extra", [
    ["--workers", "8"], ["--serve-requests", "32"], ["--batch", "4"],
    ["--engine", "inplace"], ["--workload", "solve"],
    ["--numerics", "summary"], ["--slo-report"], ["--scaling-floor", "2.0"],
    ["--replicas", "1"], ["--kills", "0"], ["--batch-cap", "1"],
    ["--plan-cache", "/tmp/p.json"], ["--fleet-demo"], ["--tune"],
])
def test_cli_lp_demo_flag_contract_exit_1(extra):
    argv = LP_BASE + extra
    assert jmain(argv) == 1
    assert tmain(argv + ["--device", CPU]) == 1


def test_cli_lp_demo_float32_refused_in_both():
    argv = ["16", "8", "--lp-demo", "--dtype", "float32", "--quiet"]
    assert jmain(argv) == 1
    assert tmain(argv + ["--device", CPU]) == 1


def test_cli_lp_demo_runs_and_checks(capsys):
    rc = tmain(["8", "8", "--lp-demo", "--dtype", "float64", "--quiet",
                "--replicas", "2", "--kills", "1", "--batch-cap", "2",
                "--device", CPU])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rep = json.loads(line)
    assert rep["metric"] == "lp_demo" and rep["device"] == CPU
    assert "log" not in rep["chaos"]["faults"]
    assert all(leg["converged"] for leg in rep["legs"].values())
    assert rep["errors"] == [] and rep["mismatches"] == []
    # Exit 2 only on the wall-clock verdict (see the module docstring).
    timing_only = not rep["batched"]["amortized_beats_one_per_launch"]
    assert rc == (2 if timing_only else 0)
    assert rep["silent_divergence"] == timing_only


def test_cli_lp_demo_without_a_card_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tmain(LP_BASE) == 2
