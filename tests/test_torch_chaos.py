"""The port's serving resilience against the JAX package's, on the CPU.

Twins of ``tests/test_chaos.py``'s serve cases run on the port with
``device="cpu"``: the breaker opens, fast-fails and recovers half-open; the
riders of a failed batch get typed errors; a transient mid-batch failure is
invisible to its riders (bits equal to the fault-free run); corruption is
caught when the lead element is singular; queue and execute deadlines fail
typed; close drains in-flight retries; a fault-free stream leaves every
resilience counter at zero.  A seeded ``FaultPlan`` on the same staged
stream counts the same calls and fires the same injections in both
packages, and ``chaos_demo`` at n=128 passes ``tools/check_chaos.py`` (run
unchanged, as a subprocess) with the JAX report's accounting.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_jordan import serve as jserve
from tpu_jordan.resilience import FaultPlan as JPlan
from tpu_jordan.resilience import ResiliencePolicy as JPolicy
from tpu_jordan.resilience import RetryPolicy as JRetry
from tpu_jordan.resilience import activate as jactivate

from tpu_jordan_torch.obs.metrics import REGISTRY
from tpu_jordan_torch.resilience import (FaultPlan, FaultSpec,
                                         InjectedFaultError,
                                         ResiliencePolicy, RetryPolicy,
                                         activate)
from tpu_jordan_torch.resilience.policy import (CircuitBreaker,
                                                CircuitOpenError,
                                                DeadlineExceededError)
from tpu_jordan_torch.serve import JordanService, chaos_demo

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"

#: The fewest requests at which the JAX report fires every point
#: check_chaos.py requires at n=128 for seeds 0-2 (2 already does) and the
#: stream carries one of its singular fixtures (index 5).
CHAOS_REQUESTS = 6


def _mats(rng, n, count):
    return [rng.standard_normal((n, n)).astype(np.float32)
            for _ in range(count)]


def _total(name):
    return REGISTRY.counter(name).total()


def _policy(retries=0, backoff=0.0, breaker_failures=3, cooldown=30.0):
    return ResiliencePolicy(
        retry=RetryPolicy(max_retries=retries, backoff_s=backoff,
                          max_backoff_s=backoff),
        breaker_failures=breaker_failures, breaker_cooldown_s=cooldown)


def test_breaker_states_follow_the_jax_machine():
    now = [0.0]
    br = CircuitBreaker(failures=2, cooldown_s=1.0, clock=lambda: now[0],
                        name="t")
    br.record_failure()
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "open" and not br.allow()
    now[0] = 1.5
    assert br.state == "half_open" and br.allow()
    br.record_failure()                       # a failed probe: open again
    assert br.state == "open"
    now[0] = 3.0
    assert br.allow()
    br.record_success()
    assert br.state == "closed"
    with pytest.raises(ValueError):
        CircuitBreaker(failures=0)


def test_exactly_the_riders_get_typed_errors(rng):
    mats = _mats(rng, 48, 6)
    svc = JordanService(batch_cap=2, max_wait_ms=1.0, autostart=False,
                        policy=_policy(retries=0), device=CPU)
    svc.warmup(shapes=[48])
    futs = [svc.submit(a) for a in mats[:4]]
    plan = FaultPlan([FaultSpec("execute", (1,), "permanent")])
    with activate(plan):
        svc.start()
        for i in (0, 1):
            with pytest.raises(InjectedFaultError):
                futs[i].result(120)
        assert all(not futs[i].result(120).singular for i in (2, 3))
    later = [svc.submit(a) for a in mats[4:]]
    assert all(not f.result(120).singular for f in later)
    svc.close()
    assert svc.stats()["breakers"] == {"64": "closed"}


def test_breaker_opens_fast_fails_and_recovers_half_open(rng):
    mats = _mats(rng, 32, 5)
    svc = JordanService(batch_cap=1, max_wait_ms=0.5, autostart=False,
                        policy=_policy(retries=0, breaker_failures=2,
                                       cooldown=0.05), device=CPU)
    svc.warmup(shapes=[32])
    opens = _total("tpu_jordan_torch_breaker_open_total")
    futs = [svc.submit(a) for a in mats[:2]]
    plan = FaultPlan([FaultSpec("execute", (1, 2), "permanent")])
    with activate(plan):
        svc.start()
        for f in futs:
            with pytest.raises(InjectedFaultError):
                f.result(120)
    assert svc.stats()["breakers"]["64"] == "open"
    assert _total("tpu_jordan_torch_breaker_open_total") == opens + 1
    with pytest.raises(CircuitOpenError):
        svc.submit(mats[2])
    assert svc.stats()["totals"]["rejected"] == 1
    time.sleep(0.06)
    assert not svc.submit(mats[3]).result(120).singular   # the probe
    assert svc.stats()["breakers"]["64"] == "closed"
    assert not svc.invert(mats[4], timeout=120).singular
    svc.close()


def test_transient_mid_batch_failure_is_invisible_to_riders(rng):
    a = _mats(rng, 48, 1)[0]
    with JordanService(batch_cap=1, max_wait_ms=0.5,
                       policy=_policy(retries=2), device=CPU) as svc:
        svc.warmup(shapes=[48])
        clean = svc.invert(a, timeout=120)
        before = _total("tpu_jordan_torch_retries_total")
        plan = FaultPlan([FaultSpec("execute", (1,), "transient")])
        with activate(plan):
            r = svc.invert(a, timeout=120)
    assert torch.equal(r.inverse, clean.inverse)
    assert _total("tpu_jordan_torch_retries_total") == before + 1


def test_corruption_on_a_singular_lead_element_is_still_caught(rng):
    bad = np.ones((32, 32), np.float32)
    good = _mats(rng, 32, 1)[0]
    svc = JordanService(batch_cap=2, max_wait_ms=50.0, autostart=False,
                        policy=_policy(retries=2), device=CPU)
    svc.warmup(shapes=[32])
    before = _total("tpu_jordan_torch_retries_total")
    f_bad, f_good = svc.submit(bad), svc.submit(good)
    plan = FaultPlan([FaultSpec("result_corrupt_nan", (1,), "corrupt")])
    with activate(plan):
        svc.start()
        rb, rg = f_bad.result(120), f_good.result(120)
    assert rb.singular and not rg.singular
    assert np.isfinite(rg.rel_residual)
    assert plan.injected_total == 1
    assert _total("tpu_jordan_torch_retries_total") == before + 1
    svc.close()


def test_queue_deadline_fails_typed_before_dispatch(rng):
    mats = _mats(rng, 32, 2)
    svc = JordanService(batch_cap=2, max_wait_ms=1.0, autostart=False,
                        policy=_policy(), default_deadline_ms=5, device=CPU)
    svc.warmup(shapes=[32])
    doomed = svc.submit(mats[0])
    healthy = svc.submit(mats[1], deadline_ms=60_000)
    time.sleep(0.05)
    svc.start()
    with pytest.raises(DeadlineExceededError):
        doomed.result(120)
    assert not healthy.result(120).singular
    svc.close()


def test_execute_overrun_fails_typed_after_dispatch(rng):
    a = _mats(rng, 32, 1)[0]
    counter = REGISTRY.counter("tpu_jordan_torch_deadline_exceeded_total")
    before = counter.value(phase="execute")
    svc = JordanService(batch_cap=1, max_wait_ms=0.5, autostart=False,
                        policy=_policy(retries=1, backoff=0.3), device=CPU)
    svc.warmup(shapes=[32])
    fut = svc.submit(a, deadline_ms=100)
    plan = FaultPlan([FaultSpec("execute", (1,), "transient")])
    with activate(plan):
        svc.start()
        with pytest.raises(DeadlineExceededError):
            fut.result(120)
    assert counter.value(phase="execute") == before + 1
    svc.close()


def test_close_drains_in_flight_retries(rng):
    mats = _mats(rng, 32, 3)
    svc = JordanService(batch_cap=1, max_wait_ms=0.5, autostart=False,
                        policy=_policy(retries=2, backoff=0.15), device=CPU)
    svc.warmup(shapes=[32])
    futs = [svc.submit(a) for a in mats]
    plan = FaultPlan([FaultSpec("execute", (1, 2), "transient")])
    with activate(plan):
        svc.start()
        time.sleep(0.05)          # the dispatcher is inside retry #1
        t0 = time.perf_counter()
        svc.close(drain=True)
        drained = time.perf_counter() - t0
    assert all(not f.result(0).singular for f in futs)
    assert drained < 60


def test_fault_free_stream_leaves_every_resilience_counter_at_zero(rng):
    names = ("tpu_jordan_torch_retries_total",
             "tpu_jordan_torch_faults_injected_total",
             "tpu_jordan_torch_breaker_open_total",
             "tpu_jordan_torch_deadline_exceeded_total",
             "tpu_jordan_torch_recovery_rungs_total",
             "tpu_jordan_torch_plan_cache_write_failures_total",
             "tpu_jordan_torch_serve_batch_failures_total")
    mats = _mats(rng, 24, 25) + _mats(rng, 48, 25)
    svc = JordanService(batch_cap=8, max_wait_ms=5.0, max_queue=64,
                        autostart=False, device=CPU)    # default policy on
    svc.warmup(shapes=[24, 48])
    compiles = svc.stats()["totals"]["compiles"]
    before = {n: _total(n) for n in names}
    futs = [svc.submit(a) for a in mats]
    svc.start()
    res = [f.result(300) for f in futs]
    svc.close()
    assert len(res) == 50 and all(not r.singular for r in res)
    assert {n: _total(n) for n in names} == before
    stats = svc.stats()
    assert stats["totals"]["compiles"] == compiles
    assert stats["measurements"] == 0


def _chaos_points(requests, cap):
    horizon = max(4, requests // cap // 2)
    return {"compile": (1, 2), "execute": (3, horizon),
            "result_corrupt_nan": (2, horizon), "plan_cache_write": (1, 2)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_plan_fires_at_the_same_calls_in_both_packages(
        rng, tmp_path, seed):
    mats = _mats(rng, 128, 5) + _mats(rng, 64, 5)
    pol = RetryPolicy(max_retries=6, backoff_s=0.0)
    jpol = JRetry(max_retries=6, backoff_s=0.0)

    def run(make, plan, act, path):
        with act(plan):
            svc = make(path)
            svc.warmup(shapes=[128, 64])
            futs = [svc.submit(a) for a in mats]
            svc.start()
            out = [f.result(120) for f in futs]
            svc.close()
        return out, plan

    mine, plan = run(
        lambda p: JordanService(batch_cap=4, max_wait_ms=1.0,
                                autostart=False, plan_cache=p, device=CPU,
                                policy=ResiliencePolicy(retry=pol)),
        FaultPlan.seeded(seed, points=_chaos_points(10, 4)), activate,
        str(tmp_path / "t.json"))
    ref, jplan = run(
        lambda p: jserve.JordanService(batch_cap=4, max_wait_ms=1.0,
                                       autostart=False, plan_cache=p,
                                       policy=JPolicy(retry=jpol)),
        JPlan.seeded(seed, points=_chaos_points(10, 4)), jactivate,
        str(tmp_path / "j.json"))
    assert plan.calls() == jplan.calls()
    assert plan.injections == jplan.injections
    assert plan.report() == jplan.report()
    assert [r.singular for r in mine] == [r.singular for r in ref]


def _check_chaos(report, tmp_path):
    path = tmp_path / "chaos.json"
    path.write_text(json.dumps(report))
    return subprocess.run([sys.executable, str(ROOT / "tools"
                                               / "check_chaos.py"),
                           str(path)], capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_demo_passes_the_checker_with_jax_accounting(tmp_path, seed):
    rep = chaos_demo(n=128, requests=CHAOS_REQUESTS, batch_cap=4, seed=seed,
                     device=CPU)
    ref = jserve.chaos_demo(n=128, requests=CHAOS_REQUESTS, batch_cap=4,
                            seed=seed)
    proc = _check_chaos(rep, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert rep["mismatches"] == [] and rep["silent_corruption"] is False
    assert rep["accounting"] == ref["accounting"]
    assert rep["faults"]["calls_by_point"] == ref["faults"]["calls_by_point"]
    assert rep["journey_ledger"] == ref["journey_ledger"]
    assert rep["singular_flagged"] == ref["singular_flagged"] >= 1
    for key in ("requests", "request_sizes", "matched_bitwise",
                "typed_errors", "counters_delta"):
        assert rep[key] == ref[key], key


def test_chaos_cli_report_passes_the_checker(tmp_path):
    out = tmp_path / "cli.json"
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_jordan_torch", "128", "32",
         "--chaos-demo", "--serve-requests", str(CHAOS_REQUESTS),
         "--batch-cap", "4", "--quiet", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out.write_text(proc.stdout.strip().splitlines()[-1])
    rep = json.loads(out.read_text())
    assert "log" not in rep["faults"]
    assert _check_chaos(rep, tmp_path).returncode == 0
