"""The port's replica fleet (``tpu_jordan_torch.fleet``), its SLO monitor and
cross-replica spread, on the CPU.

``SLOMonitor.evaluate`` and ``cross_replica_spread`` are held equal to the
JAX package's on the same samples (the same counter and histogram
mutations on each package's own registry, the same injected clock).  The
fleet's typed surface follows ``tests/test_fleet.py``'s cases on
``JordanFleet(device="cpu")``: typed backpressure, an open circuit, no
live replica and an exhausted fleet; the staged kill's re-queue, wedge
detection and the restart breaker on an injected clock, a warm replacement
with zero builds, per-replica metric labels and an idempotent close; a
warmup that runs one inert batch of each lane on each replica's dispatcher
thread (a replacement's too) and is not judged while it runs; the
seeded ``replica_kill`` on the admission path.  A replica killed while its
dispatcher runs an update leaves the handle's version sequence whole: the
in-flight update commits first, the re-queued ones after it, each once,
and the final pair bit-equal to a fault-free replay.

``fleet_demo`` (n = 96, 3 replicas, 60 requests, 2 kills) runs once and
goes through ``tools/check_fleet.py`` and ``tools/check_slo.py`` as
subprocesses; its doctored twins exit 1 or 2 as the JAX tests' do.  The
report's two timing verdicts (``scaling_x`` against its floor, the p99s
against their bound) are wall-clock ratios, and the JAX package's twin of
such a ratio fails under ``-n 6``, so this file does not assert them: when
the CPU misses one, the checker's only complaints must be those verdicts.
The card holds them through the smoke's full checker exit.  The CLI's
``--fleet-demo`` flag contract is the JAX CLI's, case by case.
"""

import copy
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_jordan.__main__ import main as jmain
from tpu_jordan.obs.metrics import MetricsRegistry as JRegistry
from tpu_jordan.obs.slo import SLOMonitor as JSLOMonitor
from tpu_jordan.obs.slo import bucket_specs as jbucket_specs
from tpu_jordan.serve.stats import cross_replica_spread as jspread

from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.fleet import (JordanFleet, Replica,
                                    ReplicaKilledError, fleet_demo)
from tpu_jordan_torch.fleet.replica import DEAD, READY
from tpu_jordan_torch.obs.metrics import REGISTRY, MetricsRegistry
from tpu_jordan_torch.obs.slo import SLOMonitor, SLOSpec, bucket_specs
from tpu_jordan_torch.resilience import (CircuitOpenError, FaultPlan,
                                         FaultSpec, activate)
from tpu_jordan_torch.serve import (ServiceOverloadedError, bucket_for,
                                    cross_replica_spread)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _fleet(replicas=3, **kw):
    """A small manually supervised fleet on the CPU."""
    kw.setdefault("batch_cap", 4)
    kw.setdefault("max_wait_ms", 1.0)
    kw.setdefault("autostart_supervisor", False)
    kw.setdefault("stable_after_s", 0.0)
    kw.setdefault("restart_grace_s", 0.2)
    kw.setdefault("device", CPU)
    return JordanFleet(replicas=replicas, **kw)


def _mats(count, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, n)).astype(np.float32)
            for _ in range(count)]


def _compiles():
    return REGISTRY.counter("tpu_jordan_torch_compiles_total").total()


# ---------------------------------------------------------------------
# SLO monitor and cross-replica spread against the JAX package's
# ---------------------------------------------------------------------

#: (t, [(outcome, bucket, count)], [(bucket, latency_s)]) per sample.
SLO_SAMPLES = [
    (0.0, [], []),
    (5.0, [("ok", "64", 40), ("error", "64", 1), ("ok", "128", 10)],
     [("64", 0.010), ("64", 0.030), ("128", 0.020)]),
    (20.0, [("ok", "64", 30), ("error", "64", 6), ("error", "128", 3)],
     [("64", 0.250), ("128", 0.040)]),
    (70.0, [("ok", "64", 12), ("error", "64", 4), ("ok", "128", 12)],
     [("128", 0.015)]),
]


def _drive(reg, prefix, clock, monitor):
    outcome = reg.counter(f"{prefix}_request_outcome_total")
    latency = reg.histogram(f"{prefix}_request_latency_seconds")
    for t, outs, lats in SLO_SAMPLES:
        clock.t = t
        for kind, bucket, count in outs:
            outcome.inc(count, outcome=kind, bucket=bucket)
        for bucket, seconds in lats:
            latency.observe(seconds, bucket=bucket)
        monitor.sample()
    return monitor.evaluate()


@pytest.mark.parametrize("windows", [
    ((60.0, 10.0, 14.4), (300.0, 60.0, 6.0)),
    ((30.0, 5.0, 1.0),),
])
@pytest.mark.parametrize("p99_ms", [None, 100.0])
def test_slo_evaluate_equals_jax(windows, p99_ms):
    clock, jclock = FakeClock(), FakeClock()
    mon = SLOMonitor(bucket_specs([64, 128], availability=0.95,
                                  p99_latency_ms=p99_ms),
                     registry=MetricsRegistry(), clock=clock,
                     windows=windows)
    jmon = JSLOMonitor(jbucket_specs([64, 128], availability=0.95,
                                     p99_latency_ms=p99_ms),
                       registry=JRegistry(), clock=jclock, windows=windows)
    got = _drive(mon.registry, "tpu_jordan_torch", clock, mon)
    want = _drive(jmon.registry, "tpu_jordan", jclock, jmon)
    assert got == want
    # The fixture exercises both verdicts somewhere.
    pages = [p["page"] for o in got["objectives"] for p in o["windows"]]
    if windows[0][2] == 1.0:
        assert any(pages)


def test_slo_report_passes_check_slo_and_refuses_bad_specs(tmp_path):
    clock = FakeClock()
    mon = SLOMonitor([SLOSpec("fleet", availability=0.95)],
                     registry=MetricsRegistry(), clock=clock,
                     windows=((60.0, 10.0, 14.4),))
    rep = _drive(mon.registry, "tpu_jordan_torch", clock, mon)
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(rep))
    out = subprocess.run([sys.executable, str(ROOT / "tools" /
                                                "check_slo.py"), str(path)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    with pytest.raises(ValueError):
        SLOSpec("x", availability=1.0)
    with pytest.raises(ValueError):
        SLOMonitor([SLOSpec("x")], windows=((10.0, 60.0, 1.0),))
    with pytest.raises(ValueError):
        SLOMonitor([])


def _snap(replica, samples_ms, batches):
    from tpu_jordan_torch.serve.stats import _percentiles

    return {"labels": {"replica": replica},
            "exec_ms": _percentiles([s / 1e3 for s in samples_ms]),
            "totals": {"batches": batches}}


@pytest.mark.parametrize("snaps", [
    [],
    [_snap("0", [1.0, 2.0, 3.0], 3)],
    [_snap("0", [1.0, 2.0, 3.0], 3), _snap("1", [4.0, 9.0], 2)],
    [_snap("0", [5.0], 1), _snap("1", [], 0), _snap("2", [2.5, 2.0], 2)],
    [{"exec_ms": None, "totals": None}, _snap("7", [1.5], 1),
     _snap("8", [3.0], 1)],
])
def test_cross_replica_spread_equals_jax(snaps):
    assert cross_replica_spread(snaps) == jspread(copy.deepcopy(snaps))


# ---------------------------------------------------------------------
# The typed surface
# ---------------------------------------------------------------------


def test_round_trip_kill_and_warm_replacement():
    """A 2-replica pool serves a burst, survives a kill of the bucket's
    home replica mid-stream, and the supervisor refills the slot from the
    shared store with zero builds."""
    with _fleet(replicas=2, autostart_supervisor=True,
                stable_after_s=0.05) as fleet:
        fleet.warmup([16])
        c0 = _compiles()
        mats = _mats(10)
        futs = [fleet.submit(a) for a in mats[:5]]
        home = bucket_for(16).bit_length() % 2
        fleet.slot_table()[home].replica.kill(reason="test")
        futs += [fleet.submit(a) for a in mats[5:]]
        results = [f.result(60) for f in futs]
        for a, r in zip(mats, results):
            assert r.inverse.device.type == CPU
            np.testing.assert_allclose(r.inverse.numpy() @ a, np.eye(16),
                                       atol=5e-4)
        deadline = time.monotonic() + 10
        while (fleet.stats()["ready"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.01)
        stats = fleet.stats()
        assert stats["ready"] == 2
        assert stats["ledger"]["outstanding"] == 0
        assert stats["ledger"]["resolved_ok"] == 10
        assert stats["journey_ledger"]["ok"] == 10
        assert stats["journey_ledger"]["gaps"] == []
        assert _compiles() == c0


def _open_breaker(replica, lane):
    br = replica.service.executors.breaker(lane)
    for _ in range(replica.service.policy.breaker_failures):
        br.record_failure()
    assert not br.allow()


def test_breaker_open_replica_gets_no_bucket_traffic():
    bucket = bucket_for(16)
    with _fleet(replicas=2) as fleet:
        fleet.warmup([16])
        home = bucket.bit_length() % fleet.slots
        victim = fleet.slot_table()[home].replica
        _open_breaker(victim, bucket)
        before = victim.service.stats()["totals"]["requests"]
        futs = [fleet.submit(a) for a in _mats(8)]
        assert all(not f.result(60).singular for f in futs)
        assert victim.service.stats()["totals"]["requests"] == before


def test_every_breaker_open_is_typed_circuit_open():
    bucket = bucket_for(16)
    with _fleet(replicas=2) as fleet:
        fleet.warmup([16])
        for slot in fleet.slot_table():
            _open_breaker(slot.replica, bucket)
        with pytest.raises(CircuitOpenError):
            fleet.submit(_mats(1)[0])
        # Another bucket's traffic is unaffected.
        assert not fleet.submit(_mats(1, n=96)[0]).result(60).singular


def test_saturation_is_typed_backpressure():
    with _fleet(replicas=2, max_queue=2, batch_cap=1,
                autostart=False) as fleet:
        fleet.warmup([16])
        accepted = 0
        with pytest.raises(ServiceOverloadedError):
            for a in _mats(10):
                fleet.submit(a)
                accepted += 1
        assert accepted == 4          # 2 replicas x max_queue=2
        fleet.start()


def test_no_live_replica_is_typed():
    with _fleet(replicas=2) as fleet:
        fleet.warmup([16])
        for slot in fleet.slot_table():
            slot.replica.kill(reason="test")
        with pytest.raises(ServiceOverloadedError):
            fleet.submit(_mats(1)[0])


def test_staged_kill_requeues_queued_work():
    reroutes = REGISTRY.counter("tpu_jordan_torch_fleet_reroutes_total")
    before = reroutes.total()
    with _fleet(replicas=3, autostart=False, max_queue=64) as fleet:
        fleet.warmup([16])
        futs = [fleet.submit(a) for a in _mats(12)]
        victim = max(fleet.slot_table(),
                     key=lambda s: s.replica.queued).replica
        assert victim.queued > 0
        victim.kill(reason="test")
        fleet.start()
        assert all(not f.result(60).singular for f in futs)
        assert fleet.stats()["ledger"]["resolved_ok"] == 12
    assert reroutes.total() > before


def test_total_loss_waits_for_warm_replacement():
    with _fleet(replicas=2, autostart=False, autostart_supervisor=True,
                stable_after_s=0.05, restart_grace_s=10.0,
                max_queue=64) as fleet:
        fleet.warmup([16])
        futs = [fleet.submit(a) for a in _mats(8)]
        for slot in fleet.slot_table():
            slot.replica.kill(reason="test")
        fleet.start()
        assert all(not f.result(60).singular for f in futs)
        stats = fleet.stats()
        assert stats["ledger"]["resolved_ok"] == 8
        assert stats["ledger"]["outstanding"] == 0


def test_exhausted_fleet_surfaces_typed_death():
    with _fleet(replicas=1, autostart=False) as fleet:
        fleet.warmup([16])
        fut = fleet.submit(_mats(1)[0])
        fleet.closing = True          # block re-dispatch (shutdown race)
        fleet.slot_table()[0].replica.kill(reason="test")
        with pytest.raises(ReplicaKilledError):
            fut.result(10)
        (ctx,) = fleet.journey.contexts()
        assert ctx.outcome() == ("error", "ReplicaKilledError")
        reject = next(e for e in ctx.events() if e["event"] == "reject")
        assert reject["reason"] == "closing"


def test_injected_replica_kill_fires_on_dispatch():
    deaths = REGISTRY.counter("tpu_jordan_torch_fleet_replica_deaths_total")
    before = sum(deaths.value(reason="injected", replica=s)
                 for s in ("0", "1"))
    plan = FaultPlan([FaultSpec("replica_kill", (3,), "permanent")])
    with _fleet(replicas=2) as fleet:
        fleet.warmup([16])
        with activate(plan):
            futs = [fleet.submit(a) for a in _mats(6)]
            assert all(not f.result(60).singular for f in futs)
        assert plan.injected_total == 1
    after = sum(deaths.value(reason="injected", replica=s)
                for s in ("0", "1"))
    assert after == before + 1


# ---------------------------------------------------------------------
# Liveness and supervision
# ---------------------------------------------------------------------


class _StubBatcher:
    def __init__(self):
        self.ticks = 0
        self.busy = False

    def progress(self):
        return self.ticks, self.busy


class _StubService:
    def __init__(self):
        self._batcher = _StubBatcher()
        self.closed = []

    def close(self, drain=True, error=None, join_timeout_s=None):
        self.closed.append((drain, join_timeout_s))


def _stamped_after(replica, t, timeout=5.0):
    deadline = time.monotonic() + timeout
    while replica.last_beat <= t and time.monotonic() < deadline:
        time.sleep(0.005)
    return replica.last_beat > t


def test_stuck_dispatcher_goes_stale_then_recovers():
    svc = _StubService()
    r = Replica(0, 1, svc, heartbeat_interval_s=0.01)
    try:
        assert _stamped_after(r, r.started_at)
        svc._batcher.busy = True
        time.sleep(0.15)
        stale_from = r.last_beat
        time.sleep(0.15)
        assert r.last_beat == stale_from
        svc._batcher.ticks += 1
        svc._batcher.busy = False
        assert _stamped_after(r, stale_from)
    finally:
        assert r.kill(reason="test")
    assert svc.closed == [(False, r._kill_join_timeout_s)]
    assert not r.kill(reason="test")           # idempotent


def test_wedge_detected_killed_and_replaced():
    clock = FakeClock()
    with _fleet(replicas=2, clock=clock, liveness_deadline_s=1.0) as fleet:
        fleet.warmup([16])
        c0 = _compiles()
        victim = fleet.slot_table()[0].replica
        victim.wedge()
        clock.advance(1.5)
        deadline = time.monotonic() + 5
        other = fleet.slot_table()[1].replica
        while other.last_beat < clock.t and time.monotonic() < deadline:
            time.sleep(0.01)
        fleet.supervisor.check()
        assert victim.state == DEAD
        stats = fleet.stats()
        assert stats["ready"] == 2
        assert stats["slots"][0]["lineage"] == ["r0g1", "r0g2"]
        assert REGISTRY.counter(
            "tpu_jordan_torch_fleet_replica_deaths_total").value(
                reason="wedged", replica="0") >= 1
        assert _compiles() == c0                  # a warm replacement


def test_restart_breaker_stops_crash_loop_then_half_open():
    clock = FakeClock()
    with _fleet(replicas=2, clock=clock, restart_failures=2,
                restart_cooldown_s=10.0, liveness_deadline_s=1e6,
                stable_after_s=1.0) as fleet:
        fleet.warmup([16])
        slot = fleet.slot_table()[0]
        slot.replica.kill(reason="test")
        fleet.supervisor.check()
        assert slot.replica.state == READY
        slot.replica.kill(reason="test")
        fleet.supervisor.check()
        assert slot.replica.state == DEAD
        assert fleet.stats()["ready"] == 1
        assert slot.breaker.state == "open"
        assert not fleet.submit(_mats(1)[0]).result(60).singular
        clock.advance(10.5)
        fleet.supervisor.check()
        assert slot.replica.state == READY
        clock.advance(1.5)
        fleet.supervisor.check()
        assert slot.breaker.state == "closed"


def test_warm_replacement_builds_nothing_and_serves():
    with _fleet(replicas=2) as fleet:
        fleet.warmup([16, 32], update_shapes=[(16, 2)],
                     solve_shapes=[(16, 1)])
        c0 = _compiles()
        fleet.slot_table()[1].replica.kill(reason="test")
        fleet.supervisor.check()
        replacement = fleet.slot_table()[1].replica
        assert replacement.generation == 2
        assert _compiles() == c0
        for n in (16, 32):
            assert not replacement.submit(
                _mats(1, n=n)[0]).result(60).singular
        assert _compiles() == c0


def _warm_batches(replica: str) -> dict:
    """{(workload, bucket, cap, rhs): inert warm batches} of one slot."""
    out = {}
    for key, v in REGISTRY.counter(
            "tpu_jordan_torch_serve_warm_batches_total").series().items():
        lb = dict(key)
        if lb.get("replica") == replica:
            out[(lb["workload"], int(lb["bucket"]), int(lb["cap"]),
                 int(lb["rhs"]))] = v
    return out


#: The lanes of warmup([16, 32], update_shapes=[(16, 2)], solve_shapes=
#: [(16, 1)]) at batch cap 4: every size lands in the 64 bucket.
WARM_LANES = {("invert", 64, 4, 0), ("invert", 64, 1, 0),
              ("solve", 64, 4, 1), ("update", 64, 1, 8),
              ("update", 64, 4, 8)}


@pytest.mark.parametrize("autostart", [True, False])
def test_warmup_runs_one_inert_batch_a_lane_on_each_dispatcher(
        monkeypatch, autostart):
    from tpu_jordan_torch.serve.executors import BucketExecutor

    ran = []
    warm = BucketExecutor.warm

    def spy(ex):
        ran.append((threading.current_thread(), ex.key))
        warm(ex)

    def ran_by(thread):
        return [k for t, k in ran if t is thread]

    monkeypatch.setattr(BucketExecutor, "warm", spy)
    with _fleet(replicas=2, autostart=autostart) as fleet:
        before = {r: _warm_batches(r) for r in ("0", "1")}
        fleet.warmup([16, 32], update_shapes=[(16, 2)],
                     solve_shapes=[(16, 1)])
        def deltas(r):
            after = _warm_batches(r)
            delta = {k: after[k] - before[r].get(k, 0) for k in after}
            return {k: d for k, d in delta.items() if d}

        if not autostart:
            # Deferred to each dispatcher's start, ahead of any batch.
            assert ran == []
            fleet.start()
            deadline = time.monotonic() + 30
            while (sum(sum(deltas(r).values()) for r in ("0", "1")) < 10
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        for r in ("0", "1"):
            assert deltas(r) == dict.fromkeys(WARM_LANES, 1)
        for slot in fleet.slot_table():
            assert len(ran_by(slot.replica.service._batcher._thread)) == 5
        ran.clear()
        fleet.slot_table()[1].replica.kill(reason="test")
        fleet.supervisor.check()
        replacement = fleet.slot_table()[1].replica
        assert replacement.generation == 2
        assert len(ran_by(replacement.service._batcher._thread)) == 5
        assert len(ran) == 5


def test_a_warming_replica_is_not_judged(monkeypatch):
    from tpu_jordan_torch.serve.executors import BucketExecutor

    warm = BucketExecutor.warm

    def slow(ex):
        time.sleep(0.3)
        warm(ex)

    monkeypatch.setattr(BucketExecutor, "warm", slow)
    deaths = REGISTRY.counter("tpu_jordan_torch_fleet_replica_deaths_total")
    wedged0 = deaths.value(reason="wedged", replica="0")
    with _fleet(replicas=1, autostart_supervisor=True,
                heartbeat_interval_s=0.01, check_interval_s=0.01,
                liveness_deadline_s=0.1) as fleet:
        replica = fleet.slot_table()[0].replica
        fleet.warmup([16])
        time.sleep(0.05)
        assert fleet.slot_table()[0].replica is replica
        assert replica.state == READY
    assert deaths.value(reason="wedged", replica="0") == wedged0


def test_close_is_idempotent_and_concurrent():
    fleet = _fleet(replicas=2)
    fleet.warmup([16])
    futs = [fleet.submit(a) for a in _mats(6)]
    errs = []

    def closer():
        try:
            fleet.close()
        except Exception as e:            # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=closer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fleet.close()
    assert errs == []
    assert all(not f.result(1).singular for f in futs)
    assert all(s.replica.state == "closed" for s in fleet.slot_table())
    with pytest.raises(ServiceOverloadedError):
        fleet.submit(_mats(1)[0])


def test_per_replica_metric_labels_and_spread():
    with _fleet(replicas=2) as fleet:
        fleet.warmup([16, 128])
        futs = [fleet.submit(a) for a in _mats(6) + _mats(6, n=100)]
        [f.result(60) for f in futs]
        c = REGISTRY.counter("tpu_jordan_torch_serve_requests_total")
        per_replica = [c.value(bucket=str(b), replica=r)
                       for b in (bucket_for(16), bucket_for(100))
                       for r in ("0", "1")]
        spread = fleet.stats()["exec_spread"]
    assert sum(per_replica) >= 12
    assert set(spread["replicas"]) == {"0", "1"}


def test_device_and_dtype_reach_every_replica():
    with _fleet(replicas=2, dtype="float64") as fleet:
        assert fleet.dtype == torch.float64
        assert fleet.device == torch.device(CPU)
        for r in fleet.live_replicas():
            assert r.service.device == torch.device(CPU)
            assert r.service.dtype == torch.float64


def test_fleet_without_a_card_refuses_typed():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tpu_jordan_torch.errors import DeviceUnavailableError

    with pytest.raises(DeviceUnavailableError):
        JordanFleet(replicas=2)


def test_drain_grow_and_pre_shed():
    """The pool's capacity calls and the router's pre-shed flag (the
    autoscaler's hooks): a drained slot parks empty and the supervisor
    leaves it so, the last live replica is never drained, ``grow`` refills
    the parked slot and then appends one, warm from the shared store; a
    pre-shed submission is typed backpressure with its journey and count."""
    shed = REGISTRY.counter("tpu_jordan_torch_fleet_shed_total")
    with _fleet(replicas=2) as fleet:
        fleet.warmup([16])
        c0 = _compiles()
        assert fleet.drain_slot() == 1
        assert fleet.slot_table()[1].parked
        assert fleet.slot_table()[1].replica is None
        assert fleet.drain_slot() is None
        fleet.supervisor.check()
        assert fleet.ready_count() == 1
        assert fleet.slot_table()[1].replica is None
        assert fleet.grow() == 1 and fleet.ready_count() == 2
        assert fleet.grow() == 2 and fleet.slots == 3
        assert fleet.ready_count() == 3
        assert _compiles() == c0
        before = shed.value(reason="pre_shed")
        fleet.router.pre_shed = True
        with pytest.raises(ServiceOverloadedError):
            fleet.submit(_mats(1)[0])
        assert shed.value(reason="pre_shed") == before + 1
        ctx = fleet.journey.contexts()[-1]
        assert ctx.outcome() == ("error", "ServiceOverloadedError")
        assert {"event": "reject", "reason": "pre_shed"}.items() <= next(
            e for e in ctx.events() if e["event"] == "reject").items()
        fleet.router.pre_shed = False
        assert not fleet.submit(_mats(1)[0]).result(60).singular


def test_checkpointed_solve_resumes_after_a_preemption(tmp_path):
    """``solve_system(ckpt=...)``: a preemption at the second segment
    boundary (after its checkpoint is durable) re-queues through the router,
    which finds the live token and resumes (the ``ckpt_resume`` hop); the
    solution's bits equal the uninterrupted run's."""
    from tpu_jordan_torch.obs.recorder import RECORDER
    from tpu_jordan_torch.resilience import (CheckpointStore,
                                             ResiliencePolicy, RetryPolicy)

    rng = np.random.default_rng(21)
    a = rng.standard_normal((96, 96)) + 8 * np.eye(96)
    b = rng.standard_normal((96, 4))
    store = CheckpointStore(str(tmp_path))
    spec = {"store": store, "cadence": 2, "engine": "unrolled",
            "block_size": 16}
    policy = ResiliencePolicy(retry=RetryPolicy(max_retries=4,
                                                backoff_s=0.0))
    mark = RECORDER.total
    with _fleet(replicas=2, dtype="float64", batch_cap=1,
                policy=policy) as fleet:
        base = fleet.solve_system(a, b, timeout=60,
                                  ckpt=dict(spec, run_id="t:base"))
        plan = FaultPlan([FaultSpec("preempt", (2,), "permanent")])
        with activate(plan):
            res = fleet.solve_system(a, b, timeout=60,
                                     ckpt=dict(spec, run_id="t:pre"))
    assert plan.injected_total == 1
    assert torch.equal(res.solution, base.solution)
    assert res.ckpt_info["resumed"] and not base.ckpt_info["resumed"]
    np.testing.assert_allclose(res.solution.numpy(),
                               np.linalg.solve(a, b), rtol=1e-9)
    hops = [e for e in RECORDER.since(mark) if e["kind"] == "journey"
            and e.get("event") == "ckpt_resume"]
    assert [e["run_id"] for e in hops] == ["t:pre"]
    assert store.ledger()["invariant_holds"]


# ---------------------------------------------------------------------
# The kill boundary of the update lanes
# ---------------------------------------------------------------------


def _update_stream(rng, n, count):
    return [(0.1 * rng.standard_normal((n, 1)),
             0.1 * rng.standard_normal((n, 1))) for _ in range(count)]


def test_kill_during_update_keeps_the_version_sequence():
    """The victim's dispatcher is held inside an update's launch (the
    handle's transaction open) while the replica is killed: the two
    updates queued behind it re-queue to the other replica and wait on the
    handle, the in-flight one commits version 1 on the abandoned
    dispatcher, then the others commit 2 and 3, each exactly once, and the
    final pair is bit-equal to a fault-free replay."""
    n = 16
    rng = np.random.default_rng(7)
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    muts = _update_stream(rng, n, 3)
    kw = dict(dtype="float64", batch_cap=1)

    with _fleet(replicas=2, **kw) as replay:
        replay.warmup([n], update_shapes=[(n, 1)])
        ref = replay.invert(a, resident=True)
        want = [replay.update(ref, u, v) for u, v in muts]
        st = replay.handles.get(ref.handle_id)
        want_a, want_inv = st.a.clone(), st.inverse.clone()

    with _fleet(replicas=2, **kw) as fleet:
        fleet.warmup([n], update_shapes=[(n, 1)])
        ref = fleet.invert(a, resident=True)
        (ex,) = [e for k, e in fleet.store.entries()
                 if k.workload == "update"]
        started, proceed = threading.Event(), threading.Event()
        inner = ex._fn

        def held(*args):
            if not started.is_set():
                started.set()
                assert proceed.wait(30)
            return inner(*args)

        ex._fn = held
        home = fleet.slot_table()[bucket_for(n).bit_length() % 2].replica
        futs = [fleet.submit_update(ref, *muts[0])]
        assert started.wait(30)
        futs += [fleet.submit_update(ref, u, v) for u, v in muts[1:]]
        assert home.queued == 2
        home.kill(reason="test")
        assert home.state == DEAD
        proceed.set()
        got = [f.result(60) for f in futs]
        st = fleet.handles.get(ref.handle_id)
        assert [r.handle_version for r in got] == [1, 2, 3]
        assert st.version == st.updates_applied == 3
        assert torch.equal(st.a, want_a) and torch.equal(st.inverse,
                                                         want_inv)
        for r, w in zip(got, want):
            assert r.update_outcome == w.update_outcome
            assert torch.equal(r.inverse, w.inverse)
        journeys = {c.request_id: [e["event"] for e in c.events()]
                    for c in fleet.journey.contexts()}
        requeued = [rid for rid, evs in journeys.items()
                    if "requeue" in evs]
        assert len(requeued) == 2
        assert fleet.stats()["ledger"]["outstanding"] == 0


# ---------------------------------------------------------------------
# fleet_demo through its checkers, and the CLI's flag contract
# ---------------------------------------------------------------------


def _check(tool, report, tmp_path, name):
    path = tmp_path / name
    path.write_text(json.dumps(report))
    return subprocess.run([sys.executable, str(ROOT / "tools" / tool),
                           str(path)], capture_output=True, text=True)


@pytest.fixture(scope="module")
def demo_report():
    return fleet_demo(n=96, replicas=3, requests=60, batch_cap=4, kills=2,
                      seed=0, device=CPU, slo_report=True)


def _timing_errors(rep) -> list:
    thr = rep["throughput"]
    errs = []
    if thr["scaling_x"] < thr["scaling_floor"]:
        errs.append("below the report's own floor")
    for key in ("fleet_p99_ms", "chaos_p99_ms"):
        if thr[key] > thr["p99_bound_ms"]:
            errs.append(f"{key} {thr[key]} exceeds the bound")
    return errs


def test_fleet_demo_passes_its_checkers(demo_report, tmp_path):
    rep = demo_report
    assert rep["silent_loss"] is False and rep["mismatches"] == []
    chaos = rep["chaos"]
    assert chaos["kills_injected"] == 2
    assert chaos["deaths"] >= 2 and chaos["restarts"] >= 1
    assert chaos["compiles_delta_after_warmup"] == 0
    assert rep["plan_cache"]["measurements"] == 0
    assert rep["plan_cache"]["read_only"] is True
    typed = sum(rep["typed_errors"].values())
    assert rep["matched_bitwise"] + typed == rep["requests"]
    assert rep["ledger"]["outstanding"] == 0
    assert rep["singular_flagged"] >= 1
    assert rep["journey_ledger"]["gaps"] == []
    assert rep["blackbox"]["dropped"] == 0
    out = _check("check_fleet.py", rep, tmp_path, "fleet.json")
    timing = _timing_errors(rep)
    if not timing:
        assert out.returncode == 0, out.stderr
    else:
        # The wall-clock verdicts alone (see the module docstring).
        lines = [ln for ln in out.stderr.splitlines() if ln.strip()]
        assert out.returncode == 1 and len(lines) == len(timing), out.stderr
        assert all(any(t in ln for t in timing) for ln in lines)
    out = _check("check_slo.py", rep, tmp_path, "slo.json")
    assert out.returncode == 0, out.stderr
    assert rep["slo"]["samples"] == 3


def _accepted(rep):
    """The report with its timing verdicts made to pass (the CPU does not
    hold them), so a doctored twin differs from an accepted one in one
    claim."""
    rep = copy.deepcopy(rep)
    thr = rep["throughput"]
    thr["scaling_x"] = max(thr["scaling_x"], thr["scaling_floor"])
    thr["p99_bound_ms"] = max(thr["p99_bound_ms"], thr["fleet_p99_ms"],
                              thr["chaos_p99_ms"])
    return rep


@pytest.mark.parametrize("doctor,rc", [
    ("compiled", 1), ("outstanding", 2), ("floor", 1), ("kills", 1),
    ("mismatch", 2)])
def test_check_fleet_rejects_doctored_reports(demo_report, tmp_path,
                                              doctor, rc):
    rep = _accepted(demo_report)
    assert _check("check_fleet.py", rep, tmp_path,
                  "base.json").returncode == 0
    if doctor == "compiled":
        rep["chaos"]["compiles_delta_after_warmup"] = 1
    elif doctor == "outstanding":
        rep["ledger"]["outstanding"] = 1
    elif doctor == "floor":
        rep["throughput"]["scaling_floor"] = 0.1
    elif doctor == "kills":
        rep["chaos"]["kills_injected"] = 0
    else:
        rep["mismatches"] = [{"request": 0, "why": "doctored"}]
    assert _check("check_fleet.py", rep, tmp_path,
                  f"{doctor}.json").returncode == rc


@pytest.mark.parametrize("doctor,rc", [("burn", 1), ("paging", 1),
                                       ("healthy", 1)])
def test_check_slo_rejects_doctored_reports(demo_report, tmp_path, doctor,
                                            rc):
    rep = copy.deepcopy(demo_report["slo"])
    obj = rep["objectives"][0]
    if doctor == "burn":
        obj["windows"][0]["long"]["burn_rate"] += 1.0
    elif doctor == "paging":
        obj["paging"] = not obj["paging"]
    else:
        rep["healthy"] = not rep["healthy"]
    assert _check("check_slo.py", rep, tmp_path,
                  f"{doctor}.json").returncode == rc


FLEET_BASE = ["96", "32", "--fleet-demo", "--quiet"]


@pytest.mark.parametrize("extra", [
    ["--workers", "8"], ["--chaos-demo"], ["--serve-demo"],
    ["--numerics-demo"], ["--replicas", "1"], ["--kills", "0"],
    ["--tune"], ["--batch", "2"], ["--group", "2"],
    ["--numerics", "summary"], ["--workload", "solve"],
])
def test_cli_fleet_demo_flag_contract_exit_1(extra):
    argv = FLEET_BASE + extra
    assert jmain(argv) == 1
    assert tmain(argv + ["--device", CPU]) == 1


@pytest.mark.parametrize("argv", [
    ["64", "8", "--slo-report"], ["64", "8", "--workers", "0"],
    ["64", "8", "--capacity-demo", "--kills", "1"],
])
def test_cli_misapplied_fleet_flags_exit_1_in_both(argv):
    assert jmain(argv) == 1
    assert tmain(argv + ["--device", CPU]) == 1


@pytest.mark.parametrize("argv,item", [
    # The ids are kept from when these cases were later Queue A items'
    # refusals.  Queue A is ported: argv0, argv1 and argv5 are now the
    # single-device demos' refusals of the distributed flags, argv4 the
    # comm demo's, each in the JAX CLI's words; argv2 and argv3 (the
    # augmented engine on 2 ranks and on a 2x2 mesh) run (item None:
    # exit 0).
    pytest.param(["64", "8", "--autoscale-demo", "--workers", "2"],
                 "runs on a single device", id="argv0-item 14d"),
    pytest.param(["64", "8", "--update-demo", "--no-gather"],
                 "runs on a single device", id="argv1-item 14d"),
    pytest.param(["64", "8", "--workers", "2", "--engine", "augmented"],
                 None, id="argv2-item 14d"),
    pytest.param(["64", "8", "--workers", "2x2", "--engine", "augmented"],
                 None, id="argv3-item 14d"),
    pytest.param(["64", "8", "--workers", "2x4", "--comm-demo"],
                 "--workers and --no-gather do not apply",
                 id="argv4-item 15"),
    pytest.param(["96", "32", "--fleet-demo", "--workers", "8"],
                 "--fleet-demo runs on a single device", id="argv5-item 15"),
])
def test_cli_later_items_refused_typed(argv, item, capsys):
    if item is None:
        assert tmain(argv + ["--device", CPU]) == 0
        assert "residual" in capsys.readouterr().out
        return
    assert tmain(argv + ["--device", CPU]) == 1
    assert item in capsys.readouterr().err


def test_cli_fleet_demo_runs_and_checks(capsys, tmp_path):
    assert tmain(["64", "16", "--fleet-demo", "--slo-report", "--quiet",
                  "--serve-requests", "24", "--batch-cap", "4",
                  "--device", CPU]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rep = json.loads(line)
    assert rep["metric"] == "fleet_demo" and rep["device"] == CPU
    assert "log" not in rep["chaos"]["faults"]
    assert not rep["silent_loss"]
    assert _check("check_slo.py", rep, tmp_path, "s.json").returncode == 0
