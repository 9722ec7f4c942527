"""Request journeys, exemplars, the journey lanes of the trace and the
thread-safe kernel loader, on the CPU.

One staged stream (an invert lane, a solve lane, a singular rider, an
overload rejection and a cancelled request) goes through both packages'
services: the outcome ledgers are equal and so is each request's sequence
of hops (names and their non-timing attributes).  The Chrome trace gets one
lane per request and passes ``tools/check_telemetry.py``; exemplars follow
the JAX metrics; ``_build.load`` runs a library's build once however many
threads ask for it first.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from tpu_jordan import serve as jserve
from tpu_jordan.obs import journey as jjourney
from tpu_jordan.obs.recorder import RECORDER as JRECORDER

from tpu_jordan_torch import _build
from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.obs import export, journey
from tpu_jordan_torch.obs import spans as tspans
from tpu_jordan_torch.obs.metrics import MetricsRegistry
from tpu_jordan_torch.obs.recorder import RECORDER
from tpu_jordan_torch.resilience import (FaultPlan, FaultSpec,
                                         ResiliencePolicy, RetryPolicy,
                                         activate)
from tpu_jordan_torch.serve import JordanService, ServiceOverloadedError

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"

#: Hop attributes that carry time or a package's own naming.
_VOLATILE = {"t", "kind", "seq", "request_id", "seconds", "engine"}


def _stream(rng):
    mats = [rng.standard_normal((s, s)).astype(np.float32)
            for s in (24, 48, 100, 30)]
    rhs = rng.standard_normal((48, 2)).astype(np.float32)
    return mats, rhs


def _drive(svc, recorder, overloaded, mats, rhs):
    """The staged stream; returns the recorder's journey slice."""
    mark = recorder.total
    svc.warmup(shapes=[24, 100])
    futs = [svc.submit(a) for a in mats]
    futs.append(svc.submit(np.ones((40, 40), np.float32)))   # singular
    futs.append(svc.submit(mats[1], rhs))                    # solve lane
    cancelled = svc.submit(mats[0])
    assert cancelled.cancel()
    with pytest.raises(overloaded):
        svc.submit(mats[2])                                  # queue full
    svc.start()
    for f in futs:
        f.result(120)
    svc.close()
    return [e for e in recorder.since(mark) if e["kind"] == "journey"]


def _hops(events):
    out = {}
    for e in events:
        out.setdefault(e["request_id"].split("-")[-1], []).append(
            {k: v for k, v in e.items() if k not in _VOLATILE})
    return out


def test_journeys_and_ledger_equal_jax(rng):
    mats, rhs = _stream(rng)
    mine = _drive(JordanService(batch_cap=4, max_wait_ms=1.0, max_queue=7,
                                autostart=False, device=CPU),
                  RECORDER, ServiceOverloadedError, mats, rhs)
    ref = _drive(jserve.JordanService(batch_cap=4, max_wait_ms=1.0,
                                      max_queue=7, autostart=False),
                 JRECORDER, jserve.ServiceOverloadedError, mats, rhs)
    assert journey.outcome_ledger(mine) == jjourney.outcome_ledger(ref)
    led = journey.outcome_ledger(mine)
    assert led["submitted"] == 8 and led["gaps"] == []
    assert led["typed_errors"] == {"Cancelled": 1,
                                   "ServiceOverloadedError": 1}
    assert led["singular_flagged"] == 1
    assert _hops(mine) == _hops(ref)
    names = [e["event"] for e in mine if e["request_id"].endswith("00001")]
    assert names == ["submit", "enqueue", "dispatch", "executor", "served",
                     "result"]


def test_chrome_trace_with_journey_lanes_passes_the_checker(rng, tmp_path):
    tel = tspans.Telemetry()
    mark = RECORDER.total
    with JordanService(batch_cap=2, max_wait_ms=1.0, telemetry=tel,
                       device=CPU) as svc:
        svc.invert(rng.standard_normal((32, 32)).astype(np.float32),
                   timeout=120)
        svc.solve_system(np.eye(20, dtype=np.float32),
                         np.ones(20, np.float32), timeout=120)
    events = [e for e in RECORDER.since(mark) if e["kind"] == "journey"]
    doc = export.to_chrome_trace(tel, journey_events=events)
    lanes = [e for e in doc["traceEvents"] if e["ph"] in ("b", "e", "n")]
    assert {e["id"] for e in lanes} == {e["request_id"] for e in events}
    assert {e["name"] for e in doc["traceEvents"]
            if e["ph"] == "X"} >= {"compile", "execute"}
    path = tmp_path / "t.json"
    export.write_chrome_trace(str(path), tel, journey_events=events)
    prom = tmp_path / "m.prom"
    export.write_metrics(str(prom))
    proc = subprocess.run([sys.executable,
                           str(ROOT / "tools" / "check_telemetry.py"),
                           str(prom), str(path)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_journey_log_ids_close_and_future_mapping():
    from concurrent.futures import Future

    log = journey.JourneyLog(prefix="jt")
    other = journey.JourneyLog(prefix="jt")
    assert other.prefix == "jt2"
    a, b = log.new(10, 64), log.new(20, 64, workload="solve")
    assert (a.request_id, b.request_id) == ("jt-00001", "jt-00002")
    a.close("ok", singular=False)
    a.close("error", error="Late")                   # first closer wins
    assert a.outcome() == ("ok", None)
    f = Future()
    f.set_exception(ValueError("x"))
    b.close_from_future(f)
    assert b.outcome() == ("error", "ValueError")
    c = log.new(5, 64)
    f = Future()
    f.cancel()
    c.close_from_future(f)
    assert c.outcome() == ("error", "Cancelled")
    assert log.active_count() == 0
    assert log.ledger()["typed_errors"] == {"Cancelled": 1,
                                            "ValueError": 1}


def test_explanatory_hops_and_consts_match_the_jax_and_checker_copies():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import check_blackbox
    finally:
        sys.path.pop(0)
    assert journey.EXPLANATORY_HOPS == jjourney.EXPLANATORY_HOPS
    assert journey.EXPLANATORY_HOPS == check_blackbox.EXPLANATORY_HOPS
    assert journey.MAX_EVENTS_PER_REQUEST == jjourney.MAX_EVENTS_PER_REQUEST


def test_exemplars_follow_the_jax_metrics():
    reg = MetricsRegistry()
    c = reg.counter("tpu_jordan_torch_test_total")
    c.inc(component="a")
    assert c.exemplar(component="a") is None
    c.inc(2, exemplar="req-00007", component="a")
    assert c.exemplar(component="a") == "req-00007"
    assert c.value(component="a") == 3.0          # never a label
    series = reg.snapshot()["tpu_jordan_torch_test_total"]["series"]
    assert series == [{"labels": {"component": "a"}, "value": 3.0,
                       "exemplar": "req-00007"}]


def test_retry_exemplar_reaches_the_counter_and_the_recorder(rng):
    from tpu_jordan_torch.obs.metrics import REGISTRY

    mark = RECORDER.total
    pol = ResiliencePolicy(retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    with JordanService(batch_cap=1, max_wait_ms=0.5, policy=pol,
                       device=CPU) as svc:
        svc.warmup(shapes=[32])
        with activate(FaultPlan([FaultSpec("execute", (1,),
                                           "transient")])):
            svc.invert(rng.standard_normal((32, 32)).astype(np.float32),
                       timeout=120)
        rid = svc.journey.contexts()[-1].request_id
    retries = [e for e in RECORDER.since(mark) if e["kind"] == "retry"]
    assert [e.get("request_id") for e in retries] == [rid]
    assert REGISTRY.counter("tpu_jordan_torch_retries_total").exemplar(
        component="serve.execute") == rid


def test_json_line_refuses_colliding_extras():
    line = export.to_json_line(MetricsRegistry(), note="x")
    assert '"note": "x"' in line and '"metric": "telemetry"' in line
    with pytest.raises(UsageError, match="collide"):
        export.to_json_line(MetricsRegistry(), metrics={})


def test_build_load_runs_one_build_for_racing_threads(monkeypatch):
    builds, started = [], threading.Barrier(4)

    def slow_build(names, verbose=False):
        builds.append(tuple(names))
        time.sleep(0.2)
        return {n: "" for n in names}

    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    libs = []

    def load():
        started.wait(10)
        libs.append(_build.load("gj_probe"))

    threads = [threading.Thread(target=load) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert builds == [("gj_probe",)]
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)


def test_build_temp_names_differ_between_threads(monkeypatch, tmp_path):
    seen, both = [], threading.Barrier(2)

    class Proc:
        def __init__(self, cmd, **kw):
            seen.append(cmd[cmd.index("-o") + 1])
            both.wait(10)             # both builds in flight at once

    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    threads = [threading.Thread(target=_build._start,
                                args=("gj_probe", False))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(seen) == 2 and seen[0] != seen[1]
