"""The port's ``FleetAutoscaler`` and ``autoscale_demo`` against the JAX
package's, on the CPU.

The JAX tests' fake-clock harness (a scripted registry, a four-method fake
pool) drives both packages' autoscalers through the same tick scripts:
scale-up on a two-window burn, the capacity veto, cooldown spacing, the
ceiling and floor, the p99-risk pre-shed and the skew judge's veto (a fake
judge: the port has no ``FleetSkewJudge`` until ROADMAP.md Queue A item
15b).  Every tick summary and every recorded action (evidence included)
must be equal: the policy is host arithmetic on the same numbers, so there
is no tolerance.  Then each package runs its ``--autoscale-demo`` at n = 64
(the JAX default) and ``tools/check_autoscale.py`` judges the port's report
as a subprocess (exit 0).  The demo's action counts ride real sleeps and
queue waits, so the two demos are held to the same loop, not to the same
number of scale steps.
"""

import json
import pathlib
import subprocess
import sys
import time
import types

import pytest

from tpu_jordan.fleet import FleetAutoscaler as JAutoscaler
from tpu_jordan.fleet import autoscale_demo as jdemo
from tpu_jordan.obs.slo import SLOMonitor as JMonitor
from tpu_jordan.obs.slo import SLOSpec as JSpec

from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.fleet.autoscaler import FleetAutoscaler as TAutoscaler
from tpu_jordan_torch.fleet.autoscaler import autoscale_demo as tdemo
from tpu_jordan_torch.obs.metrics import REGISTRY as TREGISTRY
from tpu_jordan_torch.obs.recorder import RECORDER as TRECORDER
from tpu_jordan_torch.obs.slo import SLOMonitor as TMonitor
from tpu_jordan_torch.obs.slo import SLOSpec as TSpec

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHECKER = ROOT / "tools" / "check_autoscale.py"

PACKAGES = {
    "jax": (JAutoscaler, JMonitor, JSpec, "tpu_jordan",
            "tpu_jordan.obs.capacity.live_bytes"),
    "torch": (TAutoscaler, TMonitor, TSpec, "tpu_jordan_torch",
              "tpu_jordan_torch.obs.capacity.live_bytes"),
}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


class FakeRegistry:
    """The two series the burn windows and the p99 objective read, under a
    package's metric prefix."""

    def __init__(self, prefix, bucket="64"):
        self.prefix, self.bucket = prefix, bucket
        self.ok = self.err = 0
        self.p99_s = None

    def snapshot(self):
        snap = {f"{self.prefix}_request_outcome_total": {"series": [
            {"labels": {"bucket": self.bucket, "outcome": "ok"},
             "value": float(self.ok)},
            {"labels": {"bucket": self.bucket, "outcome": "error"},
             "value": float(self.err)},
        ]}}
        if self.p99_s is not None:
            snap[f"{self.prefix}_request_latency_seconds"] = {"series": [
                {"labels": {"bucket": self.bucket}, "p99": self.p99_s}]}
        return snap


class FakePool:
    """Ready count, grow, drain and the router's pre-shed flag."""

    def __init__(self, ready=1):
        self._ready = int(ready)
        self.router = types.SimpleNamespace(pre_shed=False)
        self.grown = self.drained = 0

    def ready_count(self):
        return self._ready

    def grow(self):
        self._ready += 1
        self.grown += 1
        return self._ready - 1

    def drain_slot(self):
        self._ready -= 1
        self.drained += 1
        return self._ready


class FakeJudge:
    """A skew judge: ``veto()`` returns the scripted verdict."""

    def __init__(self):
        self.verdict = None

    def veto(self):
        return self.verdict


def _harness(pkg, ready=1, p99_ms=100.0, floor=1, ceiling=3,
             idle_after_s=5.0, cooldown=0.0, **kw):
    scaler_cls, monitor_cls, spec_cls, prefix, _ = PACKAGES[pkg]
    clock = FakeClock()
    reg = FakeRegistry(prefix)
    monitor = monitor_cls(
        [spec_cls(name="demo", bucket="64", availability=0.9,
                  p99_latency_ms=p99_ms)],
        registry=reg, clock=clock, windows=((10.0, 2.0, 1.0),))
    pool = FakePool(ready=ready)
    scaler = scaler_cls(pool, monitor, floor=floor, ceiling=ceiling,
                        idle_after_s=idle_after_s,
                        scale_cooldown_s=cooldown, clock=clock, **kw)
    return clock, reg, pool, scaler


# One script step: (advance seconds, ok, err, p99 seconds, veto verdict).
_VETO = {"replica": "2", "spread": 5.5, "threshold": 2.0}
SCRIPTS = {
    "full_cycle": (dict(), [
        (0, 0, 0, None, None), (1, 5, 5, None, None),
        (1, 5, 5, None, None), (1, 5, 5, None, None),
        (11, 5, 5, None, None), (1, 5, 5, None, None),
        (1, 5, 5, None, None)]),
    "cooldown": (dict(cooldown=100.0), [
        (0, 0, 0, None, None), (1, 5, 5, None, None),
        (1, 5, 5, None, None), (1, 9, 9, None, None)]),
    "ceiling_and_floor": (dict(idle_after_s=0.0, ceiling=2), [
        (0, 0, 0, None, None), (1, 0, 0, None, None),
        (1, 5, 5, None, None), (1, 5, 5, None, None)]),
    "p99_risk": (dict(ready=2, idle_after_s=0.0), [
        (0, 0, 0, 0.090, None), (1, 0, 0, 0.010, None),
        (1, 0, 0, 0.010, None)]),
    "skew_veto": (dict(ready=2, idle_after_s=0.0), [
        (0, 0, 0, 0.090, _VETO), (1, 0, 0, 0.090, _VETO),
        (1, 5, 5, 0.090, _VETO), (20, 10, 0, 0.090, None),
        (1, 10, 0, 0.090, None)]),
}


def _drive(pkg, name, monkeypatch, budget=None, live=None):
    kw, script = SCRIPTS[name]
    judge = FakeJudge() if name == "skew_veto" else None
    if judge is not None:
        kw = dict(kw, skew_judge=judge)
    if budget is not None:
        kw = dict(kw, scale_budget_bytes=budget)
    # The capacity ledger is process-wide: pin what it reports, so the
    # evidence compares equal whatever else the process holds.
    monkeypatch.setattr(PACKAGES[pkg][4], lambda *a, **k: live or 0)
    clock, reg, pool, scaler = _harness(pkg, **kw)
    ticks = []
    for dt, ok, err, p99, verdict in script:
        clock.advance(dt)
        reg.ok, reg.err, reg.p99_s = ok, err, p99
        if judge is not None:
            judge.verdict = verdict
        ticks.append(scaler.tick())
    return ticks, scaler.actions, (pool.grown, pool.drained,
                                   pool.router.pre_shed)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tick_scripts_match_jax(name, monkeypatch):
    j = _drive("jax", name, monkeypatch)
    t = _drive("torch", name, monkeypatch)
    assert t == j
    assert t[1], "the script must exercise the policy"


@pytest.mark.parametrize("live", [5000, 10])
def test_capacity_veto_matches_jax(live, monkeypatch):
    """Over its budget the ledger withholds the grow (``scale_withheld``,
    ready unchanged); under it the grow proceeds, in both packages."""
    j = _drive("jax", "cooldown", monkeypatch, budget=1000, live=live)
    t = _drive("torch", "cooldown", monkeypatch, budget=1000, live=live)
    assert t == j
    want = "scale_withheld" if live >= 1000 else "scale_up"
    assert t[1][0]["action"] == want


def test_actions_are_counted_and_recorded(monkeypatch):
    """Each action is a ``tpu_jordan_torch_autoscale_actions_total``
    increment and a flight-recorder ``autoscale`` event, in order."""
    c = TREGISTRY.counter("tpu_jordan_torch_autoscale_actions_total")
    before = {a: c.value(action=a) for a in ("scale_up", "drain",
                                             "pre_shed_on",
                                             "pre_shed_off")}
    mark = TRECORDER.total
    _, actions, _ = _drive("torch", "full_cycle", monkeypatch)
    kinds = [a["action"] for a in actions]
    assert kinds == ["scale_up", "pre_shed_on", "scale_up",
                     "pre_shed_off", "drain", "drain"]
    for a in before:
        assert c.value(action=a) - before[a] == kinds.count(a)
    events = [e for e in TRECORDER.since(mark) if e["kind"] == "autoscale"]
    assert [e["action"] for e in events] == kinds


def test_bounds_are_validated_in_both():
    for pkg in PACKAGES:
        _, _, pool, scaler = _harness(pkg)
        cls = PACKAGES[pkg][0]
        with pytest.raises(ValueError, match="floor"):
            cls(pool, scaler.monitor, floor=0)
        with pytest.raises(ValueError, match="ceiling"):
            cls(pool, scaler.monitor, floor=3, ceiling=2)


def test_background_loop_ticks_and_stops():
    """``start`` ticks on a thread until ``stop`` joins it."""
    _, _, _, scaler = _harness("torch")
    scaler.clock = time.monotonic
    scaler.start(interval_s=0.01)
    deadline = time.monotonic() + 5.0
    while scaler.ticks < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    scaler.stop()
    assert scaler.ticks >= 3 and scaler._thread is None
    n = scaler.ticks
    time.sleep(0.05)
    assert scaler.ticks == n


def _loop_shape(report):
    kinds = report["actions_by_kind"]
    return {
        "legs": {k: kinds.get(k, 0) >= 1 for k in (
            "scale_up", "drain", "pre_shed_on", "pre_shed_off")},
        "ends_at_floor": report["ready_trajectory"][-1] == report["floor"],
        "silent": report["silent_p99_breach"],
        "outstanding": report["ledger"]["outstanding"],
        "config": report["config"],
        "waves": (report["waves"], report["requests_per_wave"]),
        "recovery_clean": not report["phases"]["recovery"]["typed_errors"],
        "deadline_burn": any(
            w["typed_errors"].get("DeadlineExceededError")
            for w in report["phases"]["burst"]["waves"]),
    }


def test_demo_matches_jax_and_passes_the_checker(tmp_path):
    """Both demos at n = 64 walk the whole loop; the port's report passes
    ``tools/check_autoscale.py`` unchanged."""
    jrep = jdemo(n=64, block_size=16)
    trep = tdemo(n=64, block_size=16, device="cpu")
    assert _loop_shape(trep) == _loop_shape(jrep)
    assert _loop_shape(trep)["legs"] == dict.fromkeys(
        ("scale_up", "drain", "pre_shed_on", "pre_shed_off"), True)
    assert trep["pre_shed_count"] >= 1
    path = tmp_path / "autoscale.json"
    path.write_text(json.dumps(trep))
    out = subprocess.run([sys.executable, str(CHECKER), str(path)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


def test_cli_demo_runs_and_checks(capsys):
    assert tmain(["48", "16", "--autoscale-demo", "--serve-requests",
                  "32", "--batch-cap", "4", "--quiet", "--device",
                  "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "slo_final" not in json.loads(line)
    out = subprocess.run([sys.executable, str(CHECKER), "-"], input=line,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("extra", [
    ["--replicas", "1"], ["--kills", "1"], ["--engine", "inplace"],
    ["--workload", "solve"], ["--numerics", "summary"], ["--slo-report"],
    ["--batch", "2"], ["--tune"], ["--group", "2"], ["--fleet-demo"],
    ["--workers", "2"], ["--no-gather"], ["--plan-cache", "/tmp/p.json"],
])
def test_cli_flag_contract_exit_1(extra):
    from tpu_jordan.__main__ import main as jmain

    argv = ["64", "8", "--autoscale-demo", "--quiet"] + extra
    assert jmain(argv) == 1
    assert tmain(argv + ["--device", "cpu"]) == 1
