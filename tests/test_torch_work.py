"""The port's work observatory (``obs/work.py``) against the JAX package's,
on the CPU.

  * ``work.engine_report`` on the same layouts as the JAX package's
    (``tpu_jordan.obs.work.engine_report``): 1D p ∈ {1, 2, 3, 4} and the
    meshes (2, 2), (2, 3), (1, 4), (4, 1), a ragged and an aligned n, the
    invert and solve workloads, k ∈ {1, 3}, ``unroll`` passed explicitly.
    The per-worker and per-superstep FLOPs, the convention, the executed
    model, the ragged penalty and the skew are equal exactly: integer
    layout math, no tolerance.
  * ``FleetSkewJudge`` and ``expected_latency_factor`` give the JAX
    package's verdicts, spreads and flight-recorder events on the same p99
    inputs (suspected, layout-attributed, recovered), and the demo's fleet
    legs are the JAX package's.
  * The real judge drives the port's autoscaler veto
    (``fleet/autoscaler.py``) as the JAX judge drives the JAX autoscaler,
    on one script: every tick and every action equal.
  * On one world of 4 CPU ranks, the counted GEMM pin of each engine and
    layout is within ``XLA_BAND`` of the executed model; with recording off
    nothing is counted.  The pin counts the engine section alone.
"""

import types

import pytest

from tpu_jordan.fleet import FleetAutoscaler as JAutoscaler
from tpu_jordan.obs import work as jwork
from tpu_jordan.obs.recorder import RECORDER as JRECORDER
from tpu_jordan.obs.slo import SLOMonitor as JMonitor
from tpu_jordan.obs.slo import SLOSpec as JSpec
from tpu_jordan.parallel import layout as jl

from tpu_jordan_torch.fleet.autoscaler import FleetAutoscaler as TAutoscaler
from tpu_jordan_torch.obs import comm
from tpu_jordan_torch.obs import work as twork
from tpu_jordan_torch.obs.recorder import RECORDER as TRECORDER
from tpu_jordan_torch.obs.slo import SLOMonitor as TMonitor
from tpu_jordan_torch.obs.slo import SLOSpec as TSpec
from tpu_jordan_torch.parallel import layout as tl
from tpu_jordan_torch.parallel import run_calls, run_workers
from tpu_jordan_torch.parallel.group import RankLog, collecting, section
from tpu_jordan_torch.parallel.group import tally_gemm

M = 8
LAYOUTS = [1, 2, 3, 4, (2, 2), (2, 3), (1, 4), (4, 1)]
SIZES = [44, 96]          # ragged (44 % 8 != 0), aligned (96 = 12·8)
WORKLOADS = [("inplace", 0), ("solve_sharded", 1), ("solve_sharded", 3)]


def _layouts(w, n):
    if isinstance(w, tuple):
        return (jl.CyclicLayout2D.create(n, M, *w),
                tl.CyclicLayout2D.create(n, M, *w))
    return jl.CyclicLayout.create(n, M, w), tl.CyclicLayout.create(n, M, w)


def _fields(rep):
    return {"per_worker": rep.per_worker,
            "per_superstep": rep.per_superstep,
            "convention": rep.convention,
            "executed_model": rep.executed_model,
            "ragged_penalty": rep.ragged_penalty, "skew": rep.skew(),
            "exact": rep.exact, "supersteps": rep.supersteps,
            "padded_supersteps": rep.padded_supersteps,
            "padded_n": rep.padded_n, "last_height": rep.last_height,
            "max_worker_flops": rep.max_worker_flops()}


@pytest.mark.parametrize("unroll", [True, False])
@pytest.mark.parametrize("engine,k", WORKLOADS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("workers", LAYOUTS, ids=str)
def test_inventory_equals_jax(workers, n, engine, k, unroll):
    jlay, tlay = _layouts(workers, n)
    j = jwork.engine_report(engine=engine, lay=jlay, k=k, unroll=unroll)
    t = twork.engine_report(engine=engine, lay=tlay, k=k, unroll=unroll)
    assert _fields(t) == _fields(j)
    assert t.exact
    assert t.to_json()["per_worker"] == j.to_json()["per_worker"]
    assert (twork.expected_latency_factor(t)
            == jwork.expected_latency_factor(j))


@pytest.mark.parametrize("engine", ["inplace", "grouped", "swapfree",
                                    "lookahead", "solve_lookahead"])
def test_default_unroll_is_the_eager_loop(engine):
    """In the port the traced model is the executed model."""
    rep = twork.engine_report(engine=engine,
                              lay=tl.CyclicLayout.create(44, M, 4), k=2)
    assert rep.unroll is True
    assert rep.to_json()["unroll"] is True


# The "augmented" case keeps its id from before that engine had an
# inventory (it has one now: test_torch_sharded_augmented.py); the name it
# tries is one no engine has.
@pytest.mark.parametrize("engine", [
    pytest.param("augmented_2d", id="augmented"), "sharded_jordan"])
def test_unknown_engine_raises(engine):
    with pytest.raises(ValueError, match="inventory"):
        twork.engine_report(engine=engine,
                            lay=tl.CyclicLayout.create(44, M, 4))


def _events(recorder, mark):
    return [{k: v for k, v in e.items() if k not in ("t", "seq")}
            for e in recorder.since(mark)
            if e["kind"] in ("straggler_suspected", "straggler_cleared")]


# Each script: a list of (p99_ms, expected) observations.
JUDGE_SCRIPTS = {
    "suspected_then_recovered": [
        ({"0": 10.0, "1": 10.5, "2": 52.0}, None),
        ({"0": 10.0, "1": 10.5, "2": 60.0}, None),
        ({"0": 11.0, "1": 11.0, "2": 11.0}, None)],
    "layout_attributed": [
        ({"0": 10.0, "1": 40.0}, {"0": 1.0e6, "1": 4.0e6})],
    "one_replica": [({"0": 12.0, "1": None}, None)],
    "threshold_edge": [({"0": 10.0, "1": 20.0}, None),
                       ({"0": 10.0, "1": 20.5}, None)],
}


@pytest.mark.parametrize("name", sorted(JUDGE_SCRIPTS))
def test_judge_matches_jax(name):
    out = {}
    for pkg, judge_cls, rec in (("jax", jwork.FleetSkewJudge, JRECORDER),
                                ("torch", twork.FleetSkewJudge, TRECORDER)):
        judge = judge_cls()
        mark = rec.total
        verdicts = [judge.assess(p99, expected)
                    for p99, expected in JUDGE_SCRIPTS[name]]
        out[pkg] = (verdicts, judge.veto(), judge.last_verdict,
                    _events(rec, mark))
    assert out["torch"] == out["jax"]


def test_layout_factor_matches_jax():
    for p in (2, 8):
        j = jwork.engine_report(engine="inplace",
                                lay=jl.CyclicLayout.create(44, 8, p))
        t = twork.engine_report(engine="inplace",
                                lay=tl.CyclicLayout.create(44, 8, p))
        assert (twork.expected_latency_factor(t)
                == jwork.expected_latency_factor(j))


def test_fleet_skew_legs_match_jax():
    jm, tm = JRECORDER.total, TRECORDER.total
    jlegs, jfleet = jwork._fleet_skew_legs()
    tlegs, tfleet = twork._fleet_skew_legs()
    assert [leg["verdict"] for leg in tlegs] == [leg["verdict"]
                                                 for leg in jlegs]
    assert [leg["expect_suspected"] for leg in tlegs] == [
        leg["expect_suspected"] for leg in jlegs]
    assert tfleet == jfleet
    assert _events(TRECORDER, tm) == _events(JRECORDER, jm)


# --- The autoscaler's veto, driven by the real judge.


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Registry:
    def __init__(self, prefix):
        self.prefix, self.p99_s = prefix, None

    def snapshot(self):
        snap = {f"{self.prefix}_request_outcome_total": {"series": [
            {"labels": {"bucket": "64", "outcome": "ok"}, "value": 0.0},
            {"labels": {"bucket": "64", "outcome": "error"},
             "value": 0.0}]}}
        if self.p99_s is not None:
            snap[f"{self.prefix}_request_latency_seconds"] = {"series": [
                {"labels": {"bucket": "64"}, "p99": self.p99_s}]}
        return snap


class _Pool:
    def __init__(self):
        self.router = types.SimpleNamespace(pre_shed=False)

    def ready_count(self):
        return 2

    def grow(self):
        raise AssertionError("no grow in this script")

    def drain_slot(self):
        return None


# (advance s, p99 s, fleet p99s fed to the judge)
VETO_SCRIPT = [(0, 0.090, {"0": 10.0, "1": 10.0, "2": 55.0}),
               (1, 0.090, {"0": 10.0, "1": 10.0, "2": 58.0}),
               (1, 0.090, {"0": 10.0, "1": 10.5, "2": 11.0}),
               (1, 0.090, {"0": 10.0, "1": 10.5, "2": 11.0}),
               (1, 0.010, {"0": 10.0, "1": 10.5, "2": 11.0})]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_real_judge_drives_the_autoscaler_veto(pkg, monkeypatch):
    runs = {}
    for name, scaler_cls, mon_cls, spec_cls, judge_cls, prefix, live in (
            ("jax", JAutoscaler, JMonitor, JSpec, jwork.FleetSkewJudge,
             "tpu_jordan", "tpu_jordan.obs.capacity.live_bytes"),
            ("torch", TAutoscaler, TMonitor, TSpec, twork.FleetSkewJudge,
             "tpu_jordan_torch", "tpu_jordan_torch.obs.capacity.live_bytes")):
        monkeypatch.setattr(live, lambda *a, **k: 0)
        clock, reg, judge = _Clock(), _Registry(prefix), judge_cls()
        monitor = mon_cls([spec_cls(name="demo", bucket="64",
                                    availability=0.9, p99_latency_ms=100.0)],
                          registry=reg, clock=clock,
                          windows=((10.0, 2.0, 1.0),))
        pool = _Pool()
        scaler = scaler_cls(pool, monitor, floor=1, ceiling=3,
                            idle_after_s=1e9, scale_cooldown_s=0.0,
                            clock=clock, skew_judge=judge)
        ticks = []
        for dt, p99_s, fleet in VETO_SCRIPT:
            clock.t += dt
            reg.p99_s = p99_s
            judge.assess(fleet)
            ticks.append(scaler.tick())
        runs[name] = (ticks, scaler.actions, pool.router.pre_shed)
    assert runs["torch"] == runs["jax"]
    actions = [a["action"] for a in runs[pkg][1]]
    assert actions[0] == "pre_shed_vetoed" and "pre_shed_on" in actions


# --- The counted pin on one world.

PIN_LEGS = {
    "1d_inplace": ("invert", dict(workers=4, engine="inplace", gather=True)),
    "1d_lookahead": ("invert", dict(workers=4, engine="lookahead",
                                    gather=False)),
    "1d_grouped2": ("invert", dict(workers=4, engine="grouped", gather=True,
                                   group_k=2)),
    "1d_grouped3": ("invert", dict(workers=4, engine="grouped",
                                   gather=False, group_k=3)),
    "1d_swapfree": ("invert", dict(workers=4, engine="swapfree",
                                   gather=False)),
    "2d_inplace": ("invert", dict(workers=(2, 2), engine="inplace",
                                  gather=True)),
    "2d_lookahead": ("invert", dict(workers=(2, 2), engine="lookahead",
                                    gather=True)),
    "2d_grouped2": ("invert", dict(workers=(2, 2), engine="grouped",
                                   gather=False, group_k=2)),
    "2d_swapfree": ("invert", dict(workers=(2, 2), engine="swapfree",
                                   gather=False)),
    "2d_1x4_inplace": ("invert", dict(workers=(1, 4), engine="inplace",
                                      gather=True)),
    "2d_4x1_inplace": ("invert", dict(workers=(4, 1), engine="inplace",
                                      gather=True)),
    "1d_solve": ("solve", dict(workers=4, gather=True, k=3)),
    "1d_solve_lookahead": ("solve", dict(workers=4, gather=True, k=2,
                                         engine="solve_lookahead")),
    "2d_solve": ("solve", dict(workers=(2, 2), gather=False, k=2)),
}


@pytest.fixture(scope="module")
def pins():
    calls = []
    for name, (kind, kw) in PIN_LEGS.items():
        calls.append((comm.run_leg, (kind, name, {
            "n": 44, "m": M, "dtype": "float64", "generator": "rand", **kw})))
    calls.append((comm.run_leg, ("invert", "off", {
        "n": 44, "m": M, "dtype": "float64", "generator": "rand",
        "record": False, **PIN_LEGS["1d_inplace"][1]})))
    out = run_workers(4, run_calls, calls, device_type="cpu",
                      deadline_s=600)
    return {leg["name"]: leg for leg in out[0]}


@pytest.mark.parametrize("name", sorted(PIN_LEGS))
def test_counted_pin_within_band(pins, name):
    x = pins[name]["work"]["xla"]
    assert x["available"] is True and x["within"] is True
    lo, hi = twork.XLA_BAND
    assert lo <= x["xla_vs_model"] <= hi
    assert len(x["per_rank_flops"]) == 4
    assert all(f > 0 for f in x["per_rank_flops"])
    assert x["total_flops"] == pytest.approx(
        x["per_device_flops"] * x["devices"], rel=1e-12)
    assert x["model_traced_flops"] == x["model_executed_flops"]
    assert pins[name]["work"]["totals"]["exact"] is True


def test_nothing_counted_with_recording_off(pins):
    assert pins["off"]["work"]["xla"] == {"available": False,
                                          "source": twork.COUNTED_SOURCE}


def test_the_pin_counts_the_engine_section_alone():
    log = RankLog()
    with collecting(log):
        tally_gemm(4, 8, 16)                       # unsectioned
        for name in ("timing", "gather", "residual"):
            with section(name):
                tally_gemm(4, 8, 16)
        with section("engine"):
            tally_gemm(4, 8, 16)
            with section("residual"):
                tally_gemm(4, 8, 16)
    assert log.gemm_flops == 2 * 4 * 8 * 16


def test_attach_counted_out_of_band_is_not_within():
    rep = twork.engine_report(engine="inplace",
                              lay=tl.CyclicLayout.create(44, M, 4))
    x = rep.attach_counted([rep.executed_model * 2] * 4)
    assert x["xla_vs_model"] == 8.0 and x["within"] is False
