"""The port's tuner against the JAX package's, on the CPU: the measurement
core's statistics, plan keys, legality and cost-only picks over a grid,
the selection ladder under injected timings, the plan cache's failure
modes, the fault points the tuner crosses, and the product surface
(``solve``, ``solve_system``, ``JordanSolver``, the CLI) with ``tune`` and
``plan_cache``."""

import json
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_jordan import driver as jdriver
from tpu_jordan.linalg import solve_system as jsolve_system
from tpu_jordan.models import JordanSolver as JJordanSolver
from tpu_jordan.resilience import faults as jfaults
from tpu_jordan.tuning import measure as jmeasure
from tpu_jordan.tuning import plan_cache as jplan_cache
from tpu_jordan.tuning import registry as jregistry
from tpu_jordan.tuning import tuner as jtuner

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.linalg import lstsq, solve_system
from tpu_jordan_torch.models import JordanSolver
from tpu_jordan_torch.obs import metrics as tmetrics
from tpu_jordan_torch.obs import recorder as trecorder
from tpu_jordan_torch.resilience import faults as tfaults
from tpu_jordan_torch.tuning import measure as tmeasure
from tpu_jordan_torch.tuning import plan_cache as tplan_cache
from tpu_jordan_torch.tuning import registry as tregistry
from tpu_jordan_torch.tuning import tuner as ttuner
from tpu_jordan_torch.utils.benchmarking import slope_time


def _fields(meas):
    return (meas.seconds, meas.samples, meas.accepted, meas.rejected,
            meas.spread_pct, meas.variance_flag)


# ---- the measurement core ------------------------------------------------

@pytest.mark.parametrize("seed", range(20))
def test_robust_stats_matches_jax(seed):
    """Seeded sample sets, k from 1 to 9, some with planted outliers (a
    sample 3-20x the typical one, or a near-zero one): the same median,
    accepted and rejected sets, spread and flag."""
    rng = np.random.default_rng(seed)
    k = 1 + seed % 9
    samples = list(1e-3 * (1.0 + 0.05 * rng.standard_normal(k)))
    if seed % 3 == 0:
        samples[rng.integers(k)] *= float(rng.uniform(3.0, 20.0))
    if seed % 5 == 1:
        samples[rng.integers(k)] = 1e-9
    got = tmeasure.robust_stats(samples)
    ref = jmeasure.robust_stats(samples)
    assert _fields(got) == _fields(ref)


def test_robust_stats_flags_and_rejects_like_jax():
    samples = [1.0, 1.01, 0.99, 1.02, 9.0]
    got = tmeasure.robust_stats(samples)
    assert got.rejected == (9.0,) and got.variance_flag is None
    noisy = tmeasure.robust_stats([1.0, 1.3, 1.6])
    assert noisy.variance_flag == jmeasure.robust_stats(
        [1.0, 1.3, 1.6]).variance_flag
    assert tmeasure.VARIANCE_FLAG_PCT == jmeasure.VARIANCE_FLAG_PCT
    with pytest.raises(ValueError):
        tmeasure.robust_stats([])


def test_measure_direct_retries_an_injected_transient_once():
    """A transient injected at the ``measure`` point (the second call) is
    retried once, and the measurement completes with every sample."""
    calls = []
    plan = tfaults.FaultPlan([tfaults.FaultSpec("measure", (2,))])
    with tfaults.activate(plan):
        meas = tmeasure.measure_direct(lambda: calls.append(1), samples=3)
    assert plan.injections == [("measure", 2, "transient")]
    assert plan.calls() == {"measure": 5}       # 1 warm + 3 + 1 retry
    assert len(calls) == 4 and len(meas.samples) == 3


def test_measure_direct_passes_a_permanent_fault_through():
    plan = tfaults.FaultPlan([tfaults.FaultSpec("measure", (1,),
                                                "permanent")])
    with tfaults.activate(plan), pytest.raises(tfaults.InjectedFaultError):
        tmeasure.measure_direct(lambda: None, samples=2)


def test_slope_time_contract():
    """fn runs r1 and r2 times in a chained loop, each trip count warmed
    once and timed ``trials`` times; the result is the slope."""
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    x = torch.eye(8, dtype=torch.float64)
    s = slope_time(fn, (x,), r1=2, r2=5, trials=2)
    assert len(calls) == (1 + 2) * 2 + (1 + 2) * 5
    assert math.isfinite(s)
    slopes = slope_time(fn, (x,), r1=1, r2=2, trials=1, samples=3)
    assert len(slopes) == 3
    meas = tmeasure.measure_slope(fn, (x,), r1=1, r2=2, samples=3, trials=1)
    assert len(meas.samples) == 3


# ---- plan keys ----------------------------------------------------------

KEY_POINTS = [
    (64, 8, "float64", True, 1, "invert"),
    (1000, None, "float32", True, 1, "invert"),
    (8192, 384, "float32", True, 1, "invert"),
    (4096, 128, "complex64", True, 1, "invert"),
    (512, 64, "float32", True, 64, "invert"),
    (4096, None, "float32", True, 1, "solve"),
    (8192, 384, "float64", True, 1, "solve_spd"),
    (1024, 128, "float32", True, 1, "update"),
    (300, 50, "bfloat16", False, 8, "solve"),
]


@pytest.mark.parametrize("n,m,dt,gather,batch,wl", KEY_POINTS)
def test_cpu_plan_keys_are_byte_equal_to_jax(n, m, dt, gather, batch, wl):
    tp = tregistry.TunePoint.create(n, m, dt, 1, gather, batch=batch,
                                    workload=wl, device="cpu")
    jp = jregistry.TunePoint.create(n, m, dt, 1, gather, backend="cpu",
                                    batch=batch, workload=wl)
    assert tplan_cache.plan_key(tp) == jplan_cache.plan_key(jp)
    assert (tp.backend, tp.chip) == ("cpu", None)


def test_n_bucket_matches_jax():
    for n in list(range(1, 70)) + [1000, 4096, 4097, 8192, 10000, 32768]:
        assert tplan_cache.n_bucket(n) == jplan_cache.n_bucket(n)


def test_card_point_key_names_the_chip():
    """A point made as the card makes it (backend "cuda", chip "h100")
    keys as cuda-h100, so no TPU or CPU plan is honored on the card, and
    carries its block size, so a plan of one m never serves another."""
    p = tregistry.TunePoint.create(8192, None, "float32", backend="cuda",
                                   chip="h100")
    assert tplan_cache.plan_key(p) == \
        "cuda-h100|single|n8192|float32|gathered|m384"
    slv = tregistry.TunePoint.create(8192, None, "float32", backend="cuda",
                                     chip="h100", workload="solve")
    assert tplan_cache.plan_key(slv) == \
        "cuda-h100|single|n8192|float32|gathered|m384|wsolve"
    keys = {tplan_cache.plan_key(tregistry.TunePoint.create(
        n, m, "float32", backend="cuda", chip="h100"))
        for n, m in ((8192, 384), (8192, 128), (6000, 300))}
    assert len(keys) == 3


def test_point_takes_the_backend_from_the_device():
    """A CPU call makes a CPU point whatever the machine has; no device
    and no backend is a CPU point too, never a CUDA default."""
    assert tregistry.TunePoint.create(64, device="cpu").backend == "cpu"
    assert tregistry.TunePoint.create(64).backend == "cpu"
    assert tregistry.TunePoint.create(64, device=torch.device(
        "cpu")).chip is None
    # A (pr, pc) mesh is a point of its own now (item 15c): its cache
    # label is the JAX package's, and a dimension below 1 is refused.
    assert tregistry.TunePoint.create(64, workers=(2, 4)).topology == "2x4"
    with pytest.raises(UsageError, match="mesh dimensions"):
        tregistry.TunePoint.create(64, workers=(2, 0))
    with pytest.raises(ValueError, match="workload"):
        tregistry.TunePoint.create(64, workload="serve")


# ---- the registry against the JAX registry -------------------------------

# Invert points where the cost-only picks differ: the H100 constants rank
# the in-place engine 1.5 % ahead of grouped k=2 at 8192/m384, the JAX
# package's v5e constants rank grouped first (ROADMAP.md Queue C).
DIFFERING = {(8192, None, "float32"): ("inplace", "grouped2"),
             (8192, None, "float64"): ("inplace", "grouped2"),
             (8192, None, "bfloat16"): ("inplace", "grouped2")}
# Invert points where the card's cost-only pick is not the CPU's, as
# (card, CPU): the fused-update engines are priced only where their
# kernel runs, so at sub-fp32 storage with m % 128 == 0, n >= 8192 and
# Nr <= 64 the card picks the bf16 fused engine (the JAX package's pick on
# a TPU) and the CPU does not (ROADMAP.md Queue C).
CARD_ONLY_PICKS = {(8192, None, "bfloat16"): ("grouped_pallas_bf16",
                                              "inplace"),
                   (8192, 128, "bfloat16"): ("grouped_pallas_bf16",
                                             "grouped2"),
                   (16384, None, "bfloat16"): ("grouped_pallas_bf16",
                                               "grouped2")}
# The port's own cost-only invert picks from 8192 on (real dtypes), pinned.
PORT_INVERT_PICKS = {(8192, None): "inplace", (8192, 128): "grouped2",
                     (8192, 50): "grouped2", (16384, None): "grouped2",
                     (16384, 128): "grouped2", (16384, 50): "grouped2",
                     (32768, None): "grouped2", (32768, 128): "grouped2",
                     (32768, 50): "grouped2"}


@pytest.mark.parametrize("dt", ["float32", "float64", "complex64",
                                "bfloat16"])
@pytest.mark.parametrize("m", [None, 128, 50])
@pytest.mark.parametrize("n", [64, 256, 1000, 4096, 6000, 8192, 16384,
                               32768])
def test_legality_and_picks_match_jax(n, m, dt):
    """At every workload: the candidate name sets equal the JAX
    registry's; the cost-only picks equal it wherever structure decides
    (below 8192, complex, the solve workloads, the update), and at the
    real invert points from 8192 on the port's own pick is pinned, the
    differing points listed in DIFFERING.  The card's point picks as the
    CPU's but at the points of CARD_ONLY_PICKS, where both are pinned."""
    for wl in tregistry.WORKLOADS:
        tp = tregistry.TunePoint.create(n, m, dt, workload=wl, device="cpu")
        jp = jregistry.TunePoint.create(n, m, dt, 1, True, backend="cpu",
                                        workload=wl)
        assert ({c.name for c in tregistry.candidates(tp)}
                == {c.name for c in jregistry.candidates(jp)}), wl
        got = tregistry.select_by_cost(tp).name
        ref = jregistry.select_by_cost(jp).name
        if (n, m, dt) in DIFFERING and wl == "invert":
            assert (got, ref) == DIFFERING[(n, m, dt)]
        else:
            assert got == ref, wl
        if wl == "invert" and n >= 8192 and not dt.startswith("complex"):
            assert got == PORT_INVERT_PICKS[(n, m)]
        card = tregistry.TunePoint.create(n, m, dt, workload=wl,
                                          backend="cuda", chip="h100")
        pair = (tregistry.select_by_cost(card).name, got)
        if wl == "invert" and (n, m, dt) in CARD_ONLY_PICKS:
            assert pair == CARD_ONLY_PICKS[(n, m, dt)]
        else:
            assert pair[0] == got, wl


def test_registry_is_the_engine_vocabulary():
    """Every (engine, workload) pair is registered once; the driver's,
    the CLI's and linalg's vocabularies derive from the registry; the JAX
    registry has exactly the port's configs."""
    from tpu_jordan_torch.linalg import SOLVE_ENGINES

    pairs = [(c.engine, c.workload) for c in tregistry.CONFIGS]
    assert sorted(pairs) == sorted(set(pairs))
    assert tdriver.ENGINES is tregistry.ENGINES
    assert SOLVE_ENGINES is tregistry.SOLVE_ENGINES
    assert tdriver.PALLAS_ENGINES == jregistry.PALLAS_ENGINES
    assert (tdriver.GROUPED_MIN_SINGLE_CHIP_N
            == jregistry.GROUPED_MIN_SINGLE_CHIP_N)
    assert set(jregistry.REGISTRY) == set(tregistry.REGISTRY)
    for name, cfg in tregistry.REGISTRY.items():
        ref = jregistry.REGISTRY[name]
        assert (cfg.engine, cfg.group, cfg.workload) == (
            ref.engine, ref.group, ref.workload)
    with pytest.raises(UsageError, match="item 15"):
        tdriver.resolve_invert_engine("swapfree", 0, 64, workers=1)


def test_fused_update_engine_is_priced_only_on_the_card():
    """grouped_pallas has a finite cost only on backend "cuda" (m % 128 ==
    0, n >= 8192), at 1.02x the grouped projection; on the CPU it runs the
    plain twin and is never cost-preferred."""
    gp = tregistry.get("grouped_pallas")
    card = tregistry.TunePoint.create(8192, 128, "float32", backend="cuda",
                                      chip="h100")
    cpu = tregistry.TunePoint.create(8192, 128, "float32", device="cpu")
    assert math.isinf(gp.cost(cpu))
    assert gp.cost(card) == pytest.approx(
        1.02 * tregistry.projected_seconds(card, group=2))
    # At 8192/m384 on the card the survivors are in-place, lookahead and
    # grouped k=2; the fused engine is the fourth.
    p = tregistry.TunePoint.create(8192, None, "float32", backend="cuda",
                                   chip="h100")
    assert [c.name for c in tregistry.candidates(p)][:4] == [
        "inplace", "lookahead", "grouped2", "grouped_pallas"]
    assert 0.0 < tregistry.probe_overlap_headroom(p) < 1.0


def test_invert_engines_leave_their_input_alone():
    """Every sample of a measurement inverts the same matrix, so no
    registered engine may write its input."""
    from tpu_jordan_torch.linalg.api import solve_engine_fn
    from tpu_jordan_torch.ops import generate

    a = generate("rand", (48, 48), torch.float32, device="cpu")
    b = generate("rand", (48, 1), torch.float32, device="cpu")
    keep_a, keep_b = a.clone(), b.clone()
    for cfg in tregistry.CONFIGS:
        if cfg.workload == "invert":
            tdriver.invert(a, cfg.engine, cfg.group, 16)
        elif cfg.workload != "update":
            solve_engine_fn(cfg.engine, 16)(a, b)
        assert torch.equal(a, keep_a) and torch.equal(b, keep_b), cfg.name


# ---- the ladder under injected timings -----------------------------------

def _fake(mod, timings):
    def fn(point, cfg, samples=5):
        s = timings[cfg.name]
        return mod.Measurement(seconds=s, samples=(s,) * samples,
                               accepted=(s,) * samples)
    return fn


def _points():
    """The same single-device point in both packages: (64, 8, fp64) on
    the CPU, where both rankings give the survivors in-place, lookahead,
    augmented."""
    return (tregistry.TunePoint.create(64, 8, "float64", device="cpu"),
            jregistry.TunePoint.create(64, 8, jnp.float64, 1, True,
                                       backend="cpu"))


def _counts():
    return (ttuner._M_MEASUREMENTS.total(), ttuner._M_HITS.total(),
            ttuner._M_MISSES.total(), jtuner._M_MEASUREMENTS.total(),
            jtuner._M_HITS.total(), jtuner._M_MISSES.total())


def _same_plan(got, ref):
    assert (got.config, got.engine, got.group, got.source, got.seconds) == (
        ref.config, ref.engine, ref.group, ref.source, ref.seconds)
    assert ([t["config"] for t in got.trials]
            == [t["config"] for t in ref.trials])
    assert ([t["measured"] for t in got.trials]
            == [t["measured"] for t in ref.trials])
    # The projections come from different chips: drift is only present.
    assert all(t["drift"] is not None and t["drift"] > 0
               for t in got.trials)


def _run_both(case):
    """Run ``case(pkg_tuner, pkg_plan_cache, pkg_measure, point, side)``
    for each package and return the results and the counter deltas."""
    tp, jp = _points()
    out = []
    for side, (tun, pc, meas, pt) in enumerate(
            ((ttuner, tplan_cache, tmeasure, tp),
             (jtuner, jplan_cache, jmeasure, jp))):
        before = _counts()
        res = case(tun, pc, meas, pt, side)
        after = _counts()
        delta = [a - b for a, b in zip(after, before)]
        out.append((res, delta[:3] if side == 0 else delta[3:]))
    return out


TIMINGS = {"inplace": 2e-3, "lookahead": 1e-3, "augmented": 9e-3,
           "grouped2": 5e-3}


def test_ladder_cost_only_is_deterministic_and_free():
    def case(tun, pc, meas, pt, side):
        t = tun.Tuner()
        p1, p2 = t.select(pt), t.select(pt)
        assert p1 == p2 and t.measurements == 0
        return p1
    (got, dg), (ref, dr) = _run_both(case)
    assert (got.config, got.source) == (ref.config, ref.source) == (
        "inplace", "cost_model")
    assert dg == dr == [0, 0, 2]


def test_ladder_fake_timings_select_deterministically():
    def case(tun, pc, meas, pt, side):
        t = tun.Tuner(measure=True, measure_fn=_fake(meas, TIMINGS))
        plan = t.select(pt)
        t2 = tun.Tuner(measure=True, measure_fn=_fake(meas, TIMINGS))
        assert t2.select(pt) == plan
        return plan, t.measurements
    (got, dg), (ref, dr) = _run_both(case)
    _same_plan(got[0], ref[0])
    assert got[0].config == "lookahead" and got[1] == ref[1] == 3
    assert [t["config"] for t in got[0].trials] == [
        "inplace", "lookahead", "augmented"]
    assert dg == dr == [6, 0, 2]


def test_ladder_warm_cache_performs_zero_measurements(tmp_path):
    def case(tun, pc, meas, pt, side):
        path = str(tmp_path / f"plans{side}.json")
        t1 = tun.Tuner(cache=pc.PlanCache(path), measure=True,
                       measure_fn=_fake(meas, TIMINGS))
        plan1 = t1.select(pt)
        t2 = tun.Tuner(cache=pc.PlanCache.load(path), measure=True,
                       measure_fn=_fake(meas, TIMINGS))
        plan2 = t2.select(pt)
        assert plan2 == plan1 and t2.last_source == "cache"
        return plan1, (t1.measurements, t2.measurements)
    (got, dg), (ref, dr) = _run_both(case)
    _same_plan(got[0], ref[0])
    assert got[1] == ref[1] == (3, 0)
    assert dg == dr == [3, 1, 1]


def test_ladder_tune_is_not_satisfied_by_a_cost_model_entry(tmp_path):
    def case(tun, pc, meas, pt, side):
        path = str(tmp_path / f"plans{side}.json")
        assert tun.Tuner(cache=pc.PlanCache(path)).select(
            pt).source == "cost_model"
        t = tun.Tuner(cache=pc.PlanCache.load(path), measure=True,
                      measure_fn=_fake(meas, TIMINGS))
        plan = t.select(pt)
        t2 = tun.Tuner(cache=pc.PlanCache.load(path), measure=True,
                       measure_fn=_fake(meas, TIMINGS))
        assert t2.select(pt) == plan and t2.measurements == 0
        return plan, t.measurements
    (got, dg), (ref, dr) = _run_both(case)
    _same_plan(got[0], ref[0])
    assert got[1] == ref[1] == 3
    assert dg == dr == [3, 1, 2]


@pytest.mark.parametrize("config,engine", [
    ("retired-engine", "retired"),       # no longer in the registry
    ("grouped_pallas", "grouped_pallas"),  # registered, illegal at m=8
    ("grouped2", "inplace"),             # another (engine, group)
])
def test_ladder_stale_and_illegal_entries_fall_through(tmp_path, config,
                                                       engine):
    def case(tun, pc, meas, pt, side):
        path = str(tmp_path / f"plans{side}.json")
        cache = pc.PlanCache(path)
        cache.put(pc.plan_key(pt), pc.Plan(config=config, engine=engine,
                                           group=2))
        cache.save()
        plan = tun.Tuner(cache=pc.PlanCache.load(path)).select(pt)
        assert pc.PlanCache.load(path).get(pc.plan_key(pt)) == plan
        return plan
    (got, dg), (ref, dr) = _run_both(case)
    assert (got.config, got.source) == (ref.config, ref.source) == (
        "inplace", "cost_model")
    assert dg == dr == [0, 0, 1]


def test_ladder_read_only_cache_skips_write_back(tmp_path):
    def case(tun, pc, meas, pt, side):
        path = tmp_path / f"plans{side}.json"
        pc.PlanCache(str(path)).save()
        before = path.read_text()
        cache = pc.PlanCache.load(str(path), read_only=True)
        t = tun.Tuner(cache=cache, measure=True,
                      measure_fn=_fake(meas, TIMINGS))
        plan = t.select(pt)
        assert path.read_text() == before and cache.plans == {}
        return plan, t.measurements
    (got, dg), (ref, dr) = _run_both(case)
    _same_plan(got[0], ref[0])
    assert got[1] == ref[1] == 3
    assert dg == dr == [3, 0, 1]


# ---- the plan cache -------------------------------------------------------

@pytest.mark.parametrize("content,reason", [
    (None, None),
    ("{not json", "corrupt"),
    ('{"version": 1, "plans": {"k": {"engine": "x"}}}', "corrupt"),
    ('{"version": 1, "plans": []}', "corrupt"),
    ('{"version": 99, "plans": {}}', "version"),
])
def test_plan_cache_failure_modes_match_jax(tmp_path, content, reason):
    """Missing, corrupt or wrong-version files give an empty cache, with
    a ``fallback_reason`` on the last two, in both packages."""
    path = tmp_path / "plans.json"
    if content is not None:
        path.write_text(content)
    got = tplan_cache.PlanCache.load(str(path))
    ref = jplan_cache.PlanCache.load(str(path))
    assert got.plans == ref.plans == {}
    if reason is None:
        assert got.fallback_reason is None is ref.fallback_reason
    else:
        assert reason in got.fallback_reason
        assert got.fallback_reason == ref.fallback_reason


def test_plan_cache_atomic_save_round_trips(tmp_path):
    path = str(tmp_path / "sub" / "plans.json")
    plan = tplan_cache.Plan(config="grouped2", engine="grouped", group=2,
                            source="measured", seconds=0.05,
                            projected=0.047, drift=1.06,
                            variance_flag="noisy",
                            trials=({"config": "grouped2"},))
    cache = tplan_cache.PlanCache(path)
    cache.put("k", plan)
    cache.save()
    assert tplan_cache.PlanCache.load(path).get("k") == plan
    doc = json.load(open(path))
    assert doc["version"] == tplan_cache.CACHE_VERSION
    # The JAX package reads the port's document (and the reverse).
    assert jplan_cache.PlanCache.load(path).get("k").to_json() == \
        plan.to_json()
    assert not [p for p in (tmp_path / "sub").iterdir()
                if p.name.endswith(".tmp")]


def test_read_only_plan_cache_refuses_writes(tmp_path):
    path = str(tmp_path / "plans.json")
    tplan_cache.PlanCache(path).save()
    cache = tplan_cache.PlanCache.load(path, read_only=True)
    plan = tplan_cache.Plan(config="inplace", engine="inplace")
    with pytest.raises(UsageError, match="read-only"):
        cache.put("k", plan)
    with pytest.raises(UsageError, match="read-only"):
        cache.save()
    with pytest.raises(UsageError, match="does not exist"):
        tplan_cache.PlanCache.load(str(tmp_path / "nope.json"),
                                   read_only=True)


def test_plan_cache_write_fault_degrades(tmp_path):
    """An injected ``plan_cache_write`` fault: the save degrades to the
    in-memory plans, counts one write failure and records one event."""
    path = str(tmp_path / "plans.json")
    cache = tplan_cache.PlanCache(path)
    cache.put("k", tplan_cache.Plan(config="inplace", engine="inplace"))
    fails = tplan_cache._M_WRITE_FAILS.total()
    mark = trecorder.RECORDER.total
    plan = tfaults.FaultPlan.seeded(0, points={"plan_cache_write": (1, 1)})
    with tfaults.activate(plan):
        cache.save()
    assert tplan_cache._M_WRITE_FAILS.total() == fails + 1
    events = [e for e in trecorder.RECORDER.since(mark)
              if e["kind"] == "plan_cache_write_failure"]
    assert len(events) == 1 and "simulated disk full" in events[0]["error"]
    assert cache.last_write_error and cache.get("k") is not None
    assert not (tmp_path / "plans.json").exists()
    cache.save()                       # the fault has passed: written
    assert cache.last_write_error is None
    assert tplan_cache.PlanCache.load(path).get("k") is not None


# ---- fault plans ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_seeded_fault_plans_fire_like_jax(seed):
    """The same seed gives the same schedules and, driven through the same
    call sequence, the same firing log as the JAX package's plan."""
    points = {"measure": (3, 12), "plan_cache_write": (2, 8),
              "execute": 2, "result_corrupt_nan": 1}
    got = tfaults.FaultPlan.seeded(seed, points=points)
    ref = jfaults.FaultPlan.seeded(seed, points=points)
    assert ([(s.point, s.calls, s.mode) for s in got.specs]
            == [(s.point, s.calls, s.mode) for s in ref.specs])
    for plan, errors in ((got, (tfaults.InjectedTransientError, OSError)),
                         (ref, (jfaults.InjectedTransientError, OSError))):
        for _ in range(20):
            for point in ("measure", "plan_cache_write", "execute"):
                try:
                    plan.fire(point)
                except errors:
                    pass
            plan.corrupt("result_corrupt_nan")
    assert got.injections == ref.injections
    assert got.report() == ref.report()
    assert tfaults.POINTS == jfaults.POINTS and tfaults.MODES == jfaults.MODES


def test_fault_scopes_do_not_nest_and_unknown_points_raise():
    plan = tfaults.FaultPlan([])
    with tfaults.activate(plan):
        assert tfaults.active() is plan
        with pytest.raises(RuntimeError):
            with tfaults.activate(tfaults.FaultPlan([])):
                pass
        with pytest.raises(ValueError):
            tfaults.fire("no_such_point")
    assert tfaults.active() is None and not tfaults.corrupt("execute")
    with pytest.raises(ValueError):
        tfaults.FaultSpec("measure", (0,))


# ---- the product surface ---------------------------------------------------

@pytest.fixture
def two_samples(monkeypatch):
    """Real measurements on the CPU with samples=2 (the tuner's default is
    5): the ladder's own measure_config, with fewer samples."""
    real = ttuner.measure_config
    monkeypatch.setattr(ttuner, "measure_config",
                        lambda point, cfg, samples=5: real(point, cfg,
                                                           samples=2))


def test_solve_tunes_then_serves_from_the_warm_cache(tmp_path, two_samples):
    """solve(engine="auto", tune=True) measures the survivors for real on
    the CPU; a second call measures nothing and returns the same engine
    with a bit-equal inverse.  A CPU solve writes a CPU key."""
    path = str(tmp_path / "plans.json")
    before = ttuner._M_MEASUREMENTS.total()
    r1 = tdriver.solve(64, 8, generator="rand", device="cpu", engine="auto",
                       tune=True, plan_cache=path)
    assert ttuner._M_MEASUREMENTS.total() == before + 3
    assert r1.plan.source == "measured" and len(r1.plan.trials) == 3
    assert [t["config"] for t in r1.plan.trials] == [
        "inplace", "lookahead", "augmented"]
    assert r1.engine == r1.plan.engine
    r2 = tdriver.solve(64, 8, generator="rand", device="cpu", engine="auto",
                       tune=True, plan_cache=path)
    assert ttuner._M_MEASUREMENTS.total() == before + 3
    assert (r2.engine, r2.group, r2.plan) == (r1.engine, r1.group, r1.plan)
    assert torch.equal(r1.inverse, r2.inverse)
    keys = list(json.load(open(path))["plans"])
    assert keys == ["cpu|single|n64|float32|gathered"]


def test_solve_system_and_lstsq_tune(tmp_path, two_samples):
    a = np.random.default_rng(3).standard_normal((32, 32))
    b = np.random.default_rng(4).standard_normal((32, 2))
    path = str(tmp_path / "plans.json")
    res = solve_system(a, b, block_size=8, tune=True, plan_cache=path,
                       device="cpu")
    assert res.plan.source == "measured"
    assert [t["config"] for t in res.plan.trials] == ["solve_aug",
                                                       "solve_fori"]
    assert res.engine == res.plan.engine
    assert res.rel_residual < 1e-12
    before = ttuner._M_MEASUREMENTS.total()
    again = solve_system(a, b, block_size=8, tune=True, plan_cache=path,
                         device="cpu")
    assert ttuner._M_MEASUREMENTS.total() == before
    assert torch.equal(again.x, res.x)
    fit = lstsq(np.vstack([a, a[:8]]), np.ones(40), block_size=8,
                plan_cache=path, device="cpu")
    assert fit.plan is fit.inner.plan and fit.plan.source == "cost_model"
    assert fit.engine == "solve_spd"
    assert "cpu|single|n32|float64|gathered|wsolve_spd" in json.load(
        open(path))["plans"]


def _jax_error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return str(e.value)


def test_tune_with_an_explicit_engine_is_refused_in_jax_words():
    ref = _jax_error(lambda: jdriver.solve(16, 8, engine="inplace",
                                           tune=True))
    a = np.eye(16)
    cases = [
        (lambda: tdriver.solve(16, 8, engine="inplace", tune=True,
                               device="cpu"), ref),
        (lambda: tdriver.solve(16, 8, engine="grouped",
                               plan_cache="p.json", device="cpu"), ref),
        (lambda: solve_system(a, a[:, 0], engine="solve_aug", tune=True,
                              device="cpu"),
         _jax_error(lambda: jsolve_system(a, a[:, 0], engine="solve_aug",
                                          tune=True))),
        (lambda: JordanSolver(n=16, engine="inplace", tune=True,
                              device="cpu"),
         _jax_error(lambda: JJordanSolver(n=16, engine="inplace",
                                          tune=True))),
    ]
    for fn, words in cases:
        with pytest.raises(UsageError) as e:
            fn()
        assert str(e.value) == words


def test_solver_resolves_auto_through_the_ladder(tmp_path):
    path = str(tmp_path / "plans.json")
    s = JordanSolver(n=48, block_size=8, dtype="float64", plan_cache=path,
                     device="cpu")
    assert (s.engine, s.plan.source) == ("inplace", "cost_model")
    a = np.random.default_rng(8).standard_normal((48, 48))
    inv, sing = s.invert(a)
    assert not bool(sing) and s.residual(a, inv) < 1e-9
    c = JordanSolver(n=16, dtype="complex64", device="cpu")
    assert (c.engine, c.plan.config) == ("augmented", "augmented")
    assert "cpu|single|n64|float64|gathered" in json.load(
        open(path))["plans"]


def test_cli_tune_flags(tmp_path, capsys):
    path = str(tmp_path / "plans.json")
    assert tmain(["64", "8", "--device", "cpu", "--tune", "--engine",
                  "inplace"]) == 1
    assert tmain(["64", "8", "--device", "cpu", "--batch", "2",
                  "--tune"]) == 1
    assert tmain(["64", "8", "--device", "cpu", "--plan-cache", path,
                  "--batch", "2"]) == 1
    # A cache seeded with a measured plan: --tune measures nothing.
    cache = tplan_cache.PlanCache(path)
    point = tregistry.TunePoint.create(64, 8, "float32", device="cpu")
    cache.put(tplan_cache.plan_key(point), tplan_cache.Plan(
        config="lookahead", engine="lookahead", source="measured",
        seconds=1e-3, variance_flag="session spread 12.0% > 10%"))
    cache.save()
    capsys.readouterr()
    before = ttuner._M_MEASUREMENTS.total()
    assert tmain(["64", "8", "--device", "cpu", "--generator", "rand",
                  "--tune", "--plan-cache", path]) == 0
    assert ttuner._M_MEASUREMENTS.total() == before
    out = capsys.readouterr().out
    assert "engine: lookahead on cpu" in out
    assert "plan: lookahead (auto, measured plan)" in out
    assert "variance_flag: session spread 12.0%" in out
    assert tmain(["64", "8", "--engine", "swapfree", "--device",
                  "cpu"]) == 1
    assert "item 15" in capsys.readouterr().err


def test_measure_config_refusals():
    upd = tregistry.TunePoint.create(64, 8, "float32", workload="update",
                                     device="cpu")
    ref = _jax_error(lambda: jtuner.measure_config(
        jregistry.TunePoint.create(64, 8, jnp.float32, 1, True,
                                   backend="cpu", workload="update"),
        jregistry.get("smw_update")))
    with pytest.raises(UsageError) as e:
        ttuner.measure_config(upd, tregistry.get("smw_update"))
    assert str(e.value) == ref
    # The augmented engine at p > 1 was refused here; it is measured now,
    # as in the JAX package.
    dist = tregistry.TunePoint(64, 8, "float32", workers=8, backend="cpu")
    meas = ttuner.measure_config(dist, tregistry.get("augmented"))
    assert meas.seconds > 0
    from tpu_jordan_torch.obs import Telemetry

    tel = Telemetry()
    engine, _, _ = ttuner.auto_select(64, 8, "float32", 1, True,
                                      telemetry=tel, device="cpu")
    sel = tel.find("select")
    assert sel.attrs["engine"] == engine and sel.attrs["source"]


def test_metric_names_are_in_the_port_namespace():
    """Every name in the port's registry matches the port's prefix, and
    the tuner's four counters are registered."""
    names = tmetrics.REGISTRY.names()
    assert {"tpu_jordan_torch_plan_cache_hits_total",
            "tpu_jordan_torch_plan_cache_misses_total",
            "tpu_jordan_torch_tuner_measurements_total",
            "tpu_jordan_torch_plan_cache_write_failures_total"} <= set(names)
    bad = [n for n in names
           if not re.match(r"^tpu_jordan_torch_[a-z0-9_]+$", n)]
    assert bad == []
