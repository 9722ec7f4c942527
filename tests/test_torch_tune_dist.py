"""``tune=True`` and the cost ranking at p > 1 against the JAX package's
tuner.

  * The registry's distributed solve configurations (``solve_sharded``,
    ``solve_lookahead_sharded``) and the cost-only picks at distributed
    solve and invert points equal the JAX registry's at pinned points, and
    so do the invert candidates: the augmented engine is a candidate at
    p > 1, as in the JAX package (``parallel/sharded_jordan.py``), and at
    4N³ never the cost-only pick.
  * ``measure_config`` at a p = 2 point spawns exactly one CPU world per
    configuration: the tuner's trials are one per legal configuration, each
    with every sample from its world.
  * A measured plan in the cache is a hit: ``driver.solve(workers=2,
    tune=True)`` and the CLI's ``--tune --workers 2`` measure nothing, and
    the plan keys carry the point's workers.
"""

import json

import jax.numpy as jnp
import pytest

from tpu_jordan.tuning import registry as jregistry

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.parallel import launch as tlaunch
from tpu_jordan_torch.tuning import plan_cache as tplan_cache
from tpu_jordan_torch.tuning import registry as tregistry
from tpu_jordan_torch.tuning import tuner as ttuner

POINTS = [(48, 8, 2), (45, 8, 4), (520, 8, 4), (4096, 128, 4),
          (8192, 384, 4), (8192, 384, 8)]


def _points(n, m, p, workload):
    return (tregistry.TunePoint.create(n, m, "float32", p, True,
                                       workload=workload, device="cpu"),
            jregistry.TunePoint.create(n, m, jnp.float32, p, True,
                                       backend="cpu", workload=workload))


@pytest.mark.parametrize("n,m,p", POINTS)
def test_solve_picks_and_candidates_equal_jax(n, m, p):
    tp, jp = _points(n, m, p, "solve")
    assert ([c.name for c in tregistry.candidates(tp)]
            == [c.name for c in jregistry.candidates(jp)])
    assert (tregistry.select_by_cost(tp).engine
            == jregistry.select_by_cost(jp).engine)
    want = "solve_lookahead" if -(-n // m) <= 64 else "solve_sharded"
    assert tregistry.select_by_cost(tp).engine == want


@pytest.mark.parametrize("n,m,p", POINTS)
def test_invert_picks_equal_jax(n, m, p):
    tp, jp = _points(n, m, p, "invert")
    tnames = {c.name for c in tregistry.candidates(tp)}
    assert {c.name for c in jregistry.candidates(jp)} == tnames
    assert "augmented" in tnames
    assert tregistry.select_by_cost(tp).engine != "augmented"
    assert (tregistry.select_by_cost(tp).engine
            == jregistry.select_by_cost(jp).engine)


def test_distributed_solve_configs_are_not_single_device():
    tp, jp = _points(64, 8, 1, "solve")
    for name in ("solve_sharded", "solve_lookahead_sharded"):
        assert not tregistry.get(name).legal(tp)
        assert not jregistry.get(name).legal(jp)
        assert tregistry.get(name).engine == jregistry.get(name).engine


@pytest.fixture
def worlds(monkeypatch):
    """Counts the worlds spawned in this process."""
    spawned = []
    real = tlaunch.run_workers

    def counting(p, fn, *args, **kw):
        spawned.append((p, fn.__name__))
        return real(p, fn, *args, **kw)

    monkeypatch.setattr(tlaunch, "run_workers", counting)
    return spawned


def test_one_world_per_measured_configuration(worlds, tmp_path):
    point = tregistry.TunePoint.create(48, 8, "float32", 2, True,
                                       workload="solve", device="cpu")
    cache = tplan_cache.PlanCache(str(tmp_path / "plans.json"))
    tuner = ttuner.Tuner(cache=cache, measure=True, survivors=8,
                         samples=3)
    plan = tuner.select(point)
    legal = [c.name for c in tregistry.candidates(point)]
    assert sorted(t["config"] for t in plan.trials) == sorted(legal)
    assert worlds == [(2, "measure_rank")] * len(legal)
    assert tuner.measurements == len(legal) and plan.source == "measured"
    assert plan.engine in ("solve_sharded", "solve_lookahead")
    meas = ttuner.measure_config(
        tregistry.TunePoint.create(48, 8, "float32", 2, True,
                                   device="cpu"),
        tregistry.get("inplace"), samples=4)
    assert len(meas.samples) == 4 and meas.seconds > 0
    assert len(worlds) == len(legal) + 1
    # The cache now holds the measured plan: a new tuner measures nothing.
    again = ttuner.Tuner(cache=tplan_cache.PlanCache.load(cache.path),
                         measure=True)
    assert again.select(point) == plan
    assert again.measurements == 0 and again.last_source == "cache"
    assert len(worlds) == len(legal) + 1


def test_cached_plan_measures_nothing_in_solve_and_cli(worlds, tmp_path,
                                                       capsys):
    path = str(tmp_path / "plans.json")
    point = tregistry.TunePoint.create(64, 8, "float32", 2, True,
                                       device="cpu")
    cache = tplan_cache.PlanCache(path)
    cache.put(tplan_cache.plan_key(point), tplan_cache.Plan(
        config="swapfree", engine="swapfree", source="measured",
        seconds=1e-3))
    cache.save()
    assert "cpu|p2|" in next(iter(json.load(open(path))["plans"]))
    before = ttuner._M_MEASUREMENTS.total()
    res = tdriver.solve(64, 8, workers=2, tune=True, plan_cache=path,
                        generator="rand", device="cpu")
    assert res.engine == "swapfree" and res.plan.source == "measured"
    capsys.readouterr()
    assert tmain(["64", "8", "--workers", "2", "--tune", "--plan-cache",
                  path, "--generator", "rand", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "engine: swapfree on cpu x2 (gloo)" in out
    assert "plan: swapfree (auto, measured plan)" in out
    assert ttuner._M_MEASUREMENTS.total() == before
    assert [f for _, f in worlds] == ["solve_rank", "solve_rank"]
