"""``tune=True`` and the cost ranking on a (pr, pc) mesh against the JAX
package's tuner.

  * A mesh point's cache label is the JAX package's ("2x2"); its legal
    configurations equal the JAX registry's, the augmented engine included
    (``parallel/jordan2d.py``'s engine); the cost-only picks at pinned 2D
    points equal the JAX registry's, never the augmented engine.
  * ``measure_config`` at a (2, 2) point spawns exactly one CPU world of
    4 ranks per configuration.
  * A measured plan in the cache is a hit: ``driver.solve(workers=(2, 2),
    tune=True)`` and the CLI's ``--tune --workers 2x2`` measure nothing.
"""

import json

import jax.numpy as jnp
import pytest

from tpu_jordan.tuning import registry as jregistry

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.parallel import launch as tlaunch
from tpu_jordan_torch.tuning import cost_model as tcost
from tpu_jordan_torch.tuning import plan_cache as tplan_cache
from tpu_jordan_torch.tuning import registry as tregistry
from tpu_jordan_torch.tuning import tuner as ttuner

#: 2D points where the H100 and the JAX package's constants rank alike
#: (at 2048/m128 and 4096/m128 on meshes with pc >= 3 the JAX model's
#: v5e constants put swapfree first, the H100's lookahead).
POINTS = [(48, 8, (2, 2)), (45, 8, (2, 3)), (520, 8, (2, 2)),
          (4096, 128, (2, 2)), (4096, 128, (4, 1)), (8192, 384, (2, 2)),
          (8192, 384, (2, 4)), (16384, 128, (2, 2))]


def _points(n, m, w, workload):
    return (tregistry.TunePoint.create(n, m, "float32", w, True,
                                       workload=workload, device="cpu"),
            jregistry.TunePoint.create(n, m, jnp.float32, w, True,
                                       backend="cpu", workload=workload))


@pytest.mark.parametrize("n,m,w", POINTS)
@pytest.mark.parametrize("workload", ["invert", "solve"])
def test_mesh_points_equal_jax(n, m, w, workload):
    tp, jp = _points(n, m, w, workload)
    assert tp.topology == jp.topology == f"{w[0]}x{w[1]}"
    assert tp.mesh_shape == jp.mesh_shape == w and tp.ranks == w[0] * w[1]
    tnames = {c.name for c in tregistry.candidates(tp)}
    jnames = {c.name for c in jregistry.candidates(jp)}
    assert jnames == tnames
    assert ("augmented" in tnames) == (workload == "invert")
    assert tregistry.select_by_cost(tp).engine != "augmented"
    assert (tregistry.select_by_cost(tp).engine
            == jregistry.select_by_cost(jp).engine)


def test_mesh_comm_terms_are_the_jax_models():
    """pc > 1 adds the chunk broadcast, the fix-up and the unscramble on
    the swap engines and the column permutation on the swap-free one; a
    (p, 1) mesh is the 1D model."""
    chip = tcost.H100
    one_d = tcost.predict(4096, 128, chip, p=4)
    assert tcost.predict(4096, 128, chip, p=4, pc=1) == one_d
    sq = tcost.predict(4096, 128, chip, p=2, pc=2)
    sf = tcost.predict(4096, 128, chip, p=2, pc=2, swapfree=True)
    assert sq["elim"] == pytest.approx(one_d["elim"])
    assert sq["comm"] > sf["comm"] > 0
    Nr, N = 32, 4096
    chunk = 4 * (N / 2) * 128
    link, lat = chip.link, chip.latency
    per_step = ((chunk / 2 / link + lat) + (4 * 128 * 128 / 2 / link + lat)
                + 2 * (chunk / 2 / link + lat))
    row = tcost.predict(4096, 128, chip, p=2, pc=1)
    # The 2x2 mesh's rows are half as wide as the 2x1 mesh's: the column
    # communicator's row broadcasts halve, and the pc terms add per_step.
    rows_1 = 2 * (4 * 128 * N / 2 / link + lat)
    rows_2 = 2 * (4 * 128 * (N / 2) / 2 / link + lat)
    h = (4 * 128 * 128 * 3 / 4 / link + lat) - (4 * 128 * 128 / 2 / link
                                                 + lat)
    assert sq["comm"] == pytest.approx(
        row["comm"] + Nr * (per_step - rows_1 + rows_2 + h))


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
    point = tregistry.TunePoint.create(48, 8, "float32", (2, 2), True,
                                       device="cpu")
    cache = tplan_cache.PlanCache(str(tmp_path / "plans.json"))
    tuner = ttuner.Tuner(cache=cache, measure=True, survivors=2, samples=3)
    plan = tuner.select(point)
    assert len(plan.trials) == 2
    assert worlds == [(4, "measure_rank")] * 2
    assert tuner.measurements == 2 and plan.source == "measured"
    meas = ttuner.measure_config(
        tregistry.TunePoint.create(48, 8, "float32", (2, 2), True,
                                   workload="solve", device="cpu"),
        tregistry.get("solve_sharded"), samples=3)
    assert len(meas.samples) == 3 and meas.seconds > 0
    assert worlds[-1] == (4, "measure_rank") and len(worlds) == 3
    again = ttuner.Tuner(cache=tplan_cache.PlanCache.load(cache.path),
                         measure=True)
    assert again.select(point) == plan
    assert again.measurements == 0 and again.last_source == "cache"
    assert len(worlds) == 3


def test_cached_plan_measures_nothing_in_solve_and_cli(worlds, tmp_path,
                                                       capsys):
    path = str(tmp_path / "plans.json")
    point = tregistry.TunePoint.create(64, 8, "float32", (2, 2), True,
                                       device="cpu")
    cache = tplan_cache.PlanCache(path)
    cache.put(tplan_cache.plan_key(point), tplan_cache.Plan(
        config="swapfree", engine="swapfree", source="measured",
        seconds=1e-3))
    cache.save()
    assert "cpu|2x2|" in next(iter(json.load(open(path))["plans"]))
    before = ttuner._M_MEASUREMENTS.total()
    res = tdriver.solve(64, 8, workers=(2, 2), tune=True, plan_cache=path,
                        generator="rand", device="cpu")
    assert res.engine == "swapfree" and res.plan.source == "measured"
    capsys.readouterr()
    assert tmain(["64", "8", "--workers", "2x2", "--tune", "--plan-cache",
                  path, "--generator", "rand", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "engine: swapfree on cpu 2x2 (gloo)" in out
    assert "plan: swapfree (auto, measured plan)" in out
    assert ttuner._M_MEASUREMENTS.total() == before
    assert [f for _, f in worlds] == ["solve_rank", "solve_rank"]
