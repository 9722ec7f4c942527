"""The port's communication observatory (``obs/comm.py``, the recording
point of ``parallel/group.py``) on the CPU.

One gloo world of 4 CPU ranks for the module (``parallel.run_calls``):
every leg is a ``driver.solve`` or ``linalg.solve_system`` through its
joined-world branch under ``obs.comm.recording()``
(``obs.comm.run_leg``), 1D p = 4 and the meshes (2, 2), (1, 4), (4, 1).
The same numpy fixtures (written to matrix files) go through the JAX
package's single-device in-place engine, whose pivots the port's invert
legs hold (the padded tail's self-pivots aside): the JAX package's comm
inventory counts its own XLA collectives, so it is no oracle for the
port's, and the comm checker is the judge of the reports.

  * Every 1D and 2D engine, both gather modes, grouped k = 2 and 3 (a
    narrower tail group), the solves, a singular matrix, a fixture whose
    pivot is row t on some steps and not on others, and one whose swaps
    cross mesh columns: the observed collectives equal the inventory per
    rank and for the world.
  * Off, the recording point records nothing; a view of one rank records
    nothing.
  * A doctored inventory (one signature dropped, one added, a record moved
    between two ranks) is a typed mismatch.
  * The drift policies: "auto" judges nccl and never CPU or gloo ranks,
    "always" records the event, "never" overrides, a bad value raises.
  * The cost feedback is inert by default and re-prices the comm term
    only; the metric names pass the port's lint.
"""

import numpy as np
import pytest
import torch

from tpu_jordan.ops.jordan_inplace import \
    block_jordan_invert_inplace as jinvert

from tpu_jordan_torch.obs import comm
from tpu_jordan_torch.obs.metrics import NAME_RE, REGISTRY
from tpu_jordan_torch.obs.recorder import RECORDER
from tpu_jordan_torch.io import write_matrix_file
from tpu_jordan_torch.parallel import run_calls, run_workers
from tpu_jordan_torch.parallel.group import (RankLog, WorkerGroup, collecting,
                                             section, tally_gemm)
from tpu_jordan_torch.parallel.layout import CyclicLayout, CyclicLayout2D
from tpu_jordan_torch.tuning import cost_model
from tpu_jordan_torch.tuning.registry import TunePoint, projected_seconds

N, M = 44, 8


def _fixture(kind, n=N):
    rng = np.random.default_rng(7 * n + len(kind))
    if kind == "gauss":
        return rng.standard_normal((n, n))
    if kind == "swaps":
        # Diagonally dominant, rolled by one block: every step swaps, and
        # on pc = 4 the partners sit on other mesh columns.
        a = rng.standard_normal((n, n)) + 2.0 * n * np.eye(n)
        return np.roll(a, M, axis=0)
    a = rng.standard_normal((n, n))
    a[n // 2] = 0.0                                   # zero_row
    return a


# name -> (kind, kwargs): "invert" legs read a fixture file, "solve" legs
# generate A ("rand") and B as the demo does.
LEGS = {
    "1d_inplace_gathered": ("invert", "gauss", dict(workers=4,
                                                    engine="inplace",
                                                    gather=True)),
    "1d_inplace_sharded_fp32": ("invert", "gauss", dict(
        workers=4, engine="inplace", gather=False, dtype="float32")),
    "1d_inplace_bf16": ("invert", "gauss", dict(workers=4, engine="inplace",
                                                gather=True,
                                                dtype="bfloat16")),
    "1d_lookahead_gathered": ("invert", "gauss", dict(
        workers=4, engine="lookahead", gather=True)),
    "1d_grouped2_gathered": ("invert", "gauss", dict(
        workers=4, engine="grouped", gather=True, group_k=2)),
    "1d_grouped3_sharded": ("invert", "gauss", dict(
        workers=4, engine="grouped", gather=False, group_k=3)),
    "1d_swapfree_sharded": ("invert", "gauss", dict(
        workers=4, engine="swapfree", gather=False)),
    "1d_swapfree_gathered": ("invert", "swaps", dict(
        workers=4, engine="swapfree", gather=True)),
    "1d_inplace_swaps": ("invert", "swaps", dict(workers=4,
                                                 engine="inplace",
                                                 gather=True)),
    "1d_inplace_singular": ("invert", "zero_row", dict(
        workers=4, engine="inplace", gather=True)),
    "2d_inplace_gathered": ("invert", "gauss", dict(
        workers=(2, 2), engine="inplace", gather=True)),
    "2d_inplace_sharded": ("invert", "gauss", dict(
        workers=(2, 2), engine="inplace", gather=False)),
    "2d_lookahead_sharded": ("invert", "gauss", dict(
        workers=(2, 2), engine="lookahead", gather=False)),
    "2d_grouped2_gathered": ("invert", "gauss", dict(
        workers=(2, 2), engine="grouped", gather=True, group_k=2)),
    "2d_grouped3_sharded": ("invert", "gauss", dict(
        workers=(2, 2), engine="grouped", gather=False, group_k=3)),
    "2d_swapfree_sharded": ("invert", "gauss", dict(
        workers=(2, 2), engine="swapfree", gather=False)),
    "2d_swapfree_singular": ("invert", "zero_row", dict(
        workers=(2, 2), engine="swapfree", gather=True)),
    "2d_1x4_inplace_swaps": ("invert", "swaps", dict(
        workers=(1, 4), engine="inplace", gather=True)),
    "2d_1x4_swapfree_swaps": ("invert", "swaps", dict(
        workers=(1, 4), engine="swapfree", gather=False)),
    "2d_4x1_inplace_gathered": ("invert", "gauss", dict(
        workers=(4, 1), engine="inplace", gather=True)),
    "1d_solve_gathered": ("solve", None, dict(workers=4, gather=True, k=3)),
    "1d_solve_lookahead": ("solve", None, dict(
        workers=4, gather=False, k=2, engine="solve_lookahead")),
    "2d_solve_sharded": ("solve", None, dict(workers=(2, 2), gather=False,
                                             k=2)),
    "2d_solve_lookahead": ("solve", None, dict(
        workers=(2, 2), gather=True, k=1, engine="solve_lookahead")),
}
SINGULAR = {"1d_inplace_singular", "2d_swapfree_singular"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every leg once recorded, and 1d_inplace_gathered and
    2d_inplace_sharded once more with recording off, in one world."""
    tmp = tmp_path_factory.mktemp("comm")
    files = {}
    for kind in ("gauss", "swaps", "zero_row"):
        files[kind] = str(tmp / f"{kind}.txt")
        write_matrix_file(files[kind], _fixture(kind))
    calls = []
    for name, (kind, fix, kw) in LEGS.items():
        kw = {"n": N, "m": M, "dtype": "float64", **kw}
        if kind == "invert":
            kw["file"] = files[fix]
        else:
            kw["generator"] = "rand"
        calls.append((comm.run_leg, (kind, name, kw)))
    for name in ("1d_inplace_gathered", "2d_inplace_sharded"):
        kw = {"n": N, "m": M, "dtype": "float64", "file": files["gauss"],
              "record": False, **LEGS[name][2]}
        calls.append((comm.run_leg, ("invert", name + "_off", kw)))
    out = run_workers(4, run_calls, calls, device_type="cpu",
                      deadline_s=600)
    return {leg["name"]: leg for leg in out[0]}, out


@pytest.mark.parametrize("name", sorted(LEGS))
def test_observed_equals_inventory_per_rank_and_world(world, name):
    leg = world[0][name]
    c = leg["comm"]
    assert c["reconciled"] is True, c["mismatches"][:5]
    assert c["mismatches"] == []
    # Judged on every rank: each rank returned its own records.
    assert sorted(c["observed_ranks"]) == ["0", "1", "2", "3"]
    assert c["observed"]["engine"], "the engine section was observed"
    assert all(s["traced"] == s["executed"] for s in c["sigs"])
    assert leg["singular"] is (name in SINGULAR)


@pytest.mark.parametrize("name", sorted(LEGS))
def test_every_rank_returns_the_same_leg(world, name):
    legs = [{leg["name"]: leg for leg in rank}[name] for rank in world[1]]
    assert all(leg["comm"] == legs[0]["comm"] for leg in legs)


@pytest.mark.parametrize("name", [n for n in sorted(LEGS)
                                  if "inplace" in n and "bf16" not in n
                                  and "fp32" not in n and "singular" not in n
                                  and "swapfree" not in n])
def test_invert_pivots_hold_to_the_jax_engine(world, name):
    """The inventory's data input, the pivot record, is the JAX in-place
    engine's on the same matrix (the padded tail pivots on itself)."""
    leg = world[0][name]
    a = _fixture(LEGS[name][1])
    _, sing, stats = jinvert(a, block_size=M, collect_stats=True)
    ref = np.asarray(stats["pivot_block"]).tolist()
    assert not bool(sing)
    assert leg["pivots"][:len(ref)] == ref
    assert leg["pivots"][len(ref):] == list(range(len(ref),
                                                  len(leg["pivots"])))


def test_fixtures_cover_the_data_dependent_counts(world):
    """gauss pivots on row t at some steps and not at others; swaps never;
    the row-t broadcasts follow."""
    piv = world[0]["1d_inplace_gathered"]["pivots"]
    moved = [g != t for t, g in enumerate(piv)]
    assert any(moved) and not all(moved)
    sw = world[0]["1d_inplace_swaps"]["pivots"]
    assert sum(g != t for t, g in enumerate(sw[:-2])) >= 3
    sigs = world[0]["1d_inplace_gathered"]["comm"]["sigs"]
    rowt = sum(s["executed"] for s in sigs if s["phase"] == "row_exchange")
    assert rowt == 4 * sum(moved)


def test_swaps_cross_mesh_columns(world):
    """On (1, 4) the swaps move rows across mesh columns: the fix-up and
    the unscramble's point-to-point chunks are on the books."""
    sigs = world[0]["2d_1x4_inplace_swaps"]["comm"]["sigs"]
    assert any(s["phase"] == "unscramble" and s["kind"] == "send"
               for s in sigs)
    assert any(s["phase"] == "row_exchange" and s["axis"] == "pc"
               for s in sigs)
    assert not any(s["axis"] == "pr" for s in sigs), \
        "a (1, 4) mesh's column communicators are views of one rank"


def test_singular_swapfree_sends_no_h_at_pinned_steps(world):
    c = world[0]["2d_swapfree_singular"]["comm"]
    h = sum(s["executed"] for s in c["sigs"]
            if s["phase"] == "pivot" and s["kind"] == "broadcast")
    steps = CyclicLayout2D.create(N, M, 2, 2).Nr
    assert h < 4 * steps
    assert "gather" not in {s["section"] for s in c["sigs"]}


def test_gather_moves_the_storage_dtype(world):
    c = world[0]["1d_inplace_bf16"]["comm"]
    dts = {s["section"]: s["dtype"] for s in c["sigs"]}
    assert dts["gather"] == "bfloat16" and dts["engine"] == "float32"


@pytest.mark.parametrize("name", ["1d_inplace_gathered_off",
                                  "2d_inplace_sharded_off"])
def test_recording_off_records_nothing(world, name):
    leg = world[0][name]
    assert leg["comm"]["observed"] == {}
    assert leg["comm"]["reconciled"] is None
    assert leg["work"]["xla"]["available"] is False
    assert leg["comm"]["sigs"] == world[0][name[:-4]]["comm"]["sigs"]


def test_view_of_one_rank_records_nothing():
    g = WorkerGroup(rank=0, world_size=1, device=torch.device("cpu"),
                    backend="gloo")
    one = WorkerGroup(rank=2, world_size=4, device=torch.device("cpu"),
                      backend="gloo", members=(2,), axis="pc")
    log = RankLog()
    with collecting(log), section("engine"):
        for view in (g, one):
            view.all_reduce(torch.ones(3), "min")
            view.broadcast(torch.ones(3), 0)
            view.exchange([], [])
        tally_gemm(2, 3, 4)
    assert log.records == {}
    assert log.gemm_flops == 48
    with collecting(None):
        tally_gemm(2, 3, 4)
    assert log.gemm_flops == 48


def _expand(records):
    return [(r["kind"], r["axis"], tuple(r["shape"]), r["dtype"])
            for r in records for _ in range(r["count"])]


def _rebuilt(leg, kw):
    lay = (CyclicLayout2D.create(N, M, *kw["workers"])
           if isinstance(kw["workers"], tuple)
           else CyclicLayout.create(N, M, kw["workers"]))
    rep = comm.engine_report(engine=kw["engine"], lay=lay, dtype="float64",
                             pivots=leg["pivots"], gather=kw["gather"],
                             group=kw.get("group_k", 0))
    obs = {int(r): {sec: _expand(recs) for sec, recs in d.items()}
           for r, d in leg["comm"]["observed_ranks"].items()}
    return rep, obs


def test_rebuilt_report_reconciles(world):
    leg = world[0]["2d_inplace_gathered"]
    rep, obs = _rebuilt(leg, LEGS["2d_inplace_gathered"][2])
    rep.attach_observed(obs)
    assert rep.reconciled is True
    rep.check()
    assert rep.to_json()["sigs"] == leg["comm"]["sigs"]


@pytest.mark.parametrize("doctor", ["drop", "add", "move", "unpaired"])
def test_doctored_inventory_is_a_typed_mismatch(world, doctor):
    leg = world[0]["1d_grouped3_sharded"]
    rep, obs = _rebuilt(leg, LEGS["1d_grouped3_sharded"][2])
    if doctor == "drop":
        victim = rep.rank_sigs[1].pop()
        rep.sigs = comm.merge_sigs(
            [s for r in sorted(rep.rank_sigs) for s in rep.rank_sigs[r]])
        assert victim.executed
    elif doctor == "add":
        extra = comm.CollectiveSig("pivot", "broadcast", "p", 4, (8, 8),
                                   "float64", 1, 1)
        rep.rank_sigs[2].append(extra)
        rep.sigs = rep.sigs + [extra]
    elif doctor == "move":
        # A record moved from rank 0 to rank 3: the world's sums still
        # agree, so only the per-rank verdict catches it.
        obs[3]["engine"].append(obs[0]["engine"].pop())
    else:
        # A receive that both the inventory and the record claim, with no
        # send to meet it: only the pairing catches it.
        extra = comm.CollectiveSig("permute", "recv", "p", 4, (1, 8, 64),
                                   "float64", 1, 1)
        rep.rank_sigs[1].append(extra)
        rep.sigs = rep.sigs + [extra]
        obs[1]["engine"].append(("recv", "p", (1, 8, 64), "float64"))
    rep.attach_observed(obs)
    assert rep.reconciled is False
    assert rep.mismatches
    if doctor == "move":
        assert not [m for m in rep.mismatches if m.startswith("world")]
        assert any(m.startswith("rank 0/engine") for m in rep.mismatches)
    if doctor == "unpaired":
        assert rep.mismatches == ["world/p2p: p [1, 8, 64] float64: 0 "
                                  "sends vs 1 receives"]
    with pytest.raises(comm.ReconciliationError):
        rep.check()


# The "augmented" case keeps its id from before that engine had an
# inventory (it has one now: test_torch_sharded_augmented.py); the name it
# tries is one no engine has.
@pytest.mark.parametrize("engine", [
    pytest.param("augmented_2d", id="augmented"), "sharded_jordan", ""])
def test_unknown_engine_raises(engine):
    with pytest.raises(ValueError, match="inventory"):
        comm.engine_report(engine=engine, lay=CyclicLayout.create(N, M, 4),
                           dtype="float32", pivots=list(range(8)))


def test_gloo_and_cpu_ranks_are_never_judged_in_auto(world):
    for name in LEGS:
        d = world[0][name]["comm"]["drift"]
        assert d["backend"] == "gloo" and d["judged"] is False
        assert d["event_recorded"] is False


def _synthetic():
    lay = CyclicLayout.create(4096, 128, 4)
    return comm.engine_report(engine="inplace", lay=lay, dtype="float32",
                              pivots=list(range(lay.Nr)))


@pytest.mark.parametrize("judge,backend,judged", [
    ("auto", "nccl", True), ("auto", "gloo", False), ("auto", "cpu", False),
    ("always", "gloo", True), ("never", "nccl", False)])
def test_drift_policies(judge, backend, judged):
    comm.reset_calibration()
    rep = _synthetic()
    mark = RECORDER.total
    drift_total = REGISTRY.counter(
        "tpu_jordan_torch_comm_drift_total").total()
    try:
        with comm.set_drift_policy(tolerance=1.5, judge=judge):
            d = comm.observe_drift(rep, elapsed=5.0, backend=backend)
        events = [e for e in RECORDER.since(mark)
                  if e["kind"] == "comm_drift"]
        assert d["judged"] is judged
        # 5 s against a projection of milliseconds: out of any band.
        assert d["out_of_band"] is judged
        assert d["event_recorded"] is judged
        assert len(events) == int(judged)
        assert (REGISTRY.counter("tpu_jordan_torch_comm_drift_total").total()
                - drift_total) == int(judged)
        assert comm.calibration_state()["samples"] == int(judged)
        assert d["achieved_gbps"] > 0 and d["chip"] == "h100"
    finally:
        comm.reset_calibration()


def test_drift_projection_is_the_h100_model():
    rep = _synthetic()
    r = cost_model.predict(4096, 128, cost_model.H100, p=4)
    proj = comm.projection(rep)
    assert proj["comm_s"] == r["comm"]
    assert proj["compute_s"] == r["elim"] + r["probe"] + r["glue"]


def test_bad_drift_policy_raises():
    with pytest.raises(ValueError):
        with comm.set_drift_policy(judge="sometimes"):
            pass
    assert comm.drift_policy().judge == "auto"


def test_cost_feedback_inert_by_default_and_reprices_comm_only():
    pt = TunePoint.create(8192, 256, workers=8)
    single = TunePoint.create(8192, 256, workers=1)
    comm.reset_calibration()
    assert comm.cost_comm_scale() == 1.0
    base, base_single = projected_seconds(pt), projected_seconds(single)
    r = cost_model.predict(8192, 256, cost_model.H100, p=8)
    assert base == r["total"]
    try:
        comm._record_calibration(4.0)
        assert projected_seconds(pt) == base        # feedback still off
        comm.set_cost_feedback(True)
        assert comm.cost_comm_scale() == 4.0
        assert projected_seconds(pt) == pytest.approx(
            r["total"] + 3.0 * r["comm"], rel=1e-12)
        assert projected_seconds(pt) > base
        assert (projected_seconds(pt) / base
                > projected_seconds(single) / base_single)
    finally:
        comm.reset_calibration()
    assert projected_seconds(pt) == base


def test_metric_names_pass_the_lint(world):
    names = [n for n in REGISTRY.names()
             if n.startswith(("tpu_jordan_torch_comm_",
                              "tpu_jordan_torch_work_",
                              "tpu_jordan_torch_straggler_"))]
    assert len(names) >= 6
    assert all(NAME_RE.match(n) for n in names)
