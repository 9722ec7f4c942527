"""The port's mesh-backed serve lanes (``serve/meshlanes.py`` and the mesh
axis of the serving core) against the JAX package's
(``tpu_jordan.serve.meshlanes``; mirrors ``tests/test_meshserve.py``).

  * The topology vocabulary agrees with JAX's on the same inputs; a
    malformed label is the same typed refusal.
  * The placement rule (the port's departure: ranks are processes, gloo
    ranks may share a card): at most ``RANKS_PER_CARD`` ranks a card, one
    a core on the CPU; an unplaceable mesh is a typed UsageError at
    configure time.
  * ``projected_lane_bytes(devices=p)`` equals JAX's value.
  * The typed refusals carry the JAX messages.
  * The admission walk on the same sizes and budget gives JAX's lanes,
    hops and ``CapacityExceededError`` text; ``project_capacity`` gives
    JAX's projections and builds nothing.
  * The warm round trip: requests over the single-device budget serve
    through ``p2`` with zero builds and zero world starts after warmup,
    each with a ``mesh_admitted`` hop; X is held against the JAX service's
    answer to the same request.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan.driver import UsageError as JUsageError
from tpu_jordan.resilience.policy import \
    CapacityExceededError as JCapacityError
from tpu_jordan.serve import JordanService as JService
from tpu_jordan.serve import executors as jex
from tpu_jordan.serve import meshlanes as jml

from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.obs.recorder import RECORDER
from tpu_jordan_torch.parallel.world import world_starts
from tpu_jordan_torch.resilience.policy import CapacityExceededError
from tpu_jordan_torch.serve import JordanService
from tpu_jordan_torch.serve import executors as tex
from tpu_jordan_torch.serve import meshlanes as tml

CPU = "cpu"
F32 = torch.float32


def _mesh_key(**kw):
    base = dict(bucket_n=64, batch_cap=1, dtype="float32",
                engine="inplace", block_size=16, workload="invert",
                rhs=0, mesh="p2")
    base.update(kw)
    return base


def _jax_error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return str(e.value)


class TestMeshVocabulary:
    @pytest.mark.parametrize("spec", [8, (2, 4), 1, (1, 3), 2])
    def test_one_spelling_label_roundtrip(self, spec):
        label = tml.mesh_label(spec)
        assert label == jml.mesh_label(spec)
        assert tml.parse_mesh(label) == jml.parse_mesh(label)
        assert tml.mesh_devices(spec) == jml.mesh_devices(spec)
        assert tml.MESH_SINGLE == jml.MESH_SINGLE

    @pytest.mark.parametrize("label", ["8x", "fast", "p0", "0x2", "x2"])
    def test_malformed_label_is_typed(self, label):
        ref = _jax_error(lambda: jml.parse_mesh(label))
        with pytest.raises(UsageError) as e:
            tml.parse_mesh(label)
        assert str(e.value) == ref

    @pytest.mark.parametrize("spec", [1, (0, 2), 0, "single"])
    def test_non_topologies_refused_in_jax_words(self, spec):
        ref = _jax_error(lambda: jml.normalize_mesh(spec))
        with pytest.raises(UsageError) as e:
            tml.normalize_mesh(spec, CPU)
        assert str(e.value) == ref

    def test_placement_rule(self, monkeypatch):
        cores = os.cpu_count() or 1
        assert tml.placement_capacity(CPU)[0] == cores
        assert tml.normalize_mesh(2, CPU) == 2
        assert tml.normalize_mesh("1x2", CPU) == (1, 2)
        with pytest.raises(UsageError, match=f"needs {cores + 1} ranks"):
            tml.normalize_mesh(cores + 1, CPU)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert tml.placement_capacity("cuda")[0] == tml.RANKS_PER_CARD
        assert tml.normalize_mesh((2, 2), "cuda") == (2, 2)
        with pytest.raises(UsageError, match="needs 8 ranks; this process "
                                             "places at most 4"):
            tml.normalize_mesh("2x4", "cuda")

    @pytest.mark.parametrize("args", [
        (64, 1, "float32"), (64, 4, "float32"), (4096, 1, "float32"),
        (64, 1, "float32", "solve", 8), (128, 4, "float64", "solve", 16),
        (64, 1, "float32", "update", 8)])
    @pytest.mark.parametrize("devices", [1, 2, 4, 8])
    def test_per_device_projection_equals_jax(self, args, devices):
        j = jex.projected_lane_bytes(*args, devices=devices)
        assert tex.projected_lane_bytes(*args, devices=devices) == j

    def test_lane_labels_equal_jax(self):
        for a in [("invert", 64, 1, 0, "p2"), ("solve", 64, 1, 8, "2x2"),
                  ("invert", 64, 4, 0, "single")]:
            assert tex.lane_label(*a) == jex.lane_label(*a)


class TestTypedRefusals:
    @pytest.mark.parametrize("kw", [
        dict(dtype="complex64"),
        dict(workload="solve", rhs=8, engine="solve_spd"),
        dict(workload="update", rhs=4),
        dict(batch_cap=2),
        dict(workload="solve", rhs=8, engine="lookahead"),
    ], ids=["complex", "spd", "update", "batch_cap", "solve_engine"])
    def test_executor_refusals_carry_the_jax_messages(self, kw):
        ref = _jax_error(lambda: jml.MeshLaneExecutor(
            jex.ExecutorKey(**_mesh_key(**kw)), None))
        with pytest.raises(UsageError) as e:
            tml.MeshLaneExecutor(tex.ExecutorKey(**_mesh_key(**kw)), None,
                                 torch.device(CPU))
        assert str(e.value) == ref

    def test_mesh_shapes_without_budget_is_typed(self):
        ref = _jax_error(lambda: JService(dtype=jnp.float32,
                                          mesh_shapes=(2,)))
        with pytest.raises(UsageError) as e:
            JordanService(dtype=F32, mesh_shapes=(2,), device=CPU)
        assert str(e.value) == ref.replace(" (docs/SERVING.md)", "")

    def test_resident_invert_refused_on_mesh_route(self):
        a = np.eye(64, dtype=np.float32)
        budget = tex.projected_lane_bytes(64, 4, F32) - 1
        with JService(dtype=jnp.float32, batch_cap=4, mesh_shapes=(2,),
                      lane_budget_bytes=budget, autostart=False) as js:
            ref = _jax_error(lambda: js.invert(a, resident=True))
        with JordanService(dtype=F32, batch_cap=4, mesh_shapes=(2,),
                           lane_budget_bytes=budget, autostart=False,
                           device=CPU) as svc:
            with pytest.raises(UsageError) as e:
                svc.invert(a, resident=True)
        assert str(e.value) == ref


class _Ctx:
    def __init__(self):
        self.events = []

    def event(self, name, **fields):
        self.events.append((name, fields))


def _walk(svc, sizes):
    ctx, lanes = _Ctx(), []
    for n in sizes:
        try:
            lanes.append(svc._admit_mesh(n, n, "invert", 0, ctx))
        except Exception as e:                  # noqa: BLE001
            lanes.append((type(e).__name__, str(e)))
    return lanes, ctx.events


class TestCapacityAdmission:
    def test_admission_walk_equals_jax(self):
        cap = 4
        budget = (tex.projected_lane_bytes(64, cap, F32)
                  + tex.projected_lane_bytes(128, cap, F32)) // 2
        sizes = [64, 128, 256, 2048]
        with JService(dtype=jnp.float32, batch_cap=cap,
                      mesh_shapes=(2, (2, 2)), lane_budget_bytes=budget,
                      autostart=False) as js:
            jl, jev = _walk(js, sizes)
        mark = RECORDER.total
        with JordanService(dtype=F32, batch_cap=cap, mesh_shapes=(2, (2, 2)),
                           lane_budget_bytes=budget, autostart=False,
                           device=CPU) as svc:
            tl, tev = _walk(svc, sizes)
            assert svc.stats()["mesh_lanes"] == {"p2": 2, "2x2": 4}
        assert [x if isinstance(x, str) else x[1] for x in tl] == \
            [x if isinstance(x, str) else x[1] for x in jl]
        assert tl[0] == "single" and tl[1] == "p2"
        assert tl[-1][0] == "CapacityExceededError"
        assert tev == jev
        assert any(e.get("kind") == "capacity_refused"
                   for e in RECORDER.since(mark))

    def test_over_budget_without_mesh_names_the_gap(self):
        a = np.eye(64, dtype=np.float32)
        with JService(dtype=jnp.float32, batch_cap=4, lane_budget_bytes=4096,
                      autostart=False) as js:
            with pytest.raises(JCapacityError) as je:
                js.submit(a)
        with JordanService(dtype=F32, batch_cap=4, lane_budget_bytes=4096,
                           autostart=False, device=CPU) as svc:
            with pytest.raises(CapacityExceededError,
                               match="no mesh_shapes configured") as e:
                svc.submit(a)
        assert str(e.value) == str(je.value)

    def test_too_big_for_largest_mesh_names_it(self):
        a = np.eye(64, dtype=np.float32)
        budget = tex.projected_lane_bytes(64, 1, F32, devices=2) - 1
        with JService(dtype=jnp.float32, batch_cap=4, mesh_shapes=(2,),
                      lane_budget_bytes=budget, autostart=False) as js:
            with pytest.raises(JCapacityError) as je:
                js.submit(a)
        with JordanService(dtype=F32, batch_cap=4, mesh_shapes=(2,),
                           lane_budget_bytes=budget, autostart=False,
                           device=CPU) as svc:
            with pytest.raises(CapacityExceededError,
                               match="largest configured mesh "
                                     "\\('p2'\\)") as e:
                svc.submit(a)
        assert str(e.value) == str(je.value)

    def test_project_capacity_mesh_entries_without_building(self):
        budget = tex.projected_lane_bytes(512, 4, F32)
        kw = dict(shapes=(64,), mesh_shapes=[(64, 2), (64, 8, "2x2")])
        with JService(dtype=jnp.float32, batch_cap=4,
                      mesh_shapes=(2, (2, 2)), lane_budget_bytes=budget,
                      autostart=False) as js:
            jout = js.project_capacity(**kw)
        starts = world_starts()
        with JordanService(dtype=F32, batch_cap=4, mesh_shapes=(2, (2, 2)),
                           lane_budget_bytes=budget, autostart=False,
                           device=CPU) as svc:
            tout = svc.project_capacity(**kw)
            assert svc.stats()["totals"]["compiles"] == 0
        assert tout == jout
        assert world_starts() == starts


def test_warm_mesh_round_trip_matches_jax(rng):
    """Requests over the single-device budget serve through the warm p2
    lane: zero builds, zero measurements and zero world starts on the
    request path, a ``mesh_admitted`` hop each, X equal to the JAX
    service's within the fp32 tolerance, the stats' mesh row."""
    cap = 4
    budget = (tex.projected_lane_bytes(64, 1, F32, devices=2)
              + tex.projected_lane_bytes(64, cap, F32)) // 2
    mats = [rng.standard_normal((n, n)).astype(np.float32)
            for n in (64, 60, 64)]
    kw = dict(batch_cap=cap, max_wait_ms=1.0, block_size=16,
              mesh_shapes=(2,), lane_budget_bytes=budget)
    with JService(dtype=jnp.float32, **kw) as js:
        js.warmup(mesh_shapes=[(64, 2)])
        jres = [js.submit(a).result(120) for a in mats]
    mark = RECORDER.total
    with JordanService(dtype=F32, device=CPU, **kw) as svc:
        warm = svc.warmup(mesh_shapes=[(64, 2)])
        assert warm == {"64@p2": "inplace"}
        builds = svc.stats()["totals"]["compiles"]
        starts = world_starts()
        results = [svc.submit(a).result(120) for a in mats]
        stats = svc.stats()
        assert world_starts() == starts
        lane = dict(svc.executors.entries())
        assert all(ex.world.starts == 1 for ex in lane.values())
    assert stats["totals"]["compiles"] == builds
    assert stats["measurements"] == 0
    for a, r, jr in zip(mats, results, jres):
        n = a.shape[0]
        assert not r.singular and r.inverse.shape == (n, n)
        assert r.rel_residual < 1e-4
        kappa = np.linalg.norm(a, np.inf) * np.linalg.norm(
            np.linalg.inv(a.astype(np.float64)), np.inf)
        tol = 16 * np.finfo(np.float32).eps * n * kappa
        x, jx = r.inverse.numpy(), np.asarray(jr.inverse)
        assert (np.abs(x - jx).sum(1).max() / np.abs(jx).sum(1).max()
                <= tol)
    hops = [e for e in RECORDER.since(mark) if e.get("kind") == "journey"
            and e.get("event") == "mesh_admitted"]
    assert len(hops) == len(mats) and all(e["mesh"] == "p2" for e in hops)
    rows = {b: s for b, s in stats["buckets"].items()
            if s["mesh"] != "single"}
    assert sum(s["requests"] for s in rows.values()) == len(mats)
    assert stats["engines"]["64@p2"]["mesh"] == "p2"
    # The lane's world ended with the service.
    assert all(not ex.world.alive for ex in lane.values())


def test_solve_lane_round_trip(rng):
    """A solve request over the budget rides the p2 solve lane: X within
    the solve gate of the exact answer, zero world starts once warm."""
    budget = tex.projected_lane_bytes(64, 1, F32, "solve", 2, devices=2)
    a = (rng.standard_normal((64, 64)) + 64 * np.eye(64)).astype(np.float32)
    b = rng.standard_normal((64, 2)).astype(np.float32)
    with JordanService(dtype=F32, batch_cap=2, block_size=16,
                       mesh_shapes=(2,), lane_budget_bytes=budget,
                       device=CPU) as svc:
        svc.warmup(mesh_shapes=[(64, 2, 2)])
        starts = world_starts()
        r = svc.submit(a, b).result(120)
        assert world_starts() == starts
    assert r.workload == "solve" and not r.singular
    x = np.linalg.solve(a.astype(np.float64), b)
    assert np.abs(r.solution.numpy() - x).max() < 1e-4
