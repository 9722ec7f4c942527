"""The port's serving core against the JAX package's, on the CPU.

The same numpy fixtures go through ``tpu_jordan.serve`` (its own CPU path)
and ``tpu_jordan_torch.serve`` with ``device="cpu"``: the bucket and byte
functions are equal; invert and solve round trips agree within
16·eps·n·κ∞ (relative ∞-norm; 16 is the residual gate's constant,
``ResiliencePolicy.gate_tol``), with equal singular flags, κ∞ to rtol 1e-6
in fp64, and both packages' rel_residual under the gate (it is rounding
noise, which the two packages' product orders make differ by up to ~2×);
``block_jordan_solve_batched`` picks every element's ``block_jordan_solve``
pivots; the stats snapshot has the JAX keys and
counts; the CLI's exit codes are the JAX CLI's.  The executor cache, the
micro-batcher's lifecycle and the refusals of later items are pinned on the
port alone.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan import serve as jserve
from tpu_jordan.__main__ import main as jmain

from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.errors import SingularMatrixError, UsageError
from tpu_jordan_torch.linalg import (block_jordan_solve,
                                     block_jordan_solve_batched)
from tpu_jordan_torch.obs.metrics import REGISTRY
from tpu_jordan_torch.ops import batched_jordan_invert, probe_blocks
from tpu_jordan_torch.serve import (ExecutorCache, JordanService,
                                    MicroBatcher, ServeStats,
                                    ServiceClosedError,
                                    ServiceOverloadedError, bucket_for,
                                    k_bucket_for, lane_label,
                                    projected_lane_bytes, rhs_bucket_for,
                                    serve_demo)

CPU = "cpu"


def _mats(rng, sizes, dtype=np.float64):
    return [rng.standard_normal((s, s)).astype(dtype) for s in sizes]


def _gate(a):
    """The fp64 invert gate, 16·eps·n·κ∞, capped at 0.5."""
    a = np.asarray(a, np.complex128)
    kappa = np.linalg.norm(a, np.inf) * np.linalg.norm(np.linalg.inv(a),
                                                       np.inf)
    return min(16 * np.finfo(np.float64).eps * a.shape[0] * kappa, 0.5)


def _close(x, ref, a):
    """Relative ∞-norm agreement within 16·eps·n·κ∞ (the ROADMAP's
    eps·n·κ scaling with the gate's constant)."""
    x = np.asarray(x, np.complex128)
    ref = np.asarray(ref, np.complex128)
    a = np.asarray(a, np.complex128)
    eps = np.finfo(np.float64).eps
    kappa = np.linalg.norm(a, np.inf) * np.linalg.norm(np.linalg.inv(a),
                                                       np.inf)
    diff = np.linalg.norm(x - ref, np.inf) / np.linalg.norm(ref, np.inf)
    return diff <= 16 * eps * a.shape[0] * kappa


# ---- bucket and byte functions -------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "bfloat16"])
def test_bucket_and_byte_functions_equal_jax(dtype):
    for n in (1, 7, 63, 64, 65, 100, 128, 129, 1000, 2048, 5000):
        assert bucket_for(n) == jserve.bucket_for(n)
        for cap in (1, 3, 8):
            for wl, k in (("invert", 0), ("solve", 1), ("solve", 5),
                          ("update", 8), ("update", 32)):
                b = bucket_for(n)
                assert lane_label(wl, b, cap, k) == \
                    jserve.executors.lane_label(wl, b, cap, k)
                assert (projected_lane_bytes(b, cap, dtype, wl, k)
                        == jserve.executors.projected_lane_bytes(
                            b, cap, jnp.dtype(dtype), wl, k))
    for k in (1, 2, 3, 8, 9, 100):
        assert rhs_bucket_for(k) == jserve.executors.rhs_bucket_for(k)
        assert k_bucket_for(k) == jserve.k_bucket_for(k)
    for bad in (bucket_for, rhs_bucket_for, k_bucket_for):
        with pytest.raises(ValueError):
            bad(0)
    from tpu_jordan.obs import hwcost as jhwcost
    from tpu_jordan_torch.obs import hwcost

    for n in (1, 64, 2048):
        assert hwcost.gauss_jordan_flops(n) == jhwcost.gauss_jordan_flops(n)


# ---- the executor cache --------------------------------------------------

def test_executor_cache_builds_once_per_key_then_hits():
    stats = ServeStats()
    cache = ExecutorCache(dtype=torch.float32, device=CPU, stats=stats)
    e1 = cache.get(64, 4)
    assert cache.get(64, 4) is e1
    snap = stats.snapshot()["buckets"]["64"]
    assert snap["compiles"] == 1 and snap["cache_hits"] == 1
    assert cache.get(64, 2) is not e1                  # another batch cap
    # The block size is part of the key: never a stale-m hit.
    e8, e32 = cache.get(64, 2, block_size=8), cache.get(64, 2, block_size=32)
    assert e8 is not e32
    assert (e8.key.block_size, e32.key.block_size) == (8, 32)
    assert cache.get(64, 2, block_size=8) is e8
    assert stats.snapshot()["buckets"]["64"]["compiles"] == 4


def test_a_shared_store_builds_each_lane_once_across_services():
    from tpu_jordan_torch.serve import ExecutorStore

    store = ExecutorStore()
    with JordanService(batch_cap=2, shared_executors=store,
                       device=CPU) as s1:
        s1.warmup(shapes=[48], solve_shapes=[(48, 2)])
    with JordanService(batch_cap=2, shared_executors=store,
                       device=CPU) as s2:
        s2.warmup(shapes=[48], solve_shapes=[(48, 2)])
        ex, source = s2.executors.get_info(64, 2)
        assert source == "cached"
        assert s2.stats()["totals"]["compiles"] == 0
    assert s1.stats()["totals"]["compiles"] == 2
    assert [k for k, _ in s1.executors.entries()] == \
        [k for k, _ in s2.executors.entries()]


def test_lanes_resolve_through_the_plan_cache_with_zero_measurements(
        tmp_path):
    from tpu_jordan_torch.tuning import PlanCache

    path = str(tmp_path / "plans.json")
    c1 = ExecutorCache(plan_cache=path, dtype=torch.float32, device=CPU)
    ex = c1.get(64, 4)
    sx = c1.get(64, 4, workload="solve", rhs=2)
    assert ex.key.engine == "inplace" and sx.key.engine == "solve_aug"
    assert ex.plan.source == "cost_model" and c1.measurements == 0
    assert any(k.endswith("|b4") for k in PlanCache.load(path).plans)
    c2 = ExecutorCache(plan_cache=path, dtype=torch.float32, device=CPU)
    assert c2.get(64, 4).key == ex.key
    assert c2.tuner.last_source == "cache" and c2.measurements == 0


# ---- round trips against the JAX package --------------------------------

def test_invert_round_trip_matches_jax(rng):
    sizes = [40, 64, 100, 128, 200, 256, 90, 30]
    mats = _mats(rng, sizes)
    mats[5] = np.ones((256, 256))                     # singular rider

    def run(svc):
        futs = [svc.submit(a) for a in mats]
        svc.start()
        return [f.result(120) for f in futs]

    with JordanService(batch_cap=4, max_wait_ms=1.0, autostart=False,
                       dtype=torch.float64, device=CPU) as svc:
        mine = run(svc)
    with jserve.JordanService(batch_cap=4, max_wait_ms=1.0,
                              autostart=False, dtype=jnp.float64) as svc:
        ref = run(svc)
    for a, r, j in zip(mats, mine, ref):
        assert (r.n, r.bucket_n) == (j.n, j.bucket_n)
        assert r.singular == j.singular
        assert r.inverse.device.type == "cpu"
        if r.singular:
            continue
        assert _close(r.inverse.numpy(), np.asarray(j.inverse), a)
        assert r.kappa == pytest.approx(j.kappa, rel=1e-6)
        assert max(r.rel_residual, j.rel_residual) < _gate(a)


def test_bucketed_result_bitmatches_the_batched_engine(rng):
    mats = _mats(rng, [100, 70, 128, 90], dtype=np.float32)
    with JordanService(batch_cap=4, max_wait_ms=1.0, autostart=False,
                       device=CPU) as svc:
        futs = [svc.submit(a) for a in mats]
        svc.start()
        res = [f.result(120) for f in futs]
    assert all(r.batch_occupancy == 4 for r in res)
    stack = torch.eye(128).repeat(4, 1, 1)
    for i, a in enumerate(mats):
        stack[i, :a.shape[0], :a.shape[0]] = torch.from_numpy(a)
    inv, sing = batched_jordan_invert(stack, block_size=64)
    for i, r in enumerate(res):
        assert torch.equal(r.inverse, inv[i, :r.n, :r.n])
        assert r.singular == bool(sing[i])


def _recording_probe(log):
    def probe(cands, eps):
        invs, sing = probe_blocks(cands, eps)
        log.append((invs, sing))
        return invs, sing
    return probe


def _pivots(log, B):
    """Each element's pivot per superstep from a probe log (argmin of
    ‖inv‖∞ with singular candidates excluded)."""
    out = [[] for _ in range(B)]
    for invs, sing in log:
        key = torch.where(sing, float("inf"),
                          invs.abs().sum(-1).amax(-1)).view(B, -1)
        for i, p in enumerate(torch.argmin(key, dim=1).tolist()):
            out[i].append(p)
    return out


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("k", [1, 3])
def test_solve_round_trip_matches_jax(rng, dtype, k):
    sizes = [48, 64, 100, 128]
    mats = [rng.standard_normal((s, s)) for s in sizes]
    rhs = [rng.standard_normal((s, k)) for s in sizes]
    if dtype == "complex128":
        mats = [a + 1j * rng.standard_normal(a.shape) for a in mats]
        rhs = [b + 1j * rng.standard_normal(b.shape) for b in rhs]
    bs = [b[:, 0] if k == 1 else b for b in rhs]

    def run(svc):
        futs = [svc.submit(a, b) for a, b in zip(mats, bs)]
        svc.start()
        return [f.result(120) for f in futs]

    with JordanService(batch_cap=4, max_wait_ms=1.0, autostart=False,
                       dtype=dtype, device=CPU) as svc:
        mine = run(svc)
    with jserve.JordanService(batch_cap=4, max_wait_ms=1.0,
                              autostart=False, dtype=jnp.dtype(dtype)) as svc:
        ref = run(svc)
    for a, r, j in zip(mats, mine, ref):
        assert r.workload == j.workload == "solve" and r.inverse is None
        assert r.singular == j.singular is False
        assert r.solution.shape == (a.shape[0], k)
        assert _close(r.solution.numpy(), np.asarray(j.solution), a)
        assert r.kappa == pytest.approx(j.kappa, rel=1e-6)
        assert max(r.rel_residual, j.rel_residual) < _gate(a)

    # The batched engine picks each element's single-engine pivots.
    N = 128
    A = torch.eye(N, dtype=getattr(torch, dtype)).repeat(4, 1, 1)
    B = torch.zeros((4, N, k), dtype=A.dtype)
    for i, (a, b) in enumerate(zip(mats, rhs)):
        A[i, :a.shape[0], :a.shape[0]] = torch.from_numpy(a)
        B[i, :a.shape[0]] = torch.from_numpy(b)
    A0, B0 = A.clone(), B.clone()
    log = []
    x, sing = block_jordan_solve_batched(A, B, 32,
                                         probe=_recording_probe(log))
    assert torch.equal(A, A0) and torch.equal(B, B0)   # inputs untouched
    batched = _pivots(log, 4)
    for i in range(4):
        one = []
        xi, si = block_jordan_solve(A[i], B[i], 32,
                                    probe=_recording_probe(one))
        assert batched[i] == _pivots(one, 1)[0]
        assert bool(si) == bool(sing[i])
        assert torch.allclose(x[i], xi, rtol=0, atol=1e-12)


def test_singular_rider_does_not_poison_its_batch(rng):
    good = _mats(rng, [48, 48, 48], dtype=np.float32)
    bad = np.ones((48, 48), np.float32)
    with JordanService(batch_cap=4, max_wait_ms=50.0, autostart=False,
                       device=CPU) as svc:
        futs = ([svc.submit(g) for g in good[:2]] + [svc.submit(bad)]
                + [svc.submit(good[2])])
        svc.start()
        res = [f.result(120) for f in futs]
    assert [r.singular for r in res] == [False, False, True, False]
    assert all(r.rel_residual < 1e-4 for r in res if not r.singular)
    assert res[0].batch_occupancy == 4
    with JordanService(batch_cap=1, max_wait_ms=0.5, device=CPU) as svc:
        with pytest.raises(SingularMatrixError):
            svc.invert(bad, timeout=120)
        with pytest.raises(ValueError, match="square"):
            svc.submit(np.zeros((4, 5), np.float32))


# ---- backpressure and shutdown ------------------------------------------

def test_full_queue_raises_typed_backpressure_and_drops_nothing(rng):
    mats = _mats(rng, [32] * 5, dtype=np.float32)
    svc = JordanService(batch_cap=2, max_wait_ms=1.0, max_queue=4,
                        autostart=False, device=CPU)
    futs = [svc.submit(m) for m in mats[:4]]
    with pytest.raises(ServiceOverloadedError):
        svc.submit(mats[4])
    assert svc.stats()["totals"]["rejected"] == 1
    svc.start()
    assert all(not f.result(120).singular for f in futs)
    svc.close()


def test_close_drains_queued_work(rng):
    svc = JordanService(batch_cap=4, max_wait_ms=10_000.0, autostart=False,
                        device=CPU)
    futs = [svc.submit(m) for m in _mats(rng, [24] * 3, np.float32)]
    svc.close(drain=True)                   # never started: drains inline
    assert all(f.done() and not f.result().singular for f in futs)
    with pytest.raises(ServiceClosedError):
        svc.submit(np.eye(8, dtype=np.float32))


def test_caller_cancel_drops_only_that_request(rng):
    svc = JordanService(batch_cap=4, max_wait_ms=5.0, autostart=False,
                        device=CPU)
    futs = [svc.submit(m) for m in _mats(rng, [24] * 3, np.float32)]
    assert futs[1].cancel()
    svc.start()
    assert not futs[0].result(120).singular
    assert not futs[2].result(120).singular
    assert futs[1].cancelled()
    svc.close()
    assert svc.stats()["totals"]["batches"] >= 1


def test_close_without_drain_fails_futures_explicitly(rng):
    svc = JordanService(batch_cap=4, max_wait_ms=10_000.0, autostart=False,
                        device=CPU)
    futs = [svc.submit(m) for m in _mats(rng, [24] * 2, np.float32)]
    svc.close(drain=False)
    for f in futs:
        with pytest.raises(ServiceClosedError):
            f.result(10)


def test_close_error_factory_types_queued_failures(rng):
    class WorkerGone(RuntimeError):
        pass

    svc = JordanService(batch_cap=4, max_wait_ms=10_000.0, autostart=False,
                        device=CPU)
    futs = [svc.submit(m) for m in _mats(rng, [24] * 2, np.float32)]
    svc.close(drain=False, error=lambda: WorkerGone("died"))
    for f in futs:
        with pytest.raises(WorkerGone):
            f.result(10)


def test_close_is_idempotent_and_thread_safe(rng):
    svc = JordanService(batch_cap=4, max_wait_ms=10_000.0, autostart=False,
                        device=CPU)
    futs = [svc.submit(m) for m in _mats(rng, [24] * 3, np.float32)]
    errs = []

    def closer():
        try:
            svc.close(drain=True)
        except Exception as e:            # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=closer) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    svc.close()
    assert errs == []
    assert all(not f.result(1).singular for f in futs)


def test_bounded_join_abandons_a_wedged_dispatcher():
    gate = threading.Event()

    class StuckExecutors:
        def breaker(self, lane):
            return None

        def get_info(self, bucket, batch_cap, block_size, **kw):
            gate.wait(30)          # the hung device call
            raise RuntimeError("released")

    mb = MicroBatcher(StuckExecutors(), ServeStats(), batch_cap=1,
                      max_wait_ms=0.1)
    fut = mb.submit(np.eye(4, dtype=np.float32), 4, 64)
    deadline = time.monotonic() + 10
    while not mb.progress()[1] and time.monotonic() < deadline:
        time.sleep(0.005)
    assert mb.progress()[1]
    abandoned = REGISTRY.counter(
        "tpu_jordan_torch_serve_dispatcher_abandoned_total")
    before = abandoned.total()
    t0 = time.monotonic()
    mb.close(drain=False, join_timeout_s=0.2)
    assert time.monotonic() - t0 < 5
    assert abandoned.total() == before + 1
    assert mb.reap() is False                 # still wedged
    gate.set()
    with pytest.raises(RuntimeError, match="released"):
        fut.result(30)
    mb._thread.join(30)
    assert mb.reap() is True


# ---- stats ----------------------------------------------------------------

def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_stats_snapshot_has_jax_keys_and_counts(rng):
    mats = _mats(rng, [24, 48, 100, 24, 120, 48, 24], dtype=np.float32)
    bad = np.ones((48, 48), np.float32)

    def run(svc):
        svc.warmup(shapes=[24, 100])
        futs = [svc.submit(a) for a in mats] + [svc.submit(bad)]
        futs.append(svc.submit(mats[2], mats[2][:, :3]))
        svc.start()
        for f in futs:
            f.result(120)
        svc.close()
        return svc.stats()

    mine = run(JordanService(batch_cap=4, max_wait_ms=1.0, autostart=False,
                             device=CPU))
    ref = run(jserve.JordanService(batch_cap=4, max_wait_ms=1.0,
                                   autostart=False))
    for key in ("buckets", "totals", "workloads", "labels", "exec_ms",
                "engines", "measurements", "batch_cap", "queued",
                "breakers"):
        assert key in mine and key in ref
    assert set(mine["buckets"]) == set(ref["buckets"])
    for lane, b in mine["buckets"].items():
        # The JAX lanes carry XLA's cost analysis ("executable"); eager
        # PyTorch has none, so the port leaves it absent, never modeled.
        jax_keys = _keys(ref["buckets"][lane])
        jax_keys.pop("executable", None)
        assert "executable" not in b and _keys(b) == jax_keys
        for k in ("requests", "rejected", "batches", "mean_occupancy",
                  "compiles", "cache_hits", "singular", "workload", "mesh"):
            assert b[k] == ref["buckets"][lane][k], (lane, k)
    assert mine["totals"] == ref["totals"]
    assert mine["workloads"] == ref["workloads"]
    assert mine["breakers"] == ref["breakers"]


def test_reserved_metric_labels_are_refused_typed():
    for key in ("bucket", "component", "value", "exemplar", "mesh"):
        with pytest.raises(UsageError, match="reserved metric label"):
            ServeStats(labels={key: "x"})


# ---- the demo and the CLI -------------------------------------------------

def test_serve_demo_reports_at_256():
    rep = serve_demo(256, requests=24, batch_cap=4, device=CPU)
    ref = jserve.serve_demo(256, requests=24, batch_cap=4)
    assert rep["metric"] == "serve_demo"
    assert rep["request_sizes"] == [256, 128, 64] and rep["buckets"] == 3
    assert rep["compiles"] == 3 and rep["compiles_on_request_path"] == 0
    assert rep["plan_cache_measurements"] == 0 and rep["singular"] == 0
    # The same 24 generated matrices: the worst residual is the same
    # matrix's in both packages, equal up to rounding noise.
    ratio = float(rep["worst_rel_residual"]) / float(
        ref["worst_rel_residual"])
    assert 0.25 < ratio < 4
    for key in ("request_sizes", "buckets", "compiles",
                "compiles_on_request_path", "plan_cache_measurements",
                "singular"):
        assert rep[key] == ref[key], key
    assert rep["device"] == "cpu" and rep["device_memory"] is None
    assert set(rep["mean_occupancy"]) == {"256", "128", "64"}


@pytest.mark.parametrize("argv", [
    ["96", "32", "--serve-demo", "--batch", "4", "--quiet"],
    ["96", "32", "--serve-demo", "--tune", "--quiet"],
    ["96", "32", "--serve-demo", "--engine", "swapfree", "--quiet"],
    ["96", "32", "--serve-demo", "--serve-requests", "0", "--quiet"],
    ["96", "32", "--serve-demo", "--batch-cap", "0", "--quiet"],
    ["96", "32", "--serve-demo", "--max-wait-ms", "-1", "--quiet"],
    ["96", "32", "/no/such/file", "--serve-demo", "--quiet"],
    ["96", "32", "--serve-demo", "--workload", "solve", "--quiet"],
    ["96", "32", "--chaos-demo", "--serve-demo", "--quiet"],
    ["96", "32", "--chaos-demo", "--batch", "2", "--quiet"],
    ["96", "32", "--chaos-demo", "--numerics", "summary", "--quiet"],
    ["96", "32", "--chaos-demo", "--group", "2", "--quiet"],
    ["96", "32", "--chaos-demo", "--workload", "solve", "--quiet"],
    ["96", "32", "--numerics-demo", "--serve-demo", "--quiet"],
])
def test_cli_usage_exit_codes_equal_jax(argv):
    assert jmain(argv) == 1
    assert tmain(argv + ["--device", "cpu"]) == 1


def test_cli_serve_demo_runs_and_exits_zero(capsys):
    import json

    rc = tmain(["256", "64", "--serve-demo", "--serve-requests", "12",
                "--device", "cpu", "--quiet"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    rep = json.loads(out[-1])
    assert "stats" not in rep and rep["compiles_on_request_path"] == 0


# ---- refusals of later items ---------------------------------------------

@pytest.mark.parametrize("call,item", [
    (lambda s: s.invert(np.eye(8, dtype=np.float32), resident=True), "14b"),
    (lambda s: s.update(None, None, None), "14b"),
    (lambda s: s.submit_update(None, None, None), "14b"),
    (lambda s: s.project_capacity(shapes=[64]), "14b"),
    (lambda s: s.warmup(update_shapes=[(64, 8)]), "14b"),
    (lambda s: s.warmup(mesh_shapes=[(64, 8)]), "15"),
    (lambda s: s.executors.get_info(64, 2, workload="update", rhs=8), "14b"),
    (lambda s: s.executors.get_info(64, 2, mesh="p8"), "15"),
])
def test_later_items_are_refused_typed_on_the_service(call, item):
    with JordanService(batch_cap=2, device=CPU) as svc:
        with pytest.raises(UsageError, match=f"item {item}"):
            call(svc)


@pytest.mark.parametrize("kwargs,item", [
    ({"shared_handles": object()}, "14b"),
    ({"handle_budget_bytes": 1 << 20}, "14b"),
    ({"update_drift_budget_factor": 2.0}, "14b"),
    ({"mesh_shapes": ("2x4",)}, "15"),
    ({"lane_budget_bytes": 1 << 20}, "15"),
])
def test_later_options_are_refused_typed_at_construction(kwargs, item):
    with pytest.raises(UsageError, match=f"item {item}"):
        JordanService(device=CPU, **kwargs)


def test_serve_demo_workers_and_trace_numerics_are_refused():
    with pytest.raises(UsageError, match="item 15"):
        serve_demo(64, requests=2, device=CPU, workers=8)
    with pytest.raises(UsageError, match="solve-path mode"):
        JordanService(device=CPU, numerics="trace")


def test_complex_invert_lanes_are_refused_as_jax_refuses_them():
    with JordanService(dtype=torch.complex64, batch_cap=1,
                       device=CPU) as svc:
        with pytest.raises(UsageError, match="solve lanes"):
            svc.warmup(shapes=[32])


def test_default_device_is_the_card():
    from tpu_jordan_torch.errors import DeviceUnavailableError

    if torch.cuda.is_available():
        with JordanService(batch_cap=1) as svc:
            assert svc.device.type == "cuda"
    else:
        with pytest.raises(DeviceUnavailableError):
            JordanService()
