"""The port's update lanes, resident handles and capacity budget on the
serving path, against the JAX package's, on the CPU.

The same seeded numpy stream (a resident invert, then six rank-k updates: two
plain, one rank-destroying, one plain, one through a service with a zero
drift budget, one plain) goes through ``tpu_jordan.serve.JordanService`` and
``tpu_jordan_torch.serve.JordanService(device="cpu")`` with the same
arguments, in fp64 and fp32, at (n, m, rank) = (48, 8, 4), (64, 16, 8) and
(100, 16, 6) (buckets 64, 64, 128).  The per-update outcome sequences and
versions are equal; κ∞ agrees within 16·eps·n·κ∞ (and to rtol 1e-6 in
fp64); rel_residual and drift, rounding noise that the two packages'
product orders make differ by up to ~2× (ROADMAP.md Queue C), are
held under the gate and the drift budget on both sides; the final resident
inverses agree within 16·eps·n·κ∞ (relative ∞-norm; 16 is the gate's
constant).

The rank-destroying update makes the capacitance I + VᵀA⁻¹U exactly
singular in floating point (u₀ = −e_j / X[0, j] of the committed inverse X,
v₀ = e₀, with fl(X[0, j]·(1/X[0, j])) = 1), so both packages flag it
wherever their products round.  The JAX demo's own recipe (zero column 0 of
the committed A) leaves a capacitance that is singular only to eps·κ, and
at the gaussian fixtures both packages' verdicts sit on a knife edge
(ROADMAP.md Queue C); it is held here on ``rand`` fixtures, where
its residual fails the gate by a wide margin, and at the one gaussian
fixture where both packages commit it.  A sound update that raises κ∞
a thousandfold is ``refreshed`` in both packages.

The rest is pinned on the port alone: a gated update and an expired
deadline leave the handle's bits and version untouched, an unknown handle
fails typed and never trips the breaker, a zero drift budget walks the
re_invert rung through the warm invert lane, the batched lane at cap 4
equals the cap-1 lane element by element, a mixed rider is refused typed,
``project_capacity`` gives the JAX byte numbers before any build, the
budgeted service evicts and refuses at submit, and ``capacity_demo`` passes
``tools/check_capacity.py`` and agrees with the JAX demo.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_jordan import serve as jserve
from tpu_jordan.__main__ import main as jmain
from tpu_jordan.serve.executors import ExecutorStore as JExecutorStore

from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.errors import SingularMatrixError, UsageError
from tpu_jordan_torch.linalg import drift_budget
from tpu_jordan_torch.obs.capacity import capacity_demo
from tpu_jordan_torch.obs.metrics import REGISTRY
from tpu_jordan_torch.obs.recorder import RECORDER
from tpu_jordan_torch.ops import generate
from tpu_jordan_torch.resilience import (DEFAULT_POLICY,
                                         CapacityExceededError,
                                         DeadlineExceededError,
                                         gate_threshold)
from tpu_jordan_torch.serve import (ExecutorStore, HandleRef, HandleState,
                                    HandleStore, JordanService,
                                    MixedUpdateBatchError,
                                    UnknownHandleError,
                                    resident_handle_bytes)

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent

#: The stream's plan: A = the default service, B = the zero-drift-budget
#: service (both share one executor store and one handle store), S = the
#: rank-destroying update through A.
PLAN = ("A", "A", "S", "A", "B", "A")
WANT = ("refreshed", "refreshed", "gated", "refreshed", "re_inverted",
        "refreshed")
PARITY_CASES = ((48, 8, 4), (64, 16, 8), (100, 16, 6))


def _factors(rng, n, k, dtype, count=1):
    s = 1.0 / np.sqrt(float(n) * k)
    return [(rng.standard_normal((n, k)).astype(dtype) * s,
             rng.standard_normal((n, k)).astype(dtype) * s)
            for _ in range(count)]


def _exact_singular_factors(inv, n, k, dtype):
    """Rank-k factors whose capacitance I + VᵀX·U is singular in floating
    point: U = −e_j/X[0, j] in column 0, V = e₀, for the first j where
    X[0, j]·(1/X[0, j]) rounds to 1 (one product, rounded once, in any
    GEMM)."""
    row = np.asarray(inv, dtype)[0, :n]
    for j, x in enumerate(row):
        c = dtype(1) / x
        if x != 0 and dtype(c * x) == dtype(1):
            break
    u = np.zeros((n, k), dtype)
    v = np.zeros((n, k), dtype)
    u[j, 0] = -c
    v[0, 0] = 1
    return u, v


def _zero_column_factors(a_committed, n, k, dtype):
    """The JAX update demo's rank-destroying recipe
    (``tpu_jordan/serve/update_demo.py::_singular_factors``): zero column 0
    of the committed matrix."""
    u = np.zeros((n, k), dtype)
    v = np.zeros((n, k), dtype)
    u[:, 0] = -np.asarray(a_committed, dtype)[:n, 0]
    v[0, 0] = 1
    return u, v


def _run_stream(pkg, n, m, k, dtype, seed=7):
    """The PLAN stream through one package; returns (per-update rows, the
    final resident inverse, the final resident matrix), all numpy."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(dtype)
    ups = _factors(rng, n, k, dtype, len(PLAN))
    if pkg == "jax":
        hs = jserve.HandleStore()
        kw = dict(dtype=dtype, shared_executors=JExecutorStore(),
                  shared_handles=hs)
        make = jserve.JordanService

        def state(hid):
            st = hs.get(hid)
            return np.asarray(st.a), np.asarray(st.inverse)
    else:
        hs = HandleStore()
        kw = dict(dtype=getattr(torch, np.dtype(dtype).name),
                  shared_executors=ExecutorStore(), shared_handles=hs,
                  device=CPU)
        make = JordanService

        def state(hid):
            st = hs.get(hid)
            return st.a.numpy(), st.inverse.numpy()
    svc_a = make(batch_cap=1, max_wait_ms=0.5, block_size=m, **kw)
    svc_b = make(batch_cap=1, max_wait_ms=0.5, block_size=m,
                 update_drift_budget_factor=0.0, **kw)
    rows = []
    try:
        for svc in (svc_a, svc_b):
            svc.warmup(update_shapes=[(n, k)])
        ref = svc_a.invert(a, resident=True, handle_id="p", timeout=120)
        for who, (u, v) in zip(PLAN, ups):
            if who == "S":
                u, v = _exact_singular_factors(state("p")[1], n, k, dtype)
            svc = svc_b if who == "B" else svc_a
            r = svc.submit_update(ref, u, v).result(120)
            rows.append({"outcome": r.update_outcome,
                         "version": r.handle_version,
                         "singular": bool(r.singular),
                         "kappa": float(r.kappa),
                         "rel": float(r.rel_residual),
                         "drift": float(r.drift)})
    finally:
        svc_a.close()
        svc_b.close()
    a_fin, inv_fin = state("p")
    return rows, inv_fin[:n, :n], a_fin[:n, :n]


def _kappa(a):
    a = np.asarray(a, np.float64)
    return np.linalg.norm(a, np.inf) * np.linalg.norm(np.linalg.inv(a),
                                                      np.inf)


@pytest.mark.parametrize("n,m,k", PARITY_CASES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_update_stream_matches_jax(n, m, k, dtype):
    jrows, jinv, ja = _run_stream("jax", n, m, k, dtype)
    trows, tinv, ta = _run_stream("torch", n, m, k, dtype)
    eps = float(np.finfo(dtype).eps)
    assert [r["outcome"] for r in trows] == list(WANT)
    assert [r["outcome"] for r in trows] == [r["outcome"] for r in jrows]
    assert [r["version"] for r in trows] == [r["version"] for r in jrows]
    assert [r["singular"] for r in trows] == [r["singular"] for r in jrows]
    tdt = getattr(torch, np.dtype(dtype).name)
    for j, t, who in zip(jrows, trows, PLAN):
        if t["singular"]:
            continue
        tol = 16 * eps * n * t["kappa"]
        assert abs(t["kappa"] - j["kappa"]) <= tol * j["kappa"]
        if dtype == np.float64:
            assert t["kappa"] == pytest.approx(j["kappa"], rel=1e-6)
        gate = gate_threshold(DEFAULT_POLICY, n, t["kappa"], tdt)
        for row in (j, t):
            assert row["rel"] < gate
            budget = drift_budget(gate, 0.0 if who == "B" else None)
            assert row["drift"] <= budget
    # The final resident pairs: the same matrix, inverses within the
    # eps·n·κ scaling.
    np.testing.assert_allclose(ta, ja, rtol=0, atol=64 * eps * np.abs(ja).max())
    kappa = _kappa(ja)
    diff = np.linalg.norm(tinv - jinv, np.inf) / np.linalg.norm(jinv, np.inf)
    assert diff <= 16 * eps * n * kappa


# ---- the update lane on the port alone -----------------------------------

@pytest.fixture
def svc64():
    """A warmed cap-1 fp64 service for n = 64 rank-4 updates."""
    with JordanService(dtype=torch.float64, batch_cap=1, max_wait_ms=0.5,
                       block_size=16, device=CPU) as svc:
        svc.warmup(update_shapes=[(64, 4)])
        yield svc


def _rand(n, dtype=torch.float64, offset=0):
    return generate("rand", (n, n), dtype, row_offset=offset, device=CPU)


@pytest.mark.parametrize("recipe", ["exact_capacitance", "zero_column"])
def test_singular_update_is_gated_and_leaves_the_handle_untouched(
        svc64, recipe):
    n, k = 64, 4
    ref = svc64.invert(_rand(n), resident=True, timeout=60)
    st = svc64.handles.get(ref.handle_id)
    a0, inv0 = st.a, st.inverse
    if recipe == "zero_column":
        u, v = _zero_column_factors(st.a.numpy(), n, k, np.float64)
    else:
        u, v = _exact_singular_factors(st.inverse.numpy(), n, k,
                                       np.float64)
    res = svc64.submit_update(ref, u, v).result(60)
    assert res.singular and res.update_outcome == "gated"
    assert res.inverse is None and res.handle_version == 0
    st = svc64.handles.get(ref.handle_id)
    assert st.version == 0 and st.a is a0 and st.inverse is inv0
    assert torch.equal(st.a, a0) and torch.equal(st.inverse, inv0)
    with pytest.raises(SingularMatrixError):
        svc64.update(ref, u, v, timeout=60)
    assert svc64.handles.get(ref.handle_id).version == 0
    (u2, v2), = _factors(np.random.default_rng(1), n, k, np.float64)
    ok = svc64.update(ref, u2, v2, timeout=60)
    assert ok.update_outcome == "refreshed" and ok.handle_version == 1
    want = np.linalg.inv(_rand(n).numpy() + u2 @ v2.T)
    assert np.abs(ok.inverse.numpy() - want).max() < 1e-9


def _one_update(pkg, a, u, v, m):
    """A resident invert of ``a``, then one update by (u, v), through one
    package's cap-1 service; returns (committed κ∞, the update's row)."""
    dtype = a.dtype.type
    if pkg == "jax":
        svc = jserve.JordanService(dtype=dtype, batch_cap=1,
                                   max_wait_ms=0.5, block_size=m)
    else:
        svc = JordanService(dtype=getattr(torch, a.dtype.name), batch_cap=1,
                            max_wait_ms=0.5, block_size=m, device=CPU)
    with svc:
        svc.warmup(update_shapes=[(a.shape[0], u.shape[1])])
        ref = svc.invert(a, resident=True, timeout=120)
        kappa0 = float(svc.handles.get(ref.handle_id).kappa)
        r = svc.submit_update(ref, u, v).result(120)
    return kappa0, {"outcome": r.update_outcome,
                    "version": r.handle_version,
                    "singular": bool(r.singular),
                    "kappa": float(r.kappa),
                    "rel": float(r.rel_residual)}


@pytest.mark.parametrize("n,m", [(48, 8), (100, 16)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kappa_raising_update_is_refreshed_as_in_jax(n, m, dtype):
    """A sound rank-1 update (zero-padded to rank 4) that shrinks the
    smallest singular value of a gaussian A a thousandfold: κ∞ grows by
    100× or more and the SMW residual with it (500–850× here), yet the
    mutated matrix passes the gate at its κ∞, so both packages refresh the
    handle."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((n, n))
    left, sigma, right = np.linalg.svd(a)
    u = np.zeros((n, 4))
    v = np.zeros((n, 4))
    u[:, 0] = -(1 - 1 / 1000) * sigma[-1] * left[:, -1]
    v[:, 0] = right[-1]
    a, u, v = (x.astype(dtype) for x in (a, u, v))
    jk0, jrow = _one_update("jax", a, u, v, m)
    tk0, trow = _one_update("torch", a, u, v, m)
    assert trow["outcome"] == jrow["outcome"] == "refreshed"
    assert trow["version"] == jrow["version"] == 1
    assert not trow["singular"] and not jrow["singular"]
    tdt = getattr(torch, np.dtype(dtype).name)
    for k0, row in ((jk0, jrow), (tk0, trow)):
        assert row["kappa"] >= 100 * k0
        assert row["rel"] < gate_threshold(DEFAULT_POLICY, n, row["kappa"],
                                           tdt)


def test_zero_column_update_outcome_matches_jax():
    """The JAX demo's zero-column recipe at gaussian (48, 8, 4) fp64,
    seed 7: the capacitance probe does not flag it and its rel_residual
    passes the gate's 0.5 cap, so both packages commit it (the recipe's
    fault, ROADMAP.md Queue C); the port keeps the JAX contract."""
    n, k = 48, 4
    a = np.random.default_rng(7).standard_normal((n, n))
    u, v = _zero_column_factors(a, n, k, np.float64)
    _, jrow = _one_update("jax", a, u, v, 8)
    _, trow = _one_update("torch", a, u, v, 8)
    assert trow["outcome"] == jrow["outcome"]
    assert trow["version"] == jrow["version"]
    assert trow["singular"] == jrow["singular"]


def test_expired_deadline_leaves_the_handle_untouched(svc64):
    n = 64
    ref = svc64.invert(_rand(n), resident=True, timeout=60)
    st = svc64.handles.get(ref.handle_id)
    a0, inv0 = st.a, st.inverse
    (u, v), = _factors(np.random.default_rng(2), n, 4, np.float64)
    fut = svc64.submit_update(ref, u, v, deadline_ms=0.0)
    with pytest.raises(DeadlineExceededError):
        fut.result(60)
    st = svc64.handles.get(ref.handle_id)
    assert st.version == 0 and st.a is a0 and st.inverse is inv0


def test_unknown_handle_fails_typed_and_never_trips_the_breaker(svc64):
    n = 64
    ref = svc64.invert(_rand(n), resident=True, timeout=60)
    ghost = HandleRef("ghost", n, ref.bucket_n, "float64")
    (u, v), = _factors(np.random.default_rng(3), n, 4, np.float64)
    for _ in range(5):               # more than the breaker's K = 3
        with pytest.raises(UnknownHandleError):
            svc64.submit_update(ghost, u, v).result(60)
    ok = svc64.update(ref, u, v, timeout=60)
    assert ok.update_outcome == "refreshed"
    assert all(s != "open" for s in svc64.stats()["breakers"].values())
    with pytest.raises(ValueError, match="HandleRef"):
        svc64.submit_update("p", u, v)
    with pytest.raises(ValueError, match="matching"):
        svc64.submit_update(ref, u, v[:, :2])


@pytest.mark.parametrize("numerics", ["off", "summary"])
def test_zero_drift_budget_re_inverts_through_the_warm_lane(numerics):
    n, k = 64, 4
    rungs = REGISTRY.counter("tpu_jordan_torch_recovery_rungs_total")
    before = rungs.total()
    mark = RECORDER.total
    (u, v), = _factors(np.random.default_rng(4), n, k, np.float64)
    with JordanService(dtype=torch.float64, batch_cap=2, max_wait_ms=0.5,
                       update_drift_budget_factor=0.0, numerics=numerics,
                       device=CPU) as svc:
        svc.warmup(update_shapes=[(n, k)])
        warm = svc.stats()["totals"]["compiles"]
        ref = svc.invert(_rand(n), resident=True, timeout=60)
        res = svc.update(ref, u, v, timeout=60)
        stats = svc.stats()
    assert res.update_outcome == "re_inverted" and res.drift == 0.0
    assert stats["totals"]["compiles"] == warm
    assert stats["measurements"] == 0
    assert stats["handles"][ref.handle_id]["reinverts"] == 1
    assert rungs.total() == before + 1
    want = np.linalg.inv(_rand(n).numpy() + u @ v.T)
    assert np.abs(res.inverse.numpy() - want).max() < 1e-9
    events = RECORDER.since(mark)
    rung_seq = [e["seq"] for e in events if e["kind"] == "recovery_rung"]
    assert rung_seq
    if numerics == "summary":
        # The drift breadcrumb precedes the rung it explains.
        spikes = [e["seq"] for e in events if e["kind"] == "numerics_spike"
                  and e.get("signal") == "drift"]
        assert spikes and min(spikes) < min(rung_seq)


@pytest.mark.parametrize("targets,group,batches", [
    ((0, 1, 2, 3, 0), 4, 2),     # 4 distinct in one launch, then 1 alone
    ((0, 1, 2, 0), 3, 1),        # 3 distinct in one launch + a follower
])
def test_batched_lane_equals_the_cap1_lane_element_by_element(
        targets, group, batches):
    """Distinct handles of one batch ride one launch of the cap-4 lane; a
    second update of a handle follows in order and sees the committed
    state.  Each result equals the cap-1 lane's on the same states."""
    n, k = 48, 6
    rng = np.random.default_rng(5)
    mats = [rng.standard_normal((n, n)) for _ in range(4)]
    ups = _factors(rng, n, k, np.float64, len(targets))

    def run(cap):
        with JordanService(dtype=torch.float64, batch_cap=cap,
                           max_wait_ms=50.0, device=CPU,
                           autostart=False) as svc:
            svc.warmup(update_shapes=[(n, k)])
            svc.start()
            refs = [svc.invert(a, resident=True, handle_id=f"e{i}",
                               timeout=60) for i, a in enumerate(mats)]
            svc.close()
        store = svc.handles
        with JordanService(dtype=torch.float64, batch_cap=cap,
                           max_wait_ms=50.0, device=CPU, autostart=False,
                           shared_handles=store) as svc:
            svc.warmup(update_shapes=[(n, k)])
            futs = [svc.submit_update(refs[t], u, v)
                    for t, (u, v) in zip(targets, ups)]
            svc.start()
            out = [f.result(60) for f in futs]
            stats = svc.stats()
            batched = [e for e in RECORDER.since(mark)
                       if e["kind"] == "journey"
                       and e.get("event") == "executor"
                       and e.get("batched")]
        return out, stats, batched

    mark = RECORDER.total
    one, _, none = run(1)
    mark = RECORDER.total
    four, stats, batched = run(4)
    assert not none
    assert len(batched) == group and {e["batched"] for e in batched} == {
        group}
    lane = stats["buckets"]["update:64:k8"]
    assert lane["batches"] == batches and lane["requests"] == len(targets)
    for x, y in zip(one, four):
        assert (x.update_outcome, x.handle_version, x.singular) == (
            y.update_outcome, y.handle_version, y.singular)
        assert x.kappa == pytest.approx(y.kappa, rel=1e-9)
        ref = x.inverse.numpy()
        kappa = _kappa(ref)
        diff = (np.linalg.norm(y.inverse.numpy() - ref, np.inf)
                / np.linalg.norm(ref, np.inf))
        assert diff <= 16 * np.finfo(np.float64).eps * n * kappa
    # The follower saw the first update's commit.
    assert four[-1].handle_version == 2
    want = np.linalg.inv(mats[0] + ups[0][0] @ ups[0][1].T
                         + ups[-1][0] @ ups[-1][1].T)
    assert np.abs(four[-1].inverse.numpy() - want).max() < 1e-9


def test_a_filler_slot_never_touches_a_real_element():
    """A partial batch (2 riders at cap 4) pads with identity fillers; the
    real elements' flags and residuals are their own."""
    from tpu_jordan_torch.linalg import (smw_update_batched_with_metrics,
                                         smw_update_with_metrics)

    n, N, K = 40, 64, 8
    rng = np.random.default_rng(6)
    a = torch.eye(N, dtype=torch.float64).repeat(4, 1, 1)
    u = torch.zeros((4, N, K), dtype=torch.float64)
    v = torch.zeros_like(u)
    for i in range(2):
        a[i, :n, :n] = torch.from_numpy(rng.standard_normal((n, n)))
        u[i, :n] = torch.from_numpy(rng.standard_normal((n, K)) * 0.05)
        v[i, :n] = torch.from_numpy(rng.standard_normal((n, K)) * 0.05)
    inv = torch.linalg.inv(a)
    n_real = torch.tensor([n, n, 0, 0])
    a_new, inv_new, sing, kappa, rel = smw_update_batched_with_metrics(
        a, inv, u, v, n_real)
    assert not sing.any()
    assert torch.equal(inv_new[2], torch.eye(N, dtype=torch.float64))
    assert kappa[2] == 0 and rel[2] == 0
    for i in range(2):
        one = smw_update_with_metrics(a[i], inv[i], u[i], v[i],
                                      n_real=torch.tensor([n]))
        assert bool(one[2]) == bool(sing[i])
        assert float(one[3]) == pytest.approx(float(kappa[i]), rel=1e-9)
        torch.testing.assert_close(inv_new[i], one[1], rtol=0, atol=1e-9)


def test_mixed_riders_are_refused_typed(svc64):
    from tpu_jordan_torch.serve.batcher import MicroBatcher

    n = 64
    ref = svc64.invert(_rand(n), resident=True, timeout=60)
    batcher: MicroBatcher = svc64._batcher
    good = torch.zeros((64, 8), dtype=torch.float64)
    fut = batcher.submit(None, n, 64, workload="update", rhs=8, k=4,
                         handle=ref, padded_u=good.float(),
                         padded_v=good.float())
    with pytest.raises(MixedUpdateBatchError):
        fut.result(60)
    fut = batcher.submit(None, n, 64, workload="update", rhs=8, k=4,
                         handle=ref, padded_u=good[:, :4],
                         padded_v=good[:, :4])
    with pytest.raises(MixedUpdateBatchError):
        fut.result(60)
    assert svc64.handles.get(ref.handle_id).version == 0


def test_complex_update_through_the_lane():
    """A complex64 handle (installed from an augmented-engine inverse: the
    invert lanes are real, as in the JAX package) updates through the
    lane's complex capacitance solve."""
    from tpu_jordan_torch.ops import block_jordan_invert

    n, k = 32, 4
    a = generate("crand", (n, n), torch.complex64, device=CPU)
    inv, sing = block_jordan_invert(a, block_size=8, global_scale=True)
    assert not bool(sing)
    store = HandleStore()
    eye = torch.eye(64, dtype=torch.complex64)
    a_pad, inv_pad = eye.clone(), eye.clone()
    a_pad[:n, :n], inv_pad[:n, :n] = a, inv
    ref = store.create(HandleState("c", n, 64, "complex64", a_pad, inv_pad))
    rng = np.random.default_rng(8)
    u = ((rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k)))
         * 0.05).astype(np.complex64)
    v = ((rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k)))
         * 0.05).astype(np.complex64)
    with JordanService(dtype=torch.complex64, batch_cap=1, device=CPU,
                       shared_handles=store) as svc:
        res = svc.update(ref, u, v, timeout=60)
    assert res.update_outcome == "refreshed" and res.handle_version == 1
    want = np.linalg.inv(a.numpy().astype(np.complex128) + u @ v.T)
    assert (np.abs(res.inverse.numpy() - want).max()
            / np.abs(want).max()) < 1e-4


def test_project_capacity_equals_jax_before_any_build():
    compiles = REGISTRY.counter("tpu_jordan_torch_compiles_total")
    c0 = compiles.total()
    shapes = dict(shapes=[48, 200], solve_shapes=[(48, 3)],
                  update_shapes=[(48, 8), (100, 20)])
    with JordanService(batch_cap=4, max_wait_ms=0.5, autostart=False,
                       device=CPU) as svc:
        mine = svc.project_capacity(**shapes)
    with jserve.JordanService(batch_cap=4, max_wait_ms=0.5,
                              autostart=False) as jsvc:
        ref = jsvc.project_capacity(**shapes)
    assert mine == ref
    assert list(mine) == list(ref)
    assert compiles.total() == c0
    g = REGISTRY.gauge("tpu_jordan_torch_capacity_projected_lane_bytes")
    assert g.value(lane="update:64:b1:k8") == mine["update:64:b1:k8"]
    with JordanService(batch_cap=1, autostart=False, device=CPU) as svc:
        assert set(svc.project_capacity(update_shapes=[(48, 8)])) == {
            "invert:64:b1", "update:64:b1:k8"}


class TestBudgetedService:
    @pytest.fixture(scope="class")
    def warm(self):
        per = resident_handle_bytes(64, torch.float32)
        svc = JordanService(batch_cap=1, max_wait_ms=0.5,
                            handle_budget_bytes=2 * per, device=CPU)
        svc.warmup(update_shapes=[(48, 8)])
        yield svc, per
        svc.close()

    @pytest.fixture
    def budgeted(self, warm):
        svc, per = warm
        yield svc, per
        for hid in svc.handles.ids():
            svc.handles.unpin(hid)
            svc.handles.evict(hid)

    def test_round_trip_under_the_budget_builds_nothing(self, budgeted):
        svc, per = budgeted
        rng = np.random.default_rng(9)
        compiles = REGISTRY.counter("tpu_jordan_torch_compiles_total")
        meas = REGISTRY.counter("tpu_jordan_torch_tuner_measurements_total")
        c0, m0 = compiles.total(), meas.total()
        mats = [rng.standard_normal((48, 48)).astype(np.float32)
                for _ in range(4)]
        r1 = svc.invert(mats[0], resident=True, handle_id="c1", timeout=60)
        svc.invert(mats[1], resident=True, handle_id="c2", timeout=60)
        (u, v), = _factors(rng, 48, 4, np.float32)
        assert svc.update(r1, u, v, timeout=60).update_outcome == "refreshed"
        svc.invert(mats[2], resident=True, handle_id="c3", timeout=60)
        assert svc.handles.ids() == ["c1", "c3"]     # c2 was the LRU
        svc.handles.pin("c1")
        svc.handles.pin("c3")
        with pytest.raises(CapacityExceededError):
            svc.invert(mats[3], resident=True, handle_id="c4", timeout=60)
        assert compiles.total() == c0 and meas.total() == m0
        snap = svc.stats()
        assert snap["handle_budget"]["max_bytes"] == 2 * per
        assert snap["handle_budget"]["budget_evictions"] >= 1
        assert snap["handle_budget"]["refusals"] >= 1
        assert snap["handles"]["c1"]["version"] == 1

    def test_refused_invert_is_never_submitted(self, budgeted):
        svc, _ = budgeted
        rng = np.random.default_rng(10)
        for hid in ("r1", "r2"):
            svc.invert(rng.standard_normal((48, 48)), resident=True,
                       handle_id=hid, timeout=60)
            svc.handles.pin(hid)
        req = REGISTRY.counter("tpu_jordan_torch_serve_requests_total")
        r0 = req.total()
        with pytest.raises(CapacityExceededError):
            svc.invert(rng.standard_normal((48, 48)), resident=True,
                       handle_id="r3", timeout=60)
        assert req.total() == r0
        assert svc.journey.contexts()[-1].outcome() == (
            "error", "CapacityExceededError")

    def test_budget_eviction_is_a_journey_hop(self, budgeted):
        svc, _ = budgeted
        rng = np.random.default_rng(11)
        for hid in ("j1", "j2"):
            svc.invert(rng.standard_normal((48, 48)), resident=True,
                       handle_id=hid, timeout=60)
        mark = RECORDER.total
        svc.invert(rng.standard_normal((48, 48)), resident=True,
                   handle_id="j3", timeout=60)
        events = RECORDER.since(mark)
        hops = [e for e in events if e["kind"] == "journey"
                and e.get("event") == "capacity_evict"]
        assert len(hops) == 1 and hops[0]["handle"] == "j1"
        assert hops[0]["cause"] == "budget"
        evs = [e for e in events if e["kind"] == "capacity_eviction"]
        assert len(evs) == 1 and evs[0]["cause"] == "budget"


def test_shared_store_plus_budget_is_refused_typed():
    with pytest.raises(UsageError, match="shared store"):
        JordanService(shared_handles=HandleStore(),
                      handle_budget_bytes=1024, autostart=False, device=CPU)


# ---- the capacity demo ----------------------------------------------------

@pytest.fixture(scope="module")
def demo_reports():
    from tpu_jordan.obs.capacity import capacity_demo as jcapacity_demo

    return capacity_demo(n=48, device=CPU), jcapacity_demo(n=48)


def test_capacity_demo_passes_its_checker(demo_reports, tmp_path):
    rep, _ = demo_reports
    path = tmp_path / "cap.json"
    path.write_text(json.dumps(rep))
    out = subprocess.run([sys.executable,
                          str(ROOT / "tools" / "check_capacity.py"),
                          str(path)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")
    assert rep["compiles_on_capacity_path"] == 0 and not rep[
        "silent_capacity"]


def test_capacity_demo_agrees_with_jax(demo_reports):
    rep, jrep = demo_reports
    for key in ("budget_evictions", "handles_alive",
                "update_after_evict_typed", "typed_overflow", "handle_bytes",
                "budget_bytes", "projected_lanes", "journey_evict_hops",
                "measurements"):
        assert rep[key] == jrep[key], key
    assert ([(e["handle_id"], e["cause"], e["nbytes"])
             for e in rep["evictions"]]
            == [(e["handle_id"], e["cause"], e["nbytes"])
                for e in jrep["evictions"]])


def test_cli_capacity_demo_exits_zero_and_checks(capsys):
    assert tmain(["48", "8", "--capacity-demo", "--quiet",
                  "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = subprocess.run([sys.executable,
                          str(ROOT / "tools" / "check_capacity.py"), "-"],
                         input=line, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "handles" not in json.loads(line)


@pytest.mark.parametrize("extra", [
    ["--fleet-demo"], ["--workers", "8"], ["--workload", "solve"],
    ["--numerics", "summary"], ["--batch-cap", "4"], ["--replicas", "2"],
    ["--plan-cache", "/tmp/p.json"], ["--slo-report"], ["--serve-demo"],
    ["--batch", "2"], ["--tune"],
])
def test_cli_capacity_flag_contract_exit_1(extra):
    argv = ["96", "32", "--capacity-demo", "--quiet"] + extra
    assert jmain(argv) == 1
    assert tmain(argv + ["--device", "cpu"]) == 1
