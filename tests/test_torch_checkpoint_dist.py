"""The port's distributed checkpoint/resume (``checkpointed_invert`` and
``checkpointed_solve`` with ``workers=p``, topology ``1d:p``) against its
own monolithic 1D engines and against the JAX package's runners on
``make_mesh(p)`` (its 8 virtual CPU devices).

  * Invert and solve segments [0, t1), [t1, Nr) give the bytes of the
    monolithic run (``parallel.invert_shards``, ``solve_system_rank``) on a
    world of the same p.
  * A seeded ``preempt`` raises at the same boundary, after the same fault
    calls, as in the JAX package; the resumed run gives the uninterrupted
    bytes.
  * A ``1d:p`` checkpoint written by either package is resumed by the
    other: the stored swap record is the other's pivot sequence, and the
    result lies within min(100·eps·κ∞, 1e-3) of the writer's own
    uninterrupted result (relative ∞-norm).
  * The refusals (lookahead, swapfree, grouped, SPD, complex, on p ranks
    and on a 2D mesh) are the JAX package's, typed.
"""

import numpy as np
import pytest
import torch

from tpu_jordan.parallel import make_mesh
from tpu_jordan.resilience import FaultPlan as JPlan
from tpu_jordan.resilience import FaultSpec as JSpec
from tpu_jordan.resilience import activate as jactivate
from tpu_jordan.resilience import checkpoint as jckpt

from tpu_jordan_torch.parallel import (gather_inverse_inplace,
                                       gather_solution_1d, invert_shards,
                                       run_calls, run_workers,
                                       scatter_rhs_1d,
                                       to_identity_padded_blocks)
from tpu_jordan_torch.parallel import layout as tl
from tpu_jordan_torch.parallel.dist_solve import (DistSolveSpec,
                                                  solve_system_rank)
from tpu_jordan_torch.resilience import (CheckpointStore,
                                         CheckpointUnsupportedError,
                                         FaultPlan, FaultSpec, PreemptedError,
                                         activate, checkpointed_invert,
                                         checkpointed_solve)

P, N, M, K = 2, 48, 8, 2          # Nr = 6: three block rows a rank


def _mat(n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + n * np.eye(n)).astype(dtype)


def _rhs(n, seed, k=K, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(dtype)


def _close(x, ref, a):
    kappa = (np.abs(a).sum(1).max()
             * np.abs(np.linalg.inv(a)).sum(1).max())
    tol = min(100 * np.finfo(a.dtype).eps * kappa, 1e-3)
    return np.abs(x - ref).sum(1).max() / np.abs(ref).sum(1).max() <= tol


_MONO = {}


def _monolithic():
    """The monolithic invert and solve of the module's fixtures, in one
    world of P ranks."""
    if _MONO:
        return _MONO
    a, b = _mat(N, 1), _rhs(N, 2)
    lay = tl.CyclicLayout.create(N, M, P)
    at = torch.from_numpy(a)
    shards = [to_identity_padded_blocks(at, lay, r).numpy()
              for r in range(P)]
    per_rank = [([(invert_shards, (shards, lay, "inplace", 0)),
                  (solve_system_rank,
                   (DistSolveSpec(N, M, "float64", "solve_sharded"),
                    shards[r], scatter_rhs_1d(b, lay, r).numpy()))],)
                for r in range(P)]
    res = run_workers(P, run_calls, per_rank=per_rank, deadline_s=300,
                      device_type="cpu")
    _MONO["inv"] = gather_inverse_inplace([r[0]["blocks"] for r in res],
                                          lay, N)
    _MONO["x"] = gather_solution_1d([r[1]["x_blocks"] for r in res], lay, N)
    _MONO["pivots"] = res[0][0]["pivots"]
    return _MONO


@pytest.mark.parametrize("workload", ["invert", "solve"])
def test_segments_give_the_monolithic_bits(tmp_path, workload):
    mono = _monolithic()
    a, b = _mat(N, 1), _rhs(N, 2)
    store = CheckpointStore(str(tmp_path))
    kw = dict(store=store, run_id=f"t:{workload}", cadence=4,
              engine="unrolled", workers=P, device="cpu")
    if workload == "invert":
        out, sing, info = checkpointed_invert(a, M, **kw)
        assert torch.equal(out, mono["inv"])
    else:
        out, sing, info = checkpointed_solve(a, b, M, **kw)
        assert torch.equal(out, mono["x"])
    assert not sing
    assert info["topology"] == f"1d:{P}" and info["Nr"] == 6
    assert info["segments_run"] == [(0, 4), (4, 6)]
    assert info["ckpt_written"] == 1
    assert store.ledger()["invariant_holds"]


def test_preempt_then_resume_gives_the_bits_and_jax_calls(tmp_path):
    mono = _monolithic()
    a, b = _mat(N, 1), _rhs(N, 2)
    store = CheckpointStore(str(tmp_path / "t"))
    plan = FaultPlan([FaultSpec("preempt", (3,), "permanent")])
    with activate(plan):
        with pytest.raises(PreemptedError) as ei:
            checkpointed_solve(a, b, M, store=store, run_id="t:p",
                               cadence=2, engine="fori", workers=P,
                               device="cpu")
    jplan = JPlan([JSpec("preempt", (3,), "permanent")])
    with jactivate(jplan):
        with pytest.raises(jckpt.PreemptedError) as ej:
            jckpt.checkpointed_solve(
                a, b, M, store=jckpt.CheckpointStore(str(tmp_path / "j")),
                run_id="t:p", cadence=2, engine="fori", mesh=make_mesh(P))
    assert ei.value.step == ej.value.step == 4
    assert plan.calls() == jplan.calls()
    x, sing, info = checkpointed_solve(a, b, M, store=store, run_id="t:p",
                                       cadence=2, engine="fori", workers=P,
                                       resume_from="t:p", device="cpu")
    assert not sing and torch.equal(x, mono["x"])
    assert info["resumed"] and info["start_step"] == 4
    assert info["segments_run"] == [(4, 6)]
    assert store.ledger()["invariant_holds"]


@pytest.mark.parametrize("workload", ["invert", "solve"])
def test_port_resumes_jax_checkpoint(tmp_path, workload):
    a, b = _mat(N, 3), _rhs(N, 4)
    jstore = jckpt.CheckpointStore(str(tmp_path))
    jkw = dict(store=jstore, run_id="x", cadence=2, engine="fori",
               mesh=make_mesh(P))
    jfn = (jckpt.checkpointed_invert if workload == "invert"
           else jckpt.checkpointed_solve)
    args = (a, M) if workload == "invert" else (a, b, M)
    ref, _, _ = jfn(*args, **dict(jkw, run_id="ref"))
    with jactivate(JPlan([JSpec("preempt", (2,), "permanent")])):
        with pytest.raises(jckpt.PreemptedError):
            jfn(*args, **jkw)
    _, step, stored = jstore.peek("x")
    assert step == 2 and stored["W"].shape == (6, M, N)
    fn = checkpointed_invert if workload == "invert" else checkpointed_solve
    store = CheckpointStore(str(tmp_path))
    out, sing, info = fn(*args, store=store, run_id="x", cadence=2,
                         engine="fori", workers=P, resume_from="x",
                         device="cpu")
    assert not sing and info["start_step"] == 2
    assert _close(out.numpy(), np.asarray(ref), a)
    assert store.ledger()["invariant_holds"]


def test_jax_resumes_port_checkpoint(tmp_path):
    mono = _monolithic()
    a = _mat(N, 1)
    store = CheckpointStore(str(tmp_path))
    with activate(FaultPlan([FaultSpec("preempt", (2,), "permanent")])):
        with pytest.raises(PreemptedError):
            checkpointed_invert(a, M, store=store, run_id="y", cadence=2,
                                engine="unrolled", workers=P, device="cpu")
    jstore = jckpt.CheckpointStore(str(tmp_path))
    key, step, stored = jstore.peek("y")
    assert key.topology == f"1d:{P}" and step == 2
    assert stored["swaps"].shape == (P, 6)
    for row in stored["swaps"]:
        assert row[:2].tolist() == mono["pivots"][:2]
    inv, sing, info = jckpt.checkpointed_invert(
        a, M, store=jstore, run_id="y", cadence=2, engine="unrolled",
        mesh=make_mesh(P), resume_from="y")
    assert not sing and info["start_step"] == 2
    assert _close(np.asarray(inv), mono["inv"].numpy(), a)
    assert jstore.ledger()["invariant_holds"]


@pytest.mark.parametrize("engine", ["lookahead", "swapfree", "grouped"])
def test_pipeline_engines_refused_as_in_jax(tmp_path, engine):
    a = _mat(32, 5)
    with pytest.raises(jckpt.CheckpointUnsupportedError) as ej:
        jckpt.checkpointed_invert(
            a, 8, store=jckpt.CheckpointStore(str(tmp_path / "j")),
            run_id="t", cadence=2, engine=engine, mesh=make_mesh(P))
    with pytest.raises(CheckpointUnsupportedError) as et:
        checkpointed_invert(a, 8, store=CheckpointStore(str(tmp_path)),
                            run_id="t", cadence=2, engine=engine, workers=P,
                            device="cpu")
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("case", ["spd", "complex"])
def test_spd_and_complex_refused_as_in_jax(tmp_path, case):
    a, b = _mat(32, 6), _rhs(32, 7)
    kw = {"spd": True} if case == "spd" else {}
    if case == "complex":
        a, b = a.astype(np.complex64), b.astype(np.complex64)
    with pytest.raises(jckpt.CheckpointUnsupportedError) as ej:
        jckpt.checkpointed_solve(
            a, b, 8, store=jckpt.CheckpointStore(str(tmp_path / "j")),
            run_id="t", cadence=2, engine="fori", mesh=make_mesh(P), **kw)
    with pytest.raises(CheckpointUnsupportedError) as et:
        checkpointed_solve(a, b, 8, store=CheckpointStore(str(tmp_path)),
                           run_id="t", cadence=2, engine="fori", workers=P,
                           device="cpu", **kw)
    assert str(et.value) == str(ej.value)


def test_mesh_is_an_alias_and_2d_is_item_15c(tmp_path):
    # The 2D runner is ported (item 15c); a (2, 2) mesh keeps the JAX
    # package's refusal of the pipeline engines, typed, before any world.
    store = CheckpointStore(str(tmp_path))
    with pytest.raises(CheckpointUnsupportedError,
                       match="not checkpointable on distributed"):
        checkpointed_invert(_mat(32, 8), 8, store=store, run_id="t",
                            cadence=2, engine="grouped", mesh=(2, 2),
                            device="cpu")
    inv, sing, info = checkpointed_invert(
        _mat(N, 1), M, store=store, run_id="t:m", cadence=4,
        engine="unrolled", mesh=P, device="cpu")
    assert info["topology"] == f"1d:{P}"
    assert torch.equal(inv, _monolithic()["inv"])
