"""The port's 2D checkpoint/resume (``checkpointed_invert`` and
``checkpointed_solve`` with ``workers=(pr, pc)`` or ``mesh=(pr, pc)``,
topology ``2d:prxpc``) against its own monolithic 2D engines and against
the JAX package's runners on ``make_mesh_2d`` (its virtual CPU devices).

  * Invert and solve segments [0, t1), [t1, Nr) give the bytes of the
    monolithic run (``invert_shards_2d``, ``solve_system_rank``) on a
    world of the same mesh.
  * A seeded ``preempt`` raises at the same boundary, after the same fault
    calls, as in the JAX package; the resumed run gives the uninterrupted
    bytes.
  * A ``2d:2x2`` invert checkpoint written by either package is resumed by
    the other (W in 2D-cyclic storage order on both axes, ``singular``
    (2, 2), ``swaps`` (2, 2, Nr)): the stored swap record is the other's
    pivot sequence, and the result lies within min(100·eps·κ∞, 1e-3) of
    the writer's own uninterrupted result.  A port solve checkpoint loads
    in the JAX store with the JAX 2D solve format (X (Nr, m, k) in
    row-cyclic order); the JAX 2D solve segments do not compile under this
    JAX (ROADMAP.md Queue C), so only the port resumes one.
  * The refusals (lookahead, swapfree, grouped) are the JAX package's,
    typed.
"""

import numpy as np
import pytest
import torch

from tpu_jordan.parallel import make_mesh_2d
from tpu_jordan.resilience import FaultPlan as JPlan
from tpu_jordan.resilience import FaultSpec as JSpec
from tpu_jordan.resilience import activate as jactivate
from tpu_jordan.resilience import checkpoint as jckpt

from tpu_jordan_torch.parallel import jordan2d as tj2
from tpu_jordan_torch.parallel import jordan2d_inplace as tji
from tpu_jordan_torch.parallel import run_calls, run_workers
from tpu_jordan_torch.parallel.dist_solve import (DistSolveSpec,
                                                  solve_system_rank)
from tpu_jordan_torch.parallel.layout import CyclicLayout2D
from tpu_jordan_torch.resilience import (CheckpointStore,
                                         CheckpointUnsupportedError,
                                         FaultPlan, FaultSpec, PreemptedError,
                                         activate, checkpointed_invert,
                                         checkpointed_solve)

MESH, N, M, K = (2, 2), 48, 8, 2          # Nr = 6
TOPO = "2d:2x2"


def _mat(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + n * np.eye(n)


def _rhs(n, seed, k=K):
    return np.random.default_rng(seed).standard_normal((n, k))


def _close(x, ref, a):
    kappa = (np.abs(a).sum(1).max()
             * np.abs(np.linalg.inv(a)).sum(1).max())
    tol = min(100 * np.finfo(a.dtype).eps * kappa, 1e-3)
    return np.abs(x - ref).sum(1).max() / np.abs(ref).sum(1).max() <= tol


_MONO = {}


def _monolithic():
    """The monolithic 2D invert and solve of the module's fixtures, in one
    world of 4 ranks."""
    if _MONO:
        return _MONO
    a, b = _mat(N, 1), _rhs(N, 2)
    lay = CyclicLayout2D.create(N, M, *MESH)
    shards = [tj2.scatter_matrix_2d(a, lay, *divmod(r, MESH[1])).numpy()
              for r in range(4)]
    per_rank = [([(tji.invert_shards_2d, (shards, MESH, N, M)),
                  (solve_system_rank,
                   (DistSolveSpec(N, M, "float64", "solve_sharded",
                                  mesh=MESH), shards[r],
                    tji.scatter_rhs_2d(b, lay, r // MESH[1]).numpy()))],)
                for r in range(4)]
    res = run_workers(4, run_calls, per_rank=per_rank, deadline_s=300,
                      device_type="cpu")
    _MONO["inv"] = tji.gather_inverse_inplace_2d([r[0]["blocks"]
                                                  for r in res], lay, N)
    _MONO["x"] = tji.gather_solution_2d([r[1]["x_blocks"] for r in res],
                                        lay, N)
    _MONO["pivots"] = res[0][0]["pivots"]
    return _MONO


@pytest.mark.parametrize("workload", ["invert", "solve"])
def test_segments_give_the_monolithic_bits(tmp_path, workload):
    mono = _monolithic()
    a, b = _mat(N, 1), _rhs(N, 2)
    store = CheckpointStore(str(tmp_path))
    kw = dict(store=store, run_id=f"t:{workload}", cadence=4,
              engine="unrolled", workers=MESH, device="cpu")
    if workload == "invert":
        out, sing, info = checkpointed_invert(a, M, **kw)
        assert torch.equal(out, mono["inv"])
    else:
        out, sing, info = checkpointed_solve(a, b, M, **kw)
        assert torch.equal(out, mono["x"])
    assert not sing
    assert info["topology"] == TOPO and info["Nr"] == 6
    assert info["segments_run"] == [(0, 4), (4, 6)]
    assert info["ckpt_written"] == 1
    assert store.ledger()["invariant_holds"]


@pytest.mark.parametrize("workload", ["invert", "solve"])
def test_preempt_then_resume_gives_the_bits_and_jax_calls(tmp_path,
                                                          workload):
    mono = _monolithic()
    a, b = _mat(N, 1), _rhs(N, 2)
    fn = checkpointed_invert if workload == "invert" else checkpointed_solve
    args = (a, M) if workload == "invert" else (a, b, M)
    store = CheckpointStore(str(tmp_path / "t"))
    kw = dict(store=store, run_id="t:p", cadence=2, engine="fori",
              mesh=MESH, device="cpu")
    plan = FaultPlan([FaultSpec("preempt", (3,), "permanent")])
    with activate(plan):
        with pytest.raises(PreemptedError) as ei:
            fn(*args, **kw)
    assert ei.value.step == 4
    if workload == "invert":
        jplan = JPlan([JSpec("preempt", (3,), "permanent")])
        with jactivate(jplan):
            with pytest.raises(jckpt.PreemptedError) as ej:
                jckpt.checkpointed_invert(
                    a, M, store=jckpt.CheckpointStore(str(tmp_path / "j")),
                    run_id="t:p", cadence=2, engine="fori",
                    mesh=make_mesh_2d(*MESH))
        assert ej.value.step == 4 and plan.calls() == jplan.calls()
    out, sing, info = fn(*args, resume_from="t:p", **kw)
    assert not sing and info["resumed"] and info["start_step"] == 4
    assert torch.equal(out, mono["inv" if workload == "invert" else "x"])
    assert info["segments_run"] == [(4, 6)]
    assert store.ledger()["invariant_holds"]


def test_port_resumes_jax_checkpoint(tmp_path):
    a = _mat(N, 3)
    jstore = jckpt.CheckpointStore(str(tmp_path))
    jkw = dict(store=jstore, run_id="x", cadence=2, engine="fori",
               mesh=make_mesh_2d(*MESH))
    ref, _, _ = jckpt.checkpointed_invert(a, M, **dict(jkw, run_id="ref"))
    with jactivate(JPlan([JSpec("preempt", (2,), "permanent")])):
        with pytest.raises(jckpt.PreemptedError):
            jckpt.checkpointed_invert(a, M, **jkw)
    key, step, stored = jstore.peek("x")
    assert key.topology == TOPO and step == 2
    assert stored["W"].shape == (6, M, N)
    assert stored["singular"].shape == MESH
    assert stored["swaps"].shape == MESH + (6,)
    store = CheckpointStore(str(tmp_path))
    out, sing, info = checkpointed_invert(a, M, store=store, run_id="x",
                                          cadence=2, engine="fori",
                                          workers=MESH, resume_from="x",
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
                                engine="unrolled", workers=MESH,
                                device="cpu")
    jstore = jckpt.CheckpointStore(str(tmp_path))
    key, step, stored = jstore.peek("y")
    assert key.topology == TOPO and step == 2
    assert stored["swaps"].shape == MESH + (6,)
    assert stored["singular"].shape == MESH
    for row in stored["swaps"].reshape(-1, 6):
        assert row[:2].tolist() == mono["pivots"][:2]
    # The stored W is the 2D-cyclic storage of the state: its shards are
    # what the ranks held.
    lay = CyclicLayout2D.create(N, M, *MESH)
    assert len(tj2.split_shards_2d(torch.from_numpy(stored["W"]), lay)) == 4
    inv, sing, info = jckpt.checkpointed_invert(
        a, M, store=jstore, run_id="y", cadence=2, engine="unrolled",
        mesh=make_mesh_2d(*MESH), resume_from="y")
    assert not sing and info["start_step"] == 2
    assert _close(np.asarray(inv), mono["inv"].numpy(), a)
    assert jstore.ledger()["invariant_holds"]


def test_port_solve_checkpoint_loads_in_jax_format(tmp_path):
    a, b = _mat(N, 1), _rhs(N, 2)
    store = CheckpointStore(str(tmp_path))
    with activate(FaultPlan([FaultSpec("preempt", (2,), "permanent")])):
        with pytest.raises(PreemptedError):
            checkpointed_solve(a, b, M, store=store, run_id="z", cadence=2,
                               engine="fori", workers=MESH, device="cpu")
    key, step, stored = jckpt.CheckpointStore(str(tmp_path)).peek("z")
    assert (key.topology, key.workload, key.nrhs, step) == (TOPO, "solve",
                                                           K, 2)
    assert stored["W"].shape == (6, M, N)
    assert stored["X"].shape == (6, M, K)
    assert stored["singular"].shape == MESH and "swaps" not in stored


@pytest.mark.parametrize("engine", ["lookahead", "swapfree", "grouped"])
def test_pipeline_engines_refused_as_in_jax(tmp_path, engine):
    a = _mat(32, 5)
    with pytest.raises(jckpt.CheckpointUnsupportedError) as ej:
        jckpt.checkpointed_invert(
            a, 8, store=jckpt.CheckpointStore(str(tmp_path / "j")),
            run_id="t", cadence=2, engine=engine, mesh=make_mesh_2d(*MESH))
    with pytest.raises(CheckpointUnsupportedError) as et:
        checkpointed_invert(a, 8, store=CheckpointStore(str(tmp_path)),
                            run_id="t", cadence=2, engine=engine,
                            mesh=MESH, device="cpu")
    assert str(et.value) == str(ej.value)
