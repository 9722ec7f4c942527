"""The port's pre-shard_map augmented engines on p ranks and on a (pr, pc)
mesh (``parallel/sharded_jordan.py``, ``parallel/jordan2d.py``) against
the JAX package's ``sharded_jordan_invert`` and
``sharded_jordan_invert_2d`` on its 8 virtual CPU devices.

Meshes: p ∈ {2, 3, 4} and (2, 2), (1, 4), (4, 1), run in three module
worlds (2, 3 and 4 CPU ranks; the 4-rank world serves p = 4 and the three
meshes).  Fixtures in fp64: ragged and aligned gaussian n, absdiff (tied
pivot keys), a matrix with a zero row (the collective singular agreement)
and hilbert.

  * The pivot sequence equals the JAX engine's exactly.  The JAX engine
    does not return its pivots, so the test steps the JAX engine's own
    superstep function (``_local_step``, ``_local_step2d``) under
    ``shard_map`` from the host and reads each step's pivot off the state
    that step starts from (the JAX probe on the live candidates, the
    smallest ‖inv‖∞, ties to the lowest row), up to the first all-singular
    step, after which neither engine's pivots mean anything, and up to
    the first step whose two best keys differ by less than eps·κ∞(A)
    relative (but are not one value): there the keys are rounding noise
    and the pick may part (ROADMAP.md Queue C; on hilbert that is from
    the second step on).
  * The singular flag equals JAX's; the inverse is within 16·eps·n·κ∞ of
    JAX's (relative ∞-norm; the sums' order differs).
  * The collectives each rank recorded reconcile with the analytical
    "augmented" inventory, per rank and for the world.
  * The work inventory equals JAX's ``engine_report("augmented", …)``
    exactly (its ``unroll`` flag aside: the port's model is its eager loop,
    JAX's augmented engine a fori loop; the invert's executed model is the
    same 4N³ either way), and the counted GEMM FLOPs sit in the band.
  * Each rank probed exactly at the steps where it held a live candidate.
  * The cost-only picks at the pinned p > 1 points are unchanged: the
    augmented engine is a candidate there and never the pick.
  * ``driver.solve(workers=…, engine="augmented")`` and the CLI run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_jordan.config import eps_for as jeps
from tpu_jordan.obs import work as jwork
from tpu_jordan.ops.block_inverse import probe_blocks as jprobe
from tpu_jordan.ops.norms import block_inf_norms as jnorms
from tpu_jordan.parallel import jordan2d as jj2
from tpu_jordan.parallel import layout as jl
from tpu_jordan.parallel import make_mesh, make_mesh_2d
from tpu_jordan.parallel import sharded_jordan as jsj
from tpu_jordan.parallel.compat import shard_map
from tpu_jordan.tuning import registry as jregistry

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.obs import comm as tcomm
from tpu_jordan_torch.obs import work as twork
from tpu_jordan_torch.parallel.dist_solve import (DistSpec,
                                                  invert_strip_rank,
                                                  join_strips, split_strips)
from tpu_jordan_torch.parallel.layout import CyclicLayout, CyclicLayout2D
from tpu_jordan_torch.parallel.world import World
from tpu_jordan_torch.tuning import registry as tregistry

CASES = [
    # (id, workers, fixture, n, m)
    ("p2-gauss-ragged", 2, "gauss", 50, 8),
    ("p2-absdiff", 2, "absdiff", 48, 8),
    ("p3-gauss-ragged", 3, "gauss", 40, 8),
    ("p3-singular", 3, "zero_row", 48, 8),
    ("p4-hilbert", 4, "hilbert", 32, 8),
    ("p4-absdiff", 4, "absdiff", 64, 8),
    ("2x2-gauss", (2, 2), "gauss", 64, 8),
    ("2x2-singular", (2, 2), "zero_row", 48, 8),
    ("1x4-absdiff", (1, 4), "absdiff", 48, 8),
    ("4x1-hilbert-ragged", (4, 1), "hilbert", 40, 8),
]


def _fixture(kind, n):
    rng = np.random.default_rng(3 * n + len(kind))
    i = np.arange(n)
    if kind == "gauss":
        return rng.standard_normal((n, n))
    if kind == "absdiff":
        return np.abs(i[:, None] - i[None, :]).astype(float)
    if kind == "hilbert":
        return 1.0 / (i[:, None] + i[None, :] + 1.0)
    a = rng.standard_normal((n, n))
    a[n // 2] = 0.0
    return a


def _ranks(workers):
    return workers[0] * workers[1] if isinstance(workers, tuple) else workers


@pytest.fixture(scope="module")
def worlds():
    out = {p: World(p, "cpu") for p in (2, 3, 4)}
    yield out
    for w in out.values():
        w.close()


def _jax_replay(a, m, workers):
    """(pivots up to the first all-singular step, singular) of the JAX
    engine's own superstep stepped from the host (module docstring)."""
    n = a.shape[0]
    A = jnp.asarray(a)
    eps = jeps(A.dtype)
    if isinstance(workers, tuple):
        mesh = make_mesh_2d(*workers)
        lay = jl.CyclicLayout2D.create(n, m, *workers)
        W = jj2.scatter_augmented_2d(A, lay, mesh)
        sw, ss = P("pr", None, "pc"), P("pr", "pc")
        sing = jnp.zeros(workers, bool)
        body = jj2._local_step2d
        rowp, colp = jj2._perms(lay, 2 * lay.Nr)
        irow, icol = np.argsort(np.asarray(rowp)), np.argsort(np.asarray(colp))

        def natural(W):
            b = np.asarray(W).reshape(lay.Nr, m, 2 * lay.Nr, m)
            return b[irow][:, :, icol].reshape(lay.N, 2 * lay.N)
    else:
        mesh = make_mesh(workers)
        lay = jl.CyclicLayout.create(n, m, workers)
        W = jsj.scatter_augmented(A, lay, mesh)
        sw, ss = P("p", None, None), P("p")
        sing = jnp.zeros((workers,), bool)
        body = jsj._local_step
        perm = np.asarray(jl.cyclic_scatter_perm(lay))

        def natural(W):
            return np.asarray(W)[perm].reshape(lay.N, 2 * lay.N)

    sing = jax.device_put(sing, NamedSharding(mesh, ss))
    step = jax.jit(shard_map(
        lambda Wl, s, t: body(t, Wl, s, lay=lay, eps=eps,
                              precision=lax.Precision.HIGHEST,
                              use_pallas=False),
        mesh=mesh, in_specs=(sw, ss, P()), out_specs=(sw, ss)))
    pivots, live = [], True
    kappa = np.linalg.cond(a, np.inf)
    # A singular A has no κ: its keys are compared exactly up to the
    # all-singular step.
    tol = np.finfo(np.float64).eps * kappa if np.isfinite(kappa) else 0.0
    for t in range(lay.Nr):
        if live:
            Wn = natural(W)
            cands = np.stack([Wn[g * m:(g + 1) * m, t * m:(t + 1) * m]
                              for g in range(t, lay.Nr)])
            invs, bad = jprobe(jnp.asarray(cands), eps, False)
            key = np.where(np.asarray(bad), np.inf,
                           np.asarray(jnorms(invs)))
            best = np.sort(key)
            gap = ((best[1] - best[0]) / best[0] if best.size > 1
                   else np.inf)
            if np.isinf(key).all() or 0 < gap < tol:
                live = False
            else:
                pivots.append(t + int(np.argmin(key)))
        W, sing = step(W, sing, jnp.asarray(t, jnp.int64))
    return pivots, bool(np.asarray(sing).any())


_RESULTS = {}


def _run(case, worlds):
    if case[0] in _RESULTS:
        return _RESULTS[case[0]]
    name, workers, kind, n, m = case
    a = _fixture(kind, n)
    mesh = workers if isinstance(workers, tuple) else None
    lay = (CyclicLayout2D.create(n, m, *mesh) if mesh
           else CyclicLayout.create(n, m, workers))
    spec = DistSpec(n=n, m=m, generator="rand", dtype="float64",
                    engine="augmented", mesh=mesh, record=True)
    strips = split_strips(torch.from_numpy(a), lay)
    outs = worlds[_ranks(workers)].run(invert_strip_rank, spec,
                                       per_rank=[(s, None) for s in strips])
    if isinstance(workers, tuple):
        jinv, jsing = jj2.sharded_jordan_invert_2d(
            jnp.asarray(a), make_mesh_2d(*workers), m)
    else:
        jinv, jsing = jsj.sharded_jordan_invert(jnp.asarray(a),
                                                make_mesh(workers), m)
    jpiv, jsing_replay = _jax_replay(a, m, workers)
    _RESULTS[name] = (a, lay, outs, np.asarray(jinv), bool(jsing), jpiv,
                      jsing_replay)
    return _RESULTS[name]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pivots_and_flags_equal_jax(case, worlds):
    a, lay, outs, jinv, jsing, jpiv, jsing_replay = _run(case, worlds)
    assert jsing_replay == jsing
    sing = [o["singular"] for o in outs]
    assert sing == [jsing] * len(outs)
    pivots = outs[0]["pivots"]
    assert all(o["pivots"] == pivots for o in outs)
    assert pivots[:len(jpiv)] == jpiv
    if case[2] != "hilbert":
        assert jpiv
        if not jsing:
            assert len(jpiv) == lay.Nr


@pytest.mark.parametrize("case", [c for c in CASES if c[2] != "zero_row"],
                         ids=[c[0] for c in CASES if c[2] != "zero_row"])
def test_inverse_within_eps_n_kappa(case, worlds):
    a, lay, outs, jinv, _, _, _ = _run(case, worlds)
    n = a.shape[0]
    inv = join_strips([o["blocks"] for o in outs], lay, n).numpy()
    kappa = np.abs(a).sum(1).max() * np.abs(jinv).sum(1).max()
    err = np.abs(inv - jinv).sum(1).max() / np.abs(jinv).sum(1).max()
    assert err <= 16 * np.finfo(np.float64).eps * n * kappa


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_comm_reconciles_per_rank_and_world(case, worlds):
    a, lay, outs, _, jsing, _, _ = _run(case, worlds)
    rep = tcomm.engine_report(
        engine="augmented", lay=lay, dtype="float64",
        pivots=outs[0]["pivots"], gather=False, refine=1, singular=jsing)
    rep.attach_observed({o["rank"]: o["observed"] for o in outs})
    assert rep.reconciled, rep.mismatches[:3]
    assert set(rep.observed_ranks) == set(range(len(outs)))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_work_inventory_equals_jax(case, worlds):
    name, workers, _, n, m = case
    _, lay, outs, _, _, _, _ = _run(case, worlds)
    jlay = (jl.CyclicLayout2D.create(n, m, *workers)
            if isinstance(workers, tuple)
            else jl.CyclicLayout.create(n, m, workers))
    j = jwork.engine_report(engine="augmented", lay=jlay)
    t = twork.engine_report(engine="augmented", lay=lay)
    assert t.to_json()["per_worker"] == j.to_json()["per_worker"]
    for key in ("per_superstep", "convention", "executed_model",
                "ragged_penalty", "supersteps",
                "padded_supersteps", "padded_n", "last_height", "workload"):
        assert getattr(t, key) == getattr(j, key), key
    assert t.exact
    t.attach_counted([o["gemm_flops"] for o in outs])
    assert t.xla["within"], t.xla


# The 1D cases without a singular step (past one, the probe record is the
# engine's own).
LIVE_1D = [c for c in CASES if not isinstance(c[1], tuple)
           and c[2] != "zero_row"]


@pytest.mark.parametrize("case", LIVE_1D, ids=[c[0] for c in LIVE_1D])
def test_each_rank_probes_its_live_steps(case, worlds):
    _, lay, outs, _, _, _, _ = _run(case, worlds)
    for o in outs:
        k = o["rank"]
        last = (lay.blocks_per_worker - 1) * lay.p + k
        assert o["probe_steps"] == [t for t in range(lay.Nr) if t <= last]


@pytest.mark.parametrize("n,m,p", [(48, 8, 2), (45, 8, 4), (520, 8, 4),
                                   (4096, 128, 4), (8192, 384, 8)])
def test_cost_only_picks_unchanged(n, m, p):
    tp = tregistry.TunePoint.create(n, m, "float32", p, True, device="cpu")
    jp = jregistry.TunePoint.create(n, m, jnp.float32, p, True,
                                    backend="cpu")
    assert "augmented" in {c.name for c in tregistry.candidates(tp)}
    pick = tregistry.select_by_cost(tp).engine
    assert pick == jregistry.select_by_cost(jp).engine != "augmented"


@pytest.mark.parametrize("workers", [2, (2, 2)], ids=["p2", "2x2"])
def test_driver_solve_augmented(workers):
    res = tdriver.solve(48, 8, generator="absdiff", workers=workers,
                        engine="augmented", dtype="float64", device="cpu")
    ref = tdriver.solve(48, 8, generator="absdiff", workers=workers,
                        engine="inplace", dtype="float64", device="cpu")
    assert res.engine == "augmented" and res.residual < 1e-9
    assert res.ranks[0]["pivots"] == ref.ranks[0]["pivots"]
    assert res.comm.engine == "augmented"
    assert res.work.engine == "augmented"


def test_cli_augmented_on_ranks(capsys):
    assert tmain(["40", "8", "--workers", "2x2", "--engine", "augmented",
                  "--dtype", "float64", "--device", "cpu"]) == 0
    assert "residual" in capsys.readouterr().out
