"""The port's distributed [A | B] solves against the JAX package's
``solve_system(workers=p)`` on its 8 virtual CPU devices.

One ``gloo`` world of CPU ranks per p ∈ {2, 4} (module-cached, every case
of one p in one spawn) runs ``parallel.dist_solve.solve_system_rank``, the
rank body ``solve_system(workers=p)`` runs, on each rank's strips of the
same numpy fixtures, for both engines:

  * X within 16·eps·n·κ∞ of the JAX ``solve_system(workers=p, engine=...)``
    (relative ∞-norm), and the pivot sequence exactly the JAX engine's (the
    record of its 1D invert segment executable on the same A, which the
    JAX package pins equal to its solve's);
  * the fixtures: ragged n with k = 1, forced swaps (the diagonal blocks
    weakest), tied pivots (``|i − j|``, exactly repeated blocks), Nr = 65
    (``solve_sharded`` runs; ``solve_lookahead`` is refused, typed, in
    both);
  * each rank probes exactly the steps at which it holds a live candidate.

Through ``solve_system(workers=p)`` itself: ``gather=False`` with
``numerics="summary"`` and a clean policy (the ``compile``/``execute``
fault points fired as in the JAX package), the refine rung with the
recovered X cut into ``x_blocks`` again, every typed refusal, and the CLI.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_jordan.__main__ import main as jmain
from tpu_jordan.driver import UsageError as JUsageError
from tpu_jordan.linalg import solve_system as jsolve_system
from tpu_jordan.resilience import FaultPlan as JFaultPlan
from tpu_jordan.resilience import ResiliencePolicy as JPolicy
from tpu_jordan.resilience import activate as jactivate

import torch

from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.linalg import solve_system
from tpu_jordan_torch.parallel import layout as tl
from tpu_jordan_torch.parallel import run_calls, run_workers
from tpu_jordan_torch.parallel.dist_solve import (DistSolveSpec,
                                                  solve_system_rank)
from tpu_jordan_torch.parallel.sharded_inplace import (
    gather_solution_1d, scatter_rhs_1d, to_identity_padded_blocks)
from tpu_jordan_torch.resilience import FaultPlan, ResiliencePolicy, activate

ENGINES = ("solve_sharded", "solve_lookahead")


def _jax_pivots(a, m, p):
    """The JAX 1D engine's swap record on ``a``, from its segment
    executable (the fori body beyond MAX_UNROLL_NR)."""
    import jax
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec

    from tpu_jordan.config import eps_for
    from tpu_jordan.parallel import layout as jl
    from tpu_jordan.parallel import make_mesh
    from tpu_jordan.parallel import sharded_inplace as jsi
    from tpu_jordan.parallel.ring_gemm import _to_identity_padded_blocks

    mesh = make_mesh(p)
    lay = jl.CyclicLayout.create(a.shape[0], m, p)
    blocks = _to_identity_padded_blocks(jnp.asarray(a), lay, mesh)
    sing = jax.device_put(jnp.zeros((p,), bool),
                          NamedSharding(mesh, PartitionSpec("p")))
    sw = jax.device_put(jnp.zeros((p, lay.Nr), jnp.int32),
                        NamedSharding(mesh, PartitionSpec("p", None)))
    _, _, sw = jsi._sharded_jordan_inplace_segment(
        blocks, sing, sw, mesh, lay, 0, lay.Nr, eps_for(blocks.dtype),
        lax.Precision.HIGHEST, False, lay.Nr <= jsi.MAX_UNROLL_NR)
    return np.asarray(sw)[0].tolist()


def _fixture(kind, n, k, seed):
    rng = np.random.default_rng(seed)
    if kind == "absdiff":
        i = np.arange(n)
        a = np.abs(i[:, None] - i[None, :]).astype(float)
    elif kind == "swaps":
        # The diagonal blocks are the weakest candidates: the pivot leaves
        # the diagonal at every superstep it can.
        a = rng.standard_normal((n, n)) + 2.0 * n * np.eye(n)
        a = np.roll(a, 8, axis=0)
    else:
        a = rng.standard_normal((n, n))
    return a, rng.standard_normal((n, k))


#: (kind, n, m, k, engines) of each p.
CASES = {2: [("gauss", 48, 8, 3, ENGINES),
             ("gauss", 130, 2, 1, ("solve_sharded",))],          # Nr = 65
         4: [("gauss", 45, 8, 1, ENGINES),                        # ragged
             ("swaps", 48, 8, 2, ENGINES),
             ("absdiff", 64, 8, 2, ENGINES)]}                     # ties
PARAMS = [(p, i, e) for p, cases in CASES.items()
          for i, c in enumerate(cases) for e in c[4]]
IDS = [f"p{p}-{CASES[p][i][0]}-n{CASES[p][i][1]}-{e}" for p, i, e in PARAMS]

_WORLDS = {}


def _world(p):
    """Every case of one p in one spawned world, each rank handed only its
    own strips."""
    if p in _WORLDS:
        return _WORLDS[p]
    calls = [[] for _ in range(p)]
    labels = []
    for i, (kind, n, m, k, engines) in enumerate(CASES[p]):
        a, b = _fixture(kind, n, k, seed=n + k)
        lay = tl.CyclicLayout.create(n, m, p)
        at = torch.from_numpy(a)
        for e in engines:
            for r in range(p):
                calls[r].append((solve_system_rank,
                                 (DistSolveSpec(n, m, "float64", e),
                                  to_identity_padded_blocks(at, lay,
                                                            r).numpy(),
                                  scatter_rhs_1d(b, lay, r).numpy())))
            labels.append((i, e))
    results = run_workers(p, run_calls, per_rank=[(c,) for c in calls],
                          deadline_s=300, device_type="cpu")
    _WORLDS[p] = {lab: [results[r][j] for r in range(p)]
                  for j, lab in enumerate(labels)}
    return _WORLDS[p]


@pytest.mark.parametrize("p,i,engine", PARAMS, ids=IDS)
def test_solve_matches_jax(p, i, engine):
    kind, n, m, k, _ = CASES[p][i]
    a, b = _fixture(kind, n, k, seed=n + k)
    ranks = _world(p)[(i, engine)]
    lay = tl.CyclicLayout.create(n, m, p)
    assert not any(r["singular"] for r in ranks)
    piv = ranks[0]["pivots"]
    assert all(r["pivots"] == piv for r in ranks)
    assert piv == _jax_pivots(a, m, p)
    bpw = lay.blocks_per_worker
    for rk, r in enumerate(ranks):
        assert r["probe_steps"] == [t for t in range(lay.Nr)
                                    if (bpw - 1) * p + rk >= t]
    xt = gather_solution_1d([r["x_blocks"] for r in ranks], lay, n).numpy()
    xj = np.asarray(jsolve_system(a, b, block_size=m, workers=p,
                                  engine=engine).x)
    eps = np.finfo(np.float64).eps
    kappa = (np.abs(a).sum(1).max()
             * np.abs(np.linalg.inv(a)).sum(1).max())
    diff = np.abs(xt - xj).sum(1).max() / np.abs(xj).sum(1).max()
    assert diff <= 16 * eps * n * kappa


def test_nr65_lookahead_is_refused_in_both():
    a, b = _fixture("gauss", 130, 1, seed=131)
    with pytest.raises(JUsageError, match="unrolled-only"):
        jsolve_system(a, b, block_size=2, workers=2,
                      engine="solve_lookahead")
    with pytest.raises(UsageError, match="unrolled-only"):
        solve_system(a, b, block_size=2, workers=2,
                     engine="solve_lookahead", device="cpu")


@pytest.mark.parametrize("kwargs,match", [
    ({"workers": 2, "numerics": "trace"}, "summary"),
    ({"workers": 2, "assume": "spd"}, "spd"),
    ({"engine": "solve_sharded"}, "workers"),
    ({"engine": "solve_lookahead"}, "workers"),
    ({"workers": 2, "engine": "solve_aug"}, "solve_sharded"),
    ({"gather": False}, "gather"),
    ({"assume": "spd", "engine": "solve_lookahead"},
     "nothing to probe ahead"),
])
def test_refusals_are_typed_as_in_jax(kwargs, match):
    a, b = _fixture("gauss", 32, 1, seed=33)
    with pytest.raises(JUsageError, match=match):
        jsolve_system(a, b, block_size=8, **kwargs)
    with pytest.raises(UsageError, match=match):
        solve_system(a, b, block_size=8, device="cpu", **kwargs)


def test_complex_distributed_is_refused_in_both():
    a, b = _fixture("gauss", 32, 1, seed=33)
    a = (a + 1j * a.T).astype(np.complex64)
    b = b.astype(np.complex64)
    with pytest.raises(JUsageError, match="complex"):
        jsolve_system(a, b, block_size=8, workers=2)
    with pytest.raises(UsageError, match="complex"):
        solve_system(a, b, block_size=8, workers=2, device="cpu")


def test_gather_false_summary_policy_and_fault_points():
    """Auto resolves to solve_lookahead as in the JAX package; x_blocks
    gather back to x; a clean solve under a policy climbs no rung; the
    compile and execute fault points fire as the JAX solve fires them."""
    a, b = _fixture("gauss", 48, 2, seed=50)
    jplan, tplan = JFaultPlan([]), FaultPlan([])
    with jactivate(jplan):
        rj = jsolve_system(a, b, block_size=8, workers=2, gather=False,
                           numerics="summary", policy=JPolicy())
    with activate(tplan):
        rt = solve_system(a, b, block_size=8, workers=2, gather=False,
                          numerics="summary", policy=ResiliencePolicy(),
                          device="cpu")
    assert tplan.calls() == jplan.calls()
    assert rt.engine == rj.engine == "solve_lookahead"
    assert rt.plan.config == rj.plan.config
    assert rt.recovery == rj.recovery == ()
    assert rt.numerics.workload == rj.numerics.workload == "solve"
    assert rt.workers == 2 and rt.layout.p == 2
    x2 = gather_solution_1d(rt.x_blocks, rt.layout, 48)
    assert torch.equal(x2, rt.x)
    assert rt.rel_residual < 1e-12
    assert len(rt.ranks) == 2 and rt.ranks[0]["backend"] == "gloo"


def test_refine_rung_rescatters_recovered_blocks():
    """bf16 storage judged at the fp32 gate: the refine rung re-runs the
    distributed solve on the residual, in both packages, and the
    recovered X is cut into x_blocks again."""
    a, b = _fixture("gauss", 48, 2, seed=52)
    a = a + 48 * np.eye(48)
    rj = jsolve_system(jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16), block_size=8,
                       workers=2, gather=False,
                       policy=JPolicy(gate_dtype=jnp.float32))
    rt = solve_system(torch.from_numpy(a).bfloat16(),
                      torch.from_numpy(b).bfloat16(), block_size=8,
                      workers=2, gather=False, device="cpu",
                      policy=ResiliencePolicy(gate_dtype=torch.float32))
    assert ([r["rung"] for r in rt.recovery]
            == [r["rung"] for r in rj.recovery] == ["refine"])
    x2 = gather_solution_1d(rt.x_blocks, rt.layout, 48)
    assert torch.equal(x2, rt.x)
    assert rt.rel_residual < 1e-5


def test_cli_workload_solve_workers(capsys):
    argv = ["48", "8", "--workload", "solve", "--rhs", "2", "--workers",
            "2", "--generator", "rand", "--dtype", "float64"]
    assert jmain(argv) == 0
    capsys.readouterr()
    assert tmain(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "engine: solve_lookahead on cpu" in out
    rel, gate = out.split("rel_residual: ")[1].split(" (solve gate ")
    assert float(rel) <= float(gate.split(")")[0])
    lsq = ["48", "8", "--workload", "lstsq", "--workers", "2"]
    assert jmain(lsq) == 1
    assert tmain(lsq + ["--device", "cpu"]) == 1
