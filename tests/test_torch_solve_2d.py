"""The port's 2D [A | B] solves (``solve_blocks_2d``, ``solve_system(
workers=(pr, pc))``) against the JAX package's ``solve_system(workers=(pr,
pc))`` on its virtual CPU devices: its pivots, its refusals, and its
``solve_system`` X.

One gloo world of 4 CPU ranks (module-cached) runs
``parallel.dist_solve.solve_system_rank``, the rank body of
``solve_system(workers=(pr, pc))``, on each rank's shards of the same
numpy fixtures, on the meshes (2, 2), (1, 4) and (4, 1), for both engines:

  * the pivot sequence exactly the JAX 2D engine's (the record of its
    invert segment executable on the same A, which the JAX package pins
    equal to its solve's); X within 16·eps·n·κ∞ (relative ∞-norm) of the
    JAX package's ``solve_system``: the single-device one, because the
    JAX 2D solve engine does not compile under this JAX (its ``shard_map``
    output fails the replication check, ROADMAP.md Queue C);
    ``solve_lookahead``'s X bits equal ``solve_sharded``'s;
  * the pc replicas of X are bit-identical;
  * the rows probed across the ranks at each step are the live rows, each
    probed by one rank.

Through ``solve_system(workers=(2, 2))`` itself, gathered and with
``gather=False`` (whose ``x_blocks`` keep the replicas), the typed
refusals (complex, ``assume="spd"``, ``numerics="trace"``) in both
packages, and the CLI's ``--workload solve --workers 2x2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec

from tpu_jordan.config import eps_for as jeps
from tpu_jordan.driver import UsageError as JUsageError
from tpu_jordan.linalg import solve_system as jsolve_system
from tpu_jordan.parallel import jordan2d as jj2
from tpu_jordan.parallel import jordan2d_inplace as jji
from tpu_jordan.parallel import layout as jl
from tpu_jordan.parallel import make_mesh_2d

from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.linalg import solve_system
from tpu_jordan_torch.parallel import jordan2d as tj2
from tpu_jordan_torch.parallel import jordan2d_inplace as tji
from tpu_jordan_torch.parallel import run_calls, run_workers
from tpu_jordan_torch.parallel.dist_solve import (DistSolveSpec,
                                                  solve_system_rank)
from tpu_jordan_torch.parallel.layout import CyclicLayout2D

ENGINES = ("solve_sharded", "solve_lookahead")
#: (name, mesh, kind, n, m, k)
CASES = [("gauss22", (2, 2), "gauss", 48, 8, 3),
         ("absdiff14", (1, 4), "absdiff", 64, 8, 2),
         ("swaps41", (4, 1), "swaps", 48, 8, 2),
         ("ragged22", (2, 2), "gauss", 45, 8, 1)]
NAMES = {c[0]: c for c in CASES}


def _fixture(kind, n, k, seed):
    rng = np.random.default_rng(seed)
    if kind == "absdiff":
        i = np.arange(n)
        a = np.abs(i[:, None] - i[None, :]).astype(float)
    elif kind == "swaps":
        a = rng.standard_normal((n, n)) + 2.0 * n * np.eye(n)
        a = np.roll(a, 8, axis=0)
    else:
        a = rng.standard_normal((n, n))
    return a, rng.standard_normal((n, k))


_WORLD = {}


def _world():
    """Every case and engine in one spawned world, each rank handed only
    its own shards."""
    if _WORLD:
        return _WORLD
    calls = [[] for _ in range(4)]
    labels = []
    for name, shape, kind, n, m, k in CASES:
        a, b = _fixture(kind, n, k, seed=n + k)
        lay = CyclicLayout2D.create(n, m, *shape)
        for e in ENGINES:
            for r in range(4):
                kr, kc = divmod(r, shape[1])
                calls[r].append((solve_system_rank, (
                    DistSolveSpec(n, m, "float64", e, mesh=shape),
                    tj2.scatter_matrix_2d(a, lay, kr, kc).numpy(),
                    tji.scatter_rhs_2d(b, lay, kr).numpy())))
            labels.append((name, e))
    res = run_workers(4, run_calls, per_rank=[(c,) for c in calls],
                      deadline_s=600, device_type="cpu")
    for i, label in enumerate(labels):
        _WORLD[label] = [res[r][i] for r in range(4)]
    return _WORLD


_JAX = {}


def _jax_ref(name):
    """The JAX 2D engine's pivots on A and its solve_system X."""
    if name in _JAX:
        return _JAX[name]
    _, shape, kind, n, m, k = NAMES[name]
    a, b = _fixture(kind, n, k, seed=n + k)
    mesh = make_mesh_2d(*shape)
    lay = jl.CyclicLayout2D.create(n, m, *shape)
    W = jj2.scatter_matrix_2d(jnp.asarray(a), lay, mesh)
    sing = jax.device_put(jnp.zeros(shape, bool),
                          NamedSharding(mesh, PartitionSpec("pr", "pc")))
    sw = jax.device_put(jnp.zeros(shape + (lay.Nr,), jnp.int32),
                        NamedSharding(mesh, PartitionSpec("pr", "pc", None)))
    _, _, sw = jji._sharded_jordan2d_inplace_segment(
        W, sing, sw, mesh, lay, 0, lay.Nr, jeps(W.dtype),
        lax.Precision.HIGHEST, False, True)
    # The JAX 2D solve engine does not compile under this JAX (its
    # shard_map out_specs fail the replication check; ROADMAP.md Queue C):
    # X is held to the JAX package's single-device solve_system.
    x = np.asarray(jsolve_system(a, b, block_size=m).x)
    _JAX[name] = (a, b, np.asarray(sw)[0, 0].tolist(), x)
    return _JAX[name]


def _within(x, ref, a):
    eps = np.finfo(np.float64).eps
    kappa = np.abs(a).sum(1).max() * np.abs(np.linalg.inv(a)).sum(1).max()
    rel = np.abs(x - ref).sum(1).max() / np.abs(ref).sum(1).max()
    return rel <= 16 * eps * a.shape[0] * kappa


PARAMS = [(c[0], e) for c in CASES for e in ENGINES]


@pytest.mark.parametrize("name,engine", PARAMS,
                         ids=[f"{n}-{e}" for n, e in PARAMS])
def test_solve_matches_jax(name, engine):
    _, shape, kind, n, m, k = NAMES[name]
    ranks = _world()[(name, engine)]
    a, b, pivots, xref = _jax_ref(name)
    lay = CyclicLayout2D.create(n, m, *shape)
    assert not any(r["singular"] for r in ranks)
    assert all(r["pivots"] == pivots for r in ranks)
    x = tji.gather_solution_2d([r["x_blocks"] for r in ranks], lay,
                               n).numpy()
    assert _within(x, xref, a)
    # The pc replicas of X are bit-identical.
    for r in ranks:
        assert torch.equal(r["x_blocks"],
                           ranks[r["kr"] * shape[1]]["x_blocks"])
    by_step = {}
    for r in ranks:
        for t, rows in r["probed"]:
            by_step.setdefault(t, []).extend(rows)
    assert ([sorted(by_step.get(t, [])) for t in range(lay.Nr)]
            == [list(range(t, lay.Nr)) for t in range(lay.Nr)])


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_lookahead_x_bits_equal_sharded(name):
    w = _world()
    for x, y in zip(w[(name, "solve_sharded")], w[(name, "solve_lookahead")]):
        assert torch.equal(x["x_blocks"], y["x_blocks"])


@pytest.mark.parametrize("gather", [True, False])
def test_solve_system_on_a_mesh(gather):
    a, b, pivots, xref = _jax_ref("gauss22")
    res = solve_system(a, b, block_size=8, workers=(2, 2), gather=gather,
                       device="cpu")
    assert res.engine == "solve_lookahead" and res.workers == (2, 2)
    assert all(r["pivots"] == pivots for r in res.ranks)
    assert _within(res.x.numpy(), xref, a)
    assert res.rel_residual < 1e-12
    if gather:
        assert res.x_blocks is None and res.layout is None
        return
    lay = res.layout
    assert (lay.pr, lay.pc) == (2, 2)
    assert torch.equal(res.x_blocks[0], res.x_blocks[1])
    assert torch.equal(res.x_blocks[2], res.x_blocks[3])
    assert torch.equal(tji.gather_solution_2d(res.x_blocks, lay, 48), res.x)


@pytest.mark.parametrize("kwargs", [
    {"dtype": "complex64"}, {"assume": "spd"}, {"numerics": "trace"}])
def test_mesh_refusals_are_typed_in_both(kwargs):
    rng = np.random.default_rng(9)
    a, b = rng.standard_normal((16, 16)), rng.standard_normal((16, 1))
    jkw = dict(kwargs)
    if "dtype" in jkw:
        a, b = a.astype(np.complex64), b.astype(np.complex64)
        jkw.pop("dtype")
    with pytest.raises(JUsageError):
        jsolve_system(a, b, workers=(2, 2), **jkw)
    with pytest.raises(UsageError):
        solve_system(a, b, workers=(2, 2), device="cpu", **kwargs)


def test_cli_solve_on_a_mesh(capsys):
    assert tmain(["48", "8", "--workload", "solve", "--workers", "2x2",
                  "--generator", "rand", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "engine: solve_lookahead" in out
    rel, gate = out.split("rel_residual: ")[1].split(" (solve gate ")
    assert float(rel) <= float(gate.split(")")[0])
