"""The port's distributed ``JordanSolver`` (``models/jordan_solver.py`` on
a persistent world of ranks) against the JAX package's ``JordanSolver``
(mirrors ``tests/test_solver.py``'s distributed cases).

The same numpy fixtures (fp64 where pivots are compared) go through both.
Each solver below is module-scoped and owns one world of CPU ranks,
closed at teardown:

  * ``workers=4`` and ``workers=(2, 2)``: pivots equal the JAX engine's
    exactly (its segment executable's swap record), the inverse within
    16·eps·n·κ∞ of the JAX solver's; three ``invert`` calls start one
    world (the world-start counter);
  * ``gather=False``: the inverse blocks stay on the ranks, and
    ``residual(a, handle)`` runs the ring (SUMMA on the mesh) residual
    there, equal to the gathered residual within the gate; the comm report
    gains its residual section only when ``residual`` runs, reconciled;
  * ``residual`` before any ``invert``; bfloat16 storage;
  * the JAX solver's refusals: ``invert_batch`` when distributed,
    ``refine``/``mixed`` with ``gather=False``, ``gather=False`` and
    ``swapfree`` on one device, the fused-kernel engines on a mesh.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec

from tpu_jordan.config import eps_for as jeps
from tpu_jordan.models import JordanSolver as JSolver
from tpu_jordan.parallel import jordan2d as jj2
from tpu_jordan.parallel import jordan2d_inplace as jji
from tpu_jordan.parallel import layout as jl
from tpu_jordan.parallel import make_mesh, make_mesh_2d
from tpu_jordan.parallel import sharded_inplace as jsi
from tpu_jordan.parallel.ring_gemm import _to_identity_padded_blocks

from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.models import DistributedInverse, JordanSolver
from tpu_jordan_torch.obs import comm as tcomm
from tpu_jordan_torch.parallel.world import state_get, world_starts

N, M = 48, 8


def _fixture(seed, n=N):
    return np.random.default_rng(seed).standard_normal((n, n))


def _jax_pivots(a, m, workers):
    """The JAX plain engine's swap record on ``a``, from its segment
    executable (1D or 2D)."""
    n = a.shape[0]
    if isinstance(workers, tuple):
        mesh = make_mesh_2d(*workers)
        lay = jl.CyclicLayout2D.create(n, m, *workers)
        W = jj2.scatter_matrix_2d(jnp.asarray(a), lay, mesh)
        sing = jax.device_put(jnp.zeros(workers, bool),
                              NamedSharding(mesh, PartitionSpec("pr", "pc")))
        sw = jax.device_put(jnp.zeros(workers + (lay.Nr,), jnp.int32),
                            NamedSharding(mesh,
                                          PartitionSpec("pr", "pc", None)))
        _, _, sw = jji._sharded_jordan2d_inplace_segment(
            W, sing, sw, mesh, lay, 0, lay.Nr, jeps(W.dtype),
            lax.Precision.HIGHEST, False, lay.Nr <= jji.MAX_UNROLL_NR)
        return np.asarray(sw)[0, 0].tolist()
    mesh = make_mesh(workers)
    lay = jl.CyclicLayout.create(n, m, workers)
    blocks = _to_identity_padded_blocks(jnp.asarray(a), lay, mesh)
    sing = jax.device_put(jnp.zeros((workers,), bool),
                          NamedSharding(mesh, PartitionSpec("p")))
    sw = jax.device_put(jnp.zeros((workers, lay.Nr), jnp.int32),
                        NamedSharding(mesh, PartitionSpec("p", None)))
    _, _, sw = jsi._sharded_jordan_inplace_segment(
        blocks, sing, sw, mesh, lay, 0, lay.Nr, jeps(blocks.dtype),
        lax.Precision.HIGHEST, False, lay.Nr <= jsi.MAX_UNROLL_NR)
    return np.asarray(sw)[0].tolist()


def _rel(x, ref):
    return np.abs(x - ref).sum(1).max() / np.abs(ref).sum(1).max()


def _tol(a, inv, eps=np.finfo(np.float64).eps):
    kappa = np.abs(a).sum(1).max() * np.abs(inv).sum(1).max()
    return 16 * eps * a.shape[0] * kappa


@pytest.fixture(scope="module", params=[4, (2, 2)], ids=["p4", "2x2"])
def solver(request):
    s = JordanSolver(n=N, block_size=M, dtype="float64",
                     workers=request.param, device="cpu")
    yield s
    s.close()


def test_repeated_inverts_one_world_and_jax_parity(solver):
    jsolver = JSolver(n=N, block_size=M, dtype=jnp.float64,
                      workers=solver.workers)
    starts = world_starts()
    for seed in (1, 2, 3):
        a = _fixture(seed)
        inv, sing = solver.invert(a)
        assert not bool(sing) and inv.dtype == torch.float64
        jinv, jsing = jsolver.invert(a)
        assert not bool(jsing)
        jinv = np.asarray(jinv)
        assert _rel(inv.numpy(), jinv) <= _tol(a, jinv)
        assert solver.ranks[0]["pivots"] == _jax_pivots(a, M,
                                                        solver.workers)
        assert solver.residual(a, inv) < 1e-9
        assert solver.comm.reconciled is None          # nothing recorded
    assert world_starts() - starts == 1 and solver.world.starts == 1


def test_residual_before_invert():
    with JordanSolver(n=32, block_size=8, dtype="float64", workers=4,
                      device="cpu") as s:
        a = _fixture(5, 32)
        assert s.residual(a, np.linalg.inv(a)) < 1e-9
        assert s.world.starts == 1


@pytest.fixture(scope="module", params=[4, (2, 2)], ids=["p4", "2x2"])
def nogather(request):
    s = JordanSolver(n=N, block_size=M, dtype="float64",
                     workers=request.param, gather=False, device="cpu")
    yield s
    s.close()


def test_no_gather_blocks_stay_on_the_ranks(nogather):
    a = _fixture(7)
    with tcomm.recording():
        handle, sing = nogather.invert(a)
        assert isinstance(handle, DistributedInverse) and not bool(sing)
        assert handle.layout is nogather.layout and handle.n == N
        kept = nogather.world.run(state_get, handle.key)
        lay = nogather.layout
        width = lay.N if isinstance(nogather.workers, int) else (
            lay.N // lay.pc)
        rows = (lay.blocks_per_worker if isinstance(nogather.workers, int)
                else lay.bpr)
        assert [tuple(b.shape) for b in kept] == [(rows, M, width)] * len(
            kept)
        assert nogather.comm.reconciled
        assert not any(s.section == "residual" for s in nogather.comm.sigs)
        res = nogather.residual(a, handle)
    assert res < 1e-9
    assert nogather.comm.reconciled
    assert any(s.section == "residual" for s in nogather.comm.sigs)
    assert nogather.ranks[0]["pivots"] == _jax_pivots(a, M,
                                                      nogather.workers)
    # The gathered route agrees.
    inv = np.linalg.inv(a)
    assert abs(nogather.residual(a, inv) - res) < 1e-9
    nogather.drop(handle)
    with pytest.raises(Exception, match="no inverse blocks kept"):
        nogather.residual(a, handle)


def test_no_gather_matches_jax_blocks_residual(nogather):
    a = _fixture(8)
    jsolver = JSolver(n=N, block_size=M, dtype=jnp.float64,
                      workers=nogather.workers, gather=False)
    jblocks, _ = jsolver.invert(a)
    handle, _ = nogather.invert(a)
    ours, theirs = nogather.residual(a, handle), jsolver.residual(a, jblocks)
    assert ours < 1e-9 and theirs < 1e-9
    assert abs(ours - theirs) < 16 * np.finfo(np.float64).eps * N * (
        np.abs(a).sum(1).max() * np.abs(np.linalg.inv(a)).sum(1).max())


def test_sub_fp32_storage_dtype():
    a = _fixture(9, 32).astype(np.float32)
    with JordanSolver(n=32, block_size=8, dtype=torch.bfloat16, workers=4,
                      device="cpu") as s:
        inv, sing = s.invert(a)
    jinv, _ = JSolver(n=32, block_size=8, dtype=jnp.bfloat16,
                      workers=4).invert(a)
    assert inv.dtype == torch.bfloat16 and not bool(sing)
    assert np.asarray(jinv).dtype == jnp.bfloat16
    ours = inv.float().numpy()
    theirs = np.asarray(jinv, np.float32)
    assert _rel(ours, theirs) < 2 ** -6


@pytest.mark.parametrize("kwargs,match", [
    ({"workers": 4, "refine": 2, "gather": False}, "refine"),
    ({"workers": 4, "precision": "mixed", "gather": False}, "mixed"),
    ({"gather": False}, "gather=False"),
    ({"engine": "swapfree"}, "swapfree"),
    ({"workers": (2, 2), "engine": "grouped_pallas"}, "fused-kernel"),
])
def test_refusals_match_jax(kwargs, match):
    jkw = dict(kwargs)
    with pytest.raises(Exception, match=match):
        JSolver(n=16, **jkw)
    with pytest.raises(UsageError, match=match):
        JordanSolver(n=16, device="cpu", **kwargs)


def test_invert_batch_refused_when_distributed():
    stack = np.stack([np.eye(16)] * 2)
    with pytest.raises(Exception, match="single-device") as je:
        JSolver(n=16, workers=4).invert_batch(stack)
    with JordanSolver(n=16, workers=4, device="cpu") as s:
        with pytest.raises(UsageError) as e:
            s.invert_batch(stack)
    assert str(e.value) == str(je.value)
    assert not s.world.alive and s.world.starts == 0
