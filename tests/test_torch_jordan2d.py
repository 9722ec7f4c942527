"""The port's 2D block-cyclic helpers (``parallel/jordan2d.py``,
``stream_scatter_2d``, the gathers and the corner of
``parallel/jordan2d_inplace.py``) against the JAX package's on its
virtual CPU devices.

  * Each helper is a function of one rank: called for every (kr, kc) of a
    (2, 2), (2, 3) and (2, 4) mesh, its shard equals the JAX package's
    device shard bit for bit (``_perms``/``_inv_perm``,
    ``scatter_matrix_2d``, ``scatter_augmented_2d``, ``scatter_rhs_2d``,
    ``sharded_generate_2d`` for each generator, ``stream_scatter_2d``), in
    fp64, fp32 and bf16 storage, ``augmented`` True and False, at a ragged
    n.
  * The gathers and ``inverse_corner_2d`` invert the scatters exactly.
  * The streamed scatter holds at most one strip (m rows) of the file.
  * The SUMMA residual on one 4-rank gloo world, on meshes (2, 2), (1, 4)
    and (4, 1), lies within 4·eps·n·‖A‖∞‖A⁻¹‖∞ of the JAX
    ``distributed_residual_2d`` on the same operands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_jordan.ops import generate as jgenerate
from tpu_jordan.parallel import jordan2d as jj2
from tpu_jordan.parallel import jordan2d_inplace as jji
from tpu_jordan.parallel import layout as jl
from tpu_jordan.parallel import make_mesh_2d
from tpu_jordan.parallel import scatter_stream as jss

from tpu_jordan_torch.io import (reset_strip_peak, strip_peak_rows,
                                 write_matrix_file)
from tpu_jordan_torch.parallel import jordan2d as tj2
from tpu_jordan_torch.parallel import jordan2d_inplace as tji
from tpu_jordan_torch.parallel import run_calls, run_workers
from tpu_jordan_torch.parallel import scatter_stream as tss
from tpu_jordan_torch.parallel.layout import CyclicLayout2D

MESHES = [(2, 2), (2, 3), (2, 4)]
N_RAGGED, M = 45, 8


def _mat(n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)).astype(dtype)


def _lays(n, m, shape):
    return (CyclicLayout2D.create(n, m, *shape),
            jl.CyclicLayout2D.create(n, m, *shape))


def _shards(arr, lay):
    """The JAX global storage array split into the device shards, in rank
    order."""
    return [x.numpy() for x in tj2.split_shards_2d(
        torch.from_numpy(np.array(arr)), lay)]


def _ranks(lay):
    return [divmod(r, lay.pc) for r in range(lay.pr * lay.pc)]


def _eq(x, y):
    x = torch.as_tensor(x)
    y = torch.as_tensor(np.asarray(y))
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("shape", MESHES)
def test_perms_equal_jax(shape):
    lay, jlay = _lays(N_RAGGED, M, shape)
    for ncb in (lay.Nr, 2 * lay.Nr):
        rowp, colp = tj2._perms(lay, ncb)
        jrowp, jcolp = jj2._perms(jlay, ncb)
        assert rowp.tolist() == np.asarray(jrowp).tolist()
        assert colp.tolist() == np.asarray(jcolp).tolist()
        assert (tj2._inv_perm(colp).tolist()
                == np.asarray(jj2._inv_perm(jcolp)).tolist())


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_scatters_equal_jax_device_shards(shape, dtype):
    lay, jlay = _lays(N_RAGGED, M, shape)
    mesh = make_mesh_2d(*shape)
    a = _mat(N_RAGGED, 1, dtype)
    b = np.random.default_rng(2).standard_normal((N_RAGGED, 3)).astype(dtype)
    jw = _shards(jj2.scatter_matrix_2d(jnp.asarray(a), jlay, mesh), lay)
    jaug = _shards(jj2.scatter_augmented_2d(jnp.asarray(a), jlay, mesh),
                   lay)
    jx = np.asarray(jji.scatter_rhs_2d(jnp.asarray(b), jlay, mesh))
    for r, (kr, kc) in enumerate(_ranks(lay)):
        assert _eq(tj2.scatter_matrix_2d(a, lay, kr, kc), jw[r])
        assert _eq(tj2.scatter_augmented_2d(a, lay, kr, kc), jaug[r])
        assert _eq(tji.scatter_rhs_2d(b, lay, kr),
                   jx[kr * lay.bpr:(kr + 1) * lay.bpr])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("gen", ["absdiff", "rand", "hilbert"])
@pytest.mark.parametrize("augmented", [True, False])
def test_sharded_generate_equals_jax(shape, gen, augmented):
    lay, jlay = _lays(N_RAGGED, M, shape)
    mesh = make_mesh_2d(*shape)
    want = _shards(jj2.sharded_generate_2d(gen, jlay, mesh, jnp.float64,
                                           augmented=augmented), lay)
    for r, (kr, kc) in enumerate(_ranks(lay)):
        assert _eq(tj2.sharded_generate_2d(gen, lay, kr, kc, torch.float64,
                                           augmented=augmented), want[r])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("dtype,storage", [("float64", None),
                                           ("float32", None),
                                           ("float32", "bfloat16")])
@pytest.mark.parametrize("augmented", [False, True])
def test_stream_scatter_equals_jax(tmp_path, shape, dtype, storage,
                                   augmented):
    lay, jlay = _lays(N_RAGGED, M, shape)
    mesh = make_mesh_2d(*shape)
    path = str(tmp_path / "a.txt")
    write_matrix_file(path, _mat(N_RAGGED, 3))
    want = _shards(jss.stream_scatter_2d(
        path, jlay, mesh, jnp.dtype(dtype), augmented=augmented,
        storage_dtype=None if storage is None else jnp.bfloat16), lay)
    for r, (kr, kc) in enumerate(_ranks(lay)):
        reset_strip_peak()
        got = tss.stream_scatter_2d(path, lay, kr, kc, dtype,
                                    augmented=augmented,
                                    storage_dtype=storage)
        assert 0 < strip_peak_rows() <= lay.m
        assert _eq(got, want[r])


@pytest.mark.parametrize("shape", MESHES)
def test_gathers_and_corner_invert_the_scatters(shape):
    lay, jlay = _lays(N_RAGGED, M, shape)
    a = _mat(N_RAGGED, 4)
    shards = [tj2.scatter_matrix_2d(a, lay, kr, kc)
              for kr, kc in _ranks(lay)]
    at = torch.from_numpy(a)
    assert torch.equal(tji.gather_inverse_inplace_2d(shards, lay,
                                                     N_RAGGED), at)
    storage = tj2.join_shards_2d(shards, lay)
    assert torch.equal(tji.gather_inverse_inplace_2d(storage, lay,
                                                     N_RAGGED), at)
    assert all(torch.equal(x, y) for x, y in
               zip(tj2.split_shards_2d(storage, lay), shards))
    # The JAX package's gather on the port's storage, and the corner.
    jgot = jji.gather_inverse_inplace_2d(jnp.asarray(storage.numpy()), jlay,
                                         N_RAGGED)
    assert np.array_equal(np.asarray(jgot), a)
    assert torch.equal(tji.inverse_corner_2d(shards, lay, N_RAGGED),
                       at[:10, :10])
    aug = [tj2.scatter_augmented_2d(a, lay, kr, kc)
           for kr, kc in _ranks(lay)]
    assert torch.equal(tj2.gather_inverse_2d(aug, lay, N_RAGGED),
                       torch.eye(N_RAGGED, dtype=torch.float64))
    assert all(torch.equal(tj2.split_inverse_blocks_2d(x, lay),
                           tj2.scatter_matrix_2d(np.eye(N_RAGGED), lay,
                                                 kr, kc)[:, :, :])
               for x, (kr, kc) in zip(aug, _ranks(lay)))
    b = np.random.default_rng(5).standard_normal((N_RAGGED, 2))
    xs = [tji.scatter_rhs_2d(b, lay, kr) for kr, _ in _ranks(lay)]
    assert torch.equal(tji.gather_solution_2d(xs, lay, N_RAGGED),
                       torch.from_numpy(b))


_RESID = {}
RESID_MESHES = [(2, 2), (1, 4), (4, 1)]
RESID_N = 40


def _residual_world():
    """Every mesh's SUMMA residual in one spawned world of 4 CPU ranks."""
    if _RESID:
        return _RESID
    a = _mat(RESID_N, 6) + RESID_N * np.eye(RESID_N)
    x = np.linalg.inv(a) + 1e-9 * _mat(RESID_N, 7)
    calls = [(tj2.residual_shards_2d, (a, x, shape, M))
             for shape in RESID_MESHES]
    res = run_workers(4, run_calls, calls, deadline_s=300, device_type="cpu")
    _RESID.update(a=a, x=x, res=res)
    return _RESID


@pytest.mark.parametrize("i,shape", list(enumerate(RESID_MESHES)))
def test_summa_residual_matches_jax(i, shape):
    w = _residual_world()
    a, x = w["a"], w["x"]
    got = [r[i] for r in w["res"]]
    assert len(set(got)) == 1               # the same float on every rank
    lay = jl.CyclicLayout2D.create(RESID_N, M, *shape)
    mesh = make_mesh_2d(*shape)
    want = float(jj2.distributed_residual_2d(
        jj2.scatter_matrix_2d(jnp.asarray(a), lay, mesh),
        jj2.scatter_matrix_2d(jnp.asarray(x), lay, mesh), mesh, lay))
    bound = (4 * np.finfo(np.float64).eps * RESID_N
             * np.abs(a).sum(1).max() * np.abs(x).sum(1).max())
    assert abs(got[0] - want) <= bound
    dense = np.abs(a @ x - np.eye(RESID_N)).sum(1).max()
    assert abs(got[0] - dense) <= bound


def test_jax_generate_rows_equal_port_shards():
    """The generated shard is the matching block of ops.generate, bit for
    bit (no n×n array on any rank)."""
    lay = CyclicLayout2D.create(N_RAGGED, M, 2, 3)
    full = np.asarray(jgenerate("rand", (N_RAGGED, N_RAGGED), jnp.float32))
    for kr, kc in _ranks(lay):
        got = tj2.sharded_generate_2d("rand", lay, kr, kc, torch.float32,
                                      augmented=False)
        want = tj2.scatter_matrix_2d(full, lay, kr, kc)
        assert torch.equal(got, want)
