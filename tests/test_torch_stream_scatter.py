"""The streamed file input of the port's distributed path against the JAX
package's ``io.py`` and ``parallel/scatter_stream.py``.

  * ``io.MatrixStripReader``: the same strips as the JAX reader's (its pure
    Python tokenizer), bit for bit, also with a chunk of 7 characters (a
    token straddles every chunk boundary); a short file raises
    MatrixReadError, a missing one FileNotFoundError, in both.
  * ``read_matrix_corner``: exactly the JAX corner.
  * ``stream_scatter_1d``: each rank's (bpw, m, W) shard equals the
    matching device shard of the JAX ``stream_scatter_1d``, bit for bit:
    fp64, fp32 and bf16 storage, ``augmented`` True and False, ragged n,
    p ∈ {2, 3, 4}.
  * ``driver.solve(file=..., workers=4)``, gathered and not: the pivot
    sequence exactly the JAX plain engine's on the same matrix, the
    inverse within 16·eps·n·κ∞ of the JAX ``solve(file=..., workers=4)``,
    each rank's strip witness ≤ m (no rank held more than one strip of the
    file), the parent never parsing the whole file, and the verbose corner
    of A the JAX package's ``format_corner`` of its ``read_matrix_corner``;
    the CLI with a file at ``--workers 2``, a short file and a missing one,
    with the JAX CLI's exit codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec

import tpu_jordan.io as jio
from tpu_jordan import driver as jdriver
from tpu_jordan.__main__ import main as jmain
from tpu_jordan.config import eps_for as jeps
from tpu_jordan.parallel import make_mesh
from tpu_jordan.parallel import layout as jl
from tpu_jordan.parallel import sharded_inplace as jsi
from tpu_jordan.parallel.ring_gemm import _to_identity_padded_blocks
from tpu_jordan.parallel.scatter_stream import stream_scatter_1d as jstream

import tpu_jordan_torch.driver as tdriver
import tpu_jordan_torch.io as tio
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.interop import join_cyclic_blocks, split_cyclic_blocks
from tpu_jordan_torch.parallel import layout as tl
from tpu_jordan_torch.parallel.scatter_stream import stream_scatter_1d

SHARD_SIZES = {2: (18, 4), 3: (22, 4), 4: (18, 4)}
STORAGE = {"float64": (jnp.float64, None, "float64", None),
           "float32": (jnp.float32, None, "float32", None),
           "bfloat16": (jnp.float32, jnp.bfloat16, "float32", "bfloat16")}


def _write(tmp_path, n, seed=0, name=None):
    a = np.random.default_rng(seed).standard_normal((n, n))
    path = str(tmp_path / (name or f"m{n}_{seed}.txt"))
    tio.write_matrix_file(path, a)
    return path, np.loadtxt(path)


def _jax_reader_py(path, n, chunk, monkeypatch):
    """The JAX reader forced onto its pure Python tokenizer."""
    monkeypatch.setattr(jio.MatrixStripReader, "_CHUNK", chunk)
    r = jio.MatrixStripReader.__new__(jio.MatrixStripReader)
    r.path, r.n, r.dtype = path, n, np.float64
    r._native, r._tail, r._pending = None, "", []
    r._fh = open(path)
    return r


@pytest.mark.parametrize("chunk", [1 << 20, 7])
def test_strips_equal_the_jax_reader(tmp_path, monkeypatch, chunk):
    path, _ = _write(tmp_path, 12)
    monkeypatch.setattr(tio.MatrixStripReader, "_CHUNK", chunk)
    jr = _jax_reader_py(path, 12, chunk, monkeypatch)
    with tio.MatrixStripReader(path, 12) as tr:
        for rows in (5, 1, 6):
            np.testing.assert_array_equal(tr.read_rows(rows),
                                          jr.read_rows(rows))
        assert tr.max_rows == 6
    jr.close()


def test_short_and_missing_files_raise_as_in_jax(tmp_path, monkeypatch):
    short = tmp_path / "short.txt"
    short.write_text("1.0 2.0 3.0\n")
    with tio.MatrixStripReader(str(short), 4) as r:
        with pytest.raises(tio.MatrixReadError):
            r.read_rows(4)
    with pytest.raises(jio.MatrixReadError):
        _jax_reader_py(str(short), 4, 1 << 20, monkeypatch).read_rows(4)
    bad = tmp_path / "bad.txt"
    bad.write_text("1.0 x 3.0 4.0\n")
    with tio.MatrixStripReader(str(bad), 2) as r:
        with pytest.raises(tio.MatrixReadError):
            r.read_rows(2)
    with pytest.raises(FileNotFoundError):
        tio.MatrixStripReader(str(tmp_path / "none.txt"), 4)
    with pytest.raises(FileNotFoundError):
        jio.MatrixStripReader(str(tmp_path / "none.txt"), 4)


@pytest.mark.parametrize("n", [16, 7])
def test_corner_equals_jax(tmp_path, n):
    path, _ = _write(tmp_path, n)
    tio.reset_strip_peak()
    np.testing.assert_array_equal(tio.read_matrix_corner(path, n),
                                  jio.read_matrix_corner(path, n))
    assert tio.strip_peak_rows() == min(n, 10)


SHARD_CASES = [(p, st, aug) for p in SHARD_SIZES for st in STORAGE
               for aug in (False, True)]


@pytest.mark.parametrize("p,storage,augmented", SHARD_CASES,
                         ids=[f"p{p}-{st}-{'aug' if a else 'inplace'}"
                              for p, st, a in SHARD_CASES])
def test_rank_shards_equal_jax_device_shards(tmp_path, p, storage,
                                             augmented):
    n, m = SHARD_SIZES[p]
    path, _ = _write(tmp_path, n, seed=p)
    jdt, jst, tdt, tst = STORAGE[storage]
    got_j = jstream(path, jl.CyclicLayout.create(n, m, p), make_mesh(p),
                    jdt, augmented, storage_dtype=jst)
    want = split_cyclic_blocks(np.asarray(got_j), p)
    lay = tl.CyclicLayout.create(n, m, p)
    for k in range(p):
        tio.reset_strip_peak()
        shard = stream_scatter_1d(path, lay, k, tdt, augmented,
                                  storage_dtype=tst)
        assert shard.dtype.itemsize == want[k].dtype.itemsize
        np.testing.assert_array_equal(shard.numpy(), want[k])
        assert 0 < tio.strip_peak_rows() <= m


def _jax_pivots(a, m, p):
    """The JAX plain engine's swap record on ``a``, from its segment
    executable."""
    mesh = make_mesh(p)
    lay = jl.CyclicLayout.create(a.shape[0], m, p)
    blocks = _to_identity_padded_blocks(jnp.asarray(a), lay, mesh)
    sing = jax.device_put(jnp.zeros((p,), bool),
                          NamedSharding(mesh, PartitionSpec("p")))
    sw = jax.device_put(jnp.zeros((p, lay.Nr), jnp.int32),
                        NamedSharding(mesh, PartitionSpec("p", None)))
    _, _, sw = jsi._sharded_jordan_inplace_segment(
        blocks, sing, sw, mesh, lay, 0, lay.Nr, jeps(blocks.dtype),
        lax.Precision.HIGHEST, False, True)
    return np.asarray(sw)[0].tolist()


@pytest.fixture
def forbid_whole_parse(monkeypatch):
    """The p > 1 path never parses the whole file in this process (the
    ranks report their own witness)."""
    def boom(*a, **k):
        raise AssertionError("whole-matrix host parse on the streaming "
                             "path")
    monkeypatch.setattr(tio, "read_matrix_file", boom)
    monkeypatch.setattr(tdriver, "read_matrix_file", boom)


@pytest.mark.parametrize("gather", [True, False])
def test_driver_file_solve_matches_jax(tmp_path, forbid_whole_parse, capsys,
                                       gather):
    n, m, p = 36, 8, 4
    path, a = _write(tmp_path, n, seed=3)
    res = tdriver.solve(n, m, file=path, workers=p, gather=gather,
                        dtype="float64", device="cpu", verbose=gather)
    out = capsys.readouterr().out
    ref = jdriver.solve(n, m, file=path, workers=p, gather=gather,
                        dtype=jnp.float64)
    jpiv = _jax_pivots(a, m, p)
    assert all(r["pivots"] == jpiv for r in res.ranks)
    assert all(0 < r["strip_rows_max"] <= m for r in res.ranks)
    eps = np.finfo(np.float64).eps
    if gather:
        tinv, jinv = res.inverse.numpy(), np.asarray(ref.inverse)
        assert res.inverse_blocks is None
        # The corner of A printed from the file's first rows.
        lines = out.splitlines()
        corner = lines[lines.index("A") + 1:lines.index("A") + 11]
        from tpu_jordan.utils.printing import format_corner

        assert corner == format_corner(
            jnp.asarray(jio.read_matrix_corner(path, n))).splitlines()
        assert f"residual: {res.residual:e}" in out
    else:
        assert res.inverse is None and len(res.inverse_blocks) == p
        tinv = join_cyclic_blocks(res.inverse_blocks)
        jinv = np.asarray(ref.inverse_blocks)
    kappa = ref.kappa
    diff = np.abs(tinv - jinv).max() / np.abs(jinv).max()
    assert diff <= 16 * eps * n * kappa
    assert res.residual <= 16 * eps * n * kappa * res._norm_a


def test_cli_file_workers_in_both(tmp_path, capsys):
    path, _ = _write(tmp_path, 24, seed=5)
    argv = ["24", "8", path, "--workers", "2", "--dtype", "float64"]
    assert jmain(argv) == 0
    capsys.readouterr()
    assert tmain(argv + ["--device", "cpu"]) == 0
    assert "on cpu x2 (gloo)" in capsys.readouterr().out
    short = tmp_path / "short.txt"
    short.write_text("1 2 3\n")
    for main in (jmain, lambda v: tmain(v + ["--device", "cpu"])):
        assert main(["24", "8", str(short), "--workers", "2"]) == 2
        assert main(["24", "8", str(tmp_path / "none.txt"),
                     "--workers", "2"]) == 2
