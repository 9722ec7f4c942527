"""The port's foundations against the JAX package, on the CPU: numeric
configuration, generators (bit-equal), padding, norms and file input."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan import config as jconfig
from tpu_jordan import io as jio
from tpu_jordan.ops import generate as jgenerate
from tpu_jordan.ops import norms as jnorms
from tpu_jordan.ops import padding as jpadding

from tpu_jordan_torch import config as tconfig
from tpu_jordan_torch import io as tio
from tpu_jordan_torch.interop import from_numpy
from tpu_jordan_torch.ops import generate as tgenerate
from tpu_jordan_torch.ops import norms as tnorms
from tpu_jordan_torch.ops import padding as tpadding

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


@pytest.mark.parametrize("n", [8, 100, 512, 8192])
def test_default_block_size_matches(n):
    assert tconfig.default_block_size(n) == jconfig.default_block_size(n)


@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_eps_for_matches(np_dt, t_dt):
    assert tconfig.eps_for(t_dt) == jconfig.eps_for(np_dt)


@pytest.mark.parametrize("name", ["absdiff", "hilbert", "identity", "rand",
                                  "kms"])
@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
@pytest.mark.parametrize("offsets", [(0, 0), (5, 11), (70001, 3)])
def test_generator_bit_equal(name, np_dt, t_dt, offsets):
    """Every ported fixture gives the JAX package's bits (tolerance 0) on
    a ragged 37x37 window; the large offset drives the rand hash's
    multiplies past 2**32."""
    ro, co = offsets
    ref = np.asarray(jgenerate(name, (37, 37), np_dt, row_offset=ro,
                               col_offset=co))
    got = tgenerate(name, (37, 37), t_dt, row_offset=ro, col_offset=co)
    assert got.dtype == t_dt
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generator_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown generator"):
        tgenerate("zrand", (4, 4))


@pytest.mark.parametrize("n,N", [(5, 8), (8, 8)])
def test_pad_unpad_match(n, N):
    a = np.random.default_rng(1).standard_normal((n, n))
    ref = np.asarray(jpadding.pad_with_identity(jnp.asarray(a), N))
    got = tpadding.pad_with_identity(torch.from_numpy(a), N)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tpadding.unpad(got, n).numpy(), a)


def test_pad_down_raises():
    with pytest.raises(ValueError):
        tpadding.pad_with_identity(torch.zeros(4, 4), 3)


def test_norms_match():
    """Row-sum norms in fp64: the two frameworks may sum in another order,
    so the tolerance is a few ulps (rtol 1e-14)."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((24, 24))
    inv = np.linalg.inv(a)
    blocks = rng.standard_normal((3, 8, 8))
    t = torch.from_numpy
    np.testing.assert_allclose(float(tnorms.inf_norm(t(a))),
                               float(jnorms.inf_norm(jnp.asarray(a))),
                               rtol=1e-14)
    np.testing.assert_allclose(
        tnorms.block_inf_norms(t(blocks)).numpy(),
        np.asarray(jnorms.block_inf_norms(jnp.asarray(blocks))), rtol=1e-14)
    np.testing.assert_allclose(
        float(tnorms.condition_inf(t(a), t(inv))),
        float(jnorms.condition_inf(jnp.asarray(a), jnp.asarray(inv))),
        rtol=1e-14)


def test_read_matrix_file_reads_what_jax_wrote(tmp_path):
    a = np.random.default_rng(3).standard_normal((6, 6))
    path = str(tmp_path / "a.txt")
    jio.write_matrix_file(path, a)
    np.testing.assert_array_equal(tio.read_matrix_file(path, 6), a)
    np.testing.assert_array_equal(tio.read_matrix_file(path, 6),
                                  jio.read_matrix_file(path, 6))


@pytest.mark.parametrize("content", [None, "1 2 3", "1 2 x 4"])
def test_read_matrix_file_error_kinds_match(tmp_path, content):
    """A missing file is FileNotFoundError, too few or unparseable numbers
    MatrixReadError, in both packages."""
    path = str(tmp_path / "m.txt")
    if content is not None:
        with open(path, "w") as fh:
            fh.write(content)
    jexc, texc = ((FileNotFoundError, FileNotFoundError) if content is None
                  else (jio.MatrixReadError, tio.MatrixReadError))
    with pytest.raises(jexc):
        jio.read_matrix_file(path, 2)
    with pytest.raises(texc):
        tio.read_matrix_file(path, 2)


def test_format_corner_matches_jax():
    from tpu_jordan.utils.printing import format_corner as jformat
    from tpu_jordan_torch.utils.printing import format_corner as tformat

    a = np.random.default_rng(4).standard_normal((12, 12))
    assert tformat(torch.from_numpy(a)) == jformat(a)
    assert tformat(torch.from_numpy(a[:3, :3])) == jformat(a[:3, :3])


def test_from_numpy_keeps_values_and_casts():
    a = np.arange(6.0).reshape(2, 3)
    t = from_numpy(a, "cpu")
    assert t.dtype == torch.float64
    np.testing.assert_array_equal(t.numpy(), a)
    t32, t64 = from_numpy([a, a], "cpu", "float32")
    assert t32.dtype == t64.dtype == torch.float32
