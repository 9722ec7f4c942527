"""The port's native matrix reader (``native.py``: ``native/matrix_io.cpp``
built with the host's ``g++`` into ``tpu_jordan_torch/build/``) against the
JAX package's ``tpu_jordan.io.read_matrix_file`` and the port's own Python
tokenizer (mirrors ``tests/test_native.py``): the round trip, the match to
the Python parse, the missing file, the short file, garbage, and the
chunk-boundary and fuzz cases of the stream.  The port never loads the
JAX package's ``_native.so``.  Without ``g++`` the file skips with its
reason, as the JAX test does without ``make``.
"""

import shutil

import numpy as np
import pytest

from tpu_jordan import io as jio

from tpu_jordan_torch import io as tio


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no g++ on this host: the native reader cannot be built")
    from tpu_jordan_torch import native as mod

    mod.library()
    return mod


def _python_stream(path, count):
    """The port's Python tokenizer through the real reader."""
    with tio.MatrixStripReader.__new__(tio.MatrixStripReader) as r:
        r.path, r.n, r.dtype, r.max_rows = path, count, np.float64, 0
        r._tail, r._pending, r._pos = "", [], 0
        r._native, r.parser = None, "python"
        r._fh = open(path)
        return r._read_tokens(count)


def _native_stream(native, path, count):
    s = native.MatrixStream(path)
    try:
        return s.read(count)
    finally:
        s.close()


def _assert_stream_matches_fallback(native, path, count):
    got_native = _native_stream(native, path, count)
    got_py = _python_stream(path, count)
    assert got_native.size == got_py.size == count
    np.testing.assert_array_equal(got_native, got_py)


class TestNativeParser:
    def test_library_is_the_ports_own(self, native):
        from tpu_jordan_torch import _build

        path = _build.native_library_path()
        assert path.parent == _build.BUILD and path.exists()
        assert path.name != "_native.so"

    def test_roundtrip(self, native, rng, tmp_path):
        a = rng.standard_normal((30, 30))
        p = str(tmp_path / "m.txt")
        native.write_matrix_text(p, a)
        b = native.parse_matrix_text(p, 900).reshape(30, 30)
        np.testing.assert_array_equal(a, b)

    def test_matches_python_parse(self, native, rng, tmp_path):
        a = rng.standard_normal(100)
        p = tmp_path / "v.txt"
        p.write_text(" ".join(repr(float(x)) for x in a))
        v = native.parse_matrix_text(str(p), 100)
        np.testing.assert_array_equal(v, a)

    def test_missing_file(self, native, tmp_path):
        with pytest.raises(FileNotFoundError):
            native.parse_matrix_text(str(tmp_path / "nope"), 4)
        with pytest.raises(FileNotFoundError):
            native.MatrixStream(str(tmp_path / "nope"))

    def test_short_and_garbage(self, native, tmp_path):
        p = tmp_path / "s.txt"
        p.write_text("1.5 2.5 and then garbage")
        v = native.parse_matrix_text(str(p), 10)
        assert list(v) == [1.5, 2.5]

    def test_stream_long_whitespace_at_chunk_boundary(self, native, rng,
                                                      tmp_path):
        chunk = 1 << 20
        vals = rng.standard_normal(64)
        head = " ".join("%.17g" % v for v in vals[:32])
        pad = " " * (chunk - len(head) - 100)
        body = head + pad + " " * 4096 + " ".join(
            "%.17g" % v for v in vals[32:])
        p = tmp_path / "ws.txt"
        p.write_text(body)
        _assert_stream_matches_fallback(native, str(p), 64)

    def test_stream_giant_whitespace_run(self, native, tmp_path):
        p = tmp_path / "giant_ws.txt"
        p.write_text("1.25" + "\n" * ((1 << 20) + (1 << 19)) + "2.5")
        _assert_stream_matches_fallback(native, str(p), 2)

    def test_stream_long_token_at_chunk_boundary(self, native, tmp_path):
        chunk = 1 << 20
        long_num = "0." + "5" * 200
        head = "1 " * ((chunk - 50) // 2)
        p = tmp_path / "long_tok.txt"
        p.write_text(head + long_num + " 3.5")
        n = len(head) // 2 + 2
        _assert_stream_matches_fallback(native, str(p), n)

    def test_stream_garbage_tail_at_chunk_boundary(self, native, tmp_path):
        chunk = 1 << 20
        head = "2 " * ((chunk - 20) // 2)
        p = tmp_path / "garbage.txt"
        p.write_text(head + "certainly_not_a_number " + "4 " * 100)
        n_good = len(head) // 2
        got = _native_stream(native, str(p), n_good + 50)
        assert got.size == n_good
        assert all(got == 2.0)

    def test_stream_fuzz_random_whitespace_layout(self, native, rng,
                                                  tmp_path):
        parts, count, size = [], 0, 0
        target = (1 << 20) * 3 + 12345
        while size < target:
            tok = "%.17g" % rng.standard_normal()
            ws = rng.choice([" ", "\n", "\t", "  \n", " " * 500,
                             "\r\n" * 40])
            parts.append(tok + ws)
            size += len(tok) + len(ws)
            count += 1
        p = tmp_path / "fuzz.txt"
        p.write_text("".join(parts))
        _assert_stream_matches_fallback(native, str(p), count)


class TestIoThroughTheNativeReader:
    """``io.read_matrix_file`` and ``io.MatrixStripReader`` parse with the
    native reader, bit for bit the JAX package's read."""

    def test_read_matrix_file_equals_jax(self, native, rng, tmp_path):
        a = rng.standard_normal((37, 37))
        p = str(tmp_path / "a.txt")
        tio.write_matrix_file(p, a)
        tio.reset_strip_peak()
        got = tio.read_matrix_file(p, 37)
        assert tio.parser_in_use() == "native"
        np.testing.assert_array_equal(got, jio.read_matrix_file(p, 37))
        np.testing.assert_array_equal(got, a)

    def test_strip_reader_is_native_and_equals_jax(self, native, rng,
                                                   tmp_path):
        a = rng.standard_normal((24, 24))
        p = str(tmp_path / "b.txt")
        tio.write_matrix_file(p, a)
        with tio.MatrixStripReader(p, 24) as r:
            assert r.parser == "native"
            strips = [r.read_rows(8) for _ in range(3)]
        np.testing.assert_array_equal(np.concatenate(strips),
                                      jio.read_matrix_file(p, 24))
        with tio.MatrixStripReader(p, 24) as r:
            assert np.array_equal(r.read_rows(24), a)

    def test_errors_keep_the_reference_codes(self, native, tmp_path):
        with pytest.raises(FileNotFoundError):
            tio.read_matrix_file(str(tmp_path / "missing"), 4)
        with pytest.raises(FileNotFoundError):
            tio.MatrixStripReader(str(tmp_path / "missing"), 4)
        p = tmp_path / "short.txt"
        p.write_text("1 2 3")
        with pytest.raises(tio.MatrixReadError):
            tio.read_matrix_file(str(p), 2)
        with pytest.raises(tio.MatrixReadError):
            with tio.MatrixStripReader(str(p), 2) as r:
                r.read_rows(2)
        p.write_text("1 2 x 4")
        with pytest.raises(tio.MatrixReadError):
            tio.read_matrix_file(str(p), 2)

    def test_python_fallback_when_the_library_is_missing(self, rng, tmp_path,
                                                         monkeypatch):
        from tpu_jordan_torch import native as mod

        a = rng.standard_normal((10, 10))
        p = str(tmp_path / "c.txt")
        tio.write_matrix_file(p, a)

        def missing():
            raise ImportError("native matrix reader unavailable: test")

        monkeypatch.setattr(mod, "library", missing)
        tio.reset_strip_peak()
        np.testing.assert_array_equal(tio.read_matrix_file(p, 10), a)
        assert tio.parser_in_use() == "python"
        with tio.MatrixStripReader(p, 10) as r:
            assert r.parser == "python"
            np.testing.assert_array_equal(r.read_rows(10), a)

    def test_ranks_witness_the_parser(self, native, tmp_path):
        from tpu_jordan_torch import driver as tdriver

        a = np.random.default_rng(5).standard_normal((24, 24)) + 24 * np.eye(24)
        p = str(tmp_path / "d.txt")
        tio.write_matrix_file(p, a)
        res = tdriver.solve(24, 8, file=p, workers=2, dtype="float64",
                            device="cpu")
        assert [r["parser"] for r in res.ranks] == ["native", "native"]
        assert res.residual < 1e-10
