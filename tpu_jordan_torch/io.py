"""Matrix file input and output.

Replacement for ``read_matrix`` (main.cpp:209-282): the file format is n*n
whitespace-separated decimal numbers, row-major.  ``read_matrix_file``
parses the whole file on the host (the single-device path);
:class:`MatrixStripReader` reads it one strip of rows at a time, so a rank
of the distributed path holds O(n·m) of it, never O(n²) (the reference's
root rank reads one block-row buffer at a time, main.cpp:242-276).  As in
the JAX package's ``io.py``, both parse with the native reader
(``native.py``: ``parse_matrix_text``, the ``MatrixStream`` chunked
strtod stream) when it can be built, else with the plain Python chunked
tokenizer, whose values are the same bits.  Which one ran is visible:
:func:`parser_in_use` ("native" or "python"), and each distributed rank's
strip witness carries it.

Error contract mirrors the reference's collective error codes
(main.cpp:231-237, 277): -1 "cannot open" -> FileNotFoundError, -2 "cannot
read" -> MatrixReadError.

The strip readers of this process keep a witness: the largest number of
rows one ``read_rows`` call ever held (:func:`strip_peak_rows`), which the
distributed path reports per rank.
"""

from __future__ import annotations

import numpy as np


class MatrixReadError(ValueError):
    """File exists but does not contain n*n parseable numbers (the
    reference's -2 "cannot read" path, main.cpp:255, 277)."""


_PEAK_ROWS = 0


def strip_peak_rows() -> int:
    """The most rows any :class:`MatrixStripReader` of this process held at
    once since the last :func:`reset_strip_peak`."""
    return _PEAK_ROWS


def reset_strip_peak() -> None:
    global _PEAK_ROWS, _LAST_PARSER
    _PEAK_ROWS = 0
    _LAST_PARSER = None


_LAST_PARSER: str | None = None


def parser_in_use() -> str:
    """"native" or "python": the parser this process's last read used
    (since :func:`reset_strip_peak`), else the one a read would use now."""
    if _LAST_PARSER is not None:
        return _LAST_PARSER
    from .native import available

    return "native" if available() else "python"


def _note_parser(name: str) -> None:
    global _LAST_PARSER
    _LAST_PARSER = name


def read_matrix_file(path: str, n: int, dtype=np.float64) -> np.ndarray:
    """Read an (n, n) matrix of whitespace-separated numbers from ``path``.

    Raises FileNotFoundError (reference -1) or MatrixReadError (-2).
    """
    try:
        from .native import parse_matrix_text

        vals = parse_matrix_text(path, n * n)
        _note_parser("native")
    except ImportError:
        vals = _read_tokens_python(path, n)
        _note_parser("python")
    if vals.size < n * n:
        raise MatrixReadError(f"cannot read {path}")
    return vals.reshape(n, n).astype(dtype)


def _read_tokens_python(path: str, n: int) -> np.ndarray:
    """The Python tokenizer's read of up to n·n numbers from ``path``."""
    try:
        with open(path) as fh:
            tokens = fh.read().split()
    except OSError as e:
        raise FileNotFoundError(f"cannot open {path}") from e
    try:
        return np.array(tokens[: n * n], dtype=np.float64)
    except ValueError as e:
        raise MatrixReadError(f"cannot read {path}") from e


def write_matrix_file(path: str, a) -> None:
    """Write a matrix in the reference's format (whitespace-separated,
    row-major, 17 significant digits, so the values round-trip): with the
    native writer (``native.write_matrix_text``) when it loads, else
    ``np.savetxt``; the two write the same text."""
    try:
        from .native import write_matrix_text

        write_matrix_text(path, a)
    except ImportError:
        np.savetxt(path, np.asarray(a), fmt="%.17g")


def read_matrix_corner(path: str, n: int, dtype=np.float64,
                       k: int = 10) -> np.ndarray:
    """Top-left min(n, k) corner of the matrix in ``path`` (the
    print_matrix gather, main.cpp:297-341), reading only its first k
    rows."""
    k = min(n, k)
    with MatrixStripReader(path, n, dtype) as reader:
        return np.ascontiguousarray(reader.read_rows(k)[:, :k])


class MatrixStripReader:
    """Incremental row-strip reader: ``read_rows(r)`` returns the next r
    full rows as an (r, n) array.  It pulls from the native stream
    (``native.MatrixStream``) when the library loads, else from the Python
    tokenizer, which reads the file ``_CHUNK`` characters at a time,
    carrying a token that straddles a chunk's end as the tail into the
    next chunk; ``parser`` says which.  A context manager; raises
    FileNotFoundError / MatrixReadError like ``read_matrix_file``."""

    _CHUNK = 1 << 20

    def __init__(self, path: str, n: int, dtype=np.float64):
        self.path = path
        self.n = n
        self.dtype = dtype
        self.max_rows = 0
        self._tail = ""
        self._pending: list[str] = []
        self._pos = 0
        self._native = None
        self._fh = None
        try:
            from .native import MatrixStream

            self._native = MatrixStream(path)
            self.parser = "native"
        except ImportError:
            self.parser = "python"
            try:
                self._fh = open(path)
            except OSError as e:
                raise FileNotFoundError(f"cannot open {path}") from e
        _note_parser(self.parser)

    def read_rows(self, nrows: int) -> np.ndarray:
        """Next ``nrows`` full rows as an (nrows, n) array."""
        global _PEAK_ROWS
        self.max_rows = max(self.max_rows, nrows)
        _PEAK_ROWS = max(_PEAK_ROWS, nrows)
        count = nrows * self.n
        vals = (self._native.read(count) if self._native is not None
                else self._read_tokens(count))
        if vals.size < count:
            raise MatrixReadError(f"cannot read {self.path}")
        return vals.reshape(nrows, self.n).astype(self.dtype)

    def _read_tokens(self, count: int) -> np.ndarray:
        out = np.empty(count, dtype=np.float64)
        got = 0
        while got < count:
            avail = len(self._pending) - self._pos
            if avail:
                take = min(count - got, avail)
                try:
                    out[got:got + take] = self._pending[
                        self._pos:self._pos + take]
                except ValueError as e:
                    raise MatrixReadError(
                        f"cannot read {self.path}") from e
                self._pos += take
                got += take
                continue
            chunk = self._fh.read(self._CHUNK)
            if not chunk:
                # Flush the carried partial token, then EOF.
                if self._tail:
                    self._pending, self._pos = [self._tail], 0
                    self._tail = ""
                    continue
                break
            data = self._tail + chunk
            if data[-1].isspace():
                self._tail = ""
                self._pending = data.split()
            else:
                toks = data.split()
                self._tail = toks.pop() if toks else ""
                self._pending = toks
            self._pos = 0
        return out[:got]

    def close(self):
        if self._native is not None:
            self._native.close()
        if self._fh is not None:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
