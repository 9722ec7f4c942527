"""ctypes bindings to the native (C++) matrix reader in ``native/``.
Counterpart of the JAX package's ``native.py``: the same C ABI
(``tj_parse_matrix_text``, ``tj_stream_*``, ``tj_write_matrix_text``) and
the same three entry points.

The JAX package loads the library ``make native`` built into its own
directory.  The port builds its own copy at first use, from
``native/matrix_io.cpp`` as it stands, with the host's ``g++``
(``_build.build_native``: ``-O3 -shared -fPIC`` into
``tpu_jordan_torch/build/``), as the CUDA kernels are built.  When it
cannot be built, :func:`library` raises ImportError, the JAX module's
signal, and ``io.py`` parses with its Python tokenizer; which parser ran
is visible (``io.parser_in_use``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_ERROR: str | None = None


def library() -> ctypes.CDLL:
    """The loaded native library, built first if need be; ImportError when
    it cannot be built (the reason is kept for every later call)."""
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            if _ERROR is not None:
                raise ImportError(_ERROR)
            from ._build import KernelCompileError, build_native

            try:
                lib = ctypes.CDLL(str(build_native()))
            except (KernelCompileError, OSError) as e:
                _ERROR = f"native matrix reader unavailable: {e}"
                raise ImportError(_ERROR) from e
            _bind(lib)
            _LIB = lib
    return _LIB


def available() -> bool:
    """True when the native library loads (building it if need be)."""
    try:
        library()
    except ImportError:
        return False
    return True


def _bind(lib) -> None:
    dp = ctypes.POINTER(ctypes.c_double)
    lib.tj_parse_matrix_text.restype = ctypes.c_long
    lib.tj_parse_matrix_text.argtypes = [ctypes.c_char_p, dp, ctypes.c_long]
    lib.tj_write_matrix_text.restype = ctypes.c_long
    lib.tj_write_matrix_text.argtypes = [ctypes.c_char_p, dp, ctypes.c_long,
                                         ctypes.c_long]
    lib.tj_stream_open.restype = ctypes.c_void_p
    lib.tj_stream_open.argtypes = [ctypes.c_char_p]
    lib.tj_stream_read.restype = ctypes.c_long
    lib.tj_stream_read.argtypes = [ctypes.c_void_p, dp, ctypes.c_long]
    lib.tj_stream_close.restype = None
    lib.tj_stream_close.argtypes = [ctypes.c_void_p]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class MatrixStream:
    """Handle-based streaming parser (``tj_stream_*``): ``read(count)``
    pulls up to ``count`` doubles with O(chunk) native memory, the
    reference's per-block-row fscanf loop (main.cpp:242-276)."""

    def __init__(self, path: str):
        self._h = None
        self._lib = library()
        self._h = self._lib.tj_stream_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open {path}")

    def read(self, count: int) -> np.ndarray:
        out = np.empty(count, dtype=np.float64)
        got = self._lib.tj_stream_read(self._h, _ptr(out), count)
        return out[:max(got, 0)]

    def close(self):
        if self._h:
            self._lib.tj_stream_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def parse_matrix_text(path: str, count: int) -> np.ndarray:
    """Parse up to ``count`` doubles from ``path``; FileNotFoundError when
    it cannot be opened; a short read returns what parsed (``io.py`` turns
    it into the reference's "cannot read")."""
    out = np.empty(count, dtype=np.float64)
    got = library().tj_parse_matrix_text(path.encode(), _ptr(out), count)
    if got < 0:
        raise FileNotFoundError(f"cannot open {path}")
    return out[:got]


def write_matrix_text(path: str, a) -> None:
    """Write ``a`` (2-D) in the reference's text format."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    rows, cols = a.shape
    if library().tj_write_matrix_text(path.encode(), _ptr(a), rows,
                                      cols) < 0:
        raise OSError(f"cannot write {path}")
