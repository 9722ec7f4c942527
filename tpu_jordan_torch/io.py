"""Matrix file input.

Replacement for ``read_matrix`` (main.cpp:209-282): the file format is n*n
whitespace-separated decimal numbers, row-major.  This is the plain Python
token reader; the file is parsed on the host and the caller moves the array
to its device.

Error contract mirrors the reference's collective error codes
(main.cpp:231-237, 277): -1 "cannot open" -> FileNotFoundError, -2 "cannot
read" -> MatrixReadError.
"""

from __future__ import annotations

import numpy as np


class MatrixReadError(ValueError):
    """File exists but does not contain n*n parseable numbers (the
    reference's -2 "cannot read" path, main.cpp:255, 277)."""


def read_matrix_file(path: str, n: int, dtype=np.float64) -> np.ndarray:
    """Read an (n, n) matrix of whitespace-separated numbers from ``path``.

    Raises FileNotFoundError (reference -1) or MatrixReadError (-2).
    """
    try:
        with open(path) as fh:
            tokens = fh.read().split()
    except OSError as e:
        raise FileNotFoundError(f"cannot open {path}") from e
    if len(tokens) < n * n:
        raise MatrixReadError(f"cannot read {path}")
    try:
        vals = np.array(tokens[: n * n], dtype=np.float64)
    except ValueError as e:
        raise MatrixReadError(f"cannot read {path}") from e
    return vals.reshape(n, n).astype(dtype)
