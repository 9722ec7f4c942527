"""Pretty-printing of matrix corners.

Replaces ``print_matrix`` / ``print_row`` (main.cpp:284-341): the top-left
min(n, MAX_P)-corner, printed with ``"%.2f\\t"`` per element (a complex
element as ``re+imi``).  Only the corner is copied to the host.
"""

from __future__ import annotations

import torch

from ..config import MAX_PRINT


def format_corner(a, max_p: int = MAX_PRINT) -> str:
    """Format the top-left corner like the reference (main.cpp:284-295)."""
    nm = min(a.shape[0], max_p)
    corner = a[:nm, :nm].detach().cpu()
    if corner.is_complex():
        corner = corner.to(torch.complex128).numpy()
        return "\n".join(
            "".join(f"{z.real:.2f}{z.imag:+.2f}i\t" for z in row)
            for row in corner)
    corner = corner.double().numpy()
    return "\n".join(
        "".join(f"{float(corner[i, j]):.2f}\t" for j in range(nm))
        for i in range(nm))


def print_corner(a, max_p: int = MAX_PRINT) -> None:
    print(format_corner(a, max_p))
