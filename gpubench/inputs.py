"""The inputs of a run, made on the device from ``--seed``.

Pool matrix ``j`` of a run is a (batch, n, n) stack with entries uniform
in [-1, 1), drawn by a ``torch.Generator`` on the device whose seed is
derived from (seed, j).  The same (seed, j) gives the same stack, so the
reference draws the program's inputs again instead of reading anything the
program held.
"""

from __future__ import annotations

import hashlib
import random

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def derive(seed: int, tag) -> int:
    """A 63-bit generator seed for ``tag`` of run ``seed`` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def matrix(seed: int, j: int, batch: int, n: int, dtype: torch.dtype,
           device) -> torch.Tensor:
    """Pool matrix ``j`` of run ``seed``: (batch, n, n), uniform [-1, 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, f"matrix{j}"))
    out = torch.empty((batch, n, n), dtype=dtype, device=device)
    return out.uniform_(-1.0, 1.0, generator=gen)


def sampler(seed: int) -> random.Random:
    """The generator that draws the judged sample of a run's answers."""
    return random.Random(derive(seed, "sample"))
