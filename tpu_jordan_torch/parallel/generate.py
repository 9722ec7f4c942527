"""Rank-local matrix generation: each rank builds its own cyclic strip.
Counterpart of the JAX package's ``parallel/generate.py``.

Parity with ``init_matrix`` (main.cpp:128-149): the reference fills each
rank's strip from the generator formula with no communication, walking
local to global indices.  Here rank k materializes its (bpw, m, N) block
rows of the identity-padded global matrix (global block row ``s·p + k`` at
slot s) on its own device, so a generated distributed solve never holds an
n×n array anywhere.  The values are the generator's on the same int32 index
grids, so the bits equal the matching rows of ``ops.generate``.
"""

from __future__ import annotations

import torch

from ..ops.generators import GENERATORS
from .layout import CyclicLayout


def sharded_generate(fn_name: str, lay: CyclicLayout, rank: int,
                     dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Rank ``rank``'s (bpw, m, N) blocks of the identity-padded matrix of
    generator ``fn_name``: outside the n×n window A continues as I, which
    inverts to I (``ops/padding.py``)."""
    from ..interop import resolve_dtype

    dtype = resolve_dtype(dtype)
    fn = GENERATORS[fn_name]
    p, m, bpw, N, n = lay.p, lay.m, lay.blocks_per_worker, lay.N, lay.n
    gblk = torch.arange(bpw, dtype=torch.int32, device=device) * p + rank
    gi = (gblk[:, None] * m
          + torch.arange(m, dtype=torch.int32, device=device)[None, :])
    gi = gi[:, :, None].expand(bpw, m, N)                 # (bpw, m, N)
    gj = torch.arange(N, dtype=torch.int32, device=device)[None, None, :]
    gj = gj.expand(bpw, m, N)
    vals = fn(gi, gj).to(dtype)
    eye = (gi == gj).to(dtype)
    return torch.where((gi < n) & (gj < n), vals, eye)


def generate_shard(group, fn_name: str, lay: CyclicLayout,
                   dtype=torch.float32) -> torch.Tensor:
    """:func:`sharded_generate` of this rank on its device, returned on the
    CPU."""
    return sharded_generate(fn_name, lay, group.rank, dtype,
                            group.device).cpu()
