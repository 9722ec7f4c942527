"""The 2D block-cyclic helpers: each rank's shard of a matrix, generated or
cut from a whole one, the gathers back, and the SUMMA residual.
Counterpart of the front ends and the residual of the JAX package's
``parallel/jordan2d.py`` (its own augmented engine is ROADMAP.md Queue A
item 15d).

Rank (kr, kc) of a (pr, pc) mesh holds ``(bpr, m, Wc)``: its slot s is
global block row ``s·pr + kr`` and its chunk u (m columns) global column
block ``u·pc + kc`` (``layout.CyclicLayout2D``).  The JAX package keeps
one global (Nr, m, W) array in cyclic storage order on both axes, sharded
``P("pr", None, "pc")``: rank (kr, kc)'s shard is its rows
``[kr·bpr, (kr+1)·bpr)`` and columns ``[kc·Wc, (kc+1)·Wc)``
(:func:`join_shards_2d` / :func:`split_shards_2d` convert).  A scatter or
generate helper here is a function of one rank: it builds only that
rank's shard.  The global tensor is assembled only by the gathers.

The SUMMA residual (:func:`distributed_residual_2d`): at step k the owner
mesh column broadcasts A's k-panel on the row communicator and the owner
mesh row the inverse's k-panel on the column communicator; one local GEMM
accumulates.  Row sums are summed on the row communicator (a row is split
over the mesh columns), then a world ``all_reduce(MAX)``: only a scalar
leaves the ranks (main.cpp:490-513).  Its GEMMs are its own
(``torch.addmm``): nothing is shared with the engine it verifies.
"""

from __future__ import annotations

import torch

from .layout import CyclicLayout2D


def _perms(lay: CyclicLayout2D, ncb: int):
    """(row storage order, column storage order) of ``ncb`` column blocks
    as ``torch.long`` tensors."""
    return (torch.as_tensor(lay.row_perm(), dtype=torch.long),
            torch.as_tensor(lay.col_perm(ncb), dtype=torch.long))


def _inv_perm(p: torch.Tensor) -> torch.Tensor:
    """The inverse of the permutation ``p``."""
    inv = torch.empty_like(p)
    inv[p] = torch.arange(p.shape[0], dtype=p.dtype, device=p.device)
    return inv


def _own_blocks(x4: torch.Tensor, lay: CyclicLayout2D, kr: int,
                kc: int) -> torch.Tensor:
    """Rank (kr, kc)'s (bpr, m, bc·m) shard of a natural-order (Nr, m,
    ncb, m) block tensor: rows ``kr::pr``, column blocks ``kc::pc``."""
    own = x4[kr::lay.pr][:, :, kc::lay.pc]
    return own.reshape(own.shape[0], lay.m, -1).contiguous()


def scatter_matrix_2d(a, lay: CyclicLayout2D, kr: int,
                      kc: int) -> torch.Tensor:
    """Rank (kr, kc)'s (bpr, m, N/pc) shard of the identity-padded (n, n)
    ``a`` (a tensor or numpy array).  Counterpart of the JAX package's
    ``scatter_matrix_2d`` (the whole sharded array there)."""
    from ..ops.padding import pad_with_identity

    a = torch.as_tensor(a)
    x4 = pad_with_identity(a, lay.N).reshape(lay.Nr, lay.m, lay.Nr, lay.m)
    return _own_blocks(x4, lay, kr, kc)


def scatter_augmented_2d(a, lay: CyclicLayout2D, kr: int,
                         kc: int) -> torch.Tensor:
    """Rank (kr, kc)'s (bpr, m, 2N/pc) shard of the padded [A | I].
    Counterpart of the JAX package's ``scatter_augmented_2d``."""
    from ..ops.padding import pad_with_identity

    a = torch.as_tensor(a)
    W = torch.cat([pad_with_identity(a, lay.N),
                   torch.eye(lay.N, dtype=a.dtype)], dim=1)
    return _own_blocks(W.reshape(lay.Nr, lay.m, 2 * lay.Nr, lay.m), lay,
                       kr, kc)


def join_shards_2d(shards, lay: CyclicLayout2D) -> torch.Tensor:
    """The (Nr, m, W) global storage tensor (cyclic order on both axes,
    the JAX package's array) from the ranks' shards in rank order."""
    shards = [torch.as_tensor(s) for s in shards]
    rows = [torch.cat(shards[kr * lay.pc:(kr + 1) * lay.pc], dim=2)
            for kr in range(lay.pr)]
    return torch.cat(rows, dim=0)


def split_shards_2d(storage, lay: CyclicLayout2D) -> list:
    """The inverse of :func:`join_shards_2d`: rank order, each shard
    contiguous."""
    storage = torch.as_tensor(storage)
    wc = storage.shape[-1] // lay.pc
    return [storage[kr * lay.bpr:(kr + 1) * lay.bpr, :,
                    kc * wc:(kc + 1) * wc].contiguous()
            for kr in range(lay.pr) for kc in range(lay.pc)]


def _natural(out, lay: CyclicLayout2D, ncb: int) -> torch.Tensor:
    """Storage order (a tensor, or the shards in rank order) to the natural
    (N, ncb·m) matrix."""
    if not isinstance(out, torch.Tensor):
        out = join_shards_2d(out, lay)
    blocks = out.reshape(lay.Nr, lay.m, ncb, lay.m)
    rowp, colp = _perms(lay, ncb)
    blocks = blocks.index_select(0, _inv_perm(rowp).to(out.device))
    blocks = blocks.index_select(2, _inv_perm(colp).to(out.device))
    return blocks.reshape(lay.N, ncb * lay.m)


def gather_inverse_2d(out, lay: CyclicLayout2D, n: int) -> torch.Tensor:
    """The (n, n) inverse from the augmented [I | A⁻¹] storage (a tensor,
    or the shards in rank order): natural order, the B half, unpadded.
    Counterpart of the JAX package's ``gather_inverse_2d``."""
    return _natural(out, lay, 2 * lay.Nr)[:n, lay.N:lay.N + n]


def gather_matrix_2d(out, lay: CyclicLayout2D, n: int) -> torch.Tensor:
    """The (n, n) matrix from an unaugmented storage (a tensor, or the
    shards in rank order): natural order, unpadded."""
    return _natural(out, lay, lay.Nr)[:n, :n]


def sharded_generate_2d(fn_name: str, lay: CyclicLayout2D, kr: int, kc: int,
                        dtype=torch.float32, augmented: bool = True,
                        device="cpu") -> torch.Tensor:
    """Rank (kr, kc)'s shard of generator ``fn_name``'s identity-padded
    matrix (with ``augmented``, of [A | I]) from global indices on
    ``device``: no host copy of the matrix, no communication
    (init_matrix, main.cpp:128-149).  The values are the generator's on
    the same int32 index grids as the JAX package's
    ``sharded_generate_2d``, bit for bit."""
    from ..interop import resolve_dtype
    from ..ops.generators import GENERATORS

    dtype = resolve_dtype(dtype)
    fn = GENERATORS[fn_name]
    n, m, N = lay.n, lay.m, lay.N
    ncb = 2 * lay.Nr if augmented else lay.Nr
    bc = ncb // lay.pc
    i32 = dict(dtype=torch.int32, device=device)
    gi = ((torch.arange(lay.bpr, **i32) * lay.pr + kr)[:, None] * m
          + torch.arange(m, **i32)[None, :])[:, :, None, None]
    gcb = torch.arange(bc, **i32) * lay.pc + kc
    gj = (gcb[:, None] * m + torch.arange(m, **i32)[None, :])[None, None]
    shape = (lay.bpr, m, bc, m)
    gi, gj = gi.expand(shape), gj.expand(shape)
    eye_a = (gi == gj).to(dtype)
    part = torch.where((gi < n) & (gj < n), fn(gi, gj).to(dtype), eye_a)
    if augmented:
        part = torch.where(gj < N, part, (gi == gj - N).to(dtype))
    return part.reshape(lay.bpr, m, bc * m)


def split_inverse_blocks_2d(out_shard: torch.Tensor,
                            lay: CyclicLayout2D) -> torch.Tensor:
    """The B half of a rank's augmented shard: Nr is a multiple of pc, so
    its B chunks are its last bc1 chunks, a local slice.  Counterpart of
    the JAX package's ``split_inverse_blocks_2d``."""
    return out_shard[:, :, lay.bc1 * lay.m:]


def distributed_residual_2d(a_loc, b_loc, mg, lay: CyclicLayout2D) -> float:
    """‖A·B − I‖∞ from this rank's identity-padded 2D shards of A and B
    (module docstring), the same float on every rank of the mesh ``mg``.
    Counterpart of the JAX package's ``distributed_residual_2d``."""
    pr, pc, m, bpr = lay.pr, lay.pc, lay.m, lay.bpr
    kr, kc = mg.kr, mg.kc
    wc = b_loc.shape[-1]
    d = a_loc.new_zeros((bpr * m, wc))
    for kb in range(lay.Nr):
        own_c, u = kc == kb % pc, kb // pc
        a_panel = (a_loc[:, :, u * m:(u + 1) * m].contiguous() if own_c
                   else a_loc.new_empty((bpr, m, m)))
        mg.row.broadcast(a_panel, mg.rank_of(kr, kb % pc))
        b_panel = (b_loc[kb // pr].clone() if kr == kb % pr
                   else b_loc.new_empty((m, wc)))
        mg.col.broadcast(b_panel, mg.rank_of(kb % pr, kc))
        d.addmm_(a_panel.reshape(bpr * m, m), b_panel)
    # minus_i on the 2D-cyclic local indices (main.cpp:1206-1224).
    dev = d.device
    gi = ((torch.arange(bpr, device=dev) * pr + kr)[:, None] * m
          + torch.arange(m, device=dev)[None, :]).reshape(-1)
    gj = ((torch.arange(wc // m, device=dev) * pc + kc)[:, None] * m
          + torch.arange(m, device=dev)[None, :]).reshape(-1)
    d -= (gi[:, None] == gj[None, :]).to(d.dtype)
    rowsum = mg.row.all_reduce(d.abs().sum(dim=1), "sum")
    return float(mg.world.all_reduce(rowsum.amax().reshape(1),
                                     "max").item())


def row_sum_max_2d(blocks, mg, lay: CyclicLayout2D) -> float:
    """‖·‖∞ of the distributed (identity-padded) matrix whose shard is
    ``blocks``: row sums over the mesh columns, over the real rows only
    (an identity-pad row sums to exactly 1 and must not cap a small true
    norm), then the world's max."""
    pr, m, bpr = lay.pr, lay.m, lay.bpr
    dev = blocks.device
    gi = ((torch.arange(bpr, device=dev) * pr + mg.kr)[:, None] * m
          + torch.arange(m, device=dev)[None, :])
    sums = mg.row.all_reduce(blocks.abs().sum(dim=2), "sum")
    sums = torch.where(gi < lay.n, sums, 0)
    return float(mg.world.all_reduce(sums.amax().reshape(1), "max").item())


def residual_shards_2d(world, a, inv, shape: tuple,
                       m: int) -> float:
    """:func:`distributed_residual_2d` of (n, n) ``a`` and ``inv`` (numpy
    arrays or tensors every rank holds) on the (pr, pc) mesh ``shape`` of
    ``world``: each rank cuts its own shards."""
    from ..interop import from_numpy
    from .group import mesh_group

    pr, pc = shape
    a = torch.as_tensor(a)
    lay = CyclicLayout2D.create(a.shape[0], m, pr, pc)
    mg = mesh_group(world, pr, pc)

    def shard(x):
        return from_numpy(scatter_matrix_2d(x, lay, mg.kr, mg.kc),
                          world.device)

    return distributed_residual_2d(shard(a), shard(inv), mg, lay)
