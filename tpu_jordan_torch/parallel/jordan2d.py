"""The 2D block-cyclic helpers and the 2D augmented engine: each rank's
shard of a matrix, generated or cut from a whole one, the gathers back, the
SUMMA residual, and the pre-shard_map reference-parity engine on [A | I].
Counterpart of the JAX package's ``parallel/jordan2d.py``.

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

The augmented engine (:func:`augmented_blocks_2d`, the JAX
``_local_step2d``) runs on each rank's (bpr, m, 2N/pc) shard of [A | I]
(:func:`augment_shard_2d`; Nr is a multiple of pc, so a rank's A chunks
come first and its I chunks last).  A superstep t, with the in-place 2D
engines' collectives (``jordan2d_inplace._Run``):

  * the t-column chunk from the owner column on the row communicator,
    before the probe (it is the eliminate's E too);
  * the probe of this rank's share of the live slots, **without** a
    global singularity scale (as the JAX engine probes): under the
    "column" probe layout each mesh column probes its 1/pc slice, under
    "owner" the owner column probes them all (the layouts of
    ``jordan2d_inplace.resolve_probe_layout``);
  * the pivot reduction over the world (ties to the lowest global row,
    the all-singular agreement from the reduction), H from its prober to
    the world;
  * the pivot row and row t (unless the pivot is row t) on the column
    communicator; swap-by-copy; the swap fix-up chunk on the pivot's mesh
    row; one local (bpr·m, m)×(m, 2N/pc) ``addmm_``; row t takes prow.

There is no column replacement and no unscramble: after Nr steps the I
chunks hold the inverse (:func:`split_inverse_blocks_2d`), in the same
2D-cyclic shard form as the in-place engines' output.
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


def augment_shard_2d(a_shard: torch.Tensor, lay: CyclicLayout2D, kr: int,
                     kc: int) -> torch.Tensor:
    """Rank (kr, kc)'s (bpr, m, 2N/pc) shard of [A | I] from its (bpr, m,
    N/pc) shard of the identity-padded A: the I chunks are the rank's 2D
    shard of the identity, after its A chunks."""
    m, dev = lay.m, a_shard.device
    gi = ((torch.arange(lay.bpr, device=dev) * lay.pr + kr)[:, None] * m
          + torch.arange(m, device=dev)[None, :])[:, :, None]
    gj = ((torch.arange(lay.bc1, device=dev) * lay.pc + kc)[:, None] * m
          + torch.arange(m, device=dev)[None, :]).reshape(-1)
    eye = (gi == gj[None, None, :]).to(a_shard.dtype)
    return torch.cat([a_shard, eye], dim=2)


def _augmented_step2d(run, Wloc, t: int, dec, singular, pivots: list,
                      ahead=None):
    """Superstep t of the 2D augmented engine on this rank's shard of
    [A | I], in place (module docstring)."""
    from .sharded_inplace import _eliminate, _matmul, _reduce

    mg, lay = run.mg, run.lay
    pr, pc, Nr = lay.pr, lay.pc, lay.Nr
    kr = mg.kr
    g, kmin = _reduce(dec, mg.world, Nr)
    singular |= ~torch.isfinite(kmin)
    pivots.append(g)
    H = run.h_bcast(dec, g, t)
    row_piv = run.row_bcast([Wloc], g)
    row_t = row_piv if g == t else run.row_bcast([Wloc], t)
    own_p, sp = kr == g % pr, g // pr
    own_t, st = kr == t % pr, t // pr
    if own_p and g != t:
        Wloc[sp] = row_t                            # swap-by-copy
    prow = _matmul(H, row_piv)
    E = dec.chunk.clone()
    if g != t:
        fix = run.fixup(row_t, g, t, t // pc)
        if own_p:
            E[sp] = fix
    if own_t:
        E[st] = 0
    _eliminate(Wloc, E, prow)
    if own_t:
        Wloc[st] = prow
    return None


def augmented_blocks_2d(blocks, mg, lay: CyclicLayout2D, eps=None,
                        probe=None, probe_layout: str = "auto"):
    """Run the 2D augmented engine on this rank's (bpr, m, 2N/pc) shard of
    [A | I] (not modified); every rank of the mesh ``mg`` calls it
    together.  Returns ``(out, singular, pivots, probed)``: the rank's
    result shard ([I | A⁻¹]), the (1,) flag, the pivot sequence and the
    (t, global rows) it probed.  Counterpart of the JAX package's
    ``compile_sharded_jordan_2d(...)(W)``."""
    from ..config import eps_for
    from ..ops.block_inverse import probe_blocks
    from .jordan2d_inplace import _no_singular, _Run, _run_steps
    from .jordan2d_inplace import resolve_probe_layout
    from .upcast import upcast_sub_fp32

    @upcast_sub_fp32
    def run_engine(blocks):
        run = _Run(mg, lay, eps if eps is not None else eps_for(blocks.dtype),
                   probe if probe is not None else probe_blocks,
                   resolve_probe_layout(probe_layout, mg.backend))
        W = blocks.clone()
        singular, pivots = _no_singular(W), []
        _run_steps(run, lambda t, dec, ahead: _augmented_step2d(
            run, W, t, dec, singular, pivots), W, lookahead=False)
        return W, singular, pivots, run.probed

    return run_engine(blocks)


def invert_augmented_2d(a_shard, mg, lay: CyclicLayout2D, probe=None,
                        probe_layout: str = "auto"):
    """The 2D augmented engine from this rank's (bpr, m, N/pc) shard of the
    identity-padded A: ``(inverse shard, singular, pivots, probed)`` in
    the in-place 2D engines' form."""
    out, singular, pivots, probed = augmented_blocks_2d(
        augment_shard_2d(a_shard, lay, mg.kr, mg.kc), mg, lay, probe=probe,
        probe_layout=probe_layout)
    return split_inverse_blocks_2d(out, lay), singular, pivots, probed


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
