"""The systolic ring GEMM over the ranks, and the distributed residual on
it.  Counterpart of the JAX package's ``parallel/ring_gemm.py``
(``matrix_mult_matrix``, main.cpp:534-641).

d = a @ b with both operands in the 1D cyclic layout: each rank keeps its
rows of ``a`` and passes its rows of ``b`` around the ring, p steps of
rotate-and-accumulate (``MPI_Sendrecv_replace``, main.cpp:639; here one
``batch_isend_irecv`` a step: send to rank k − 1, receive from k + 1).  At
step s rank k holds the rows of rank ``(k + s) % p`` and multiplies the
columns of its ``a`` rows that meet them (the cyclic column pick,
main.cpp:583).  The residual subtracts I with cyclic-aware indices
(minus_i, main.cpp:1206-1224), takes the local ∞-norm part and
``all_reduce(MAX)``es one scalar (main.cpp:504-505).

It is kept independent of the engine, as the reference keeps it
(main.cpp:490-513): its own GEMMs (``torch.matmul``), no probe, no shared
code with what it verifies.
"""

from __future__ import annotations

import torch

from .layout import CyclicLayout


def ring_gemm_blocks(a_loc, b_loc, group, lay: CyclicLayout):
    """This rank's (bpw, m, N) blocks of a·b, from its blocks of a and b."""
    p, m, bpw, N = lay.p, lay.m, lay.blocks_per_worker, lay.N
    k = group.rank
    rows = bpw * m
    a2 = a_loc.reshape(rows, N)
    d = a2.new_zeros((rows, N))
    buf = b_loc.reshape(rows, N).clone()
    nxt = torch.empty_like(buf)
    slot_cols = torch.arange(m, device=a2.device)
    for step in range(p):
        whose = (k + step) % p
        # The columns of a that meet the held rows: global block rows
        # {s·p + whose} (the reference's bl_ind_a pick, main.cpp:583).
        blocks = torch.arange(bpw, device=a2.device) * p + whose
        cols = (blocks[:, None] * m + slot_cols[None, :]).reshape(-1)
        d.addmm_(a2.index_select(1, cols), buf)
        if step < p - 1:
            group.exchange([(buf, (k - 1) % p)], [(nxt, (k + 1) % p)])
            buf, nxt = nxt, buf
    return d.reshape(bpw, m, N)


def distributed_residual_blocks(a_loc, inv_loc, group, lay: CyclicLayout):
    """‖A·A⁻¹ − I‖∞ from the ranks' identity-padded cyclic blocks (the
    padded tail of both is I, so the product's tail is exactly I).  The
    same float on every rank."""
    p, m, bpw = lay.p, lay.m, lay.blocks_per_worker
    d = ring_gemm_blocks(a_loc, inv_loc, group, lay)
    gi = ((torch.arange(bpw, device=d.device) * p + group.rank)[:, None] * m
          + torch.arange(m, device=d.device)[None, :])           # (bpw, m)
    d[torch.arange(bpw, device=d.device)[:, None],
      torch.arange(m, device=d.device)[None, :], gi] -= 1
    local = d.abs().sum(dim=2).amax().reshape(1)
    return float(group.all_reduce(local, "max").item())


def ring_matmul(group, a, b, lay: CyclicLayout):
    """d = a @ b for (n, n) ``a`` and ``b`` (numpy arrays or tensors) held
    whole by every rank, through the ring; returns this rank's (bpw, m, N)
    blocks of the zero-padded product on the CPU
    (``gather_inverse_inplace`` assembles them)."""
    from ..interop import from_numpy

    def blocks(x):
        x = from_numpy(x, group.device)
        xp = x.new_zeros((lay.N, lay.N))
        xp[:x.shape[0], :x.shape[1]] = x
        return xp.reshape(lay.Nr, lay.m, lay.N)[group.rank::lay.p]

    return ring_gemm_blocks(blocks(a), blocks(b), group, lay).cpu()


def distributed_residual(group, a, a_inv, lay: CyclicLayout) -> float:
    """‖A·A⁻¹ − I‖∞ through the ring, for (n, n) operands (numpy arrays or
    tensors) every rank holds (the identity-padded cyclic scatter, then
    :func:`distributed_residual_blocks`)."""
    from ..interop import from_numpy
    from .sharded_inplace import to_identity_padded_blocks

    return distributed_residual_blocks(
        to_identity_padded_blocks(from_numpy(a, group.device), lay,
                                  group.rank),
        to_identity_padded_blocks(from_numpy(a_inv, group.device), lay,
                                  group.rank), group, lay)


def residual_shards(group, a_shards, inv_shards, lay: CyclicLayout) -> float:
    """:func:`distributed_residual_blocks` on this rank's shards of the
    identity-padded cyclic blocks ``a_shards`` and ``inv_shards`` (rank
    order, numpy arrays or CPU tensors)."""
    from ..interop import from_numpy

    return distributed_residual_blocks(
        from_numpy(a_shards[group.rank], group.device),
        from_numpy(inv_shards[group.rank], group.device), group, lay)
