"""The swap-free engine's deferred row permutation, point to point.
Counterpart of the JAX package's ``parallel/permute.py``
(``ppermute_bucketed``).

After the swap-free loop, physical block row x (slot x // p of rank x % p)
belongs at natural row ``pos[x]`` (slot pos[x] // p of rank pos[x] % p).
``pos`` is the same on every rank, so each rank knows, with no
communication, which of its rows go where and which rows it receives from
whom: the buckets.  The exchange is one ``batch_isend_irecv`` of exact
buckets (the rows a rank sends to one peer, in slot order), not the JAX
package's p − 1 single-hop rotations of shard-size padded buffers: those
are a static-shape and torus-hop device of XLA on a TPU ring, and an H100
host's NVLink is all to all.  No buffer exceeds one shard (N²/p elements),
the ``gather=False`` memory contract.  Staging follows the group's
transport table (``group.TRANSPORT``: ``gloo`` on the card stages through
the host).
"""

from __future__ import annotations

import torch

from .layout import CyclicLayout


def permute_rows(W: torch.Tensor, pos, group, lay: CyclicLayout):
    """Return this rank's (bpw, m, N) blocks after moving every physical
    block row x to natural row ``pos[x]``.  Every rank calls it together
    with the same ``pos``."""
    p, k, bpw = lay.p, group.rank, lay.blocks_per_worker
    out = torch.empty_like(W)
    # What this rank sends to each peer: (its slots, their slots there).
    sends = {d: ([], []) for d in range(p)}
    for s in range(bpw):
        r = pos[s * p + k]
        sends[r % p][0].append(s)
        sends[r % p][1].append(r // p)
    # What it receives from each peer: the slots here, in the peer's order.
    recvs = {src: [pos[s * p + src] // p for s in range(bpw)
                   if pos[s * p + src] % p == k] for src in range(p)}
    src_slots, dst_slots = sends[k]
    if src_slots:
        dev = W.device
        out.index_copy_(0, torch.as_tensor(dst_slots, device=dev),
                        W.index_select(0, torch.as_tensor(src_slots,
                                                          device=dev)))
    send_ops, recv_ops, places = [], [], []
    for d in range(p):
        if d != k and sends[d][0]:
            idx = torch.as_tensor(sends[d][0], device=W.device)
            send_ops.append((W.index_select(0, idx), d))
        if d != k and recvs[d]:
            buf = W.new_empty((len(recvs[d]),) + tuple(W.shape[1:]))
            recv_ops.append((buf, d))
            places.append((buf, recvs[d]))
    group.exchange(send_ops, recv_ops)
    for buf, slots in places:
        out.index_copy_(0, torch.as_tensor(slots, device=W.device), buf)
    return out
