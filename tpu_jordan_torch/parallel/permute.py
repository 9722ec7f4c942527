"""The swap-free engine's deferred row permutation, point to point.
Counterpart of the JAX package's ``parallel/permute.py``
(``ppermute_bucketed``); :func:`permute_cyclic` is the same exchange along
any cyclic axis (the 2D engines' row permutation along a mesh column and
column permutation along a mesh row).

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


def permute_cyclic(items: torch.Tensor, dest, view, p: int, k: int,
                   peer) -> torch.Tensor:
    """Return this position's (B, ...) ``items`` after moving the item at
    physical cyclic index x (slot x // p of position x % p) to natural
    index ``dest[x]`` (slot dest[x] // p of position dest[x] % p), along
    one cyclic axis of ``p`` positions of which this is ``k``.  ``peer(j)``
    is the global rank at position j, ``view`` the group that exchanges.
    Every position calls it together with the same ``dest``."""
    B = items.shape[0]
    out = torch.empty_like(items)
    # What this position sends to each peer: (its slots, their slots).
    sends = {d: ([], []) for d in range(p)}
    for s in range(B):
        r = dest[s * p + k]
        sends[r % p][0].append(s)
        sends[r % p][1].append(r // p)
    # What it receives from each peer: the slots here, in the peer's order.
    recvs = {src: [dest[s * p + src] // p for s in range(B)
                   if dest[s * p + src] % p == k] for src in range(p)}
    dev = items.device
    src_slots, dst_slots = sends[k]
    if src_slots:
        out.index_copy_(0, torch.as_tensor(dst_slots, device=dev),
                        items.index_select(0, torch.as_tensor(src_slots,
                                                              device=dev)))
    send_ops, recv_ops, places = [], [], []
    for d in range(p):
        if d != k and sends[d][0]:
            idx = torch.as_tensor(sends[d][0], device=dev)
            send_ops.append((items.index_select(0, idx), peer(d)))
        if d != k and recvs[d]:
            buf = items.new_empty((len(recvs[d]),) + tuple(items.shape[1:]))
            recv_ops.append((buf, peer(d)))
            places.append((buf, recvs[d]))
    view.exchange(send_ops, recv_ops)
    for buf, slots in places:
        out.index_copy_(0, torch.as_tensor(slots, device=dev), buf)
    return out


def permute_rows(W: torch.Tensor, pos, group, lay: CyclicLayout):
    """Return this rank's (bpw, m, N) blocks after moving every physical
    block row x to natural row ``pos[x]``.  Every rank calls it together
    with the same ``pos``."""
    return permute_cyclic(W, pos, group, lay.p, group.rank, lambda d: d)
