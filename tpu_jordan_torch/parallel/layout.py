"""1D row-block-cyclic layout math.

Pure index arithmetic reproducing the reference's data decomposition
(rows_p_process main.cpp:95-116, local_to_global main.cpp:118-123,
num_block_rows main.cpp:124-127, find_sender main.cpp:521-532): global block
row ``r`` lives on worker ``r % p`` at local slot ``r // p``; columns are
fully replicated per worker.

Everything here is host-side Python; the two permutations are also given
as ``torch.long`` tensors.  Counterpart of the JAX package's
``parallel/layout.py``.

The ragged last block of the reference (height ``l = n - m*(Nr-1)``,
main.cpp:133-137) is handled in this framework by *padding*: we extend A to
``N = Nr_pad * m`` with an identity tail, which inverts to an identity tail
(see pad_with_identity in ops/padding.py), so no ragged index math survives
into the device code.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def num_block_rows(n: int, m: int) -> int:
    """ceil(n / m) — number of block rows (num_block_rows, main.cpp:124-127)."""
    return -(-n // m)


def rows_per_worker(Nr: int, p: int, k: int) -> int:
    """Block rows owned by worker ``k`` of ``p`` under the cyclic layout.

    Parity with rows_p_process (main.cpp:95-116): worker k owns global block
    rows {k, k+p, k+2p, ...} below Nr.
    """
    if not 0 <= k < p:
        raise ValueError(f"worker {k} out of range for p={p}")
    return (Nr - k + p - 1) // p if Nr > k else 0


def local_to_global(i: int, m: int, p: int, k: int) -> int:
    """Local row index -> global row index (local_to_global, main.cpp:118-123).

    ``gi = ((i // m) * p + k) * m + i % m``: local block ``i // m`` on worker
    ``k`` is global block ``(i // m) * p + k``.
    """
    return ((i // m) * p + k) * m + i % m


def global_block_owner(r: int, p: int) -> int:
    """Worker owning global block row ``r`` (main.cpp:244: ``i % p``)."""
    return r % p


def global_to_local_block(r: int, p: int) -> int:
    """Local slot of global block row ``r`` on its owner (main.cpp:245)."""
    return r // p


def find_sender(Nr: int, p: int) -> int:
    """Worker owning the last block row; doubles as the file-I/O root
    (find_sender, main.cpp:521-532): ``(Nr - 1) % p``."""
    return (Nr - 1) % p


def last_block_height(n: int, m: int) -> int:
    """Height of the ragged last block row, ``l = n - m*(Nr-1)``
    (main.cpp:133-137)."""
    return n - m * (num_block_rows(n, m) - 1)


def padded_num_blocks(n: int, m: int, p: int = 1) -> int:
    """Smallest block count >= ceil(n/m) that is a multiple of ``p``.

    Padding both the ragged tail and the worker count means every worker owns
    exactly ``Nr_pad // p`` full m-row blocks — the device code never sees a
    ragged shape.
    """
    Nr = num_block_rows(n, m)
    return -(-Nr // p) * p


@dataclass(frozen=True)
class CyclicLayout:
    """Static description of one padded row-block-cyclic distribution."""

    n: int          # original matrix dimension
    m: int          # block size
    p: int          # number of workers (mesh axis size)
    Nr: int         # padded block-row count (multiple of p)

    @classmethod
    def create(cls, n: int, m: int, p: int = 1) -> "CyclicLayout":
        return cls(n=n, m=m, p=p, Nr=padded_num_blocks(n, m, p))

    @property
    def N(self) -> int:
        """Padded matrix dimension."""
        return self.Nr * self.m

    @property
    def blocks_per_worker(self) -> int:
        return self.Nr // self.p

    def owner(self, r: int) -> int:
        return global_block_owner(r, self.p)

    def local_slot(self, r: int) -> int:
        return global_to_local_block(r, self.p)

    def global_block(self, k: int, slot: int) -> int:
        """Inverse of (owner, local_slot): worker k's slot -> global block."""
        return slot * self.p + k

    def cyclic_block_order(self):
        """Global block indices in storage order (worker-major, slot-minor).

        Storing blocks in this order makes the cyclic layout a *contiguous*
        shard per worker: worker k's blocks are the rows
        ``[k·bpw, (k+1)·bpw)`` of the (Nr, m, N) block tensor.
        """
        return [self.global_block(k, s)
                for k in range(self.p)
                for s in range(self.blocks_per_worker)]


@dataclass(frozen=True)
class CyclicLayout2D:
    """2D block-cyclic distribution over a (pr, pc) mesh — the ScaLAPACK
    layout the 1D design can't reach: rows AND columns of the augmented
    matrix are sharded, so per-worker memory is O(N·2N/(pr·pc)) instead of
    the reference's full-width strips (main.cpp:366-370, the memory wall).

    Block (i, j) lives on worker (i % pr, j % pc) at local slot
    (i // pr, j // pc).  Local storage is (bpr, m, Wc): row blocks
    worker-cyclic on axis 0, columns stored as bc2 chunks of m in cyclic
    column-block order on axis 2 (local chunk u ↔ global column block
    u*pc + kc).
    """

    n: int           # original matrix dimension
    m: int           # block size
    pr: int          # mesh rows
    pc: int          # mesh cols
    Nr: int          # padded block-row count (multiple of lcm(pr, pc))

    @classmethod
    def create(cls, n: int, m: int, pr: int, pc: int) -> "CyclicLayout2D":
        Nr = num_block_rows(n, m)
        g = math.lcm(pr, pc)
        return cls(n=n, m=m, pr=pr, pc=pc, Nr=-(-Nr // g) * g)

    @property
    def N(self) -> int:
        return self.Nr * self.m

    @property
    def bpr(self) -> int:
        """Row blocks per worker."""
        return self.Nr // self.pr

    @property
    def bc2(self) -> int:
        """Augmented ([A|B]) column-block chunks per worker."""
        return 2 * self.Nr // self.pc

    @property
    def bc1(self) -> int:
        """Column-block chunks per worker for an unaugmented N-wide matrix."""
        return self.Nr // self.pc

    def col_perm(self, nblocks: int):
        """Storage order of column blocks: worker-major, slot-minor."""
        bpw = nblocks // self.pc
        return [s * self.pc + kc for kc in range(self.pc) for s in range(bpw)]

    def row_perm(self):
        bpw = self.Nr // self.pr
        return [s * self.pr + kr for kr in range(self.pr) for s in range(bpw)]


def cyclic_gather_perm(layout: CyclicLayout) -> torch.Tensor:
    """Permutation taking natural block order -> cyclic storage order."""
    return torch.as_tensor(layout.cyclic_block_order(), dtype=torch.long)


def cyclic_scatter_perm(layout: CyclicLayout) -> torch.Tensor:
    """Inverse permutation: cyclic storage order -> natural block order."""
    order = layout.cyclic_block_order()
    inv = [0] * len(order)
    for pos, r in enumerate(order):
        inv[r] = pos
    return torch.as_tensor(inv, dtype=torch.long)
