"""The worker group of the distributed engines: one process per rank over
``torch.distributed``.  Counterpart of the JAX package's
``parallel/mesh.py`` (the reference's MPI_Init / Comm_size / Comm_rank,
main.cpp:69-91).

The JAX package is single-controller: one process drives a mesh of devices
under ``shard_map``.  The port runs one process per rank, so a group is
this process's ``(rank, world_size, device, backend)``; the launcher
(``launch.py``) spawns the ranks, or ``distributed_init`` joins a world that
``torchrun`` launched.

**The backend rule** (:func:`backend_rule`): ``nccl`` when every rank has a
card of its own (CUDA ranks, at least as many cards as ranks), ``gloo``
otherwise: CPU ranks, and several ranks sharing one card, which NCCL
refuses.  It is decided before the group is made and recorded in the
result; it is never picked by catching a failed init.

**The transport table** (:data:`TRANSPORT`): where a collective's tensor
lives on the wire, by (backend, device type, op).  ``gloo`` takes CUDA
tensors for ``all_reduce`` and ``broadcast`` only (PyTorch's
``ProcessGroupGloo`` has CUDA work for those two), so its point-to-point
ops (the ring residual, the swap-free permutation, the gather) stage
through host memory; ``nccl`` takes every op on the card.  The table is
read, never probed: a pair it does not list raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..errors import UsageError


class MeshSizeError(ValueError):
    """More ranks asked for than the world or the host can give: the analog
    of ``mpirun -np 8`` on one slot failing to launch."""


#: (backend, device type, op) -> where the tensor travels: "device" (the
#: rank's own tensor) or "host" (a CPU copy, copied back after).
TRANSPORT = {
    ("nccl", "cuda", "all_reduce"): "device",
    ("nccl", "cuda", "broadcast"): "device",
    ("nccl", "cuda", "p2p"): "device",
    ("gloo", "cuda", "all_reduce"): "device",
    ("gloo", "cuda", "broadcast"): "device",
    ("gloo", "cuda", "p2p"): "host",
    ("gloo", "cpu", "all_reduce"): "device",
    ("gloo", "cpu", "broadcast"): "device",
    ("gloo", "cpu", "p2p"): "device",
}


def backend_rule(world_size: int, device_type: str,
                 device_count: int) -> tuple[str, str]:
    """The backend of a world of ``world_size`` ranks on ``device_type``
    with ``device_count`` cards, and the rule's reason in words."""
    if device_type == "cuda" and device_count >= world_size:
        return "nccl", (f"every rank has a card of its own "
                        f"({world_size} ranks, {device_count} cards)")
    if device_type == "cuda":
        return "gloo", (f"{world_size} ranks share {device_count} card(s); "
                        f"NCCL refuses two ranks on one card")
    return "gloo", "CPU ranks"


@dataclass(frozen=True)
class WorkerGroup:
    """This process's place in the world, and the collectives the engines
    issue through it.  Every rank issues the same collectives in the same
    order; the engines keep to that on every path, the singular one
    included."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    backend_reason: str = ""

    def _where(self, op: str) -> str:
        key = (self.backend, self.device.type, op)
        if key not in TRANSPORT:
            raise UsageError(f"no transport for {key} (parallel/group.py "
                             f"TRANSPORT)")
        return TRANSPORT[key]

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """In-place all-reduce of ``t`` with ``op`` "min", "max" or
        "sum"; returns ``t``."""
        rop = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
               "sum": dist.ReduceOp.SUM}[op]
        if self.world_size > 1:
            self._where("all_reduce")
            dist.all_reduce(t, op=rop)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """In-place broadcast of ``t`` from rank ``src``; returns ``t``."""
        if self.world_size > 1:
            self._where("broadcast")
            dist.broadcast(t, src=src)
        return t

    def exchange(self, sends, recvs) -> None:
        """Point-to-point: ``sends`` is ``[(tensor, dst), ...]``, ``recvs``
        ``[(tensor, src), ...]`` (filled in place), issued together as one
        ``batch_isend_irecv`` and waited for."""
        if not sends and not recvs:
            return
        host = self._where("p2p") == "host"
        ops, staged = [], []
        for t, dst in sends:
            buf = t.cpu() if host else t.contiguous()
            ops.append(dist.P2POp(dist.isend, buf, dst))
        for t, src in recvs:
            buf = (torch.empty(t.shape, dtype=t.dtype) if host
                   else (t if t.is_contiguous() else torch.empty_like(t)))
            staged.append((t, buf))
            ops.append(dist.P2POp(dist.irecv, buf, src))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for t, buf in staged:
            if buf is not t:
                t.copy_(buf)


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank r's device: ``cuda:r % device_count`` on the card, else CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_group(rank: int, world_size: int, device_type: str,
               store=None) -> WorkerGroup:
    """Join the world as ``rank``: pick the backend by :func:`backend_rule`,
    set this process's card, init the default process group (over
    ``store``, or ``env://`` without one)."""
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    backend, reason = backend_rule(world_size, device_type, count)
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = dict(backend=backend, rank=rank, world_size=world_size)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = "env://"
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    return WorkerGroup(rank, world_size, device, backend, reason)


def distributed_init(device_type: str = "cuda") -> WorkerGroup:
    """Join a world launched outside (``torchrun``): rank and size from
    ``RANK``/``WORLD_SIZE``, the rendezvous from ``MASTER_ADDR``/
    ``MASTER_PORT``.  Returns the existing group when this process has
    joined already.  Raises MeshSizeError when the variables are missing.
    The analog of MPI_Init (main.cpp:69)."""
    if dist.is_initialized():
        return current_group(device_type)
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise MeshSizeError(
            f"--distributed joins a world launched outside (torchrun); "
            f"{'/'.join(missing)} not set")
    return init_group(int(os.environ["RANK"]),
                      int(os.environ["WORLD_SIZE"]), device_type)


def current_group(device_type: str = "cuda") -> WorkerGroup:
    """The :class:`WorkerGroup` of this process's initialized world."""
    rank, world = dist.get_rank(), dist.get_world_size()
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    backend, reason = backend_rule(world, device_type, count)
    if dist.get_backend() != backend:
        raise UsageError(f"the world runs {dist.get_backend()!r}; the "
                         f"backend rule gives {backend!r} ({reason})")
    return WorkerGroup(rank, world, rank_device(rank, device_type),
                       backend, reason)
