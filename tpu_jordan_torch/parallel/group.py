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

**The 2D mesh** (:class:`MeshGroup2D`, :func:`mesh_group`): the counterpart
of ``make_mesh_2d``.  Rank r sits at ``(kr, kc) = divmod(r, pc)``, row-major,
as the JAX package reshapes its devices.  Besides the world it holds two
views of the same ``WorkerGroup`` type: the rank's **row communicator** (the
pc ranks with its kr: the JAX package's collectives over "pc") and its
**column communicator** (the pr ranks with its kc: those over "pr").  A
view issues its collectives on its own process group; a broadcast's
``src`` and an exchange's peers are global ranks.  The subgroups are built
once a world, by every rank, in one order (``dist.new_group`` for each
subgroup of each enumeration, the ones a rank is not in included); a view
of one rank has no group (its collectives are no-ops) and a view of the
whole world is the default group.

**The recording point** (:func:`collecting`, :class:`RankLog`): every
collective of the port passes through a :class:`WorkerGroup`'s
``all_reduce``, ``broadcast`` or ``exchange``, so that is where the
communication observatory (``obs/comm.py``) notes what this rank put on the
wire: (kind, axis, shape, dtype) per collective, a ``send`` and a ``recv``
per point-to-point message (the logical tensor, never the host staging
copy), under the log's current section (:func:`section`).  A view of one
rank issues nothing and records nothing.  Axis names are the JAX
package's: "p" for the 1D world, "pr,pc" for the 2D world, "pc" for a
rank's row communicator, "pr" for its column communicator.  The same log
counts the GEMM FLOPs the engines issue in the "engine" section
(:func:`tally_gemm`, the work observatory's pin).  With no log active a
collective or a GEMM pays one read of a thread-local.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, replace

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


class RankLog:
    """What this rank issued while the log was active: the collectives by
    section (``records[section]``: (kind, axis, shape, dtype) tuples in
    issue order) and the GEMM FLOPs of the "engine" section."""

    def __init__(self):
        self.section = "unsectioned"
        self.records: dict = {}
        self.gemm_flops = 0

    def note(self, kind: str, axis: str, shape, dtype) -> None:
        self.records.setdefault(self.section, []).append(
            (kind, axis, tuple(int(s) for s in shape),
             str(dtype).removeprefix("torch.")))

    def gemm(self, m: int, k: int, n: int) -> None:
        if self.section == "engine":
            self.gemm_flops += 2 * int(m) * int(k) * int(n)


class _Tap(threading.local):
    log = None


_TAP = _Tap()


@contextlib.contextmanager
def collecting(log: RankLog | None):
    """Record into ``log`` for the block (None: record nothing)."""
    prev = _TAP.log
    _TAP.log = log
    try:
        yield log
    finally:
        _TAP.log = prev


@contextlib.contextmanager
def section(name: str):
    """Label what the active log records in the block as ``name``."""
    log = _TAP.log
    if log is None:
        yield
        return
    prev, log.section = log.section, name
    try:
        yield
    finally:
        log.section = prev


def tally_gemm(m: int, k: int, n: int) -> None:
    """One (m, k)·(k, n) product issued by an engine: 2·m·k·n FLOPs into
    the active log's "engine" section."""
    log = _TAP.log
    if log is not None:
        log.gemm(m, k, n)


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
    #: A subgroup view's process group (None: the default group) and its
    #: global ranks in order (empty: the whole world).
    pg: object = None
    members: tuple = ()
    #: The JAX package's name of the axis this view's collectives span.
    axis: str = "p"

    @property
    def size(self) -> int:
        """The ranks this view's collectives span."""
        return len(self.members) if self.members else self.world_size

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
        if self.size > 1:
            self._where("all_reduce")
            log = _TAP.log
            if log is not None:
                log.note(f"all_reduce_{op}", self.axis, t.shape, t.dtype)
            dist.all_reduce(t, op=rop, group=self.pg)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """In-place broadcast of ``t`` from (global) rank ``src``; returns
        ``t``."""
        if self.size > 1:
            self._where("broadcast")
            log = _TAP.log
            if log is not None:
                log.note("broadcast", self.axis, t.shape, t.dtype)
            dist.broadcast(t, src=src, group=self.pg)
        return t

    def exchange(self, sends, recvs) -> None:
        """Point-to-point: ``sends`` is ``[(tensor, dst), ...]``, ``recvs``
        ``[(tensor, src), ...]`` (filled in place), issued together as one
        ``batch_isend_irecv`` and waited for.  Peers are global ranks; a
        subgroup view's exchange runs on the default group, whose first
        collective every rank has issued."""
        if not sends and not recvs:
            return
        host = self._where("p2p") == "host"
        log = _TAP.log
        if log is not None:
            for t, _ in sends:
                log.note("send", self.axis, t.shape, t.dtype)
            for t, _ in recvs:
                log.note("recv", self.axis, t.shape, t.dtype)
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


def _subgroup(world: WorkerGroup, ranks_lists, mine: tuple,
              axis: str) -> WorkerGroup:
    """This rank's view of one enumeration of disjoint subgroups, its
    collectives named ``axis``: every subgroup is created (by every rank,
    in order) unless it is a single rank or the whole world."""
    own = None
    for ranks in ranks_lists:
        if 1 < len(ranks) < world.world_size:
            pg = dist.new_group(ranks=list(ranks))
            if tuple(ranks) == mine:
                own = pg
    return replace(world, pg=own, members=mine, axis=axis)


@dataclass(frozen=True)
class MeshGroup2D:
    """A (pr, pc) mesh over the world: this rank's place ``(kr, kc)`` and
    its three views (module docstring).  Counterpart of the JAX package's
    ``make_mesh_2d``."""

    world: WorkerGroup
    pr: int
    pc: int
    row: WorkerGroup        # the pc ranks with this kr (JAX's "pc" axis)
    col: WorkerGroup        # the pr ranks with this kc (JAX's "pr" axis)

    @property
    def kr(self) -> int:
        return self.world.rank // self.pc

    @property
    def kc(self) -> int:
        return self.world.rank % self.pc

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def backend(self) -> str:
        return self.world.backend

    def rank_of(self, kr: int, kc: int) -> int:
        """The global rank at mesh position (kr, kc)."""
        return kr * self.pc + kc


_MESHES: dict = {}


def check_mesh(pr: int, pc: int, world_size: int) -> None:
    """A (pr, pc) mesh must have positive dimensions and cover the world
    (the JAX words for a mesh larger than the devices)."""
    if pr <= 0 or pc <= 0:
        raise MeshSizeError(f"mesh dims must be positive, got {pr}x{pc}")
    if pr * pc > world_size:
        raise MeshSizeError(
            f"requested a {pr}x{pc} mesh ({pr * pc} workers) but only "
            f"{world_size} rank(s) exist")
    if pr * pc < world_size:
        raise MeshSizeError(
            f"a {pr}x{pc} mesh ({pr * pc} workers) on a world of "
            f"{world_size} ranks would leave ranks idle; the mesh covers "
            f"the world")


def mesh_group(world: WorkerGroup, pr: int, pc: int) -> MeshGroup2D:
    """This rank's :class:`MeshGroup2D` of the (pr, pc) mesh over ``world``,
    built on the first call of a world and kept (every rank of the world
    makes the same calls in the same order, so the subgroups are created
    in lockstep)."""
    check_mesh(pr, pc, world.world_size)
    key = (id(dist.group.WORLD) if dist.is_initialized() else None,
           world.rank, pr, pc)
    if key not in _MESHES:
        kr, kc = divmod(world.rank, pc)
        rows = [tuple(r * pc + c for c in range(pc)) for r in range(pr)]
        cols = [tuple(r * pc + c for r in range(pr)) for c in range(pc)]
        _MESHES[key] = MeshGroup2D(replace(world, axis="pr,pc"), pr, pc,
                                   _subgroup(world, rows, rows[kr], "pc"),
                                   _subgroup(world, cols, cols[kc], "pr"))
    return _MESHES[key]
