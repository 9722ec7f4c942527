"""A persistent world of ranks: p processes (or pr·pc for a mesh) spawned
once, each joining its group once and then running jobs one after another.
It has no counterpart in the JAX package, where a mesh lane or a
distributed ``JordanSolver`` is one AOT-compiled executable that runs warm
with zero compiles; in the port the costly part of a distributed call is
the world itself (spawning p processes, importing torch and opening a CUDA
context in each), so the counterpart of that executable is a world that
outlives one call.

  * **Start.** The ranks use ``launch.run_workers``'s fork-server context,
    file-store rendezvous, backend rule (``group.backend_rule``) and kernel
    pre-build (``launch.RANK_KERNELS``, built in the parent first).  A
    start is counted (``tpu_jordan_torch_world_starts_total``, by
    topology; :attr:`World.starts`), never hidden.
  * **Jobs.** ``world.run(fn, *args, per_rank=None, deadline_s=...)`` has
    ``run_workers``'s contract: a module-level ``fn(group, *args)``,
    results in rank order, a typed :class:`~.launch.WorkerError` naming
    the rank.  Jobs on one world run one at a time; a lock serializes
    callers on other threads.  Each job is counted
    (``tpu_jordan_torch_world_jobs_total``).
  * **Payloads** go by file, never through the spawn pipe: the job (``fn``
    and the shared ``args``) is one pickle in the world's directory, each
    rank's own arguments (``per_rank``: its strips of a matrix) a pickle
    of its own that only that rank reads, each rank's result a pickle the
    parent reads back.  A job is announced to rank r by releasing its
    semaphore (a shared-memory object handed over at spawn).  The file
    round trip is recorded per job (:attr:`World.last_job`: ``write_s``,
    ``run_s``, ``read_s``).
  * **Rank state that outlives a job**: :func:`rank_state` is a dict of
    the rank's process that a job may fill and a later job read (the
    ``gather=False`` inverse blocks of a ``JordanSolver``), so a result
    can stay on the ranks.
  * **Recording is per job**: before each job the rank clears the
    recording point's log (``group.collecting``) and the strip witness
    (``io.reset_strip_peak``), so one job's collectives never land in the
    next job's report.
  * **Faults.**  A rank that raises fails the job with a ``WorkerError``.
    When every other rank reports within a short grace the world stays up
    (the ranks raised together, before any collective); otherwise, and
    whenever a rank dies or a job outlives its deadline, the world is
    poisoned: its ranks are killed and the owner's next job starts a new
    world.
  * **Closing.** :meth:`World.close` and the context manager end every
    rank (a stop job, then a kill for any rank still alive); an ``atexit``
    hook closes every world still open.  A rank also ends when the process
    that owns its world is gone.
"""

from __future__ import annotations

import atexit
import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback
import weakref

from ..obs import metrics as _metrics
from .launch import RANK_KERNELS, WorkerError, rank_context

_M_STARTS = _metrics.counter(
    "tpu_jordan_torch_world_starts_total",
    "persistent worlds of ranks started (spawned and joined), by topology")
_M_JOBS = _metrics.counter(
    "tpu_jordan_torch_world_jobs_total",
    "jobs run on persistent worlds of ranks, by topology")

#: Seconds a world waits for the other ranks after one raised before it
#: poisons itself (they may be blocked in a collective with it).
ERROR_GRACE_S = 2.0

#: Seconds a world may take to spawn and join its ranks.
START_DEADLINE_S = 600.0

_STATE: dict = {}
_OPEN: "weakref.WeakSet[World]" = weakref.WeakSet()
_STARTS: dict = {}


def rank_state() -> dict:
    """This rank process's state that outlives a job (module docstring)."""
    return _STATE


def world_starts(topology: str | None = None) -> int:
    """Worlds this process started (for ``topology``, or in all)."""
    if topology is not None:
        return _STARTS.get(topology, 0)
    return sum(_STARTS.values())


def topology_label(spec) -> str:
    """'p4' for 4 ranks on the 1D layout, '2x2' for a (2, 2) mesh (the
    serve surface's and the tuner's spelling)."""
    if isinstance(spec, tuple):
        return f"{int(spec[0])}x{int(spec[1])}"
    return f"p{int(spec)}"


def _owner_alive(pid: int) -> bool:
    """True while process ``pid`` (the world's owner) exists."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    return True


def _rank_loop(rank: int, p: int, root: str, device_type: str, sem,
               owner: int) -> None:
    """One rank of a persistent world: join once, then run jobs until a
    stop job or until the owner process is gone (a rank is a child of the
    fork server, not of its owner)."""
    ready = os.path.join(root, f"ready{rank}")
    try:
        import torch

        from ..io import reset_strip_peak
        from .group import collecting, init_group

        t0 = time.time()
        if device_type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // p))
        store = torch.distributed.FileStore(os.path.join(root, "store"), p)
        group = init_group(rank, p, device_type, store=store)
        payload = ("ok", None, [t0, time.time()])
    except BaseException as e:                      # noqa: BLE001
        payload = ("error", f"{type(e).__name__}: {e}\n"
                            f"{traceback.format_exc()}", [])
    _report(ready, payload)
    if payload[0] != "ok":
        return
    while True:
        if not sem.acquire(timeout=1.0):
            if not _owner_alive(owner):
                return                              # the owner is gone
            continue
        with open(os.path.join(root, "job"), "rb") as f:
            seq, fn, args, has_own = pickle.load(f)
        if fn is None:
            break
        status = os.path.join(root, f"res{seq}.r{rank}")
        clock = [time.time()]
        try:
            if has_own:
                own = os.path.join(root, f"job{seq}.r{rank}")
                with open(own, "rb") as f:
                    args = args + pickle.load(f)
                os.unlink(own)
            reset_strip_peak()
            with collecting(None):
                out = fn(group, *args)
            clock.append(time.time())
            result = ("ok", out, clock)
        except BaseException as e:                  # noqa: BLE001
            result = ("error", f"{type(e).__name__}: {e}\n"
                               f"{traceback.format_exc()}", clock)
        _report(status, result)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _report(path: str, payload) -> None:
    with open(path + ".tmp", "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".tmp", path)


class World:
    """p ranks (``spec`` an int) or a (pr, pc) mesh of pr·pc ranks
    (``spec`` a tuple) on ``device_type``, spawned at the first job and
    kept until :meth:`close` (module docstring)."""

    def __init__(self, spec, device_type: str = "cuda"):
        if isinstance(spec, tuple):
            spec = (int(spec[0]), int(spec[1]))
            p = spec[0] * spec[1]
        else:
            spec = int(spec)
            p = spec
        if p < 1:
            raise ValueError("a world needs at least one rank")
        self.spec, self.p = spec, p
        self.topology = topology_label(spec)
        self.device_type = device_type
        self.starts = 0
        self.jobs = 0
        #: seconds of the last start: from the first spawn until every
        #: rank had joined its group.
        self.start_s: float | None = None
        #: the last job's split: writing the payloads, the slowest rank's
        #: ``fn``, and reading the results back (seconds).
        self.last_job: dict = {}
        self._lock = threading.Lock()
        self._procs: list = []
        self._sems: list = []
        self._root: str | None = None
        self._seq = 0
        self._closed = False
        _OPEN.add(self)

    # ---- life cycle

    @property
    def alive(self) -> bool:
        """True while the world's ranks are up."""
        return bool(self._procs)

    def pids(self) -> list:
        """The ranks' process ids (empty when the world is down)."""
        return [proc.pid for proc in self._procs]

    def _ensure(self) -> None:
        if self._closed:
            raise WorkerError("-", "the world is closed")
        if self._procs:
            return
        if self.device_type == "cuda":
            from .._build import build

            build(RANK_KERNELS)
        ctx = rank_context()
        self._root = tempfile.mkdtemp(prefix="tpu_jordan_torch_pworld_")
        self._sems = [ctx.Semaphore(0) for _ in range(self.p)]
        t0 = time.time()
        try:
            for r in range(self.p):
                proc = ctx.Process(
                    target=_rank_loop,
                    args=(r, self.p, self._root, self.device_type,
                          self._sems[r], os.getpid()),
                    name=f"tpu-jordan-torch-world-rank{r}", daemon=True)
                proc.start()
                self._procs.append(proc)
            self._collect([os.path.join(self._root, f"ready{r}")
                           for r in range(self.p)], START_DEADLINE_S)
        except BaseException:
            self._kill()
            raise
        self.start_s = time.time() - t0
        self.starts += 1
        _STARTS[self.topology] = _STARTS.get(self.topology, 0) + 1
        _M_STARTS.inc(1, topology=self.topology)

    def _collect(self, paths: list, deadline_s: float) -> list:
        """Every rank's report at ``paths[r]``, in rank order; raises
        :class:`WorkerError` (poisoning the world unless every rank
        reported) on an error, a dead rank or the deadline."""
        results: dict = {}
        deadline = time.monotonic() + deadline_s
        failed = None
        while len(results) < self.p:
            for r in range(self.p):
                if r in results:
                    continue
                if os.path.exists(paths[r]):
                    with open(paths[r], "rb") as f:
                        results[r] = pickle.load(f)
                    os.unlink(paths[r])
                    if results[r][0] == "error" and failed is None:
                        failed = r
                        deadline = min(deadline,
                                       time.monotonic() + ERROR_GRACE_S)
                elif not self._procs[r].is_alive():
                    code = self._procs[r].exitcode
                    self._kill()
                    raise WorkerError(
                        r, f"exited with code {code} before reporting "
                           f"(the world is closed; the next job starts a "
                           f"new one)")
            if len(results) < self.p:
                if time.monotonic() > deadline:
                    late = [r for r in range(self.p) if r not in results]
                    self._kill()
                    if failed is not None:
                        raise WorkerError(failed, results[failed][1])
                    raise WorkerError(
                        late[0], f"no report within {deadline_s:g} s "
                                 f"(ranks {late} still running; the world "
                                 f"is closed)")
                time.sleep(0.0005)
        if failed is not None:
            raise WorkerError(failed, results[failed][1])
        return [results[r] for r in range(self.p)]

    def _kill(self) -> None:
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
        for proc in self._procs:
            proc.join(timeout=10)
        self._procs, self._sems = [], []
        if self._root is not None:
            shutil.rmtree(self._root, ignore_errors=True)
            self._root = None

    def close(self) -> None:
        """End every rank: a stop job, then a kill for any rank still
        alive after a short wait.  Idempotent."""
        with self._lock:
            self._closed = True
            if not self._procs:
                return
            try:
                self._announce(None, (), None)
                for proc in self._procs:
                    proc.join(timeout=5)
            finally:
                self._kill()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- jobs

    def _announce(self, fn, args, per_rank) -> None:
        root = self._root
        self._seq += 1
        if per_rank is not None:
            for r in range(self.p):
                path = os.path.join(root, f"job{self._seq}.r{r}")
                with open(path, "wb") as f:
                    pickle.dump(tuple(per_rank[r]), f,
                                protocol=pickle.HIGHEST_PROTOCOL)
        _report(os.path.join(root, "job"),
                (self._seq, fn, tuple(args), per_rank is not None))
        for sem in self._sems:
            sem.release()

    def run(self, fn, *args, per_rank=None, deadline_s: float = 600.0
            ) -> list:
        """Run ``fn(group, *args)`` on every rank (``per_rank[r]`` added
        after ``args`` on rank r); the results in rank order.  Starts the
        world first when it is down."""
        if per_rank is not None and len(per_rank) != self.p:
            raise ValueError(f"per_rank holds {len(per_rank)} entries for "
                             f"{self.p} ranks")
        with self._lock:
            self._ensure()
            t0 = time.perf_counter()
            self._announce(fn, args, per_rank)
            t1 = time.perf_counter()
            self.jobs += 1
            _M_JOBS.inc(1, topology=self.topology)
            reports = self._collect(
                [os.path.join(self._root, f"res{self._seq}.r{r}")
                 for r in range(self.p)], deadline_s)
            t2 = time.perf_counter()
        clocks = [c for _, _, c in reports]
        run_s = max(c[1] - c[0] for c in clocks)
        self.last_job = {"write_s": t1 - t0, "run_s": run_s,
                         "read_s": max(0.0, (t2 - t1) - run_s)}
        return [out for _, out, _ in reports]

    def __del__(self):
        try:
            if self._procs:
                self._kill()
        except Exception:                           # noqa: BLE001
            pass


@atexit.register
def _close_all() -> None:
    for world in list(_OPEN):
        try:
            world.close()
        except Exception:                           # noqa: BLE001
            pass


# ---- rank functions of the tests and the smoke (module level, so the
# ranks import them by path).


def state_put(group, key, value):
    """Keep ``value`` under ``key`` in the rank's state; returns the rank."""
    _STATE[key] = value
    return group.rank


def state_get(group, key):
    """The rank's state under ``key`` (None when absent)."""
    return _STATE.get(key)


def raise_on(group, rank: int, message: str = "raised on purpose"):
    """Raise ``ValueError(message)`` on ``rank`` and return the rank
    elsewhere (every rank returns before any collective)."""
    if group.rank == rank:
        raise ValueError(message)
    return group.rank


def rank_pid(group):
    """(rank, process id)."""
    return group.rank, os.getpid()


def sum_ranks(group):
    """One recorded ``all_reduce`` of the rank over the world; returns
    (the sum, the records this job's log holds)."""
    import torch

    from .group import RankLog, collecting

    log = RankLog()
    with collecting(log):
        t = torch.tensor([float(group.rank)], device=group.device)
        group.all_reduce(t, "sum")
    return float(t.item()), log.records
