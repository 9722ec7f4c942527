"""The launcher of a world of ranks: ``run_workers(p, fn, *args)``.  It has
no counterpart in the JAX package, which is single-controller (one process
drives the whole mesh under ``shard_map``): the port runs one process per
rank, the reference's ``mpirun -np p``.

  * p ranks start in the ``forkserver`` context (:func:`rank_context`: the
    parent may hold threads and a CUDA context, so never a plain ``fork``);
    the server imports torch and the rank code once, so a rank is a fork
    of it and pays neither import again (a ``spawn``ed rank re-imported
    torch, most of a world's start-up);
  * the rendezvous is a ``FileStore`` in a temporary directory: no TCP
    port, so two worlds on one host (test workers) never collide;
  * rank r runs on ``cuda:r % device_count`` (or the CPU, with an equal
    share of the host's cores as intra-op threads), with the backend of
    ``group.backend_rule``;
  * each rank's own arguments (``per_rank``: its strips of a matrix) are
    written to a file of its own in that directory, which the rank reads
    once it runs: passed through the spawn pipe they would hold each
    ``start`` until that child had imported torch, so the ranks would
    start one after another;
  * each rank's return value is written to a file in that directory and
    read back by the parent (no pipe to drain before a join);
  * the parent waits under ``deadline_s``.  When a rank raises, or the
    deadline passes, the parent kills every rank still alive and raises
    :class:`WorkerError` naming the rank (the first to fail, or those that
    never reported);
  * :func:`last_world` gives the wall split of this process's last world
    (spawn, joining the group, the ranks' work, the exit), each the
    slowest rank's, from the ranks' own clock readings;
  * :func:`stop_rank_server` ends and reaps the fork server and the
    resource tracker; it runs at exit, after multiprocessing's own
    clean-up, so a program that ran a world leaves none of its processes
    behind (the server would outlive it by the seconds it takes to unload
    torch).

On the card the kernels the ranks launch are built in the parent first
(``_build.build``, one ``nvcc`` per source, all at once), so the p ranks
load them and none compiles.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import pickle
import shutil
import signal
import tempfile
import time
import traceback
from multiprocessing import util as _mp_util

#: The CUDA sources a rank's probe may launch.
RANK_KERNELS = ("gj_probe", "gj_probe_fused_panel")


_LAST_WORLD: dict = {}

#: What the fork server imports once for every rank it forks: torch and
#: the ranks' code, never a CUDA context (a rank opens its own).
RANK_PRELOAD = ("torch", "torch.distributed", "tpu_jordan_torch.driver",
                "tpu_jordan_torch.parallel.dist_solve",
                "tpu_jordan_torch.parallel.world",
                "tpu_jordan_torch.resilience.checkpoint")


def rank_context():
    """The multiprocessing context ranks start in: ``forkserver``, its
    server preloading :data:`RANK_PRELOAD`."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(RANK_PRELOAD))
    return ctx


def _reap(pid: int, timeout_s: float) -> None:
    """Wait for child ``pid`` to exit, killing it after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    with contextlib.suppress(ChildProcessError):
        while os.waitpid(pid, os.WNOHANG)[0] == 0:
            if time.monotonic() > deadline:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
                return
            time.sleep(0.01)


def stop_rank_server(timeout_s: float = 30.0) -> None:
    """End this process's fork server (:func:`rank_context`) and the
    resource tracker it shares with the ranks, and reap both.  Closing
    each one's pipe asks it to exit; either is killed after ``timeout_s``.
    The next world starts a new server.  Registered to run at exit, last
    of multiprocessing's finalizers (the semaphores' clean-up before it
    may talk to the tracker)."""
    from multiprocessing import forkserver, resource_tracker

    server = forkserver._forkserver
    with server._lock:
        if server._forkserver_pid is not None:
            os.close(server._forkserver_alive_fd)
            _reap(server._forkserver_pid, timeout_s)
            address = server._forkserver_address
            server._forkserver_alive_fd = server._forkserver_pid = None
            server._forkserver_address = None
            if address and not _mp_util.is_abstract_socket_namespace(
                    address):
                with contextlib.suppress(OSError):
                    os.unlink(address)
    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        if tracker._pid is not None:
            os.close(tracker._fd)
            _reap(tracker._pid, timeout_s)
            tracker._fd = tracker._pid = None


_mp_util.Finalize(None, stop_rank_server, exitpriority=-100)


def last_world() -> dict:
    """Seconds of this process's last completed world: ``spawn_s`` (from
    the first spawn to the last rank entering its body), ``join_s`` (the
    slowest rank's group join), ``run_s`` (the slowest rank's ``fn``),
    ``exit_s`` (from the last report to the last rank's exit) and
    ``total_s``."""
    return dict(_LAST_WORLD)


class WorkerError(RuntimeError):
    """A rank of a world failed or hung; ``rank`` names it (the first to
    fail), ``detail`` carries its traceback or the deadline."""

    def __init__(self, rank, detail: str):
        self.rank = rank
        self.detail = detail
        super().__init__(f"rank {rank} of the world failed: {detail}")


def _child(rank: int, p: int, root: str, device_type: str, fn, args,
           own: str | None = None):
    """One rank: read its own arguments from the file ``own`` (appended to
    ``args``), join the world over the file store, run ``fn(group,
    *args)``, write its result (or its traceback) to ``root``."""
    import torch.distributed as dist

    from .group import init_group

    status = os.path.join(root, f"rank{rank}")
    clock = [time.time()]
    try:
        import torch

        if own is not None:
            with open(own, "rb") as f:
                args = args + pickle.load(f)
            os.unlink(own)

        if device_type == "cpu":
            # CPU ranks share the host's cores instead of each taking all.
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // p))
        store = torch.distributed.FileStore(os.path.join(root, "store"), p)
        group = init_group(rank, p, device_type, store=store)
        clock.append(time.time())
        out = fn(group, *args)
        clock.append(time.time())
        payload = ("ok", out, clock)
    except BaseException as e:                      # noqa: BLE001
        payload = ("error", f"{type(e).__name__}: {e}\n"
                            f"{traceback.format_exc()}", clock)
    # Report first: a failed rank's peers may sit in a collective that
    # never completes, and the parent kills them on this report.
    with open(status + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(status + ".tmp", status)
    if payload[0] == "ok" and dist.is_initialized():
        dist.destroy_process_group()


def run_workers(p: int, fn, *args, deadline_s: float = 600.0,
                device_type: str = "cuda", per_rank=None) -> list:
    """Run ``fn(group, *args)`` on each of ``p`` spawned ranks; returns the
    ranks' results in rank order.  ``per_rank`` (a list of p tuples) adds
    rank r's own arguments after ``args``: only rank r's process reads
    them (a rank's strips of a matrix, never the whole).  ``fn`` must be
    importable by path (a module-level function of this package), and its
    arguments and result picklable.  Raises :class:`WorkerError` when a
    rank raises or the world outlives ``deadline_s``."""
    if p < 1:
        raise ValueError("p must be >= 1")
    if per_rank is not None and len(per_rank) != p:
        raise ValueError(f"per_rank holds {len(per_rank)} entries for "
                         f"{p} ranks")
    if device_type == "cuda":
        from .._build import build

        build(RANK_KERNELS)
    ctx = rank_context()
    root = tempfile.mkdtemp(prefix="tpu_jordan_torch_world_")
    procs = []
    clocks = {}
    t_launch = time.time()
    try:
        for r in range(p):
            own = None
            if per_rank is not None:
                own = os.path.join(root, f"args{r}")
                with open(own, "wb") as f:
                    pickle.dump(tuple(per_rank[r]), f,
                                protocol=pickle.HIGHEST_PROTOCOL)
            proc = ctx.Process(
                target=_child, args=(r, p, root, device_type, fn, args, own),
                name=f"tpu-jordan-torch-rank{r}", daemon=True)
            proc.start()
            procs.append(proc)
        results: dict[int, object] = {}
        deadline = time.monotonic() + deadline_s
        while len(results) < p:
            # A report read after the deadline does not count: the check
            # comes first.
            if time.monotonic() > deadline:
                late = [r for r in range(p) if r not in results]
                raise WorkerError(
                    late[0], f"no report within {deadline_s:g} s "
                             f"(ranks {late} still running)")
            for r in range(p):
                path = os.path.join(root, f"rank{r}")
                if r in results or not os.path.exists(path):
                    if (r not in results and not procs[r].is_alive()
                            and not os.path.exists(path)):
                        raise WorkerError(
                            r, f"exited with code {procs[r].exitcode} "
                               f"before reporting")
                    continue
                with open(path, "rb") as f:
                    kind, out, clocks[r] = pickle.load(f)
                if kind == "error":
                    raise WorkerError(r, out)
                results[r] = out
            if len(results) < p:
                time.sleep(0.01)
        t_reported = time.time()
        for proc in procs:
            proc.join(timeout=max(1.0, deadline - time.monotonic()))
        t_end = time.time()
        _LAST_WORLD.clear()
        _LAST_WORLD.update(
            p=p, spawn_s=max(c[0] for c in clocks.values()) - t_launch,
            join_s=max(c[1] - c[0] for c in clocks.values()),
            run_s=max(c[2] - c[1] for c in clocks.values()),
            exit_s=t_end - t_reported, total_s=t_end - t_launch)
        return [results[r] for r in range(p)]
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
        for proc in procs:
            proc.join(timeout=10)
        shutil.rmtree(root, ignore_errors=True)


def run_calls(group, calls) -> list:
    """Run ``calls`` (``[(fn, args), ...]``, each ``fn(group, *args)``) in
    order on this rank: one world for many cases, as the tests and the
    chip smoke use it (``run_workers(p, run_calls, calls)``)."""
    return [fn(group, *args) for fn, args in calls]
