"""The persistent world of ranks (``parallel/world.py``): p CPU ranks over
gloo, spawned once and kept across jobs.  The world has no JAX counterpart
(the JAX package's mesh executables are compiled once and run warm; the
port keeps its ranks instead), so this file holds its contract alone, and
the files that use it (``test_torch_meshlanes.py``,
``test_torch_solver_dist.py``) hold the results against the JAX package.

One module-scoped world of 3 ranks, closed at teardown:

  * jobs run in order on one world and state persists between them (the
    start counter moves once);
  * a rank that raises gives a typed ``WorkerError`` naming it, and the
    world stays up when every rank reported;
  * a killed rank poisons the world: the job raises ``WorkerError``, and
    the next job starts a new world (the counter moves by one);
  * recording is per job: one job's collectives never reach the next;
  * ``close()`` leaves no live child process, and a closed world refuses
    jobs;
  * a program that ran worlds (one left open) leaves no process of its
    process group behind when it exits: the fork server and the resource
    tracker are ended and reaped before it (``launch.stop_rank_server``).
"""

import multiprocessing as mp
import os
import signal
import subprocess
import sys
import time

import pytest

from tpu_jordan_torch.obs.metrics import REGISTRY
from tpu_jordan_torch.parallel import WorkerError
from tpu_jordan_torch.parallel.group import RankLog, collecting
from tpu_jordan_torch.parallel.world import (World, raise_on, rank_pid,
                                             state_get, state_put, sum_ranks,
                                             topology_label, world_starts)

P = 3


@pytest.fixture(scope="module")
def world():
    w = World(P, "cpu")
    yield w
    w.close()


def _alive(pids):
    out = []
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        # A reaped zombie is gone; an unreaped one is not running.
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split()[2] == "Z":
                    continue
        except OSError:
            continue
        out.append(pid)
    return out


def test_topology_labels():
    assert topology_label(4) == "p4"
    assert topology_label((2, 3)) == "2x3"
    w = World((1, 2), "cpu")
    assert w.p == 2 and w.topology == "1x2" and not w.alive
    w.close()


def test_jobs_run_in_order_and_state_persists(world):
    before = world_starts("p3")
    assert world.run(state_put, "x", 41) == [0, 1, 2]
    assert world.run(state_get, "x") == [41, 41, 41]
    world.run(state_put, "x", 42)
    assert world.run(state_get, "x") == [42, 42, 42]
    # One start at most (the fixture's world starts at its first job).
    assert world_starts("p3") - before <= 1
    starts = world.starts
    world.run(state_get, "x")
    assert world.starts == starts
    assert world.last_job["run_s"] >= 0 and world.last_job["write_s"] >= 0
    assert world.start_s is not None and world.start_s > 0


def test_per_rank_arguments_reach_their_rank_only(world):
    out = world.run(state_put, "own", per_rank=[(10,), (11,), (12,)])
    assert out == [0, 1, 2]
    assert world.run(state_get, "own") == [10, 11, 12]
    with pytest.raises(ValueError, match="per_rank"):
        world.run(state_get, "own", per_rank=[()])


def test_rank_that_raises_is_typed_and_named(world):
    starts = world.starts
    with pytest.raises(WorkerError) as e:
        world.run(raise_on, 2, "bad input on purpose")
    assert e.value.rank == 2
    assert "bad input on purpose" in e.value.detail
    # Every rank reported (they raised before any collective): the world
    # is still up, and its state with it.
    assert world.alive and world.starts == starts
    world.run(state_put, "y", 7)
    assert world.run(state_get, "y") == [7, 7, 7]


def test_killed_rank_poisons_and_the_next_job_restarts(world):
    world.run(state_put, "z", 1)
    starts, total = world.starts, world_starts()
    counter = REGISTRY.counter("tpu_jordan_torch_world_starts_total")
    metric = counter.value(topology="p3")
    old = world.pids()
    os.kill(old[1], signal.SIGKILL)
    time.sleep(0.2)
    with pytest.raises(WorkerError) as e:
        world.run(state_get, "z")
    assert e.value.rank == 1
    assert not world.alive
    assert _alive(old) == []
    # The next job starts a new world: counted, its state fresh.
    assert world.run(state_get, "z") == [None, None, None]
    assert world.starts == starts + 1
    assert world_starts() == total + 1
    assert counter.value(topology="p3") == metric + 1
    assert set(world.pids()).isdisjoint(old)


def test_recording_is_per_job(world):
    log = RankLog()
    with collecting(log):
        # A log active in the caller never reaches the ranks.
        out = world.run(sum_ranks)
    assert log.records == {}
    for total, records in out:
        assert total == 0.0 + 1.0 + 2.0
        assert records == {"unsectioned": [("all_reduce_sum", "p", (1,),
                                            "float32")]}
    # A second job's log holds its own collective only.
    again = world.run(sum_ranks)
    assert [r for _, r in again] == [r for _, r in out]


def test_jobs_counted_by_topology(world):
    counter = REGISTRY.counter("tpu_jordan_torch_world_jobs_total")
    before = counter.value(topology="p3")
    world.run(rank_pid)
    world.run(rank_pid)
    assert counter.value(topology="p3") == before + 2


def test_close_leaves_no_child_and_refuses_jobs():
    w = World(2, "cpu")
    pids = [pid for _, pid in w.run(rank_pid)]
    assert sorted(pids) == sorted(w.pids())
    w.close()
    assert not w.alive
    assert _alive(pids) == []
    assert not [c for c in mp.active_children() if c.pid in pids]
    with pytest.raises(WorkerError, match="closed"):
        w.run(rank_pid)
    w.close()                                   # idempotent


def test_context_manager_closes():
    with World(2, "cpu") as w:
        pids = w.pids() or [pid for _, pid in w.run(rank_pid)]
    assert _alive(pids) == []


def test_ranks_fork_from_the_preloaded_server(world):
    """Ranks start in the fork-server context, whose server imported torch
    and the rank code once (``launch.RANK_PRELOAD``): a rank's parent is
    that server, not the owner, and the rank ends when its owner is gone
    (``_owner_alive``), not when its parent is."""
    from tpu_jordan_torch.parallel import launch
    from tpu_jordan_torch.parallel.world import _owner_alive

    ctx = launch.rank_context()
    assert ctx.get_start_method() == "forkserver"
    assert "torch" in launch.RANK_PRELOAD
    for pid in world.pids():
        with open(f"/proc/{pid}/stat") as f:
            ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        assert ppid != os.getpid()
    assert _owner_alive(os.getpid())


_PROGRAM = """
from tpu_jordan_torch.parallel.launch import run_workers
from tpu_jordan_torch.parallel.world import World, rank_pid

if __name__ == "__main__":
    with World(2, "cpu") as w:
        w.run(rank_pid)
    run_workers(2, rank_pid, device_type="cpu")
    World(2, "cpu").run(rank_pid)               # left open: closed at exit
"""


def _group_members(pgid):
    """Live processes (zombies excepted) of process group ``pgid``."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        state, _, group = stat.rsplit(")", 1)[1].split()[:3]
        if int(group) == pgid and state != "Z":
            out.append(stat[:160])
    return out


def test_program_leaves_no_process_at_exit(tmp_path):
    """The process group of a program that ran worlds is empty the moment
    the program has exited: no rank, fork server or resource tracker
    outlives it, even by the seconds a server takes to unload torch."""
    script = tmp_path / "program.py"
    script.write_text(_PROGRAM)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen([sys.executable, str(script)], cwd=root,
                            env=env, process_group=0)
    assert proc.wait(timeout=180) == 0
    assert _group_members(proc.pid) == []
