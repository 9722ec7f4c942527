"""The port's checkpoint demo (``resilience/ckpt_demo.py``, ``--ckpt-demo``)
and the kill path of a distributed checkpointed run, judged by the JAX
package's checker (``tools/check_ckpt.py``, run unchanged as a
subprocess).

  * A module fixture runs ``--ckpt-demo 48 8 --device cpu`` once through
    the CLI; ``tools/check_ckpt.py`` exits 0 on its report, and every leg
    resumed and bit-matched with zero resume compiles.
  * Doctored copies exit 2: a divergent fingerprint, a silent
    from-scratch recompute, a recompiling resume, a ledger that does not
    add up.
  * A distributed checkpointed solve whose ``abort`` fires once its second
    boundary is durable raises the error ``abort`` returned, at a durable
    step the store holds, with the live token visible while the world ran;
    its resume bit-matches the uninterrupted run, and the ledger and the
    flight recorder's preempt/resume pairing hold.
  * The CLI refusals match the JAX CLI's (the file/--workers one in the
    port's own words: it builds a world of ranks, not a virtual mesh).
"""

import copy
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from tpu_jordan.__main__ import main as jmain

from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.obs.recorder import RECORDER
from tpu_jordan_torch.resilience.checkpoint import (CheckpointStore,
                                                    checkpointed_solve,
                                                    fingerprint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKER = os.path.join(REPO, "tools", "check_ckpt.py")


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = subprocess.run(
        [sys.executable, "-m", "tpu_jordan_torch", "48", "8",
         "--ckpt-demo", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    path = tmp_path_factory.mktemp("ckpt") / "report.json"
    path.write_text(line)
    return json.loads(line), path


def _check(path):
    return subprocess.run([sys.executable, CHECKER, str(path)],
                          capture_output=True, text=True, timeout=120)


def test_checker_accepts_the_demo(report):
    rep, path = report
    res = _check(path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert rep["metric"] == "ckpt_demo" and rep["device"] == "cpu"
    assert not rep["silent_loss"]
    assert set(rep["legs"]) == {"single_invert", "dist_solve", "lp_stream",
                                "fleet_kill"}
    for name, leg in rep["legs"].items():
        assert leg["bit_match"] and leg["resume_compiles"] == 0, name
    ledger = rep["ledger"]
    assert ledger["invariant_holds"] and ledger["live"] == 0


def test_fleet_kill_resumed_mid_sweep(report):
    leg = report[0]["legs"]["fleet_kill"]
    assert leg["killed_replicas"] and 1 <= leg["kill_attempts"] <= 3
    assert leg["resumed"] and 0 < leg["resume_start_step"] < leg["Nr"]
    assert leg["topology"] == "1d:4"
    assert all(t1 - t0 <= leg["cadence"]
               for t0, t1 in leg["resume_segments"])


@pytest.mark.parametrize("doctor", [
    pytest.param(lambda r: r["legs"]["single_invert"].update(
        resume_fp="0" * 64, bit_match=False), id="divergent-fingerprint"),
    pytest.param(lambda r: r["legs"]["dist_solve"].update(
        resumed=False, resume_start_step=0), id="silent-from-scratch"),
    pytest.param(lambda r: r["legs"]["fleet_kill"].update(
        resume_compiles=1), id="recompiling-resume"),
    pytest.param(lambda r: r["ledger"].update(
        written=r["ledger"]["written"] + 1), id="ledger-off-by-one"),
])
def test_doctored_reports_exit_2(report, doctor, tmp_path):
    bad = copy.deepcopy(report[0])
    doctor(bad)
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    res = _check(path)
    assert res.returncode == 2, res.stdout + res.stderr


class Killed(RuntimeError):
    """A stand-in for the fleet's ReplicaKilledError."""


def test_abort_after_second_boundary_stops_the_world(tmp_path):
    rng = np.random.default_rng(11)
    n, m, cadence = 80, 8, 2
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, 3))
    store = CheckpointStore(str(tmp_path / "store"))
    kw = dict(store=store, cadence=cadence, engine="fori", workers=4,
              device="cpu")
    x0, _, _ = checkpointed_solve(a, b, m, run_id="base", **kw)
    seen = []

    def abort():
        # Polled by the caller's watcher while the world runs: the live
        # token (written by rank 0 from its own process) is visible here.
        if store.has_live("run"):
            step = store.peek("run")[1]
            seen.append(step)
            if step >= 2 * cadence:
                return Killed("the replica died")
        return None

    mark = RECORDER.total
    with pytest.raises(Killed) as e:
        checkpointed_solve(a, b, m, run_id="run", abort=abort, **kw)
    step = e.value.step
    assert seen and seen[0] >= cadence
    assert step >= 2 * cadence and step % cadence == 0
    assert store.has_live("run") and store.peek("run")[1] == step
    ran = e.value.info["segments_run"]
    assert ran[-1][1] == step and step < 10
    x1, _, info = checkpointed_solve(a, b, m, run_id="run",
                                     resume_from="run", **kw)
    assert info["resumed"] and info["start_step"] == step
    assert fingerprint(x1) == fingerprint(x0)
    ledger = store.ledger()
    assert ledger["invariant_holds"] and ledger["live"] == 0
    events = RECORDER.since(mark)
    pre = [ev for ev in events if ev.get("kind") == "ckpt_preempted"]
    res = [ev for ev in events if ev.get("kind") == "ckpt_resumed"]
    assert [(ev["run_id"], ev["step"]) for ev in pre] == [("run", step)]
    assert [(ev["run_id"], ev["step"]) for ev in res] == [("run", step)]
    assert not [f for f in os.listdir(store.root)
                if f.startswith(".revoke-")]


def _cli(main, argv):
    err = io.StringIO()
    with redirect_stderr(err), redirect_stdout(io.StringIO()):
        rc = main(argv)
    return rc, err.getvalue().strip()


@pytest.mark.parametrize("extra", [
    ["--serve-demo"], ["--batch", "2"], ["--tune"], ["--group", "2"],
    ["--engine", "inplace"], ["--refine", "1"], ["--workload", "solve"],
    ["--numerics", "summary"], ["--slo-report"], ["--plan-cache", "p.json"],
    ["--batch-cap", "4"], ["--replicas", "2"], ["--kills", "1"],
    ["--dtype", "complex64"]], ids=lambda x: " ".join(x))
def test_cli_refusals_match_jax(extra):
    argv = ["48", "8", "--ckpt-demo"] + extra
    j = _cli(jmain, argv)
    t = _cli(tmain, argv + ["--device", "cpu"])
    assert j[0] == t[0] == 1
    assert t[1] == j[1]


@pytest.mark.parametrize("extra", [["--workers", "2"], ["--no-gather"]])
def test_cli_refuses_distributed_flags(extra):
    rc, err = _cli(tmain, ["48", "8", "--ckpt-demo", "--device", "cpu"]
                   + extra)
    assert rc == 1 and "--workers and --no-gather do not apply" in err
    assert _cli(jmain, ["48", "8", "--ckpt-demo"] + extra)[0] == 1


def test_ckpt_dir_outside_the_demo_is_refused(tmp_path):
    argv = ["48", "8", "--ckpt-dir", str(tmp_path)]
    j = _cli(jmain, argv)
    t = _cli(tmain, argv + ["--device", "cpu"])
    assert j[0] == t[0] == 1 and t[1] == j[1]
