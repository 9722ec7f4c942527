"""The port's ``--comm-demo`` and ``--work-demo`` (``obs/comm.comm_demo``,
``obs/work.work_demo``) on the CPU, judged by the JAX package's checkers.

A module fixture runs each demo once through the CLI (``--device cpu``: one
world of 4 CPU ranks each).  Then:

  * ``tools/check_comm.py`` and ``tools/check_work.py``, run as
    subprocesses, exit 0 on the reports;
  * doctored copies are rejected with the JAX package's exit codes (its
    ``tests/test_comm.py`` and ``tests/test_work.py`` doctorings): a
    stripped collective, an unaccounted collective, a forged drift, a lie
    in the totals, a silent share shift, a hidden pin overrun, an
    unsupported verdict, a stripped straggler event, a non-zero aligned
    penalty;
  * the two demos' legs hold the JAX package's work inventories exactly on
    the same layouts;
  * the CLI's refusals exit 1 in the JAX words, complex dtypes are a typed
    refusal, and ``--comm-report``/``--work-report`` write a loadable
    snapshot of the last distributed solve.
"""

import contextlib
import io
import json
import pathlib
import subprocess
import sys

import pytest

from tpu_jordan.obs import work as jwork
from tpu_jordan.parallel import layout as jl

from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.obs import comm, work

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tmain([str(a) for a in argv])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def reports():
    out = {}
    for flag in ("--comm-demo", "--work-demo"):
        rc, text = _cli(["48", "8", flag, "--device", CPU])
        assert rc == 0, text[-2000:]
        out[flag] = json.loads(text.strip().splitlines()[-1])
    return out


def _checker(tool, doc, tmp_path, name="r.json"):
    p = tmp_path / name
    p.write_text(json.dumps(doc) if not isinstance(doc, str) else doc)
    return subprocess.run([sys.executable, str(ROOT / "tools" / tool),
                           str(p)], capture_output=True, text=True)


def _copy(doc):
    return json.loads(json.dumps(doc))


def test_comm_report_is_clean(reports, tmp_path):
    rep = reports["--comm-demo"]
    assert rep["silent_comm"] is False and rep["ragged"] is True
    assert rep["unreconciled"] == [] and rep["mismatches"] == []
    assert rep["drift_events"] >= 1 and rep["backend"] == "gloo"
    assert [leg["name"] for leg in rep["legs"]] == [
        "1d_p4_inplace_gathered", "1d_p4_grouped2_gathered",
        "1d_p4_swapfree_sharded", "1d_p4_lookahead_sharded",
        "2d_2x2_inplace_gathered", "2d_2x2_swapfree_sharded",
        "1d_p4_solve_gathered", "2d_2x2_solve_sharded",
        "1d_p4_solve_lookahead_sharded"]
    out = _checker("check_comm.py", rep, tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr


def test_work_report_is_clean(reports, tmp_path):
    rep = reports["--work-demo"]
    assert rep["silent_work"] is False and rep["ragged"] is True
    assert rep["straggler_events"] == 1 and rep["cleared_events"] == 1
    assert all(leg["work"]["xla"]["within"] for leg in rep["legs"])
    out = _checker("check_work.py", rep, tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("leg", range(6))
def test_work_legs_hold_the_jax_inventory(reports, leg):
    w = reports["--work-demo"]["legs"][leg]["work"]
    lay = (jl.CyclicLayout2D.create(w["n"], w["block_size"], *w["workers"])
           if isinstance(w["workers"], list)
           else jl.CyclicLayout.create(w["n"], w["block_size"],
                                       w["workers"]))
    j = jwork.engine_report(engine=w["engine"], lay=lay, k=w["rhs"],
                            unroll=True).to_json()
    for key in ("per_worker", "per_superstep"):
        assert w[key] == j[key]
    for key in ("convention_flops", "accounted_flops", "exact", "skew",
                "ragged_penalty", "executed_model_flops"):
        assert w["totals"][key] == j["totals"][key]


# --- Doctored comm reports (the JAX TestDemoAndChecker doctorings).


def _doctor_comm(doc, how):
    if how == "stripped":
        obs = doc["legs"][0]["comm"]["observed"]["engine"]
        next(e for e in obs if e["kind"] == "broadcast")["count"] -= 1
    elif how == "unaccounted":
        doc["legs"][1]["comm"]["observed"]["engine"].append(
            {"kind": "broadcast", "axis": "p", "shape": [512, 512],
             "dtype": "float32", "count": 2})
    elif how == "forged_drift":
        doc["blackbox"]["events"] = [e for e in doc["blackbox"]["events"]
                                     if e.get("kind") != "comm_drift"]
        doc["drift_events"] = 0
        doc["drift_leg"]["comm"]["drift"]["event_recorded"] = False
    elif how == "totals_lie":
        doc["legs"][0]["comm"]["totals"]["payload_bytes"] += 1024
    return doc


@pytest.mark.parametrize("how,rc,words", [
    ("stripped", 2, "stripped/phantom"),
    ("unaccounted", 2, "UNACCOUNTED"),
    ("forged_drift", 2, "SILENT DRIFT"),
    ("totals_lie", 1, "payload_bytes")])
def test_comm_checker_rejects_doctored(reports, tmp_path, how, rc, words):
    doc = _doctor_comm(_copy(reports["--comm-demo"]), how)
    out = _checker("check_comm.py", doc, tmp_path)
    assert out.returncode == rc
    assert words in out.stderr


# --- Doctored work reports (the JAX TestDemoAndChecker doctorings).


def _doctor_work(doc, how):
    legs = doc["legs"]
    if how == "share_shift":
        pw = legs[0]["work"]["per_worker"]
        pw["0"]["eliminate"] += 4096
        pw["1"]["eliminate"] -= 4096
    elif how == "pin_overrun":
        x = legs[0]["work"]["xla"]
        x["per_device_flops"] *= 10
        x["total_flops"] *= 10
        x["xla_vs_model"] *= 10
    elif how == "unsupported_verdict":
        for leg in doc["fleet_legs"]:
            if leg["name"] == "fleet_skew_layout_attributed":
                leg["verdict"]["suspected"] = True
    elif how == "stripped_straggler":
        doc["blackbox"]["events"] = [
            e for e in doc["blackbox"]["events"]
            if e["kind"] != "straggler_suspected"]
        doc["straggler_events"] = 0
    elif how == "aligned_penalty":
        leg = next(x for x in legs if x["name"] == "1d_p4_inplace_aligned")
        leg["work"]["totals"]["ragged_penalty"] = 0.05
    return doc


@pytest.mark.parametrize("how,rc,words", [
    ("share_shift", 2, "layout-derived"),
    ("pin_overrun", 2, "UNACCOUNTED work"),
    ("unsupported_verdict", 2, "UNSUPPORTED VERDICT"),
    ("stripped_straggler", 2, "SILENT STRAGGLER"),
    ("aligned_penalty", 2, "phantom padding")])
def test_work_checker_rejects_doctored(reports, tmp_path, how, rc, words):
    doc = _doctor_work(_copy(reports["--work-demo"]), how)
    out = _checker("check_work.py", doc, tmp_path)
    assert out.returncode == rc
    assert words in out.stderr


def test_checkers_exit_1_on_foreign_and_unreadable(reports, tmp_path):
    assert _checker("check_work.py", {"metric": "comm_demo"},
                    tmp_path).returncode == 1
    assert _checker("check_comm.py", {"metric": "work_demo"},
                    tmp_path).returncode == 1
    assert _checker("check_comm.py", "{nope", tmp_path).returncode == 1


# --- The CLI's contract.


@pytest.mark.parametrize("argv,words", [
    (["64", "8", "--workers", "2x4", "--comm-demo"],
     "--workers and --no-gather do not apply"),
    (["48", "8", "--work-demo", "--workers", "2"],
     "--workers and --no-gather do not apply"),
    (["48", "8", "--comm-demo", "--no-gather"],
     "--workers and --no-gather do not apply"),
    (["48", "8", "m.txt", "--work-demo"], "file input"),
    (["48", "8", "--comm-demo", "--work-demo"], "distinct modes"),
    (["48", "8", "--comm-demo", "--fleet-demo"], "distinct modes"),
    (["48", "8", "--comm-demo", "--tune"], "--batch/--tune/--group"),
    (["48", "8", "--work-demo", "--group", "2"], "--batch/--tune/--group"),
    (["48", "8", "--comm-demo", "--engine", "inplace"],
     "--engine/--refine do not apply"),
    (["48", "8", "--comm-demo", "--workload", "solve"], "--workload"),
    (["48", "8", "--work-demo", "--rhs", "3"], "--workload/--rhs"),
    (["48", "8", "--comm-demo", "--numerics", "summary"], "--numerics"),
    (["48", "8", "--work-demo", "--plan-cache", "p.json"], "--plan-cache"),
    (["48", "8", "--comm-demo", "--batch-cap", "4"], "--batch-cap"),
    (["48", "8", "--work-demo", "--replicas", "4"], "--replicas"),
    (["48", "8", "--comm-demo", "--dtype", "complex64"], "complex"),
    (["48", "8", "--work-demo", "--dtype", "complex64"], "complex"),
])
def test_cli_refusals_exit_1(argv, words, capsys):
    assert tmain(argv + ["--device", CPU]) == 1
    assert words in capsys.readouterr().err


@pytest.mark.parametrize("demo", [comm.comm_demo, work.work_demo])
def test_complex_dtype_is_a_typed_refusal(demo):
    with pytest.raises(UsageError, match="complex"):
        demo(n=48, block_size=8, dtype="complex64", device=CPU)


def test_reports_write_the_last_solve(tmp_path):
    cp, wp = tmp_path / "c.json", tmp_path / "w.json"
    rc, text = _cli(["48", "8", "--workers", "2", "--device", CPU,
                     "--comm-report", cp, "--work-report", wp])
    assert rc == 0, text
    c, w = json.loads(cp.read_text()), json.loads(wp.read_text())
    assert c["metric"] == "comm_report" and w["metric"] == "work_report"
    assert c["last_solve"]["mesh"] == "1D p=2"
    assert c["last_solve"]["n"] == 48
    assert c["last_solve"]["totals"]["payload_bytes"] > 0
    assert "tpu_jordan_torch_comm_bytes_total" in c["counters"]
    assert w["last_solve"]["totals"]["exact"] is True
    assert "tpu_jordan_torch_work_share" in w["gauges"]
    # A usage error still writes the snapshot (of this process).
    cp.unlink()
    assert tmain(["48", "8", "--comm-demo", "--tune", "--device", CPU,
                  "--comm-report", str(cp)]) == 1
    assert json.loads(cp.read_text())["metric"] == "comm_report"
