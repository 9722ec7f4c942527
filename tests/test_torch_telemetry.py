"""The port's spans and exporters (``tpu_jordan_torch/obs/spans.py``,
``obs/export.py``) and the telemetry of its entry points, against the JAX
package's, on the CPU.

A fake clock drives both packages' ``Telemetry`` to equal trees; the
modeled phase fractions equal the JAX package's to 1e-12.  A solve's span
names are the JAX package's less ``compile`` (torch compiles nothing),
the fused engine's execute span has measured children and the others
modeled ones, and ``elapsed`` is the execute span's duration exactly.
The Prometheus text and the Chrome trace of a solve, an lstsq and an
update pass ``tools/check_telemetry.py`` unchanged.
"""

import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_jordan.driver import solve as jsolve
from tpu_jordan.io import write_matrix_file
from tpu_jordan.obs import spans as jspans
from tpu_jordan.obs.numerics import ill_conditioned
from tpu_jordan.resilience import ResiliencePolicy as JPolicy

from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.driver import solve as tsolve
from tpu_jordan_torch.linalg import lstsq, solve_system, solve_update
from tpu_jordan_torch.obs import export, spans as tspans
from tpu_jordan_torch.obs.metrics import NAME_RE, REGISTRY
from tpu_jordan_torch.obs.recorder import RECORDER
from tpu_jordan_torch.resilience import ResiliencePolicy, RetryPolicy

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _clock():
    ticks = iter(range(10_000))
    return lambda: float(next(ticks)) * 0.25


def _drive(pkg):
    tel = pkg.Telemetry(clock=_clock())
    with tel.span("solve", n=64) as root:
        with tel.span("select", engine="inplace"):
            pass
        with tel.span("execute", engine="inplace") as esp:
            pass
        pkg.attribute_phases(esp, 64, 8, lookahead=True)
        with tel.span("residual"):
            pass
    with tel.span("solve_batch", batch=2):
        pass
    return tel, root


def test_span_tree_matches_jax_with_a_fake_clock():
    tt, troot = _drive(tspans)
    jt, jroot = _drive(jspans)
    assert troot.to_dict() == jroot.to_dict()
    assert [r.to_dict() for r in tt.roots] == [r.to_dict() for r in jt.roots]
    assert tt.find("probe_ahead").to_dict() == \
        jt.find("probe_ahead").to_dict()


@pytest.mark.parametrize("lookahead", [False, True])
@pytest.mark.parametrize("n,m", [(64, 8), (96, 16), (1000, 50),
                                 (8192, 384)])
def test_modeled_phases_match_jax(n, m, lookahead):
    ts, js = tspans.Span("execute", 2.0, 5.5), jspans.Span("execute", 2.0,
                                                             5.5)
    tspans.attribute_phases(ts, n, m, lookahead=lookahead)
    jspans.attribute_phases(js, n, m, lookahead=lookahead)
    for a, b in zip(ts.walk(), js.walk()):
        assert a.name == b.name and a.attrs == b.attrs
        assert abs(a.t_start - b.t_start) <= 1e-12
        assert abs(a.t_end - b.t_end) <= 1e-12


def test_measured_phases_match_jax():
    fr = {"pivot": 0.3, "permute": 0.05, "eliminate": 0.9}
    ts, js = tspans.Span("execute", 0.0, 2.0), jspans.Span("execute", 0.0,
                                                             2.0)
    tspans.attribute_phases_measured(ts, fr)
    jspans.attribute_phases_measured(js, fr)
    assert ts.to_dict() == js.to_dict()


def test_null_telemetry_retains_nothing_and_roots_are_bounded():
    with tspans.NULL.span("solve") as sp:
        pass
    assert sp.duration >= 0 and tspans.NULL.roots == []
    tel = tspans.Telemetry(max_roots=3)
    for i in range(5):
        with tel.span(f"r{i}"):
            pass
    assert [r.name for r in tel.roots] == ["r2", "r3", "r4"]


def test_timed_blocking_on_the_cpu_uses_the_telemetry_clock():
    tel = tspans.Telemetry(clock=_clock())
    out, sp = tspans.timed_blocking(lambda x: x + 1, 41, telemetry=tel,
                                    device="cpu", engine="inplace")
    assert out == 42 and sp.duration == 0.25
    assert sp.attrs == {"clock": "host", "engine": "inplace"}


@functools.cache
def _jax_names(engine):
    tel = jspans.Telemetry()
    jsolve(64, 8, generator="rand", engine=engine, telemetry=tel)
    return [sp.name for sp in tel.spans() if sp.name != "compile"]


@pytest.mark.parametrize("engine", ["inplace", "grouped", "lookahead",
                                    "augmented", "grouped_pallas"])
def test_solve_spans_are_the_jax_names_less_compile(engine):
    tel = tspans.Telemetry()
    r = tsolve(64, 8, generator="rand", engine=engine, telemetry=tel,
               device="cpu")
    assert [sp.name for sp in tel.spans()] == _jax_names(engine)
    esp = r.trace.find("execute")
    assert r.elapsed == esp.duration
    assert esp.attrs["engine"] == engine
    assert esp.attrs["achieved_tflops_analytical"] > 0
    phases = [c for c in esp.children]
    assert [c.name for c in phases] == ["pivot", "permute", "eliminate"]
    if engine == "grouped_pallas":
        assert all(c.attrs["measured"] and "modeled" not in c.attrs
                   and c.attrs["bracket_seconds"] > 0 for c in phases)
    else:
        assert all(c.attrs["modeled"] for c in phases)
    if engine == "lookahead":
        assert esp.attrs["probe_overlap_headroom"] > 0


def test_auto_solve_has_a_select_span():
    tel = tspans.Telemetry()
    r = tsolve(64, 8, generator="rand", telemetry=tel, device="cpu")
    sel = r.trace.find("select")
    assert sel.attrs["engine"] == r.engine
    assert sel.attrs["source"] == "cost_model"
    assert [c.name for c in r.trace.children] == [
        "select", "load", "execute", "residual"]


def test_untraced_solve_runs_no_bracket(monkeypatch):
    """Without telemetry (or with the discard-only sink) a fused solve
    times nothing beyond its own bracket."""
    from tpu_jordan_torch.ops import fused_update

    def boom(*a, **k):
        raise AssertionError("a phase bracket ran")

    monkeypatch.setattr(fused_update, "measured_phase_fractions", boom)
    r = tsolve(32, 8, generator="rand", engine="grouped_pallas",
               device="cpu")
    assert r.trace is None and r.numerics is None
    r = tsolve(32, 8, generator="rand", engine="grouped_pallas",
               device="cpu", telemetry=tspans.NULL)
    assert r.trace is not None and r.trace.children == []


def test_phase_brackets_are_cached_per_configuration():
    from tpu_jordan_torch.ops import fused_update

    fused_update._PHASE_CACHE.clear()
    f1, s1 = fused_update.measured_phase_fractions(64, 8, 2, "fp32",
                                                   device="cpu")
    f2, s2 = fused_update.measured_phase_fractions(64, 8, 2, "fp32",
                                                   device="cpu")
    assert f1 == f2 and s1 == s2 and abs(sum(f1.values()) - 1) < 1e-12
    assert set(s1) == {"pivot", "permute", "eliminate"}
    assert list(fused_update._PHASE_CACHE) == [(64, 8, 2, "fp32", "cpu")]


def _ladder_names(tel):
    rec = tel.find("recover")
    return [(c.name, [g.name for g in c.children if g.name != "compile"])
            for c in rec.children]


def test_ladder_spans_nest_under_recover(tmp_path):
    """A bf16 solve of the ill-conditioned fixture under an fp32 gate:
    the refine and resolve rungs are children of ``recover``, and the
    re-solve's own spans nest under ``resolve``, as in the JAX
    package."""
    path = str(tmp_path / "a.mat")
    write_matrix_file(path, ill_conditioned(16))
    jt, tt = jspans.Telemetry(), tspans.Telemetry()
    jsolve(16, 8, file=path, dtype=jnp.bfloat16, engine="inplace",
           policy=JPolicy(gate_dtype="float32"), telemetry=jt)
    r = tsolve(16, 8, file=path, dtype="bfloat16", engine="inplace",
               policy=ResiliencePolicy(gate_dtype="float32"),
               telemetry=tt, device="cpu")
    assert _ladder_names(tt) == _ladder_names(jt)
    assert [x["rung"] for x in r.recovery] == ["refine", "resolve"]
    assert r.trace.find("recover").attrs["recovered_by"] == "resolve"


def test_solve_system_and_update_span_trees():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((48, 48)) + 8 * np.eye(48)
    b = rng.standard_normal((48, 2))
    tel = tspans.Telemetry()
    res = solve_system(a, b, block_size=16, telemetry=tel, device="cpu")
    assert [c.name for c in res.trace.children] == [
        "load", "select", "execute", "residual"]
    esp = res.trace.find("execute")
    assert res.elapsed == esp.duration and esp.attrs["gflops"] >= 0
    assert esp.attrs["workload"] == "solve"
    lsq = lstsq(a[:, :24], b, block_size=8, telemetry=tel, device="cpu")
    assert lsq.inner.trace.attrs["workload"] == "solve_spd"
    u = rng.standard_normal((48, 2)) * 0.01
    upd = solve_update(a, np.linalg.inv(a), u, u, telemetry=tel,
                       device="cpu")
    sp = [r for r in tel.roots if r.name == "solve_update"][-1]
    assert upd.elapsed == sp.find("execute").duration


def test_workload_counter_counts_every_entry_point():
    ctr = REGISTRY.counter("tpu_jordan_torch_workload_requests_total")
    before = {w: ctr.value(workload=w) for w in ("solve", "solve_spd",
                                                 "lstsq", "update")}
    a = np.eye(16) * 3 + 0.1
    b = np.ones((16, 1))
    solve_system(a, b, device="cpu")
    lstsq(a, b, device="cpu")
    solve_update(a, np.linalg.inv(a), b * 0.01, b * 0.01, device="cpu")
    assert ctr.value(workload="solve") == before["solve"] + 1
    assert ctr.value(workload="lstsq") == before["lstsq"] + 1
    assert ctr.value(workload="solve_spd") == before["solve_spd"] + 1
    assert ctr.value(workload="update") == before["update"] + 1


def test_retry_is_counted_and_recorded():
    ctr = REGISTRY.counter("tpu_jordan_torch_retries_total")
    before = ctr.value(component="unit")
    mark = RECORDER.total
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise OSError("INTERNAL: transient")
        return 7

    assert RetryPolicy(max_retries=1).call(flaky, component="unit") == 7
    assert ctr.value(component="unit") == before + 1
    ev = [e for e in RECORDER.since(mark) if e["kind"] == "retry"]
    assert ev[0]["component"] == "unit" and ev[0]["error"] == "OSError"


def _check(*paths):
    return subprocess.run([sys.executable,
                           str(TOOLS / "check_telemetry.py"),
                           *map(str, paths)],
                          capture_output=True, text=True)


def test_exports_pass_the_checker(tmp_path):
    tel = tspans.Telemetry()
    tsolve(32, 8, generator="rand", engine="grouped_pallas", telemetry=tel,
           numerics="trace", device="cpu")
    a = np.eye(16) * 3 + 0.1
    lstsq(a, np.ones((16, 1)), telemetry=tel, device="cpu")
    solve_update(a, np.linalg.inv(a), np.ones((16, 1)) * 0.01,
                 np.ones((16, 1)) * 0.01, telemetry=tel, device="cpu")
    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    export.write_metrics(str(prom))
    export.write_chrome_trace(str(trace), tel)
    out = _check(prom, trace)
    assert out.returncode == 0, out.stdout + out.stderr
    names = {line.split()[2] for line in prom.read_text().splitlines()
             if line.startswith("# TYPE")}
    assert all(NAME_RE.match(n) for n in names)
    for jax_name in ("tpu_jordan_solves_total", "tpu_jordan_solve_seconds",
                     "tpu_jordan_pivot_condition", "tpu_jordan_residual",
                     "tpu_jordan_growth_factor",
                     "tpu_jordan_workload_requests_total",
                     "tpu_jordan_capacity_bytes"):
        assert jax_name.replace("tpu_jordan_", "tpu_jordan_torch_", 1) \
            in names


def test_a_modeled_fused_phase_fails_the_checker(tmp_path):
    tel = tspans.Telemetry()
    with tel.span("execute", engine="grouped_pallas") as esp:
        pass
    tspans.attribute_phases(esp, 64, 8)
    trace = tmp_path / "t.json"
    export.write_chrome_trace(str(trace), tel)
    assert _check(trace).returncode == 1


def test_journey_refusals():
    """Journey lanes were refused until the serving stack came; now a
    journey event becomes its request's async lane beside the spans, and an
    empty list adds nothing."""
    tel = tspans.Telemetry()
    with tel.span("solve"):
        pass
    doc = export.to_chrome_trace(tel, journey_events=[
        {"kind": "journey", "request_id": "req-00001", "event": "submit",
         "t": 1.0}])
    assert [e["ph"] for e in doc["traceEvents"]] == ["X", "b", "n", "e"]
    assert export.to_chrome_trace(None, journey_events=[]) == {
        "traceEvents": [], "displayTimeUnit": "ms"}


def test_cli_writes_every_export(tmp_path):
    paths = {k: tmp_path / k for k in ("m.prom", "t.json", "cap.json",
                                       "bb.json")}
    rc = tmain(["48", "16", "--generator", "rand", "--device", "cpu",
                "--numerics", "trace", "--metrics-out", str(paths["m.prom"]),
                "--trace-json", str(paths["t.json"]),
                "--capacity-report", str(paths["cap.json"]),
                "--blackbox-out", str(paths["bb.json"])])
    assert rc == 0
    assert _check(paths["m.prom"], paths["t.json"]).returncode == 0
    cap = json.loads(paths["cap.json"].read_text())
    assert cap["components"]["device"] == {"kind": "sampled",
                                           "available": False}
    assert json.loads(paths["bb.json"].read_text())["metric"] == "blackbox"


@pytest.mark.parametrize("argv", [
    ["--numerics-demo", "--batch", "2"], ["--numerics-demo", "--tune"],
    ["--numerics-demo", "--group", "2"], ["--batch", "2", "--numerics",
                                          "summary"]])
def test_cli_usage_errors_still_write_metrics(argv, tmp_path):
    prom = tmp_path / "m.prom"
    rc = tmain(["16", "8", "--device", "cpu", "--metrics-out", str(prom),
                *argv])
    assert rc == 1 and prom.exists()


def test_cli_exit_2_dumps_the_flight_recorder(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc = tmain(["16", "8", "--generator", "hilbert", "--dtype", "float32",
                "--engine", "inplace", "--device", "cpu"])
    dump = tmp_path / "tpu_jordan_torch_blackbox.json"
    assert rc == 2 and json.loads(dump.read_text())["metric"] == "blackbox"


def test_cli_numerics_demo_line_passes_the_checker(tmp_path, capsys):
    rc = tmain(["16", "8", "--numerics-demo", "--chaos-seed", "7",
                "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    report = json.loads(line)
    assert rc == 0 and report["seed"] == 7
    path = tmp_path / "r.json"
    path.write_text(line)
    out = subprocess.run([sys.executable, str(TOOLS / "check_numerics.py"),
                          str(path)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
