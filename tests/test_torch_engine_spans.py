"""The engines' own spans (``tpu_jordan_torch/obs/spans.py``,
``ops/jordan_inplace.py``, ``ops/batched.py``) on the CPU.

With a retaining ``Telemetry``, or while a ``torch.profiler`` collects,
``JordanSolver.invert``/``invert_batch`` are ``invert``/``invert_batch``
spans around an ``execute`` child that holds the engine's measured
``setup``, one ``step`` a superstep with ``pivot``/``permute``/
``eliminate``, and ``finalize`` with its ``readback``.  Under the
profiler each span is a host-only ``tj::<name>`` range nested as the
tree is, never a user annotation.  With spans off a call makes no span
and leaves every sink alone, and the answers are the same bits either
way.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_jordan_torch.driver import solve, solve_batch
from tpu_jordan_torch.models import JordanSolver
from tpu_jordan_torch.obs import spans
from tpu_jordan_torch.obs.metrics import REGISTRY
from tpu_jordan_torch.ops import jordan_inplace

N, M = 40, 8
NR = N // M

ENGINES = {
    "inplace": dict(engine="inplace"),
    "grouped": dict(engine="grouped", group=2),
    "lookahead": dict(engine="lookahead"),
    "grouped_lookahead": dict(engine="lookahead", group=2),
    "grouped_pallas": dict(engine="grouped_pallas", group=2,
                           dtype="float32"),
}
ALL = [*ENGINES, "batched"]
STEP_PHASES = ["pivot", "permute", "eliminate"]


def _matrix(batch=None, seed=3):
    rng = np.random.default_rng(seed)
    shape = (N, N) if batch is None else (batch, N, N)
    return rng.standard_normal(shape) + 4.0 * np.eye(N)


def _solver(kind, telemetry=None, **kw):
    cfg = {"dtype": "float64", **ENGINES.get(kind, {})}
    return JordanSolver(n=N, block_size=M, device="cpu",
                        telemetry=telemetry, **cfg, **kw)


def _call(kind, solver):
    if kind == "batched":
        return solver.invert_batch(_matrix(batch=3))
    return solver.invert(_matrix())


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _ranges(prof):
    return [(e.name[4:], e.time_range.start, e.time_range.end,
             e.is_user_annotation)
            for e in prof.events() if e.name.startswith("tj::")]


def _parents(ranges):
    """Each range's innermost enclosing ``tj::`` range (None at the
    top)."""
    out = []
    for i, (name, a, b, _) in enumerate(ranges):
        inside = [r for j, r in enumerate(ranges)
                  if j != i and r[1] <= a and b <= r[2]
                  and (r[1], -r[2]) != (a, -b)]
        best = max(inside, key=lambda r: (r[1], -r[2]), default=None)
        out.append((name, best[0] if best else None))
    return out


@pytest.mark.parametrize("kind", ALL)
def test_profiler_ranges_nest_as_the_spans(kind):
    solver = _solver(kind)
    _, prof = _profiled(lambda: _call(kind, solver))
    ranges = _ranges(prof)
    assert ranges and not any(r[3] for r in ranges)
    pairs = _parents(ranges)
    entry = "invert_batch" if kind == "batched" else "invert"
    assert (entry, None) in pairs and ("execute", entry) in pairs
    steps = [p for p in pairs if p[0] == "step"]
    assert steps == [("step", "execute")] * NR
    for name, parent in pairs:
        if name in ("setup", "finalize"):
            assert parent == "execute"
        elif name == "readback":
            assert parent == "finalize"
        elif name in ("permute", "eliminate"):
            assert parent == "step"
    pivots = [parent for name, parent in pairs if name == "pivot"]
    if "lookahead" in kind:
        # Each step takes its decision under its own pivot; the probes
        # ahead run under the execute (the prologue) or a step's
        # eliminate.
        assert pivots.count("step") == NR
        assert sorted(set(pivots) - {"step"}) <= ["eliminate", "execute"]
    else:
        assert pivots == ["step"] * NR


@pytest.mark.parametrize("kind", ALL)
def test_spans_off_make_no_span_and_touch_no_sink(kind, monkeypatch):
    made = []

    class Counted(spans.Span):
        def __post_init__(self):
            made.append(self.name)

    def refuse(*a, **k):
        raise AssertionError("a telemetry span was opened")

    solver = _solver(kind)
    monkeypatch.setattr(spans, "Span", Counted)
    monkeypatch.setattr(spans.Telemetry, "span", refuse)
    monkeypatch.setattr(spans.NullTelemetry, "span", refuse)
    before = spans.PROFILED.roots
    _call(kind, solver)
    assert made == [] and spans.PROFILED.roots == before
    assert spans.sink() is None and spans.active(None) is None


@pytest.mark.parametrize("on", ["telemetry", "profiler"])
@pytest.mark.parametrize("kind", ALL)
def test_answers_are_the_same_bits_with_spans_on(kind, on):
    x0, f0 = _call(kind, _solver(kind))
    if on == "telemetry":
        tel = spans.Telemetry()
        x1, f1 = _call(kind, _solver(kind, telemetry=tel))
        assert tel.find("step") is not None
    else:
        solver = _solver(kind)
        (x1, f1), prof = _profiled(lambda: _call(kind, solver))
        assert _ranges(prof)
    assert torch.equal(x0, x1) and torch.equal(f0, f1)


def _measured_execute(kind, entry):
    tel = spans.Telemetry()
    if entry == "solver":
        _call(kind, _solver(kind, telemetry=tel))
    elif kind == "batched":
        solve_batch(N, M, batch=2, generator="rand", dtype="float64",
                    device="cpu", telemetry=tel)
    else:
        cfg = {"dtype": "float64", **ENGINES[kind]}
        solve(N, M, generator="rand", device="cpu", telemetry=tel, **cfg)
    return tel.find("execute")


@pytest.mark.parametrize("entry", ["solver", "driver"])
@pytest.mark.parametrize("kind", ALL)
def test_measured_phases_nest_under_execute(kind, entry):
    esp = _measured_execute(kind, entry)
    kids = [c for c in esp.children if c.name != "pivot"]
    assert [c.name for c in kids] == (
        ["setup"] + ["step"] * NR + ["finalize"])
    steps = kids[1:-1]
    assert [s.attrs["t"] for s in steps] == list(range(NR))
    for s in steps:
        assert [c.name for c in s.children] == STEP_PHASES
        assert s.device_seconds is not None
        assert all(c.device_seconds is not None for c in s.children)
    assert [c.name for c in kids[-1].children] == ["readback"]
    assert kids[-1].device_seconds is not None
    assert esp.device_seconds == esp.duration
    assert not [sp for sp in esp.walk() if "modeled" in sp.attrs]


def test_augmented_execute_has_no_phase_children():
    tel = spans.Telemetry()
    r = solve(N, M, generator="rand", engine="augmented", device="cpu",
              telemetry=tel)
    assert r.trace.find("execute").children == []


@pytest.mark.parametrize("kind", ["lookahead", "grouped_lookahead"])
def test_probe_ahead_pivots_are_overlapped(kind):
    tel = spans.Telemetry()
    _call(kind, _solver(kind, telemetry=tel))
    ahead = [sp for sp in tel.spans()
             if sp.name == "pivot" and sp.attrs.get("overlapped")]
    group = ENGINES[kind].get("group", 1)
    assert [sp.attrs["t"] for sp in ahead] == list(range(0, NR, group))
    assert all(sp.device_seconds is not None for sp in ahead)


@pytest.mark.parametrize("kind", ["inplace", "batched"])
def test_solver_with_telemetry_reaches_the_registry(kind):
    solves = REGISTRY.counter("tpu_jordan_torch_solves_total")
    hist = REGISTRY.histogram("tpu_jordan_torch_solve_seconds")
    before = solves.total(), hist.value()
    tel = spans.Telemetry()
    _call(kind, _solver(kind, telemetry=tel))
    esp = tel.find("execute")
    assert solves.total() == before[0] + 1
    assert hist.value() == pytest.approx(before[1] + esp.duration)
    batch = 3 if kind == "batched" else 1
    assert esp.attrs["batch"] == batch
    assert esp.attrs["gflops"] == round(
        2.0 * N ** 3 * batch / esp.duration / 1e9, 3)
    assert esp.attrs["achieved_tflops_analytical"] > 0


def test_solver_without_telemetry_leaves_the_registry_alone():
    solves = REGISTRY.counter("tpu_jordan_torch_solves_total")
    before = solves.total()
    _call("inplace", _solver("inplace"))
    assert solves.total() == before


def test_profiled_calls_go_to_the_bounded_process_sink(monkeypatch):
    sink = spans.Telemetry(max_roots=2)
    monkeypatch.setattr(spans, "PROFILED", sink)
    solver = _solver("inplace")
    _profiled(lambda: [solver.invert(_matrix(seed=s)) for s in range(3)])
    assert [r.name for r in sink.roots] == ["invert", "invert"]
    assert sink.roots[-1].find("execute").find("step") is not None
    solver.invert(_matrix())
    assert len(sink.roots) == 2


def test_where_spans_go():
    tel = spans.Telemetry()
    assert spans.sink() is None and spans.active(tel) is tel
    assert spans.active(spans.NULL) is None
    with tel.span("outer"):
        assert spans.sink() is tel
        with spans.NULL.span("inner"):
            assert spans.sink() is tel
    assert spans.sink() is None

    def inside():
        with spans.NULL.span("solve"):
            return spans.sink(), spans.active(None)

    (got, act), _ = _profiled(inside)
    assert got is spans.PROFILED and act is spans.PROFILED


def test_device_seconds_on_the_cpu_is_the_host_duration():
    ticks = iter(range(10))
    tel = spans.Telemetry(clock=lambda: 0.5 * next(ticks))
    with tel.span("step", device=torch.device("cpu"), t=0) as sp:
        with tel.span("readback") as rb:
            pass
    assert sp.duration == 1.5 and sp.device_seconds == 1.5
    assert rb.device_seconds is None
    assert sp.to_dict()["device_seconds"] == 1.5
    assert "device_seconds" not in rb.to_dict()


def test_segments_record_their_steps():
    a = torch.from_numpy(_matrix())
    n, m, eps, nr, _, V = jordan_inplace._setup(a, M, None)
    singular, swaps = jordan_inplace._carry(nr, a.device)
    tel = spans.Telemetry()
    with tel.span("segment"):
        jordan_inplace.invert_segment(V, singular, swaps, t0=1, t1=3,
                                      Nr=nr, m=m, eps=eps)
    seg = tel.find("segment")
    assert [(c.name, c.attrs["t"]) for c in seg.children] == [
        ("step", 1), ("step", 2)]


def test_refine_is_a_span_of_its_own():
    tel = spans.Telemetry()
    _solver("inplace", telemetry=tel, refine=1).invert(_matrix())
    ref = tel.find("execute").children[-1]
    assert ref.name == "refine" and ref.attrs["steps"] == 1
    assert ref.device_seconds is not None
