"""The readers of the program's own spans (``entry_self_ms``,
``engine_idle_ms``, ``pivot_ms``, ``permute_ms``) on a synthetic profile
and a synthetic span sink, including what each returns where the program
records nothing to read (a program without these spans: None, no
error)."""

import time
import types

import pytest

from gpubench import spec, trace
from test_gpubench_trace import synthetic_run

K = "void gj_probe_kernel<double>(double*)"


def span_profile():
    # Two calls; times in microseconds.  Call 1: invert [0, 100] with
    # execute [10, 90]; call 2: invert [200, 300], execute [205, 290].
    host = [("tj::invert", 0.0, 100.0), ("tj::execute", 10.0, 90.0),
            ("tj::step", 12.0, 50.0), ("aten::mm", 20.0, 22.0),
            ("tj::invert", 200.0, 300.0), ("tj::execute", 205.0, 290.0),
            ("cudaDeviceSynchronize", 120.0, 180.0)]
    # Device: busy [15, 40] ∪ [45, 95] ∪ [150, 160] ∪ [210, 280].  Gaps:
    # 40–45 (mid 42.5, in execute 1), 95–150 (mid 122.5, between calls),
    # 160–210 (mid 185, between calls).
    device = [(K, 15.0, 40.0), (K, 45.0, 95.0), ("Memcpy DtoD", 150.0,
                                                 160.0), (K, 210.0, 280.0)]
    return trace.Profile(device=device, host=host, calls=2, window_s=3e-4)


def read(name, run):
    return spec.metric_reader(name)(run)


def test_entry_self_ms():
    run = synthetic_run(profile=span_profile())
    # (100 − 80) + (100 − 85) µs over 2 calls.
    assert read("entry_self_ms", run) == pytest.approx(35e-3 / 2)


def test_engine_idle_ms():
    run = synthetic_run(profile=span_profile())
    assert read("engine_idle_ms", run) == pytest.approx(5e-3 / 2)
    # A launch gap of call 2: 280–282, mid 281, inside execute 2.
    run.profile.device.append((K, 282.0, 285.0))
    assert read("engine_idle_ms", run) == pytest.approx(7e-3 / 2)


class _Span:
    def __init__(self, name, device_s=None, children=()):
        self.name, self.device_seconds = name, device_s
        self.children = list(children)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def _call(pivot_s, permute_s, overlapped_s=None):
    steps = [_Span("step", 1.0, [_Span("pivot", pivot_s),
                                 _Span("permute", permute_s),
                                 _Span("eliminate", 0.5)])]
    if overlapped_s is not None:
        steps[0].children[2].children.append(_Span("pivot", overlapped_s))
    return _Span("invert", None, [_Span("execute", 2.0, steps)])


@pytest.fixture
def sink(monkeypatch):
    """The program's span module as the readers find it, with a
    synthetic process-wide sink."""
    import sys

    holder = types.SimpleNamespace(roots=[])
    mod = types.SimpleNamespace(PROFILED=holder)
    monkeypatch.setitem(sys.modules, "tpu_jordan_torch.obs.spans", mod)
    return holder


def test_pivot_and_permute_ms_read_the_last_calls(sink):
    run = synthetic_run(profile=span_profile())
    # An old root beyond the traced calls, a root of another entry, then
    # the two traced calls.
    sink.roots = [_call(9.0, 9.0), _Span("solve", None),
                  _call(1e-3, 2e-4, overlapped_s=3e-3), _call(2e-3, 4e-4)]
    assert read("pivot_ms", run) == pytest.approx((1 + 3 + 2) / 2)
    assert read("permute_ms", run) == pytest.approx(0.6 / 2)


def test_span_readers_find_nothing_to_read(sink, monkeypatch):
    import sys

    bare = trace.Profile(device=[(K, 0.0, 5.0), (K, 6.0, 9.0)],
                         host=[("aten::mm", 0.0, 9.0)], calls=2,
                         window_s=1e-5)
    run = synthetic_run(profile=bare)
    for name in ("entry_self_ms", "engine_idle_ms", "pivot_ms",
                 "permute_ms"):
        assert read(name, run) is None
        assert read(name, synthetic_run()) is None
    # Roots without device-timed phases; then a program without a sink.
    sink.roots = [_call(None, None)]
    assert read("pivot_ms", run) is None
    monkeypatch.setitem(sys.modules, "tpu_jordan_torch.obs.spans",
                        types.SimpleNamespace())
    sink.roots = [_call(1.0, 1.0)]
    assert read("pivot_ms", run) is None
    assert read("permute_ms", run) is None
    monkeypatch.delitem(sys.modules, "tpu_jordan_torch.obs.spans")
    assert read("pivot_ms", run) is None


def test_the_program_fills_the_sink_the_readers_read():
    """A profiled CPU call of the program, read back by the readers."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tpu_jordan_torch.models import JordanSolver

    solver = JordanSolver(n=32, block_size=8, dtype="float64",
                          engine="inplace", device="cpu")
    a = np.eye(32) * 4 + np.random.default_rng(1).standard_normal((32, 32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            solver.invert(a)
    run = synthetic_run(profile=trace.from_profiler(prof, 2, 1e-3))
    names = {h[0] for h in run.profile.host}
    assert {"tj::invert", "tj::execute", "tj::step", "tj::pivot",
            "tj::readback"} <= names
    assert not [d for d in run.profile.device if d[0].startswith("tj::")]
    assert read("entry_self_ms", run) > 0
    assert read("pivot_ms", run) > 0 and read("permute_ms", run) > 0


def _traced(session, pool, calls):
    """``calls`` calls under the profiler, each also timed by CUDA events
    around it: (Profile, median event ms a call)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        session.entry(pool[0])
        torch.cuda.synchronize()
    ms = []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            session.entry(pool[i % len(pool)])
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        window_s = time.perf_counter() - t0
    return (trace.from_profiler(prof, calls, window_s),
            statistics.median(ms))


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_spans_leave_the_device_side_alone(card, name, monkeypatch):
    """At the cell's own size, a traced stretch with the program's spans
    on and the same stretch with them patched off (the program sees no
    profiler) put the same device operations on the trace: as many a
    call, the same kernels a call, none of them a ``tj::`` range.  The
    profiler drops a few operations at a stretch's edge (up to 3 of 5,592
    on the card, with spans on or off alike), so a count a call is
    compared rounded.  Prints each side's traced call time, idle share and
    the new readers' values."""
    import collections
    import json

    from gpubench import core
    from tpu_jordan_torch.obs import spans as program_spans

    session = core.Session(spec.load_cell(name), "cuda")
    pool = session.pool(2**31 + 2207)
    session.warm(pool)
    calls, rows = 12, {}
    for side in ("on", "off", "on", "off"):
        with monkeypatch.context() as m:
            if side == "off":
                m.setattr(program_spans, "_profiling", lambda: False)
            p, event_ms = _traced(session, pool, calls)
        run = synthetic_run(name, profile=p)
        names = collections.Counter(trace.short_name(d[0])
                                    for d in p.device)
        row = {"device_per_call": len(p.device) / calls,
               "ops_per_call": {k: round(v / calls)
                                for k, v in sorted(names.items())},
               "launches_per_call": read("launches_per_call", run),
               "tj_on_device": sorted({d[0] for d in p.device
                                       if d[0].startswith("tj::")}),
               "traced_event_ms": event_ms,
               "idle_pct": read("idle_pct", run),
               "idle_gaps_ms_per_call": [[k, v * 1e3 / calls]
                                         for k, v in p.idle_gaps(6)]}
        if side == "on":
            for metric in ("entry_self_ms", "engine_idle_ms", "pivot_ms",
                           "permute_ms", "probe_ms"):
                row[metric] = read(metric, run)
        rows.setdefault(side, []).append(row)
    session.close()
    print(json.dumps({"cell": name, "rows": rows}))
    for on, off in zip(rows["on"], rows["off"]):
        assert (round(on["device_per_call"])
                == round(off["device_per_call"]))
        assert (round(on["launches_per_call"])
                == round(off["launches_per_call"]))
        assert on["ops_per_call"] == off["ops_per_call"]
        assert on["tj_on_device"] == off["tj_on_device"] == []
        assert on["pivot_ms"] >= on["probe_ms"]
