"""The port's profiling shim (``utils/profiling.py``) against the JAX
package's: ``invert_flops`` and ``workload_flops`` give the JAX values,
``Scoreboard`` reports as the JAX one does, ``timed`` records its block as
a span whose duration is the scoreboard's and whose GFLOP/s rides as an
attribute, as in the JAX package, and ``trace`` writes a profiler trace.
The package exports the JAX package's ``utils`` names."""

import json
import os

import pytest
import torch

import tpu_jordan.utils as jutils
from tpu_jordan.obs.spans import Telemetry as JTelemetry
from tpu_jordan.utils import profiling as jprof

import tpu_jordan_torch.utils as tutils
from tpu_jordan_torch.obs.spans import Telemetry
from tpu_jordan_torch.utils import profiling as tprof


def test_exports_are_the_jax_names():
    assert sorted(tutils.__all__) == sorted(jutils.__all__)
    for name in ("Scoreboard", "timed", "trace", "invert_flops"):
        assert getattr(tutils, name) is getattr(tprof, name)


@pytest.mark.parametrize("n", [1, 64, 1000, 8192])
def test_invert_flops_equal_jax(n):
    assert tprof.invert_flops(n) == jprof.invert_flops(n)


@pytest.mark.parametrize("n,workload,k,rows", [
    (64, "invert", 1, None), (4096, "solve", 16, None),
    (512, "solve_spd", 1, None), (256, "update", 8, None),
    (128, "lstsq", 2, 256)])
def test_workload_flops_equal_jax(n, workload, k, rows):
    assert (tprof.workload_flops(n, workload, k=k, rows=rows)
            == jprof.workload_flops(n, workload, k=k, rows=rows))


@pytest.mark.parametrize("elapsed,flops", [(0.0, None), (1.5, None),
                                           (0.25, 2e9), (0.0, 2e9)])
def test_scoreboard_reports_as_jax(elapsed, flops):
    t = tprof.Scoreboard("x", elapsed=elapsed, flops=flops)
    j = jprof.Scoreboard("x", elapsed=elapsed, flops=flops)
    assert t.report() == j.report() and t.gflops == j.gflops


@pytest.mark.parametrize("flops", [None, 1e6])
def test_timed_records_a_span_as_jax(flops):
    tel, jtel = Telemetry(), JTelemetry()
    with tprof.timed("block", flops=flops, sync=torch.zeros(1),
                     telemetry=tel) as sb:
        sum(range(1000))
    with jprof.timed("block", flops=flops, telemetry=jtel) as jsb:
        sum(range(1000))
    sp, jsp = tel.find("block"), jtel.find("block")
    assert sb.elapsed == sp.duration > 0
    assert jsb.elapsed == jsp.duration > 0
    assert set(sp.attrs) == set(jsp.attrs)
    if flops is not None:
        assert sp.attrs["gflops"] == round(sb.gflops, 3)
    # Without a telemetry the block still times itself.
    with tprof.timed("quiet") as sb2:
        pass
    assert sb2.elapsed >= 0 and "glob_time" in sb2.report()


def test_trace_writes_a_profiler_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as d:
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    with open(os.path.join(d, "trace.json")) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
