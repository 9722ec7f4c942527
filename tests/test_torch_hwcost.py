"""The port's hardware-cost layer and capacity ledger
(``tpu_jordan_torch/obs/hwcost.py``, ``obs/capacity.py``) against the JAX
package's, on the CPU.

Eager PyTorch compiles no executable, so ``executable_cost`` is
``UNAVAILABLE`` on every backend and nothing modeled stands in its place;
the flop conventions, the attribute names of an execute span, the sticky
device watermark (with an injected sampler) and the ledger's
reconciliation ``created == live + evicted`` are the JAX package's, case
for case.  The device watermark stays unavailable on the CPU.
"""

import json
import os

import pytest

from tpu_jordan.obs import capacity as jcapacity
from tpu_jordan.obs import hwcost as jhwcost
from tpu_jordan.obs.metrics import REGISTRY as JREGISTRY
from tpu_jordan.obs.spans import Span as JSpan

from tpu_jordan_torch.obs import capacity as tcapacity
from tpu_jordan_torch.obs import hwcost as thwcost
from tpu_jordan_torch.obs.metrics import REGISTRY as TREGISTRY
from tpu_jordan_torch.obs.spans import Span as TSpan

# (hwcost module, capacity module, registry, metric prefix, span class)
PACKAGES = {
    "jax": (jhwcost, jcapacity, JREGISTRY, "tpu_jordan_", JSpan),
    "torch": (thwcost, tcapacity, TREGISTRY, "tpu_jordan_torch_", TSpan),
}


@pytest.mark.parametrize("workload,k,rows", [
    ("invert", 1, None), ("solve", 1, None), ("solve", 64, None),
    ("solve_spd", 16, None), ("update", 16, None), ("lstsq", 4, 256)])
def test_flop_conventions_match_jax(workload, k, rows):
    for n in (64, 1000, 8192):
        assert thwcost.baseline_workload_flops(n, workload, k, rows) == \
            jhwcost.baseline_workload_flops(n, workload, k, rows)
    assert thwcost.baseline_invert_flops(96) == \
        jhwcost.baseline_invert_flops(96)


def test_update_convention_is_the_update_modules():
    from tpu_jordan_torch.linalg import update_flops

    assert thwcost.baseline_workload_flops(8192, "update", 16) == \
        update_flops(8192, 16)


@pytest.mark.parametrize("compiled", [None, object(), "anything"])
def test_executable_cost_is_unavailable_never_modeled(compiled):
    cost = thwcost.executable_cost(compiled)
    assert cost is thwcost.UNAVAILABLE and cost.available is False
    doc = cost.to_json()
    assert all(doc[f] is None for f in (
        "flops", "bytes_accessed", "argument_bytes", "output_bytes",
        "temp_bytes", "hbm_bytes", "arithmetic_intensity"))


@pytest.mark.parametrize("workload", ["invert", "solve", "update"])
def test_solve_execute_span_has_the_analytical_rate_only(workload):
    """End to end on the CPU: the execute span of an invert, a solve and
    an update carries the workload's analytical rate and no compiler
    attribute (the cost is unavailable, and nothing stands in for it)."""
    import numpy as np

    from tpu_jordan_torch.driver import solve
    from tpu_jordan_torch.linalg import solve_system, solve_update
    from tpu_jordan_torch.obs.spans import Telemetry

    tel = Telemetry()
    rng = np.random.default_rng(7)
    a = rng.standard_normal((48, 48)) + 48 * np.eye(48)
    if workload == "invert":
        solve(48, 16, generator="rand", device="cpu", telemetry=tel)
    elif workload == "solve":
        solve_system(a, rng.standard_normal((48, 2)), block_size=16,
                     device="cpu", telemetry=tel)
    else:
        solve_update(a, np.linalg.inv(a), 1e-2 * rng.standard_normal(
            (48, 4)), rng.standard_normal((48, 4)), device="cpu",
            telemetry=tel)
    spans = [sp for r in tel.roots for sp in r.walk()
             if sp.name == "execute"]
    assert spans
    for sp in spans:
        assert sp.attrs["achieved_tflops_analytical"] > 0
        assert not [k for k in sp.attrs if "xla" in k
                    or k == "arithmetic_intensity"]


def test_attach_execute_cost_keeps_the_analytical_rate():
    """An unavailable cost still puts the 2n³ rate on the span, and no
    compiler attribute; the JAX package attaches nothing then."""
    sp = TSpan("execute", 0.0, 0.5)
    thwcost.attach_execute_cost(sp, thwcost.UNAVAILABLE,
                                analytical_flops=2.0 * 1000 ** 3)
    assert sp.attrs == {"achieved_tflops_analytical": 0.004}
    js = JSpan("execute", 0.0, 0.5)
    jhwcost.attach_execute_cost(js, jhwcost.UNAVAILABLE,
                                analytical_flops=2.0 * 1000 ** 3)
    assert js.attrs == {}


def test_attach_execute_cost_with_a_cost_matches_jax():
    """Given the same available record, the span attributes are the JAX
    package's."""
    kw = dict(available=True, flops=3.2e9, bytes_accessed=4.0e8,
              argument_bytes=100, output_bytes=50, temp_bytes=7)
    sp, js = TSpan("execute", 1.0, 1.25), JSpan("execute", 1.0, 1.25)
    thwcost.attach_execute_cost(sp, thwcost.ExecutableCost(**kw), 2.0e9)
    jhwcost.attach_execute_cost(js, jhwcost.ExecutableCost(**kw), 2.0e9)
    assert sp.attrs == js.attrs
    assert thwcost.ExecutableCost(**kw).hbm_bytes == 157


@pytest.mark.parametrize("pkg", PACKAGES)
def test_unsupported_first_probe_sticky_forever(pkg):
    hw = PACKAGES[pkg][0]
    calls = []

    def sampler():
        calls.append(1)
        return None if len(calls) == 1 else {"bytes_in_use": 9}

    wm = hw.DeviceMemoryWatermark(sampler=sampler)
    assert wm.sample() is None and wm.available is False
    assert wm.sample() is None and wm.sample() is None
    assert calls == [1]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_supported_backend_reprobed_every_sample(pkg):
    hw = PACKAGES[pkg][0]
    vals = iter([100, 200, 300])
    calls = []

    def sampler():
        v = next(vals)
        calls.append(v)
        return {"bytes_in_use": v, "peak_bytes_in_use": 300}

    wm = hw.DeviceMemoryWatermark(sampler=sampler)
    assert wm.sample()["bytes_in_use"] == 100 and wm.available is True
    assert wm.sample()["bytes_in_use"] == 200
    assert wm.sample()["bytes_in_use"] == 300
    assert calls == [100, 200, 300]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_transient_none_never_zeroes(pkg):
    hw, _, reg, prefix, _ = PACKAGES[pkg]
    seq = iter([{"bytes_in_use": 77}, None, {"bytes_in_use": 88}])
    wm = hw.DeviceMemoryWatermark(sampler=lambda: next(seq))
    g = reg.gauge(prefix + "device_bytes_in_use")
    assert wm.sample(probe="t")["bytes_in_use"] == 77
    assert g.value(probe="t") == 77
    assert wm.sample(probe="t") is None and wm.available is True
    assert g.value(probe="t") == 77
    assert wm.sample(probe="t")["bytes_in_use"] == 88
    assert g.value(probe="t") == 88


@pytest.mark.parametrize("pkg", PACKAGES)
def test_capacity_snapshot_reprobes_supported_backend(pkg, monkeypatch):
    hw, cap = PACKAGES[pkg][:2]
    calls = []

    def sampler():
        calls.append(1)
        return {"bytes_in_use": 5, "peak_bytes_in_use": 6}

    monkeypatch.setattr(hw, "WATERMARK",
                        hw.DeviceMemoryWatermark(sampler=sampler))
    d1 = cap.snapshot()["components"]["device"]
    assert d1 == cap.snapshot()["components"]["device"] == {
        "kind": "sampled", "available": True, "bytes_live": 5,
        "peak_bytes_in_use": 6}
    assert len(calls) == 2


def test_cpu_device_watermark_stays_unavailable():
    assert thwcost.device_memory_stats("cpu") is None
    dev = tcapacity.snapshot()["components"]["device"]
    assert dev == {"kind": "sampled", "available": False}


def test_cuda_memory_stats_are_normalized(monkeypatch):
    """On a card the allocator's current and peak bytes become
    ``bytes_in_use``/``peak_bytes_in_use`` (the counters faked here)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "allocated_bytes.all.current": 268435456,
        "allocated_bytes.all.peak": 805306368})
    stats = thwcost.device_memory_stats()
    assert stats["bytes_in_use"] == 268435456
    assert stats["peak_bytes_in_use"] == 805306368


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ledger_register_release_reconciles(pkg):
    led = PACKAGES[pkg][1].CapacityLedger()
    led.register("plan_cache", "a", 100, detail="x")
    led.register("plan_cache", "b", 50, detail="x")
    assert led.live_bytes("plan_cache") == 150
    led.release("plan_cache", "a")
    snap = led.snapshot()["components"]["plan_cache"]
    assert (snap["bytes_created"], snap["bytes_live"],
            snap["bytes_evicted"], snap["high_water_bytes"]) == (
        150, 50, 100, 150)
    assert snap["breakdown"] == {"x": 50}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ledger_replace_and_double_release(pkg):
    led = PACKAGES[pkg][1].CapacityLedger()
    led.register("plan_cache", "k", 100)
    led.register("plan_cache", "k", 300)
    snap = led.snapshot()["components"]["plan_cache"]
    assert (snap["bytes_live"], snap["bytes_created"],
            snap["bytes_evicted"], snap["entries"]) == (300, 400, 100, 1)
    assert led.release("plan_cache", "k") == 300
    assert led.release("plan_cache", "k") == 0
    assert led.live_bytes("plan_cache") == 0
    with pytest.raises(ValueError):
        led.register("plan_cache", "k", -1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ledger_sampled_probes(pkg):
    led = PACKAGES[pkg][1].CapacityLedger()
    led.register_probe("ring", lambda: {"bytes": 42, "extra": 1})
    led.register_probe("dev", lambda: None)
    led.register_probe("boom", lambda: 1 / 0)
    comps = led.snapshot()["components"]
    assert comps["ring"] == {"kind": "sampled", "available": True,
                             "bytes_live": 42, "extra": 1}
    assert comps["dev"] == comps["boom"] == {"kind": "sampled",
                                             "available": False}


def test_process_ledger_mirrors_its_gauges():
    key = ("test_torch_hwcost", "gauges")
    tcapacity.register("plan_cache", key, 7, detail="test")
    assert TREGISTRY.gauge("tpu_jordan_torch_capacity_bytes").value(
        component="plan_cache") >= 7
    assert TREGISTRY.counter(
        "tpu_jordan_torch_capacity_bytes_created_total").value(
        component="plan_cache") >= 7
    assert tcapacity.release("plan_cache", key) == 7


def test_every_metered_class_reconciles():
    snap = tcapacity.snapshot()
    for name, doc in snap["components"].items():
        if doc["kind"] == "metered":
            assert doc["bytes_created"] == (doc["bytes_live"]
                                            + doc["bytes_evicted"]), name
    assert snap["components"]["flight_recorder"]["available"] is True


def test_plan_cache_bytes_are_in_the_ledger(tmp_path):
    """A plan cache registers its document at construction and again
    after each save (replace semantics), keyed by the cache."""
    from tpu_jordan_torch.tuning import plan_cache as pc
    from tpu_jordan_torch.tuning.tuner import auto_select

    path = str(tmp_path / "plans.json")
    cache = pc.PlanCache(path=path)
    before = tcapacity.live_bytes("plan_cache")
    auto_select(64, 8, "float32", 1, True, plan_cache=path, device="cpu")
    loaded = pc.PlanCache.load(path)
    size = os.path.getsize(path)
    assert len(loaded._document()) == size
    assert tcapacity.live_bytes("plan_cache") >= before + size
    entry = tcapacity.LEDGER.snapshot()["components"]["plan_cache"]
    assert entry["breakdown"][path] >= size
    loaded.save()
    assert tcapacity.LEDGER.snapshot()["components"]["plan_cache"][
        "bytes_created"] == (tcapacity.live_bytes("plan_cache")
                             + tcapacity.LEDGER.snapshot()["components"][
                                 "plan_cache"]["bytes_evicted"])
    del cache


def test_write_report_is_one_json_document(tmp_path):
    path = tmp_path / "capacity.json"
    tcapacity.write_report(str(path))
    doc = json.loads(path.read_text())
    assert set(doc) == {"components", "metered_bytes_live"}
    assert doc["components"]["device"]["available"] is False
