"""The port's metrics registry and flight recorder against the JAX
package's, on the CPU: the same operations give the same snapshots (but
for the names' prefix), percentiles and dumps."""

import threading

import numpy as np
import pytest

from tpu_jordan.obs import metrics as jmetrics
from tpu_jordan.obs import recorder as jrecorder

from tpu_jordan_torch.obs import metrics as tmetrics
from tpu_jordan_torch.obs import recorder as trecorder


@pytest.mark.parametrize("k", [0, 1, 2, 5, 19, 100])
def test_percentiles_match_jax(k):
    samples = list(np.random.default_rng(k).exponential(1e-3, size=k))
    assert tmetrics.percentiles(samples) == jmetrics.percentiles(samples)


def _drive(reg, prefix):
    c = reg.counter(f"{prefix}_events_total", "events")
    c.inc()
    c.inc(2.5, bucket="512")
    reg.gauge(f"{prefix}_depth", "depth").set(7, lane="a")
    h = reg.histogram(f"{prefix}_latency_seconds", "latency")
    for v in np.random.default_rng(1).uniform(0, 1, size=50):
        h.observe(float(v), bucket="512")
    return reg.snapshot()


def test_registry_snapshot_matches_jax():
    got = _drive(tmetrics.MetricsRegistry(), "tpu_jordan_torch")
    ref = _drive(jmetrics.MetricsRegistry(), "tpu_jordan")
    assert {k.replace("tpu_jordan_torch_", ""): v for k, v in got.items()} \
        == {k.replace("tpu_jordan_", ""): v for k, v in ref.items()}


def test_registry_contract():
    reg = tmetrics.MetricsRegistry()
    c = reg.counter("tpu_jordan_torch_x_total")
    assert reg.counter("tpu_jordan_torch_x_total") is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("tpu_jordan_torch_x_total")
    for bad in ("tpu_jordan_x_total", "tpu_jordan_torch_X", "x_total"):
        with pytest.raises(ValueError, match="namespace"):
            reg.counter(bad)
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1)
    c.inc(3, lane="a")
    c.inc(1)
    assert c.total() == 4 and c.value(lane="a") == 3
    h = reg.histogram("tpu_jordan_torch_h_seconds")
    assert h.percentiles() == {"p50": None, "p95": None, "p99": None}
    assert h.value() == 0.0
    reg.reset()
    assert reg.names() == []


def test_reservoir_is_bounded():
    res = tmetrics.Reservoir(maxlen=4)
    res.extend(range(10))
    assert res.samples == [6.0, 7.0, 8.0, 9.0]
    assert (res.count, res.total) == (10, 45.0)


def test_counter_is_thread_safe():
    c = tmetrics.MetricsRegistry().counter("tpu_jordan_torch_t_total")

    def work():
        for _ in range(1000):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.total() == 8000


def _clock():
    t = [0.0]

    def tick():
        t[0] += 0.5
        return t[0]
    return tick


def test_recorder_dump_matches_jax():
    """The same events through both recorders, each on a fake clock and a
    ring of 4: equal dumps, of the window and of a slice."""
    out = []
    for mod in (trecorder, jrecorder):
        rec = mod.FlightRecorder(capacity=4, clock=_clock())
        mark = None
        for i in range(7):
            if i == 4:
                mark = rec.total
            rec.record("retry", attempt=i)
        rec.record("fault_injected", point="measure", t=99.0)
        out.append((rec.dump(), rec.dump(rec.since(mark)),
                    rec.events("fault_injected")))
    assert out[0] == out[1]
    window = out[0][0]
    assert (window["recorded_total"], window["retained"],
            window["dropped"]) == (8, 4, 4)


def test_recorder_write_and_reset(tmp_path):
    rec = trecorder.FlightRecorder(capacity=8)
    assert rec.record("plan_cache_write_failure", error="disk") == 1
    path = tmp_path / "box.json"
    rec.write(str(path))
    assert '"plan_cache_write_failure"' in path.read_text()
    rec.reset()
    assert rec.total == 0 and rec.events() == []
    with pytest.raises(ValueError):
        trecorder.FlightRecorder(capacity=0)
