"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit file, entry and metric reader is found by name, and the
file keeps to the benchmark's contract."""

import json
import re
from pathlib import Path

import pytest

from gpubench import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_with_every_file(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert spec.entry_module(c.traffic["entry"]).make
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert float(c.limits["residual_ratio"]) > 1
    assert c.limits["singular_mismatches"] == 0
    assert c.config["control_arith"] in ("float32", "tf32")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = spec.load_cell(cell)
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer


def test_names_units_and_entries():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in BENCH[group]:
            assert NAME.match(item["name"]), item["name"]
            assert item["name"] not in seen
            seen.add(item["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert 1 <= len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("gpubench/")
        assert json.loads((spec.ROOT / c["file"]).read_text())["dtype"]


def test_every_config_has_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_every_metric_has_a_reader_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_missing_cell_is_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no_such.cell")


def test_a_new_cell_is_data_only(tmp_path):
    """A cell added by files alone (a traffic mix, a limit file and a
    BENCHMARK.json entry) loads without any change to the harness."""
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "gj_fp32.n4096_m128",
                               "config": "gj_fp32", "traffic": "n4096_m128",
                               "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("configs", "workloads", "cells"):
        (tmp_path / "gpubench" / sub).mkdir(parents=True)
    for c in bench["configs"]:
        (tmp_path / c["file"]).write_text((spec.ROOT / c["file"]).read_text())
    traffic = json.loads(
        (spec.HERE / "workloads" / "n6000_m300.json").read_text())
    (tmp_path / "gpubench" / "workloads" / "n4096_m128.json").write_text(
        json.dumps(dict(traffic, n=4096, block_size=128)))
    (tmp_path / "gpubench" / "cells" / "gj_fp32.n4096_m128.json").write_text(
        json.dumps({"limits": {"residual_ratio": 30.0,
                                "singular_mismatches": 0}}))
    c = spec.load_cell("gj_fp32.n4096_m128", root=Path(tmp_path))
    assert (c.n, c.block_size, c.dtype_name) == (4096, 128, "float32")
    assert [m["name"] for m in c.end_to_end] == ["gflops", "setup_s"]
    assert len(c.per_layer) == 0 or all(
        "gj_fp32.n4096_m128" in m.get("workloads", [c.name])
        for m in c.per_layer)
