"""Finding a cell and everything it names, from ``BENCHMARK.json``.

A cell is one entry of ``workloads``: a configuration under a traffic mix.
Its files are found by name: ``configs/<config>.json``,
``workloads/<traffic>.json``, ``cells/<cell>.json``, the entry
``entries/<traffic["entry"]>.py`` and a reader ``metrics/<metric>.py`` for
every metric that the cell reports.  Adding a cell, a traffic mix or a
metric adds files; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(RuntimeError):
    """BENCHMARK.json, or a file it names, is missing or inconsistent."""


@dataclass
class Cell:
    """One cell, with its configuration, traffic, limits and metrics."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def n(self) -> int:
        return int(self.traffic["n"])

    @property
    def block_size(self) -> int:
        return int(self.traffic["block_size"])

    @property
    def batch(self) -> int:
        return int(self.traffic.get("batch", 1))

    @property
    def dtype_name(self) -> str:
        return self.config["dtype"]


def read_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{path} not found") from None
    except json.JSONDecodeError as exc:
        raise SpecError(f"{path}: {exc}") from None


def benchmark(root: Path = ROOT) -> dict:
    return read_json(Path(root) / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its files."""
    spec = benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names config {w['config']!r}, "
                        "which BENCHMARK.json does not list")
    base = Path(root) / HERE.name
    config = read_json(Path(root) / configs[w["config"]]["file"])
    traffic = read_json(base / "workloads" / f"{w['traffic']}.json")
    limits = read_json(base / "cells" / f"{name}.json")["limits"]
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"{path} not found")
    mod_name = f"gpubench.{kind}.{name}".replace("-", "_")
    loader = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module


def entry_module(name: str):
    """``entries/<name>.py``: ``make(cell, device)`` returns the entry."""
    return _module("entries", name)


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(run)``: the metric's value, or None
    where the run holds nothing to read it from."""
    return _module("metrics", name).read
