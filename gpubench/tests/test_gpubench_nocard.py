"""The measurement path refuses to run without a card, and without the
program beside it: a non-zero exit and no result line."""

import json
import shutil
import subprocess
import sys

import pytest

from gpubench import core, spec


def run(cwd, *args):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=600)


def has_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except json.JSONDecodeError:
        return False


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run(spec.ROOT, "--workload", "gj_fp64.n8192_m384", "--seed",
              str(2**31 + 5), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert not has_result(out.stdout)
    assert "no CUDA device" in out.stderr


def test_require_cards_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(core.NoDevice):
        core.require_cards(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(core.NoDevice):
        core.require_cards(4)


def test_run_of_a_cell_not_in_benchmark_json_exits_non_zero():
    out = run(spec.ROOT, "--workload", "gj_fp64.nope", "--seed", "1",
              "--seconds", "1")
    assert out.returncode != 0 and not has_result(out.stdout)


def test_run_with_only_the_benchmark_files_exits_non_zero(tmp_path):
    """A directory holding only BENCHMARK.json and the files under paths
    (no program): the run fails, with no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path, "--workload", "gj_fp32.n6000_m300", "--seed", "3",
              "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert not has_result(out.stdout)
