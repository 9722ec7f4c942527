"""What the benchmark may load and read.

No module of the harness imports JAX or the JAX package (compared by whole
top-level name: ``tpu_jordan_torch`` begins with ``tpu_jordan`` and is not
it); the yardstick (reference, inputs, work counts, trace reduction)
imports nothing of the program either; and no module names the JAX
package's old benchmark files."""

import ast
from pathlib import Path

import pytest

from gpubench import core, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_jordan"}
YARDSTICK = ("reference.py", "inputs.py", "work.py", "trace.py")
SOURCES = sorted(p for p in spec.HERE.rglob("*.py")
                 if "tests" not in p.relative_to(spec.HERE).parts)


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"):
            names.add("<dynamic>")
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    names = top_level_imports(spec.HERE / name)
    assert "tpu_jordan_torch" not in names
    assert names <= {"__future__", "bisect", "dataclasses", "hashlib",
                     "json", "math", "numpy", "pathlib", "random", "torch"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_nothing_reads_the_jax_benchmarks(path):
    text = path.read_text()
    assert "benchmarks/" not in text
    assert "bench.py" not in text
    assert "BASELINE." not in text and "BENCH_r" not in text


def test_forbidden_modules_compares_whole_top_level_names():
    assert core.forbidden_modules(["tpu_jordan_torch", "tpu_jordan_torch.ops",
                                   "jaxtyping", "torch"]) == []
    assert core.forbidden_modules(["tpu_jordan.ops", "jax._src",
                                   "flax"]) == ["flax", "jax", "tpu_jordan"]


def test_the_program_loads_no_forbidden_module(tmp_path):
    """A fresh interpreter that imports the harness and the program's
    entries holds no forbidden module afterwards."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r)\n"
            "from gpubench import core, spec\n"
            "import tpu_jordan_torch.models\n"
            "spec.entry_module('solver_invert')\n"
            "print(core.forbidden_modules())\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
