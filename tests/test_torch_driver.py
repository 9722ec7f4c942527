"""The port's driver and command line against the JAX package's, on the
CPU: the same fixture through ``solve`` of both packages, the same argv
through both CLIs, and the port's refusals of what later slices bring."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_jordan import driver as jdriver
from tpu_jordan import io as jio
from tpu_jordan.ops import generate as jgenerate
from tpu_jordan.__main__ import main as jmain

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.config import default_block_size
from tpu_jordan_torch.tuning.tuner import auto_select as tauto_select
from tpu_jordan_torch.errors import (
    DeviceUnavailableError,
    SingularMatrixError,
    UsageError,
)


def _inf(x):
    return np.abs(x).sum(axis=-1).max()


def _gate(res, eps, n):
    """The residual gate of bench.py: rel_residual < min(3·eps·n·κ∞/‖A‖∞,
    0.5)."""
    return min(3.0 * eps * n * res.kappa / res._norm_a, 0.5)


@pytest.mark.parametrize("n,m,gen,np_dt", [
    (48, 8, "absdiff", np.float64),
    (64, 16, "rand", np.float32),
])
def test_solve_matches_jax(n, m, gen, np_dt):
    """Same engine chosen; both pass the residual gate; κ∞ agrees within
    10·eps·n·κ∞ (relative), the inverses' own tolerance."""
    ref = jdriver.solve(n, m, generator=gen, dtype=np_dt)
    got = tdriver.solve(n, m, generator=gen, dtype=np_dt, device="cpu")
    eps = float(np.finfo(np_dt).eps)
    assert got.engine == ref.engine == "inplace"
    assert got.rel_residual < _gate(got, eps, n)
    assert ref.rel_residual < _gate(ref, eps, n)
    assert abs(got.kappa - ref.kappa) / ref.kappa <= 10 * eps * n * ref.kappa
    assert got.inverse.dtype == getattr(torch, np.dtype(np_dt).name)
    assert got.device == "cpu" and got.gflops > 0


def test_solve_from_file_matches_jax(tmp_path):
    a = np.random.default_rng(5).standard_normal((16, 16))
    path = str(tmp_path / "a.txt")
    jio.write_matrix_file(path, a)
    ref = jdriver.solve(16, 8, file=path, dtype=np.float64)
    got = tdriver.solve(16, 8, file=path, dtype="float64", device="cpu")
    np.testing.assert_allclose(got.inverse.numpy(), np.asarray(ref.inverse),
                               rtol=0, atol=1e-10 * np.abs(
                                   np.asarray(ref.inverse)).max())


@pytest.mark.parametrize("n", [512, 4096, 8192, 16384])
def test_auto_engine_matches_jax_cost_rule(n):
    """The invert calls' engine resolution (resolve_invert_engine, and
    resolve_engine's "auto" with n) against the port's own tuner
    (auto_select, no plan cache) for a single-device fp32 solve at the
    default block size on the CPU.  The comparison with the JAX package's
    pick, which ranks with other chip constants, is
    tests/test_torch_tuning.py's grid."""
    engine, group, plan = tauto_select(n, default_block_size(n), np.float32,
                                       1, True, device="cpu")
    assert plan.source == "cost_model"
    got = tdriver.resolve_invert_engine("auto", 0, n, device="cpu")
    assert got[:2] == (engine, group) and got[2].source == "cost_model"
    assert tdriver.resolve_engine("auto", 0, n) == (engine, group)


@pytest.mark.parametrize("engine,group,expect", [
    ("grouped", 0, ("grouped", 2)),
    ("grouped", 3, ("grouped", 3)),
    ("auto", 4, ("grouped", 4)),
    ("inplace", 0, ("inplace", 0)),
    ("grouped_pallas", 0, ("grouped_pallas", 2)),
    ("grouped_pallas", 4, ("grouped_pallas", 4)),
    ("grouped_pallas_bf16", 0, ("grouped_pallas_bf16", 2)),
    ("grouped_pallas_bf16", 4, ("grouped_pallas_bf16", 4)),
    ("augmented", 0, ("augmented", 0)),
])
def test_resolve_engine_matches_jax(engine, group, expect):
    assert jdriver.resolve_engine(engine, group) == expect
    assert tdriver.resolve_engine(engine, group) == expect


@pytest.mark.parametrize("n", [512, 8192, 16384])
def test_auto_never_picks_the_fused_update_engines(n):
    assert tdriver.resolve_engine("auto", 0, n)[0] not in (
        tdriver.PALLAS_ENGINES)


def test_grouped_pallas_solve_matches_jax():
    """The fp32 fused-update engine through both packages' solve: same
    engine and group, both within the residual gate, κ∞ agreeing as in
    test_solve_matches_jax."""
    ref = jdriver.solve(64, 16, generator="rand", dtype=np.float32,
                        engine="grouped_pallas")
    got = tdriver.solve(64, 16, generator="rand", dtype=np.float32,
                        engine="grouped_pallas", device="cpu")
    eps = float(np.finfo(np.float32).eps)
    assert (got.engine, got.group) == (ref.engine, ref.group) == (
        "grouped_pallas", 2)
    assert got.rel_residual < _gate(got, eps, 64)
    assert ref.rel_residual < _gate(ref, eps, 64)
    assert abs(got.kappa - ref.kappa) / ref.kappa <= 10 * eps * 64 * ref.kappa
    assert got.recovery == () == ref.recovery


@pytest.mark.parametrize("gen,np_dt", [("absdiff", np.float64),
                                        ("rand", np.float32)])
def test_augmented_solve_matches_jax(gen, np_dt):
    """The reference-parity engine (global singularity scale) through both
    packages' solve: same engine, both within the residual gate, κ∞
    agreeing as in test_solve_matches_jax."""
    ref = jdriver.solve(64, 16, generator=gen, dtype=np_dt,
                        engine="augmented")
    got = tdriver.solve(64, 16, generator=gen, dtype=np_dt,
                        engine="augmented", device="cpu")
    eps = float(np.finfo(np_dt).eps)
    assert got.engine == ref.engine == "augmented"
    assert got.rel_residual < _gate(got, eps, 64)
    assert ref.rel_residual < _gate(ref, eps, 64)
    assert abs(got.kappa - ref.kappa) / ref.kappa <= 10 * eps * 64 * ref.kappa


@pytest.mark.parametrize("n,m,batch,gen,np_dt", [
    (64, 16, 4, "rand", np.float32),
    (96, 32, 3, "absdiff", np.float64),
    (128, 32, 2, "rand", np.float64),
])
def test_solve_batch_matches_jax(n, m, batch, gen, np_dt):
    """Both packages' solve_batch: element 0's residual within the gate on
    both sides, κ∞ agreeing as in test_solve_matches_jax, and every
    element's inverse within min(100·eps·κ∞, 0.1) of the JAX one."""
    ref = jdriver.solve_batch(n, m, batch=batch, generator=gen, dtype=np_dt)
    got = tdriver.solve_batch(n, m, batch=batch, generator=gen, dtype=np_dt,
                              device="cpu")
    eps = float(np.finfo(np_dt).eps)
    assert got.rel_residual < _gate(got, eps, n)
    assert ref.rel_residual < _gate(ref, eps, n)
    assert abs(got.kappa - ref.kappa) / ref.kappa <= 10 * eps * n * ref.kappa
    assert got.engine == "batched" and got.device == "cpu"
    assert got.inverse.shape == (batch, n, n) and got.gflops > 0
    xj = np.asarray(ref.inverse)
    xt = got.inverse.numpy()
    a = np.stack([np.asarray(jgenerate(gen, (n, n), np_dt, row_offset=b * n,
                                       col_offset=b * n))
                  for b in range(batch)])
    for b in range(batch):
        kappa = _inf(a[b]) * _inf(xj[b])
        assert _inf(xt[b] - xj[b]) / _inf(xj[b]) <= min(100 * eps * kappa,
                                                        0.1)


@pytest.mark.parametrize("n,m,batch", [(12, 6, 3), (8, 8, 4), (16, 16, 3)])
def test_solve_batch_singular_count_matches_jax(n, m, batch):
    """Hilbert windows: the JAX package's count of flagged elements."""
    with pytest.raises(jdriver.SingularMatrixError) as ref:
        jdriver.solve_batch(n, m, batch=batch, generator="hilbert",
                            dtype=np.float64)
    with pytest.raises(SingularMatrixError) as got:
        tdriver.solve_batch(n, m, batch=batch, generator="hilbert",
                            dtype=np.float64, device="cpu")
    assert str(got.value) == str(ref.value)


def test_solve_batch_refuses_telemetry_and_needs_a_card(monkeypatch):
    """solve_batch records its span tree (the JAX package's names, less
    compile) and still needs a card unless the CPU is asked for."""
    from tpu_jordan_torch.obs import Telemetry

    r = tdriver.solve_batch(8, 4, batch=2, generator="rand", device="cpu",
                            telemetry=Telemetry())
    assert [sp.name for sp in r.trace.walk()] == [
        "solve_batch", "load", "execute", "residual"]
    assert r.elapsed == r.trace.find("execute").duration
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        tdriver.solve_batch(8, 4, batch=2)


@pytest.mark.parametrize("engine", ["grouped_pallas", "grouped_pallas_bf16"])
def test_unrolled_only_limit_matches_jax(engine):
    """Nr = 65 > MAX_UNROLL_NR = 64 is refused by both packages."""
    with pytest.raises(jdriver.UsageError, match="unrolled-only"):
        jdriver.solve(520, 8, generator="rand", engine=engine)
    with pytest.raises(UsageError, match="unrolled-only"):
        tdriver.solve(520, 8, generator="rand", engine=engine, device="cpu")


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("case", [
    "ok", "zero_n", "missing_m", "missing_file", "singular_file",
    "unreadable_file", "group_one", "unknown_engine", "grouped_pallas",
    "pallas_group_one", "augmented", "augmented_group", "batch",
    "batch_file", "batch_engine",
])
def test_cli_exit_codes_match_jax(tmp_path, case):
    argv = {
        "ok": ["8", "4"],
        "zero_n": ["0", "4"],
        "missing_m": ["8"],
        "missing_file": ["8", "4", str(tmp_path / "nope.txt")],
        "singular_file": ["8", "4", _write(tmp_path, "z", "0 " * 64)],
        "unreadable_file": ["8", "4", _write(tmp_path, "b", "1 x " * 32)],
        "group_one": ["8", "4", "--group", "1"],
        "unknown_engine": ["8", "4", "--engine", "nope"],
        "grouped_pallas": ["64", "16", "--engine", "grouped_pallas"],
        "pallas_group_one": ["8", "4", "--engine", "grouped_pallas",
                             "--group", "1"],
        "augmented": ["96", "16", "--engine", "augmented"],
        "augmented_group": ["8", "4", "--engine", "augmented", "--group",
                            "2"],
        "batch": ["64", "16", "--batch", "4"],
        "batch_file": ["8", "4", _write(tmp_path, "r", "1 " * 64),
                       "--batch", "4"],
        "batch_engine": ["64", "16", "--batch", "4", "--engine", "grouped"],
    }[case]
    expected = {"ok": 0, "zero_n": 1, "missing_m": 1, "missing_file": 2,
                "singular_file": 2, "unreadable_file": 2, "group_one": 1,
                "unknown_engine": 1, "grouped_pallas": 0,
                "pallas_group_one": 1, "augmented": 0, "augmented_group": 1,
                "batch": 0, "batch_file": 1, "batch_engine": 1}[case]
    assert jmain(argv + ["--quiet"]) == expected
    assert tmain(argv + ["--device", "cpu"]) == expected


def test_cli_verbose_prints_corners(capsys):
    assert tmain(["6", "2", "--device", "cpu", "-v", "--dtype",
                  "float64"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("A\n") and "inverse matrix:" in out


def test_import_pulls_in_no_jax():
    code = ("import sys, tpu_jordan_torch, tpu_jordan_torch.__main__; "
            "import tpu_jordan_torch.ops.gj_probe, tpu_jordan_torch._build; "
            "import tpu_jordan_torch.ops.fused_update; "
            "import tpu_jordan_torch.resilience; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'tpu_jordan' "
            "or m.startswith('tpu_jordan.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_gpu_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        tdriver.solve(8, 4)
    assert tmain(["8", "4"]) == 2


# The first two cases were the augmented engine's refusals at p > 1 and on
# a mesh; that engine runs there now, so they keep their ids and run
# (exit 0, a small residual).
DISTRIBUTED_AUGMENTED = ({"workers": 2, "engine": "augmented"},
                         {"workers": (2, 4), "engine": "augmented"})


@pytest.mark.parametrize("kwargs", [
    *DISTRIBUTED_AUGMENTED,
    {"gather": False},
    {"numerics": "trace", "engine": "augmented"},
    {"policy": object()},
    {"numerics": "loud"},
    {"tune": True, "engine": "inplace"},
    {"plan_cache": "plans.json", "engine": "grouped"},
    {"precision": "high"},
    {"precision": "mixed"},
    {"engine": "augmented", "group": 2},
    {"engine": "swapfree"},
    {"dtype": "complex64", "engine": "inplace"},
])
def test_later_slice_options_are_refused(kwargs):
    if kwargs in DISTRIBUTED_AUGMENTED:
        res = tdriver.solve(8, 4, generator="rand", device="cpu",
                            dtype="float64", **kwargs)
        assert res.engine == "augmented" and res.residual < 1e-10
        return
    with pytest.raises(UsageError):
        tdriver.solve(8, 4, device="cpu", **kwargs)


def test_port_policy_is_accepted():
    from tpu_jordan_torch.resilience import ResiliencePolicy

    r = tdriver.solve(16, 8, generator="rand", device="cpu",
                      policy=ResiliencePolicy())
    assert r.recovery == ()


def test_singular_solve_raises(tmp_path):
    path = _write(tmp_path, "ones", "1 " * 64)
    with pytest.raises(SingularMatrixError):
        tdriver.solve(8, 4, file=path, device="cpu")
