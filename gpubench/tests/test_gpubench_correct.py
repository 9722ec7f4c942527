"""What decides ``correct``: sound runs pass, and the control and every
fault a cell can have fail.

The CPU tests drive the rest of a run (``core.run_cell`` with the look for
a card skipped) at a size a test holds, with the cell's own configuration
and limits, the program's entry on the CPU, and the timed path broken
underneath.  The tests marked ``card`` run the control at each cell's own
size on three seeds."""

import time

import pytest
import torch

from conftest import small_cell
from gpubench import calibrate, core, reference, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 12345


def run_with(cell, wrap=None, seconds=0.2):
    entry = spec.entry_module(cell.traffic["entry"]).make(
        cell, torch.device("cpu"))
    return core.run_cell(cell, SEED, seconds, False, time.perf_counter(),
                         device="cpu",
                         entry=wrap(entry) if wrap else entry)


def block_for(name):
    # m = 300 has no panel width; keep an m with none (12) on the CPU too.
    return 12 if "m300" in name else 16


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    cell = small_cell(name, block_size=block_for(name))
    result = run_with(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1


def unchanged(entry):
    """A step that returns its state unchanged: the input as the answer."""
    def call(a):
        _, flags = entry(a)
        return a.clone(), flags
    return call


def altered(entry):
    """An answer altered where it is produced: one entry of each inverse
    moved by a tenth of the largest."""
    def call(a):
        x, flags = entry(a)
        x = x.clone()
        view = x.reshape(-1, x.shape[-2], x.shape[-1])
        view[:, 3, 5] += 0.1 * view.abs().amax()
        return x, flags
    return call


def flag_flipped(entry):
    """The singular flag altered: every answer flagged singular."""
    def call(a):
        x, flags = entry(a)
        return x, torch.ones_like(flags)
    return call


def half_batch(entry):
    """Half of the batch left out: only the first half of the stack is
    inverted, the rest answered with the input."""
    def call(a):
        half = a.shape[0] // 2
        x, flags = entry.solver.invert_batch(a[:half]) if half else (a, None)
        out = a.clone()
        out[:half] = x
        flags_all = torch.zeros(a.shape[0], dtype=torch.bool)
        if flags is not None:
            flags_all[:half] = flags
        return out, flags_all
    return call


FAULTS = {"unchanged": unchanged, "altered": altered,
          "flag_flipped": flag_flipped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    cell = small_cell(name, block_size=block_for(name))
    result = run_with(cell, FAULTS[fault])
    assert not result["correct"], (fault, result["checks"])
    assert result["failed"] >= 1


@pytest.mark.parametrize("name", [n for n in CELLS if "batch" in n])
def test_half_of_the_batch_left_out_is_not_correct(name):
    cell = small_cell(name, block_size=16, batch=4)
    result = run_with(cell, half_batch)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_cpu_size(name):
    """The reference in the configuration's next-lower arithmetic, in the
    program's place (TF32 emulated by rounding the products' operands)."""
    cell = small_cell(name, n=96, block_size=block_for(name))
    rows = calibrate.control_readings(cell, [SEED, 7], 0.1, device="cpu")
    assert rows and not any(r["correct"] for r in rows), rows


def test_reference_inverts_in_each_arithmetic():
    """The reference's block Gauss–Jordan against torch's inverse, and its
    residual in each arithmetic: float64 ≪ float32 ≪ TF32."""
    from gpubench import inputs

    a = inputs.matrix(3, 0, 2, 80, torch.float64, "cpu")
    want = torch.linalg.inv(a)
    res = {}
    for arith, tol in (("float64", 1e-9), ("float32", 1e-2),
                       ("tf32", None)):
        x, margin = reference.invert(a, 16, arith, 1e-15)
        assert (margin > 1).all()
        if tol is not None:
            assert (x.double() - want).abs().max() < tol * want.abs().max()
        res[arith] = reference.residuals(a, x).max()
    assert res["float64"] < 1e-12 < 1e-8 < res["float32"] < 1e-5
    assert res["float32"] * 100 < res["tf32"]


def test_reference_ragged_and_singular():
    from gpubench import inputs

    a = inputs.matrix(4, 1, 1, 70, torch.float64, "cpu")
    x, margin = reference.invert(a, 32, "float64", 1e-15)  # 70 = 2·32 + 6
    assert (margin > 1).all()
    assert reference.residuals(a, x).max() < 1e-13
    ones = torch.ones(2, 8, 8, dtype=torch.float64)
    assert (reference.invert(ones, 4, "float64", 1e-15)[1] < 1).all()


def test_program_and_reference_residuals_agree():
    """The same pivot rule in the same arithmetic: the program's residual
    over the reference's is about 1 on each matrix, though the residuals
    themselves differ by orders of magnitude between matrices."""
    from gpubench import inputs
    from tpu_jordan_torch.models import JordanSolver

    for dt, arith in ((torch.float64, "float64"), (torch.float32, "float32")):
        a = inputs.matrix(5, 0, 3, 96, dt, "cpu")
        x, _ = JordanSolver(n=96, block_size=12, dtype=dt,
                            device="cpu").invert_batch(a)
        ref, _ = reference.invert(a, 12, arith, 1e-15)
        q = reference.residuals(a, x) / reference.residuals(a, ref)
        assert ((q > 0.1) & (q < 10)).all(), q


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    assert reference.to_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, 3.0]


def test_inputs_repeat_by_seed_and_differ_by_index():
    from gpubench import inputs

    a = inputs.matrix(2**33 + 1, 0, 1, 16, torch.float32, "cpu")
    assert torch.equal(a, inputs.matrix(2**33 + 1, 0, 1, 16, torch.float32,
                                        "cpu"))
    assert not torch.equal(a, inputs.matrix(2**33 + 1, 1, 1, 16,
                                            torch.float32, "cpu"))
    assert a.min() >= -1 and a.max() < 1


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_the_cell_size(card, name):
    cell = spec.load_cell(name)
    rows = calibrate.control_readings(cell, [2**31 + 101, 2**31 + 202,
                                             2**31 + 303], 1.0)
    print(rows)
    assert len(rows) == 3 and not any(r["correct"] for r in rows), rows


@pytest.mark.parametrize("margin, flag, counted", [
    (100.0, True, 1), (100.0, False, 0), (0.01, False, 1), (0.01, True, 0),
    (3.0, True, 0), (3.0, False, 0), (0.5, False, 0), (0.5, True, 0)])
def test_singular_flag_judged_where_the_margin_is_decisive(
        monkeypatch, margin, flag, counted):
    """Outside [1/BAND, BAND] the flag must be the reference's verdict;
    inside, a pivot within rounding of the threshold decides, and either
    flag stands."""
    cell = small_cell("gj_fp64.n8192_m384", n=16, block_size=8)

    def fake_invert(a, m, arith, eps):
        return torch.linalg.inv(a), torch.full((a.shape[0],), margin,
                                               dtype=torch.float64)

    monkeypatch.setattr(reference, "invert", fake_invert)
    w = core.Window(pool_index=[0, 0], flags=[torch.tensor(flag)] * 2,
                    host_s=[0.0, 0.0])
    checks = core.judge(cell, SEED, w, "cpu")
    assert checks.singular_mismatches == 2 * counted


def test_result_line_is_strict_json():
    import json

    line = core._finite({"checks": {"residual_ratio": {
        "value": float("inf"), "limit": 10.0}}, "worst_ratio": float("nan"),
        "metrics": [1.5]})
    text = json.dumps(line, allow_nan=False)
    assert json.loads(text)["checks"]["residual_ratio"]["value"] == "inf"
