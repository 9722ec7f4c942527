"""The port's numerics observatory (``tpu_jordan_torch/obs/numerics.py``)
against the JAX package's, on the CPU.

The port's trace comes through its entry points (``driver.solve`` and
``linalg.solve_system`` with ``numerics="trace"``); the JAX side is the
same engine's ``collect_stats=True`` record, which is what the JAX
package's trace reads.  On the same generated fp64 fixtures the pivot
sequence is equal exactly, the criterion values, candidate norms and
growth watermarks agree within rtol 1e-8 (the engine tests' tolerance,
``test_torch_engine.py``), and the singular-candidate counts are equal,
except on absdiff (64, 8), where a rank-deficient candidate sits on the
probe's singularity threshold at steps 4–6 (ROADMAP.md Queue C).  The
fused fp32 engine instruments itself and is held to the JAX package's
grouped trace, which the JAX package reports for it (rtol 1e-3, fp32),
with the same flip at absdiff (64, 8) steps 5–6.
"""

import functools
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan.driver import UsageError as JUsageError
from tpu_jordan.driver import solve as jsolve
from tpu_jordan.linalg import engine as je
from tpu_jordan.linalg import solve_system as jsolve_system
from tpu_jordan.linalg import solve_update as jsolve_update
from tpu_jordan.obs import numerics as jnum
from tpu_jordan.ops import generate as jgenerate
from tpu_jordan.ops import jordan_inplace as jj
from tpu_jordan.resilience.policy import \
    ResidualGateError as JResidualGateError

from tpu_jordan_torch.driver import solve as tsolve
from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.linalg import solve_system, solve_update
from tpu_jordan_torch.obs import numerics as tnum
from tpu_jordan_torch.obs.metrics import REGISTRY
from tpu_jordan_torch.resilience import ResidualGateError

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
SHAPES = ((64, 8), (96, 16))
# (n, m, generator) -> engine -> steps whose singular-candidate count
# differs: a rank-deficient candidate on the threshold (Queue C).
KNIFE_EDGE = {(64, 8, "absdiff"): {"inplace": {5, 6}, "lookahead": {5, 6},
                                   "grouped": {4, 5, 6},
                                   "solve": {5, 6},
                                   "grouped_pallas_fp32": {5, 6}}}

# The JAX package's lookahead twin bit-matches its in-place engine, record
# included, so the in-place record stands for both.
_JAX_ENGINES = {
    "inplace": lambda a, m: jj.block_jordan_invert_inplace(
        a, block_size=m, collect_stats=True),
    "grouped": lambda a, m: jj.block_jordan_invert_inplace_grouped(
        a, block_size=m, group=2, collect_stats=True),
}


def _rhs(n, dtype):
    return np.array(jgenerate("rand", (n, 1), dtype, row_offset=n))


@functools.cache
def _jax_stats(engine, n, m, gen, dtype_name="float64"):
    dtype = np.dtype(dtype_name)
    a = jnp.asarray(np.array(jgenerate(gen, (n, n), dtype)))
    if engine == "solve":
        out = je.block_jordan_solve(a, jnp.asarray(_rhs(n, dtype)),
                                    block_size=m, collect_stats=True)
    else:
        out = _JAX_ENGINES[engine](a, m)
    return {k: np.asarray(v) for k, v in out[2].items()}


def _port_report(engine, n, m, gen, dtype="float64"):
    if engine == "solve":
        a = np.array(jgenerate(gen, (n, n), np.dtype(dtype)))
        return solve_system(a, _rhs(n, np.dtype(dtype)), block_size=m,
                            engine="solve_aug", numerics="trace",
                            device="cpu").numerics
    return tsolve(n, m, generator=gen, dtype=dtype, engine=engine,
                  numerics="trace", device="cpu").numerics


def _compare(rep, ref, knife=(), rtol=1e-8):
    assert rep.mode == "trace"
    assert rep.pivot_block == [int(v) for v in ref["pivot_block"]]
    np.testing.assert_allclose(rep.pivot_inv_norm, ref["pivot_inv_norm"],
                               rtol=rtol)
    np.testing.assert_allclose(rep.growth, ref["growth"], rtol=rtol)
    keep = [t for t in range(len(rep.pivot_block)) if t not in knife]
    np.testing.assert_allclose(np.array(rep.cand_norm_max)[keep],
                               ref["cand_norm_max"][keep], rtol=rtol)
    assert [rep.singular_candidates[t] for t in keep] == \
        [int(ref["singular_candidates"][t]) for t in keep]


@pytest.mark.parametrize("engine", ["inplace", "grouped", "lookahead",
                                    "solve"])
@pytest.mark.parametrize("gen", ["rand", "absdiff"])
@pytest.mark.parametrize("n,m", SHAPES)
def test_trace_matches_jax(engine, gen, n, m):
    knife = KNIFE_EDGE.get((n, m, gen), {}).get(engine, set())
    rep = _port_report(engine, n, m, gen)
    ref = _jax_stats("inplace" if engine == "lookahead" else engine,
                     n, m, gen)
    _compare(rep, ref, knife)
    assert rep.trace_engine == ("solve_aug" if engine == "solve"
                                else engine)
    differing = {t for t, (x, y) in enumerate(zip(
        rep.singular_candidates, ref["singular_candidates"])) if x != y}
    assert differing == knife


@pytest.mark.parametrize("gen", ["rand", "absdiff"])
@pytest.mark.parametrize("n,m", SHAPES)
def test_fused_engine_trace_matches_the_grouped_trace(gen, n, m):
    """``grouped_pallas`` fp32 traces itself; its record is the JAX
    package's grouped trace within fp32 rounding, the same threshold flip
    pinned at the listed steps and nowhere else."""
    rep = tsolve(n, m, generator=gen, dtype="float32",
                 engine="grouped_pallas", numerics="trace",
                 device="cpu").numerics
    ref = _jax_stats("grouped", n, m, gen, "float32")
    assert rep.trace_engine == "grouped_pallas"
    knife = KNIFE_EDGE.get((n, m, gen), {}).get("grouped_pallas_fp32",
                                                set())
    _compare(rep, ref, knife, rtol=1e-3)
    differing = {t for t, (x, y) in enumerate(zip(
        rep.singular_candidates, ref["singular_candidates"])) if x != y}
    assert differing == knife


@functools.cache
def _jax_solve_report():
    return jsolve(64, 8, generator="rand", dtype=jnp.float64,
                  engine="inplace", numerics="trace").numerics


@pytest.mark.parametrize("numerics", ["summary", "trace"])
def test_solve_report_matches_jax(numerics):
    """Every field of the JAX package's report (its summary fields for
    ``"summary"``): the values within rtol 1e-8, the verified
    rel_residual (rounding noise of two inverses) within 100·eps·κ∞."""
    ref = _jax_solve_report()
    rep = tsolve(64, 8, generator="rand", dtype="float64", engine="inplace",
                 numerics=numerics, device="cpu").numerics
    tj = rep.to_json()
    jj_ = {k: v for k, v in ref.to_json().items()
           if numerics == "trace" or k in tj}
    assert sorted(tj) == sorted(jj_)
    eps = np.finfo(np.float64).eps
    for key, val in jj_.items():
        if key == "mode":
            assert tj[key] == numerics
        elif key == "rel_residual":
            assert abs(tj[key] - val) <= 100 * eps * ref.kappa
        elif key == "residual_est":
            np.testing.assert_allclose(tj[key], val, rtol=1e-8)
        elif isinstance(val, float):
            assert math.isclose(tj[key], val, rel_tol=1e-8), key
        elif isinstance(val, list) and val and isinstance(val[0], float):
            np.testing.assert_allclose(tj[key], val, rtol=1e-8)
        else:
            assert tj[key] == val, key


def test_summary_reads_only_returned_numbers():
    r = tsolve(48, 16, generator="rand", dtype="float64", engine="inplace",
               numerics="summary", device="cpu")
    rep = r.numerics
    assert rep.mode == "summary" and rep.pivot_block is None
    assert rep.rel_residual == r.rel_residual and rep.kappa == r.kappa
    assert rep.eps == float(np.finfo(np.float64).eps)
    assert "pivot_block" not in rep.to_json()


def test_off_builds_no_report_and_observes_nothing():
    hist = REGISTRY.histogram("tpu_jordan_torch_residual")
    before = hist.percentiles(engine="inplace")
    count = sum(r.count for r in hist.series().values())
    r = tsolve(32, 8, generator="rand", engine="inplace", device="cpu")
    assert r.numerics is None
    assert sum(r.count for r in hist.series().values()) == count
    assert hist.percentiles(engine="inplace") == before


def test_trace_mirrors_into_the_registry():
    piv = REGISTRY.histogram("tpu_jordan_torch_pivot_condition")
    growth = REGISTRY.histogram("tpu_jordan_torch_growth_factor")
    n0, g0 = (sum(r.count for r in h.series().values())
              for h in (piv, growth))
    tsolve(48, 16, generator="rand", engine="inplace", numerics="trace",
           device="cpu")
    assert sum(r.count for r in piv.series().values()) == n0 + 3
    assert sum(r.count for r in growth.series().values()) == g0 + 1


@pytest.mark.parametrize("thresholds", [
    {}, {"pivot_condition": 1.0}, {"growth": 1.0}, {"residual": 0.0}])
def test_same_spikes_as_jax(thresholds):
    """The same report through both packages' ``record_spikes`` at the
    same thresholds fires the same signals at the same steps."""
    ref = _jax_solve_report()
    mine = tnum.trace_report(
        {k: getattr(ref, k) for k in ("pivot_block", "pivot_inv_norm",
                                      "cand_norm_max",
                                      "singular_candidates", "growth")},
        n=ref.n, block_size=ref.block_size, engine=ref.engine,
        trace_engine=ref.trace_engine, rel_residual=ref.rel_residual,
        kappa=ref.kappa, norm_a=ref.norm_a, dtype=torch.float64)
    theirs = jnum.trace_report(
        {k: getattr(ref, k) for k in ("pivot_block", "pivot_inv_norm",
                                      "cand_norm_max",
                                      "singular_candidates", "growth")},
        n=ref.n, block_size=ref.block_size, engine=ref.engine,
        trace_engine=ref.trace_engine, rel_residual=ref.rel_residual,
        kappa=ref.kappa, norm_a=ref.norm_a, dtype=jnp.float64)
    events_t, events_j = [], []
    got = tnum.record_spikes(
        mine, tnum.SpikeThresholds(**thresholds),
        recorder=lambda kind, **f: events_t.append((kind, f)))
    want = jnum.record_spikes(
        theirs, jnum.SpikeThresholds(**thresholds),
        recorder=lambda kind, **f: events_j.append((kind, f)))
    assert got == want and events_t == events_j
    assert bool(got) == bool(thresholds)


def _jax_words(fn):
    with pytest.raises(JUsageError) as e:
        fn()
    return str(e.value)


_SPD = np.eye(16) * 4 + 1.0


@pytest.mark.parametrize("case", [
    "augmented", "bf16_fused", "beyond_unroll", "spd", "fori", "update",
    "unknown_mode"])
def test_trace_refusals_match_jax_by_message(case):
    b = np.ones((16, 1))
    j, t = {
        "augmented": (
            lambda: jsolve(16, 8, engine="augmented", numerics="trace"),
            lambda: tsolve(16, 8, engine="augmented", numerics="trace",
                           device="cpu")),
        "bf16_fused": (
            lambda: jsolve(16, 8, engine="grouped_pallas_bf16",
                           numerics="trace"),
            lambda: tsolve(16, 8, engine="grouped_pallas_bf16",
                           numerics="trace", device="cpu")),
        "beyond_unroll": (
            lambda: jsolve(520, 8, generator="rand", engine="inplace",
                           numerics="trace"),
            lambda: tsolve(520, 8, generator="rand", engine="inplace",
                           numerics="trace", device="cpu")),
        "spd": (
            lambda: jsolve_system(_SPD, b, assume="spd", numerics="trace"),
            lambda: solve_system(_SPD, b, assume="spd", numerics="trace",
                                 device="cpu")),
        "fori": (
            lambda: jsolve_system(_SPD, b, block_size=2,
                                  engine="solve_fori", numerics="trace"),
            lambda: solve_system(_SPD, b, block_size=2,
                                 engine="solve_fori", numerics="trace",
                                 device="cpu")),
        "update": (
            lambda: jsolve_update(_SPD, np.linalg.inv(_SPD), b, b,
                                  numerics="trace"),
            lambda: solve_update(_SPD, np.linalg.inv(_SPD), b, b,
                                 numerics="trace", device="cpu")),
        "unknown_mode": (
            lambda: jsolve(16, 8, numerics="loud"),
            lambda: tsolve(16, 8, numerics="loud", device="cpu")),
    }[case]
    with pytest.raises(UsageError) as got:
        t()
    assert str(got.value) == _jax_words(j)


def test_solve_summary_report_is_workload_tagged():
    a = np.array(jgenerate("rand", (48, 48), np.float64))
    res = solve_system(a, _rhs(48, np.float64), block_size=16,
                       numerics="summary", device="cpu")
    rep = res.numerics
    assert rep.workload == "solve" and rep.mode == "summary"
    assert rep.rel_residual == res.rel_residual
    assert rep.kappa == res.kappa_est


def test_update_summary_and_drift_spike():
    """The update's summary record, and a drift-caused re_invert rung
    preceded by its ``drift`` spike."""
    from tpu_jordan_torch.obs.recorder import RECORDER
    from tpu_jordan_torch.resilience import ResiliencePolicy

    rng = np.random.default_rng(3)
    a = rng.standard_normal((32, 32)) + 32 * np.eye(32)
    inv = np.linalg.inv(a)
    u = rng.standard_normal((32, 2)) * 0.01
    res = solve_update(a, inv, u, u, numerics="summary", device="cpu")
    assert res.numerics.workload == "update"
    assert res.numerics.engine == "smw_update"
    mark = RECORDER.total
    res = solve_update(a, inv, u, u, drift=1.0, numerics="summary",
                       policy=ResiliencePolicy(), device="cpu")
    assert [r["cause"] for r in res.recovery] == ["drift_budget"]
    kinds = [(e["kind"], e.get("signal")) for e in RECORDER.since(mark)]
    assert kinds.index(("numerics_spike", "drift")) < kinds.index(
        ("recovery_rung", None))


@functools.cache
def _demos(workload):
    return (tnum.numerics_demo(workload=workload, device="cpu"),
            jnum.numerics_demo(workload=workload))


@pytest.mark.parametrize("workload", ["invert", "solve"])
def test_demo_passes_the_checker_and_walks_jax_rungs(workload, tmp_path):
    mine, ref = _demos(workload)
    path = tmp_path / "report.json"
    path.write_text(json.dumps(mine))
    out = subprocess.run([sys.executable, str(TOOLS / "check_numerics.py"),
                          str(path)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert [(r["rung"], r["passed"]) for r in mine["recovery"]] == \
        [(r["rung"], r["passed"]) for r in ref["recovery"]]
    assert mine["spike_count"] == ref["spike_count"]
    assert mine["engine"] == ref["engine"]
    assert not mine["silent_rung"]


def _walked(demo):
    """The demo's (rung, passed) pairs, and the report (None where the
    ladder is exhausted and ``ResidualGateError`` carries the rungs)."""
    try:
        report = demo()
    except (JResidualGateError, ResidualGateError) as e:
        return [(r["rung"], r["passed"]) for r in e.recovery], None
    return [(r["rung"], r["passed"]) for r in report["recovery"]], report


@pytest.mark.parametrize("decades,rungs", [
    (3.9, [("refine", False), ("resolve", True)]),
    (4.5, [("refine", False), ("resolve", False)])])
def test_panel_size_demo_walks_jax_rungs(decades, rungs, tmp_path):
    """At m = 128 (the smoke's card case, n = 512): at κ 10^3.9 refine
    diverges and the fp32 re-solve passes, at the default 10^4.5 the
    re-solve misses the gate's 0.5 cap too, in both packages."""
    mine, report = _walked(lambda: tnum.numerics_demo(
        n=512, block_size=128, kappa_decades=decades, device="cpu"))
    ref, _ = _walked(lambda: jnum.numerics_demo(
        n=512, block_size=128, kappa_decades=decades))
    assert mine == ref == rungs
    if report is not None:
        path = tmp_path / "report.json"
        path.write_text(json.dumps(report))
        out = subprocess.run([sys.executable,
                              str(TOOLS / "check_numerics.py"), str(path)],
                             capture_output=True, text=True)
        assert out.returncode == 0, out.stderr


def test_checker_exits_2_on_an_unexplained_rung(tmp_path):
    report = json.loads(json.dumps(_demos("invert")[0]))
    report["blackbox"]["events"] = [
        e for e in report["blackbox"]["events"]
        if e["kind"] != "numerics_spike"]
    path = tmp_path / "stripped.json"
    path.write_text(json.dumps(report))
    out = subprocess.run([sys.executable, str(TOOLS / "check_numerics.py"),
                          str(path)], capture_output=True, text=True)
    assert out.returncode == 2


def test_demo_refuses_lstsq_in_jax_words():
    assert "not 'lstsq'" in _jax_words(
        lambda: jnum.numerics_demo(workload="lstsq"))
    with pytest.raises(UsageError, match="not 'lstsq'"):
        tnum.numerics_demo(workload="lstsq", device="cpu")


def test_ill_conditioned_fixture_is_the_jax_one():
    np.testing.assert_array_equal(tnum.ill_conditioned(16),
                                  jnum.ill_conditioned(16))
