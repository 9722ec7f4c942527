"""The port's solve workloads (``tpu_jordan_torch/linalg``) against the JAX
package's ``linalg``, on the CPU.

The same numpy fixtures go through ``block_jordan_solve`` /
``block_jordan_solve_fori`` / the spd path of both packages.  Pivot
sequences (``collect_stats=True``) and singular flags must be equal; X
agrees within min(100·eps·κ∞, 0.1) in the relative ∞-norm (eps the dtype's
machine epsilon, κ∞ = ‖A‖∞‖A⁻¹‖∞ from numpy), the eps·n·κ scaling of
``test_torch_engine.py``.  ``solve_system``, ``lstsq`` and the CLI mirror
the flag contract of ``tests/test_linalg.py``; ``tests/test_torch_complex.py``
holds the complex dtypes.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan.__main__ import main as jmain
from tpu_jordan.linalg import engine as je
from tpu_jordan.linalg import lstsq as jlstsq
from tpu_jordan.linalg import solve_system as jsolve_system
from tpu_jordan.obs.numerics import ill_conditioned
from tpu_jordan.ops import generate as jgenerate
from tpu_jordan.resilience import ResiliencePolicy as JPolicy
from tpu_jordan.resilience.degrade import \
    solve_gate_threshold as jsolve_gate_threshold
from tpu_jordan.tuning.tuner import auto_select

from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.errors import (
    DeviceUnavailableError,
    SingularMatrixError,
    UsageError,
)
from tpu_jordan_torch.linalg import (
    auto_solve_engine,
    block_jordan_solve,
    block_jordan_solve_fori,
    lstsq,
    solve_batch_metrics,
    solve_system,
)
from tpu_jordan_torch.ops import block_jordan_invert_inplace
from tpu_jordan_torch.resilience import (
    ResidualGateError,
    ResiliencePolicy,
    solve_gate_threshold,
)

DTYPES = [np.float64, np.float32]


def _rand(shape, dtype=np.float32, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _inf(x):
    return np.abs(x).sum(axis=-1).max()


def _tol(a, np_dt):
    a64 = a.astype(np.float64)
    kappa = _inf(a64) * _inf(np.linalg.inv(a64))
    return min(100 * np.finfo(np_dt).eps * kappa, 0.1)


def _close(xt, xj, a, np_dt):
    xj = np.asarray(xj)
    assert xt.dtype == getattr(torch, np.dtype(np_dt).name)
    return _inf(xt.numpy() - xj) / _inf(xj) <= _tol(a, np_dt)


@pytest.mark.parametrize("np_dt", DTYPES)
@pytest.mark.parametrize("n,m,k", [(48, 8, 3), (50, 8, 1), (96, 16, 5),
                                   (64, 8, 64)])
@pytest.mark.parametrize("gen", ["rand", "absdiff"])
def test_solve_matches_jax(np_dt, n, m, k, gen):
    a = np.array(jgenerate(gen, (n, n), np_dt))
    b = _rand((n, k), np_dt, seed=n + k)
    xj, sj, stj = je.block_jordan_solve(jnp.asarray(a), jnp.asarray(b),
                                        block_size=m, collect_stats=True)
    xt, st, stt = block_jordan_solve(torch.from_numpy(a), torch.from_numpy(b),
                                     block_size=m, collect_stats=True)
    assert bool(sj) is False and bool(st) is False
    np.testing.assert_array_equal(stt["pivot_block"].numpy(),
                                  np.asarray(stj["pivot_block"]))
    assert sorted(stt) == sorted(stj)
    assert _close(xt, xj, a, np_dt)


@pytest.mark.parametrize("np_dt", DTYPES)
@pytest.mark.parametrize("n,m", [(48, 8), (64, 16), (50, 8)])
def test_spd_matches_jax_and_pivoting_bits(np_dt, n, m):
    """The pivot-free path on kms (diagonally dominant SPD): X as the JAX
    package's, and bit-equal to the pivoting path, whose criterion picks
    the diagonal anyway (a stack of one and a stack of Nr − t run the same
    per-block arithmetic)."""
    a = np.array(jgenerate("kms", (n, n), np_dt))
    b = _rand((n, 2), np_dt, seed=3)
    xj, sj = je.block_jordan_solve(jnp.asarray(a), jnp.asarray(b),
                                   block_size=m, spd=True)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    xs, ss = block_jordan_solve(at, bt, block_size=m, spd=True)
    xp, sp, stp = block_jordan_solve(at, bt, block_size=m,
                                     collect_stats=True)
    assert not (bool(sj) or bool(ss) or bool(sp))
    assert stp["pivot_block"].tolist() == list(range(-(-n // m)))
    assert torch.equal(xs, xp)
    assert _close(xs, xj, a, np_dt)


@pytest.mark.parametrize("spd,gen", [(False, "rand"), (True, "kms")])
def test_fori_beyond_unroll_limit_matches_jax(spd, gen):
    """Nr = 65 > MAX_UNROLL_NR: the unrolled engine refuses in both
    packages; the fori engines solve, X within tolerance, flags equal."""
    n, m = 260, 4
    a = np.array(jgenerate(gen, (n, n), np.float64))
    b = _rand((n, 2), np.float64, seed=5)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(UsageError, match="MAX_UNROLL_NR"):
        block_jordan_solve(at, bt, block_size=m, spd=spd)
    with pytest.raises(ValueError, match="MAX_UNROLL_NR"):
        je.block_jordan_solve(jnp.asarray(a), jnp.asarray(b), block_size=m,
                              spd=spd)
    xj, sj = je.block_jordan_solve_fori(jnp.asarray(a), jnp.asarray(b),
                                        block_size=m, spd=spd)
    xt, st = block_jordan_solve_fori(at, bt, block_size=m, spd=spd)
    assert bool(sj) is bool(st) is False
    assert _close(xt, xj, a, np.float64)


@pytest.mark.parametrize("np_dt", DTYPES)
def test_fori_equals_unrolled_within_reach(np_dt):
    a = torch.from_numpy(np.array(jgenerate("rand", (96, 96), np_dt)))
    b = torch.from_numpy(_rand((96, 3), np_dt, seed=9))
    assert torch.equal(block_jordan_solve(a, b, block_size=16)[0],
                       block_jordan_solve_fori(a, b, block_size=16)[0])


@pytest.mark.parametrize("np_dt", DTYPES)
@pytest.mark.parametrize("gen,n,m", [("rand", 48, 8), ("absdiff", 64, 8),
                                     ("rand", 96, 16), ("absdiff", 50, 8)])
def test_pivots_equal_invert_engine(np_dt, gen, n, m):
    """The [A | B] elimination probes the same candidates with the same
    criterion as the in-place invert engine: equal pivot sequences on a
    shared fixture (the JAX package pins the same)."""
    a = torch.from_numpy(np.array(jgenerate(gen, (n, n), np_dt)))
    b = torch.from_numpy(_rand((n, 2), np_dt, seed=1))
    _, _, sts = block_jordan_solve(a, b, block_size=m, collect_stats=True)
    _, _, sti = block_jordan_invert_inplace(a, block_size=m,
                                            collect_stats=True)
    assert torch.equal(sts["pivot_block"], sti["pivot_block"])


def test_probe_argument_runs_once_a_superstep():
    sizes = []

    def probe(cands, eps):
        sizes.append(cands.shape[0])
        from tpu_jordan_torch.ops import probe_blocks
        return probe_blocks(cands, eps)

    a = torch.from_numpy(np.array(jgenerate("kms", (40, 40), np.float64)))
    b = torch.ones(40, 1, dtype=torch.float64)
    block_jordan_solve(a, b, block_size=8, probe=probe)
    block_jordan_solve(a, b, block_size=8, probe=probe, spd=True)
    assert sizes == [5, 4, 3, 2, 1] + [1] * 5


def test_sub_fp32_rounds_once():
    a = torch.from_numpy(np.array(jgenerate("kms", (32, 32), np.float32)))
    b = torch.ones(32, 2)
    x16, s = block_jordan_solve(a.bfloat16(), b.bfloat16(), block_size=8)
    x32, _ = block_jordan_solve(a.bfloat16().float(), b, block_size=8)
    assert x16.dtype == torch.bfloat16 and not bool(s)
    assert torch.equal(x16, x32.bfloat16())


def test_collect_stats_refused_on_spd():
    a, b = torch.eye(8), torch.ones(8, 1)
    with pytest.raises(ValueError, match="spd fast path"):
        block_jordan_solve(a, b, block_size=4, spd=True, collect_stats=True)


def test_solve_batch_metrics_match_jax():
    a = _rand((3, 16, 16), np.float64, seed=2)
    x = _rand((3, 16, 2), np.float64, seed=3)
    b = _rand((3, 16, 2), np.float64, seed=4)
    n_real = np.array([16, 10, 0])
    mj = je.solve_batch_metrics(jnp.asarray(a), jnp.asarray(x),
                                jnp.asarray(b), n_real)
    mt = solve_batch_metrics(*(torch.from_numpy(v) for v in (a, x, b)),
                             torch.from_numpy(n_real))
    assert sorted(mt) == sorted(mj)
    for key in mj:
        np.testing.assert_allclose(mt[key].numpy(), np.asarray(mj[key]),
                                   rtol=1e-12, err_msg=key)


@pytest.mark.parametrize("n,dtype,gate_dtype", [
    (64, "float32", None), (8192, "float32", None), (8192, "float64", None),
    (100, "bfloat16", None), (100, "bfloat16", "float32"),
    (10 ** 7, "float32", None)])
def test_solve_gate_threshold_matches_jax(n, dtype, gate_dtype):
    got = solve_gate_threshold(ResiliencePolicy(gate_dtype=gate_dtype), n,
                               dtype)
    ref = jsolve_gate_threshold(JPolicy(gate_dtype=gate_dtype), n, dtype)
    assert got == pytest.approx(ref, rel=1e-12)


@pytest.mark.parametrize("n,m,assume", [
    (64, 8, "general"), (64, 8, "spd"), (520, 8, "general"),
    (520, 8, "spd"), (8192, 384, "spd"), (16384, 128, "general")])
def test_auto_follows_the_jax_registry(n, m, assume):
    workload = "solve_spd" if assume == "spd" else "solve"
    ref = auto_select(n, m, np.float32, 1, True, workload=workload)[0]
    assert auto_solve_engine(n, m, workload) == ref


@pytest.mark.parametrize("np_dt", DTYPES)
@pytest.mark.parametrize("assume,gen", [("general", "rand"),
                                        ("spd", "kms")])
def test_solve_system_matches_jax(np_dt, assume, gen):
    n = 48
    a = np.array(jgenerate(gen, (n, n), np_dt))
    b = _rand((n,), np_dt, seed=6)
    rj = jsolve_system(a, b, block_size=8, assume=assume)
    rt = solve_system(a, b, block_size=8, assume=assume, device="cpu")
    assert rt.engine == rj.engine and rt.workload == rj.workload
    assert rt.x.shape == (n,) and rt.k == rj.k == 1
    assert _close(rt.x, rj.x, a, np_dt)
    assert rt.rel_residual < solve_gate_threshold(ResiliencePolicy(), n,
                                                  np_dt)
    assert rt.kappa_est == pytest.approx(rj.kappa_est, rel=1e-3)
    assert rt.device == "cpu" and rt.gflops > 0


def test_flag_contract():
    a = _rand((16, 16), seed=24)
    b = _rand((16, 1), seed=25)

    def solve(*args, **kw):
        return solve_system(*args, device="cpu", **kw)

    with pytest.raises(UsageError, match="solve engine"):
        solve(a, b, engine="inplace")
    with pytest.raises(UsageError, match="assume"):
        solve(a, b, engine="solve_spd")   # no spd promise
    with pytest.raises(UsageError, match="assume"):
        solve(a, b, assume="hermitian")
    with pytest.raises(UsageError, match="tune"):
        solve(a, b, engine="solve_aug", tune=True)
    with pytest.raises(UsageError, match="item 12"):
        solve(a @ a.T + 16 * np.eye(16, dtype=np.float32), b, assume="spd",
              numerics="trace")
    with pytest.raises(UsageError, match="square"):
        solve(_rand((8, 4), seed=26), b)
    # a zero-column RHS is a caller bug, never a vacuous success
    with pytest.raises(UsageError, match="k>=1"):
        solve(a, np.zeros((16, 0), np.float32))


@pytest.mark.parametrize("kwargs,item", [
    ({"engine": "solve_sharded"}, "item 15"),
    ({"engine": "solve_lookahead"}, "item 15"),
    ({"workers": 2}, "item 15"),
    ({"workers": (2, 2)}, "item 15"),
    ({"gather": False}, "item 15"),
    ({"telemetry": object()}, "item 12"),
    ({"numerics": "summary"}, "item 12"),
    ({"plan_cache": "plans.json", "engine": "solve_aug"},
     "engine='auto' only"),
    ({"dtype": "complex64", "workers": 2}, "item 15"),
])
def test_later_slice_options_are_refused_by_name(kwargs, item):
    with pytest.raises(UsageError, match=item):
        solve_system(_rand((16, 16)), _rand((16, 1)), device="cpu", **kwargs)


def test_complex_input_is_refused_by_name():
    """Complex input is no longer refused: solve_system and lstsq match
    the JAX package's (X within the file's tolerance, the solve engine's
    pivots equal); only its distributed solve is refused, by item."""
    def close(xt, xj, a):
        kappa = _inf(a) * _inf(np.linalg.inv(a.astype(np.complex128)))
        tol = min(100 * np.finfo(np.float32).eps * kappa, 0.1)
        xj = np.asarray(xj)
        return _inf(xt.numpy() - xj) / _inf(xj) <= tol

    a = (_rand((8, 8)) + 1j * _rand((8, 8), seed=1)).astype(np.complex64)
    b = np.ones(8, np.complex64)
    rt, rj = solve_system(a, b, device="cpu"), jsolve_system(a, b)
    assert rt.engine == rj.engine and rt.x.dtype == torch.complex64
    assert close(rt.x, rj.x, a)
    _, _, stt = block_jordan_solve(torch.from_numpy(a),
                                   torch.from_numpy(b[:, None]),
                                   collect_stats=True)
    _, _, stj = je.block_jordan_solve(jnp.asarray(a), jnp.asarray(b[:, None]),
                                      collect_stats=True)
    np.testing.assert_array_equal(stt["pivot_block"].numpy(),
                                  np.asarray(stj["pivot_block"]))
    tall = np.concatenate([a, a.conj() + 2 * np.eye(8)]).astype(np.complex64)
    lt, lj = (lstsq(tall, np.ones(16, np.complex64), device="cpu"),
              jlstsq(tall, np.ones(16, np.complex64)))
    assert not lt.rank_deficient and not lj.rank_deficient
    assert close(lt.x, lj.x, tall.conj().T @ tall)
    with pytest.raises(UsageError, match="item 15"):
        solve_system(a, b, workers=2, device="cpu")


def test_singular_raises_and_check_false_reports():
    a = np.ones((16, 16), np.float32)
    b = _rand((16, 1), seed=27)
    with pytest.raises(SingularMatrixError):
        solve_system(a, b, block_size=8, device="cpu")
    res = solve_system(a, b, block_size=8, check=False, device="cpu")
    assert res.singular and res.x is None
    assert res.residual == float("inf")


def test_gate_passes_clean_no_rungs():
    a = _rand((32, 32), seed=32)
    b = _rand((32, 1), seed=33)
    res = solve_system(a, b, block_size=8, policy=ResiliencePolicy(),
                       device="cpu")
    assert res.recovery == ()


def test_bf16_gate_failure_recovers_by_refine():
    """The first rung: a bf16-rounded X fails the fp32-SLO gate; one
    refinement pass through the same engine recovers, in both
    packages."""
    a = ill_conditioned(16, 4.5, 7)
    b = np.random.default_rng(8).standard_normal((16, 2))
    rj = jsolve_system(a, b, block_size=8, dtype=jnp.bfloat16,
                       policy=JPolicy(gate_dtype="float32"))
    rt = solve_system(a, b, block_size=8, dtype="bfloat16",
                      policy=ResiliencePolicy(gate_dtype="float32"),
                      device="cpu")
    assert rt.recovery and rt.recovery[-1]["passed"]
    assert rt.recovery[0]["rung"] == "refine"
    assert [r["rung"] for r in rt.recovery] == [r["rung"]
                                                for r in rj.recovery]
    assert rt.x.dtype == torch.float32


def test_broken_spd_promise_recovers_by_repivot():
    """assume='spd' on a non-SPD matrix with a near-singular leading
    diagonal block: the pivot-free sweep fails the backward-error gate and
    the repivot rung recovers."""
    s = _rand((32, 32), seed=34)
    a = (s + s.T) / 2
    a[:8, :8] = np.eye(8, dtype=np.float32) * 1e-6
    b = _rand((32, 2), seed=35)
    res = solve_system(a, b, block_size=8, assume="spd",
                       policy=ResiliencePolicy(), device="cpu")
    assert res.recovery and res.recovery[-1]["passed"]
    assert res.recovery[-1]["rung"] == "repivot"
    assert res.rel_residual < 1e-5


def test_exhausted_ladder_raises():
    s = _rand((32, 32), seed=34)
    a = (s + s.T) / 2
    a[:8, :8] = np.eye(8, dtype=np.float32) * 1e-6
    with pytest.raises(ResidualGateError) as err:
        solve_system(a, _rand((32, 2), seed=35), block_size=8,
                     assume="spd", device="cpu",
                     policy=ResiliencePolicy(refine_steps=0,
                                             gate_tol=1e-12))
    assert [r["rung"] for r in err.value.recovery] == ["repivot"]


def test_lstsq_vs_numpy():
    a = _rand((64, 24), seed=40)
    b = _rand((64,), seed=41)
    res = lstsq(a, b, device="cpu")
    ref = jlstsq(a, b)
    assert res.engine == ref.engine == "solve_spd"      # gram is SPD
    exact, *_ = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                                rcond=None)
    assert np.abs(res.x.numpy() - exact).max() < 1e-3
    assert not res.rank_deficient and res.kappa_est is not None
    assert res.residual == pytest.approx(ref.residual, rel=1e-3)


def test_lstsq_rank_deficient_surfaced():
    a = _rand((32, 8), seed=42)
    a[:, 4:] = a[:, :4]                                   # rank 4 of 8
    res = lstsq(a, _rand((32,), seed=43), device="cpu")
    assert res.rank_deficient and res.x is None
    assert jlstsq(a, _rand((32,), seed=43)).rank_deficient


def test_lstsq_underdetermined_typed():
    with pytest.raises(UsageError, match="rows >= n"):
        lstsq(_rand((8, 16), seed=46), _rand((8,), seed=47), device="cpu")


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        solve_system(np.eye(4), np.ones(4))
    with pytest.raises(DeviceUnavailableError):
        lstsq(np.eye(4), np.ones(4))
    assert tmain(["16", "4", "--workload", "solve"]) == 2


@pytest.mark.parametrize("argv,expected", [
    (["64", "16", "--workload", "solve", "--rhs", "2", "--generator",
      "rand"], 0),
    (["48", "16", "--workload", "solve", "--rhs", "1", "--assume", "spd",
      "--generator", "kms"], 0),
    (["48", "16", "--workload", "lstsq", "--rhs", "1", "--generator",
      "rand"], 0),
    (["260", "4", "--workload", "solve", "--rhs", "3", "--generator",
      "rand", "--dtype", "float64"], 0),
    (["32", "8", "--workload", "solve", "--engine", "grouped"], 1),
    (["32", "8", "--workload", "solve", "--group", "2"], 1),
    (["32", "8", "--workload", "lstsq", "somefile"], 1),
    (["32", "8", "--workload", "lstsq", "--assume", "spd"], 1),
    (["32", "8", "--workload", "solve", "--refine", "1"], 1),
    (["32", "8", "--workload", "solve", "--batch", "2"], 1),
    (["32", "8", "--assume", "spd"], 1),
    (["32", "8", "--rhs", "5"], 1),
    (["1", "1", "--workload", "solve"], 2),
    # Hilbert's 64 x 32 window: a Gram matrix fp32 cannot carry (rank
    # deficient in both packages).
    (["64", "16", "--workload", "lstsq", "--generator", "hilbert"], 2),
])
def test_cli_exit_codes_match_jax(argv, expected):
    assert jmain(argv + ["--quiet"]) == expected
    assert tmain(argv + ["--device", "cpu"]) == expected


def test_cli_prints_backward_error_and_gate(capsys):
    assert tmain(["64", "16", "--workload", "solve", "--generator", "rand",
                  "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("rel_residual:"))
    rel = float(line.split()[1])
    gate = float(line.split("gate ")[1].rstrip(")"))
    assert rel < gate
    assert "engine: solve_aug on cpu" in out


def test_import_pulls_in_no_jax():
    code = ("import sys, tpu_jordan_torch.linalg, "
            "tpu_jordan_torch.profile_solve; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'tpu_jordan' "
            "or m.startswith('tpu_jordan.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
