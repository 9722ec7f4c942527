"""The port's probe-ahead (lookahead) engines against the JAX package's and
against the port's own non-lookahead engines, on the CPU.

The same numpy fixture goes through ``block_jordan_invert_inplace_lookahead``
and ``_grouped_lookahead`` of both packages with ``collect_stats=True``.
Pivot sequences and singular flags are decided by no floating-point tie
here and must be equal; inverses agree within min(100·eps·κ∞, 0.1)
(relative ∞-norm, eps the dtype's machine epsilon, κ∞ from the reference
inverse), the tolerance of ``test_torch_engine.py``: the frameworks sum
products in another order.  Against the port's own plain and grouped
engines the lookahead twins give the same bits on the CPU, which is pinned
(on the card a column-sliced GEMM need not sum like the full one, so
``chip_smoke.py`` holds the pivots there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan import driver as jdriver
from tpu_jordan.__main__ import main as jmain
from tpu_jordan.ops import generate as jgenerate
from tpu_jordan.ops import jordan_inplace as jj

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.ops import jordan_inplace as tj

SHAPES = [(64, 8), (50, 8), (96, 16)]
DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]
ENGINES = {
    "inplace": (jj.block_jordan_invert_inplace_lookahead,
                tj.block_jordan_invert_inplace_lookahead,
                tj.block_jordan_invert_inplace, {}),
    "grouped": (jj.block_jordan_invert_inplace_grouped_lookahead,
                tj.block_jordan_invert_inplace_grouped_lookahead,
                tj.block_jordan_invert_inplace_grouped, {"group": 2}),
}


def _inf(x):
    return np.abs(x).sum(axis=-1).max()


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
@pytest.mark.parametrize("gen", ["absdiff", "rand"])
@pytest.mark.parametrize("n,m", SHAPES)
def test_lookahead_matches_jax(engine, np_dt, t_dt, gen, n, m):
    jfn, tfn, _, kw = ENGINES[engine]
    a = np.array(jgenerate(gen, (n, n), np_dt))
    xj, sj, stj = jfn(jnp.asarray(a), block_size=m, collect_stats=True, **kw)
    xt, st, stt = tfn(torch.from_numpy(a), block_size=m, collect_stats=True,
                      **kw)
    xj = np.asarray(xj)
    assert bool(sj) is False and bool(st) is False
    np.testing.assert_array_equal(stt["pivot_block"].numpy(),
                                  np.asarray(stj["pivot_block"]))
    eps = np.finfo(np_dt).eps
    kappa = _inf(a) * _inf(xj)
    assert _inf(xt.numpy() - xj) / _inf(xj) <= min(100 * eps * kappa, 0.1)
    assert xt.dtype == t_dt and xt.shape == (n, n)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
@pytest.mark.parametrize("gen", ["absdiff", "rand", "kms"])
@pytest.mark.parametrize("n,m", SHAPES + [(128, 32)])
def test_lookahead_matches_port_engine(engine, np_dt, t_dt, gen, n, m):
    """Pivots, flags, the whole record and the inverse's bits equal to the
    non-lookahead engine's."""
    _, tfn, plain, kw = ENGINES[engine]
    a = torch.from_numpy(np.array(jgenerate(gen, (n, n), np_dt)))
    x0, s0, st0 = plain(a, block_size=m, collect_stats=True, **kw)
    x1, s1, st1 = tfn(a, block_size=m, collect_stats=True, **kw)
    assert bool(s0) == bool(s1)
    for key in st0:
        assert torch.equal(st0[key], st1[key]), key
    assert torch.equal(x0, x1)


@pytest.mark.parametrize("group", [3, 4])
def test_grouped_lookahead_other_group_sizes(group):
    """Groups of 3 and 4 over Nr = 10 (a ragged last group) keep the
    grouped engine's pivots and bits."""
    a = torch.from_numpy(np.array(jgenerate("rand", (80, 80), np.float64)))
    x0, _, st0 = tj.block_jordan_invert_inplace_grouped(
        a, block_size=8, group=group, collect_stats=True)
    x1, _, st1 = tj.block_jordan_invert_inplace_grouped_lookahead(
        a, block_size=8, group=group, collect_stats=True)
    assert torch.equal(st0["pivot_block"], st1["pivot_block"])
    assert torch.equal(x0, x1)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_singular_input_is_flagged(engine):
    """A rank-1 matrix: every candidate of the first column is singular,
    in both packages."""
    jfn, tfn, _, kw = ENGINES[engine]
    a = np.ones((32, 32))
    _, sj, _ = jfn(jnp.asarray(a), block_size=8, collect_stats=True, **kw)
    _, st, stt = tfn(torch.from_numpy(a), block_size=8, collect_stats=True,
                     **kw)
    assert bool(sj) and bool(st)
    assert int(stt["singular_candidates"][0]) == 4


@pytest.mark.parametrize("engine", list(ENGINES))
def test_probe_argument_runs_once_a_superstep(engine):
    """``probe=`` is called once per superstep (Nr times) on the live
    window, as in the other engines."""
    _, tfn, _, kw = ENGINES[engine]
    sizes = []

    def probe(cands, eps):
        sizes.append(cands.shape[0])
        return tj.probe_blocks(cands, eps)

    a = torch.from_numpy(np.array(jgenerate("rand", (48, 48), np.float64)))
    tfn(a, block_size=8, probe=probe, **kw)
    assert sizes == [6, 5, 4, 3, 2, 1]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_sub_fp32_is_upcast(engine):
    _, tfn, plain, kw = ENGINES[engine]
    a = torch.from_numpy(np.array(jgenerate("kms", (32, 32), np.float32)))
    x, s = tfn(a.bfloat16(), block_size=8, **kw)
    x0, _ = plain(a.bfloat16(), block_size=8, **kw)
    assert x.dtype == torch.bfloat16 and not bool(s)
    assert torch.equal(x, x0)


def test_probe_ahead_on_the_cpu_has_no_streams():
    ahead = tj._ProbeAhead(torch.device("cpu"), tj.probe_blocks, 1e-15)
    assert ahead.side is None and ahead.main is None
    cands = torch.eye(4, dtype=torch.float64).expand(3, 4, 4).contiguous()
    ahead.launch(cands, 2)
    H, piv, key, sing = ahead.take()
    assert int(piv) == 2 and not bool(sing.any())
    assert torch.equal(H, torch.eye(4, dtype=torch.float64))


@pytest.mark.parametrize("group", [0, 2, 3])
def test_resolve_engine_matches_jax(group):
    assert (tdriver.resolve_engine("lookahead", group)
            == jdriver.resolve_engine("lookahead", group))


@pytest.mark.parametrize("n", [64, 8192, 16384])
def test_auto_never_picks_lookahead(n):
    assert tdriver.resolve_engine("auto", 0, n)[0] != "lookahead"


@pytest.mark.parametrize("group", [0, 2])
def test_unrolled_only_limit_matches_jax(group):
    """Nr = 65 > MAX_UNROLL_NR = 64 is refused by both packages, with the
    same words."""
    with pytest.raises(jdriver.UsageError, match="unrolled-only") as ref:
        jdriver.solve(260, 4, generator="rand", engine="lookahead",
                      group=group)
    with pytest.raises(UsageError, match="unrolled-only") as got:
        tdriver.solve(260, 4, generator="rand", engine="lookahead",
                      group=group, device="cpu")
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("group", [0, 2])
def test_driver_solve_matches_inplace_engine(group):
    """``driver.solve(engine="lookahead")`` runs the twin of the engine the
    group names and verifies it as the other engines are verified."""
    la = tdriver.solve(96, 16, generator="rand", dtype="float64",
                       engine="lookahead", group=group, device="cpu")
    ref = tdriver.solve(96, 16, generator="rand", dtype="float64",
                        engine="grouped" if group else "inplace",
                        group=group, device="cpu")
    assert (la.engine, la.group) == ("lookahead", group)
    assert torch.equal(la.inverse, ref.inverse)
    assert la.rel_residual < 1e-12


@pytest.mark.parametrize("argv,expected", [
    (["64", "16", "--engine", "lookahead"], 0),
    (["64", "16", "--engine", "lookahead", "--group", "2"], 0),
    (["520", "8", "--engine", "lookahead"], 1),
    (["8", "4", "--engine", "lookahead", "--group", "1"], 1),
])
def test_cli_exit_codes_match_jax(argv, expected):
    assert jmain(argv + ["--quiet"]) == expected
    assert tmain(argv + ["--device", "cpu"]) == expected
