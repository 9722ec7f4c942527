"""Complex dtypes in the port against the JAX package, on the CPU.

The same numpy fixtures, complex64 and complex128, go through both
packages: ``crand`` must be bit-equal; the plain probe's flags equal, its
inverses within 50·eps·m·κ∞ of each block (eps the component dtype's
threshold, κ∞ of the block from numpy); the augmented engine's pivot
sequence equal to the JAX package's (taken from its [A | I] solve engine's
``collect_stats`` record: the JAX augmented engine does not expose its
pivots, and its in-place engine, the record ``test_torch_augmented.py``
uses, refuses complex input) and its inverse within min(100·eps·κ∞, 0.1),
the tolerance of ``test_torch_augmented.py``; ``solve_system`` and ``lstsq``
X within 3·eps·n·κ∞ of the JAX package's (``tests/test_linalg.py``), pivots
equal.  The driver's routing and refusals, the CLI, the hand-over from
numpy and the schedule rule of ``csrc/gj_probe.cu``'s complex bodies are
held here too.  The JAX side runs its plain XLA path, where complex runs in
that package anyway.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_jordan import driver as jdriver
from tpu_jordan.driver import UsageError as JUsageError
from tpu_jordan.__main__ import main as jmain
from tpu_jordan.linalg import engine as je
from tpu_jordan.linalg import lstsq as jlstsq
from tpu_jordan.linalg import solve_system as jsolve_system
from tpu_jordan.ops import block_jordan_invert as jinvert
from tpu_jordan.ops import generate as jgenerate
from tpu_jordan.ops.block_inverse import batched_block_inverse as jplain

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.config import eps_for, real_dtype
from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.interop import from_numpy, resolve_dtype
from tpu_jordan_torch.linalg import block_jordan_solve, lstsq, solve_system
from tpu_jordan_torch.ops import batched_block_inverse, generate
from tpu_jordan_torch.ops import gj_probe as probe_mod
from tpu_jordan_torch.ops import probe_blocks
from tpu_jordan_torch.ops.jordan import block_jordan_invert
from tpu_jordan_torch.ops.jordan_inplace import _select
from tpu_jordan_torch.utils.printing import format_corner

CDTYPES = [np.complex64, np.complex128]
# Global scales and the factor of the scaled-down extra block: eps·scale
# lies above every pivot of that block and below the regular blocks' (the
# constants of chip_smoke.py's scaled rows).
SCALE = {np.complex64: 2e4, np.complex128: 1e7}
SCALE_DOWN = {np.complex64: 1e-4, np.complex128: 1e-10}


def _crand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _inf(x):
    return np.abs(x).sum(axis=-1).max(axis=-1)


# --------------------------------------------------------------- crand


@pytest.mark.parametrize("np_dt", CDTYPES)
@pytest.mark.parametrize("offset", [(0, 0), (77, 13)])
def test_crand_bits_equal_jax(np_dt, offset):
    r, c = offset
    want = np.asarray(jgenerate("crand", (64, 64), np_dt, row_offset=r,
                                col_offset=c))
    got = generate("crand", (64, 64), getattr(torch, np.dtype(np_dt).name),
                   row_offset=r, col_offset=c).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("real", ["float32", "float64"])
def test_crand_refuses_a_real_dtype(real):
    with pytest.raises(ValueError, match="imaginary"):
        jgenerate("crand", (4, 4), getattr(jnp, real))
    with pytest.raises(ValueError, match="imaginary"):
        generate("crand", (4, 4), getattr(torch, real))


# --------------------------------------------------------- plain probe


def _stack(nc, m, np_dt, seed):
    b = _crand((nc, m, m), np_dt, seed)
    b[1] = 0.0                          # zero block
    b[2, m - 1] = 0.0                   # zero row
    b[3, m // 2, m // 3] = np.nan       # non-finite
    b[4, 0, m - 1] = np.inf
    return b


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("m", [8, 12, 32, 50])
@pytest.mark.parametrize("np_dt", CDTYPES)
def test_plain_probe_matches_jax(np_dt, m, scaled):
    blocks = _stack(7, m, np_dt, seed=m)
    scale, flagged = None, [1, 2, 3, 4]
    if scaled:
        blocks = np.concatenate([blocks, blocks[:1] * SCALE_DOWN[np_dt]])
        scale, flagged = SCALE[np_dt], flagged + [7]
    eps = eps_for(getattr(torch, np.dtype(np_dt).name))
    ij, sj = jplain(jnp.asarray(blocks), scale, eps)
    it, st = batched_block_inverse(torch.from_numpy(blocks), scale, eps)
    ij, sj, it, st = np.asarray(ij), np.asarray(sj), it.numpy(), st.numpy()
    np.testing.assert_array_equal(st, sj)
    assert np.flatnonzero(st).tolist() == flagged
    assert it.dtype == np_dt and st.dtype == bool
    ok = ~sj
    b64 = blocks[ok].astype(np.complex128)
    kappa = _inf(b64) * _inf(np.linalg.inv(b64))
    rel = _inf(it[ok] - ij[ok]) / _inf(ij[ok])
    assert np.all(rel <= 50 * eps * m * kappa), rel


@pytest.mark.parametrize("np_dt", CDTYPES)
def test_probe_keys_and_scale_are_real(np_dt):
    """|z| keys: a complex pivot whose real part is small but whose modulus
    is the largest is picked (the lowest row on ties, as argmax), and a
    complex scale counts by its modulus."""
    a = np.array([[0.1 + 3j, 1.0], [2.0, 1.0]], np_dt)
    ij, sj = jplain(jnp.asarray(a[None]), None, 1e-7)
    it, st = batched_block_inverse(torch.from_numpy(a[None]))
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-5)
    np.testing.assert_allclose(it[0].numpy() @ a, np.eye(2), atol=1e-5)
    # |pivots| 3.0 and 1.18: eps·|scale| = 2.0 flags the block, eps times
    # the scale's real part (1.0) would not.
    scale = torch.tensor(1e6 + 1.7320508e6j)
    _, s_c = batched_block_inverse(torch.from_numpy(a[None]), scale, 1e-6)
    _, s_r = batched_block_inverse(torch.from_numpy(a[None]), 1e6, 1e-6)
    assert bool(s_c[0]) and not bool(s_r[0])


def test_cpu_complex_probe_runs_plain_and_counts_no_launch():
    probe_mod.reset_launches()
    blocks = torch.from_numpy(_stack(6, 16, np.complex64, seed=1))
    inv, sing = probe_mod.gj_probe(blocks)
    ref = batched_block_inverse(blocks, None, eps_for(torch.complex64))
    assert torch.equal(sing, ref[1])
    assert torch.equal(inv[~sing], ref[0][~sing])
    assert probe_mod.launches == 0
    assert probe_mod.complex_launches == {"c64": 0, "c128": 0}
    with pytest.raises(ValueError, match="unsupported device"):
        probe_mod.launch_kernel(blocks, 5e-7, ("block", 1))


# ------------------------------------------------- gj_probe.cu schedule


def _packed(kind, c):
    return 132 // c


# (m, dtype, schedule) for a stack of 1000 on a card that holds 132 // C
# clusters of C blocks: complex64 keeps the block schedule to m = 128,
# complex128 (16-byte values) to m = 64.
@pytest.mark.parametrize("m,dtype,expected", [
    (50, torch.complex64, ("block", 1)),
    (128, torch.complex64, ("block", 1)),
    (129, torch.complex64, ("cluster", 2)),
    (64, torch.complex128, ("block", 1)),
    (65, torch.complex128, ("cluster", 2)),
    (128, torch.complex128, ("cluster", 2)),
])
def test_complex_schedule_by_element_size(m, dtype, expected):
    elem, key = probe_mod.value_sizes(dtype)
    assert probe_mod.probe_schedule(m, elem, 1000, _packed,
                                    key_bytes=key) == expected


@pytest.mark.parametrize("dtype,sizes", [
    (torch.float32, (4, 4)), (torch.float64, (8, 8)),
    (torch.complex64, (8, 4)), (torch.complex128, (16, 8))])
def test_value_and_key_sizes(dtype, sizes):
    assert probe_mod.value_sizes(dtype) == sizes
    assert real_dtype(dtype) == {4: torch.float32,
                                 8: torch.float64}[sizes[1]]


def test_complex_smem_keeps_real_keys():
    """The slots of keys and row sums take the component's size: complex64
    needs less shared memory than fp64 (same value size) and complex128
    more than fp64, on every schedule."""
    smem = probe_mod.probe_smem_bytes
    for c, rows in ((1, 0), (4, 96), (16, 24)):
        c64 = smem(384, 8, c, rows, key_bytes=4)
        assert c64 < smem(384, 8, c, rows)
        assert smem(384, 16, c, rows, key_bytes=8) > smem(384, 8, c, rows)


@pytest.mark.parametrize("m,dtype,body", [
    (128, torch.complex64, "gj_probe[c64]"),
    (50, torch.complex64, "gj_probe[c64]"),
    (384, torch.complex128, "gj_probe[c128]"),
    (128, torch.float32, "gj_probe_fused_panel"),
    (50, torch.float64, "gj_probe")])
def test_probe_body_names_the_complex_bodies(m, dtype, body):
    assert probe_mod.probe_body(m, dtype) == body


# --------------------------------------------------- augmented engine


def recording_probe(pivots):
    def probe(cands, eps, scale=None):
        invs, sing = probe_blocks(cands, eps, scale)
        pivots.append(int(_select(invs, sing, len(pivots))[1]))
        return invs, sing
    return probe


@pytest.mark.parametrize("np_dt", CDTYPES)
@pytest.mark.parametrize("n,m", [(96, 16), (128, 32)])
def test_augmented_engine_matches_jax(np_dt, n, m):
    a = np.array(jgenerate("crand", (n, n), np_dt))
    xj, sj = jinvert(jnp.asarray(a), block_size=m, use_pallas=False,
                     global_scale=True)
    _, _, stj = je.block_jordan_solve(jnp.asarray(a),
                                      jnp.eye(n, dtype=np_dt), block_size=m,
                                      collect_stats=True)
    pivots = []
    xt, st = block_jordan_invert(torch.from_numpy(a), block_size=m,
                                 global_scale=True,
                                 probe=recording_probe(pivots))
    assert not bool(sj) and not bool(st)
    assert pivots == np.asarray(stj["pivot_block"]).tolist()
    xj = np.asarray(xj)
    kappa = _inf(a) * _inf(xj)
    eps = np.finfo(np_dt).eps
    assert xt.dtype == getattr(torch, np.dtype(np_dt).name)
    assert _inf(xt.numpy() - xj) / _inf(xj) <= min(100 * eps * kappa, 0.1)


# --------------------------------------------------------------- driver


def test_driver_auto_runs_augmented_like_jax():
    rt = tdriver.solve(96, 16, generator="crand", dtype="complex64",
                       device="cpu")
    rj = jdriver.solve(96, 16, generator="crand", dtype=jnp.complex64)
    assert rt.engine == rj.engine == "augmented"
    assert rt.inverse.dtype == torch.complex64
    for r in (rt, rj):
        assert isinstance(r.rel_residual, float) and isinstance(r.kappa,
                                                                float)
    assert rt.kappa == pytest.approx(rj.kappa, rel=1e-3)
    gate = min(3 * np.finfo(np.float32).eps * 96 * rt.kappa / rt._norm_a,
               0.5)
    assert rt.rel_residual < gate and rj.rel_residual < gate
    x = tdriver.solve(96, 16, generator="crand", dtype="complex64",
                      engine="augmented", device="cpu").inverse
    assert torch.equal(x, rt.inverse)


@pytest.mark.parametrize("engine,group", [
    ("inplace", 0), ("grouped", 0), ("grouped", 2), ("auto", 2),
    ("lookahead", 0), ("grouped_pallas", 0), ("grouped_pallas_bf16", 0)])
def test_driver_refuses_real_only_engines_like_jax(engine, group):
    with pytest.raises(JUsageError, match="complex dtype requires"):
        jdriver.solve(32, 8, generator="crand", dtype=jnp.complex64,
                      engine=engine, group=group)
    with pytest.raises(UsageError, match="complex dtype requires"):
        tdriver.solve(32, 8, generator="crand", dtype="complex64",
                      engine=engine, group=group, device="cpu")


@pytest.mark.parametrize("kwargs,item", [
    ({"workers": 2}, "item 15"), ({"workers": (2, 2)}, "item 15"),
    ({"tune": True, "engine": "augmented"}, "engine='auto' only"),
    ({"telemetry": object()}, "item 12"),
    ({"numerics": "summary"}, "item 12")])
def test_driver_refuses_later_options_for_complex(kwargs, item):
    with pytest.raises(UsageError, match=item):
        tdriver.solve(32, 8, generator="crand", dtype="complex128",
                      device="cpu", **kwargs)


def test_solve_batch_refuses_complex():
    """The JAX solve_batch fails on a complex dtype inside its in-place
    engine (a TypeError); the port refuses it up front."""
    with pytest.raises(TypeError):
        jdriver.solve_batch(16, 8, batch=2, generator="crand",
                            dtype=jnp.complex64)
    with pytest.raises(UsageError, match="real-dtype engine"):
        tdriver.solve_batch(16, 8, batch=2, generator="crand",
                            dtype="complex64", device="cpu")


def test_driver_prints_a_complex_corner(capsys):
    tdriver.solve(16, 8, generator="crand", dtype="complex64",
                  device="cpu", verbose=True)
    out = capsys.readouterr().out
    first = out.splitlines()[1].split("\t")
    assert first[0] == "-1.00-0.37i"          # crand(0, 0)
    assert format_corner(torch.eye(2)) == "1.00\t0.00\t\n0.00\t1.00\t"


# --------------------------------------------------------------- solves


def _solve_tol(a, x_ref, x):
    kappa = _inf(a) * _inf(np.linalg.inv(a.astype(np.complex128)))
    tol = np.finfo(np.float32).eps * a.shape[0] * kappa
    return np.abs(x - x_ref).max() / np.abs(x_ref).max() <= 3 * tol


@pytest.mark.parametrize("n,m,k", [(40, 8, 2), (96, 16, 3)])
def test_complex_solve_engine_matches_jax(n, m, k):
    a = _crand((n, n), np.complex64, seed=n)
    b = _crand((n, k), np.complex64, seed=n + 1)
    xj, sj, stj = je.block_jordan_solve(jnp.asarray(a), jnp.asarray(b),
                                        block_size=m, collect_stats=True)
    xt, st, stt = block_jordan_solve(torch.from_numpy(a), torch.from_numpy(b),
                                     block_size=m, collect_stats=True)
    assert not bool(sj) and not bool(st)
    np.testing.assert_array_equal(stt["pivot_block"].numpy(),
                                  np.asarray(stj["pivot_block"]))
    assert xt.dtype == torch.complex64
    assert _solve_tol(a, np.asarray(xj), xt.numpy())


@pytest.mark.parametrize("engine,assume", [
    ("solve_aug", "general"), ("solve_fori", "general"),
    ("solve_spd", "spd"), ("auto", "spd")])
def test_complex_solve_system_matches_jax(engine, assume):
    n = 48
    a = _crand((n, n), np.complex64, seed=8)
    if assume == "spd":                    # Hermitian positive definite
        a = (a @ a.conj().T + n * np.eye(n)).astype(np.complex64)
    b = _crand((n, 2), np.complex64, seed=9)
    rj = jsolve_system(a, b, block_size=8, assume=assume, engine=engine)
    rt = solve_system(a, b, block_size=8, assume=assume, engine=engine,
                      device="cpu")
    assert rt.engine == rj.engine
    assert rt.x.dtype == torch.complex64
    assert _solve_tol(a, np.asarray(rj.x), rt.x.numpy())
    assert isinstance(rt.rel_residual, float)
    assert rt.rel_residual < 16 * np.finfo(np.float32).eps * n


def test_complex_input_solves_by_name():
    """Complex input is solved, no longer refused: solve_system and lstsq
    against numpy's complex128 answers."""
    a = _crand((8, 8), np.complex64, seed=0)
    res = solve_system(a, np.ones(8, np.complex64), device="cpu")
    truth = np.linalg.solve(a.astype(np.complex128), np.ones(8))
    assert res.x.shape == (8,)
    np.testing.assert_allclose(res.x.numpy(), truth, rtol=1e-4, atol=1e-5)
    tall = _crand((16, 8), np.complex64, seed=1)
    fit = lstsq(tall, np.ones(16, np.complex64), device="cpu")
    ref, *_ = np.linalg.lstsq(tall.astype(np.complex128), np.ones(16),
                              rcond=None)
    np.testing.assert_allclose(fit.x.numpy(), ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("assume", ["spd", "general"])
def test_complex_lstsq_matches_jax(assume):
    a = _crand((48, 12), np.complex64, seed=44)
    b = _crand((48, 2), np.complex64, seed=45)
    rj = jlstsq(a, b, block_size=4, assume=assume)
    rt = lstsq(a, b, block_size=4, assume=assume, device="cpu")
    assert not rt.rank_deficient and not rj.rank_deficient
    ref, *_ = np.linalg.lstsq(a.astype(np.complex128),
                              b.astype(np.complex128), rcond=None)
    g = a.conj().T @ a
    assert _solve_tol(g, np.asarray(rj.x), rt.x.numpy())
    assert np.abs(rt.x.numpy() - ref).max() / np.abs(ref).max() < 1e-3
    assert rt.residual == pytest.approx(rj.residual, rel=1e-3)


def test_complex_lstsq_rank_deficient_surfaced():
    a = _crand((32, 8), np.complex64, seed=42)
    a[:, 5] = a[:, 2]
    b = _crand((32,), np.complex64, seed=43)
    res = lstsq(a, b, block_size=4, device="cpu")
    assert res.rank_deficient and res.x is None
    assert jlstsq(a, b, block_size=4).rank_deficient


@pytest.mark.parametrize("workers", [2, (2, 2)])
def test_complex_distributed_solve_refused_in_jax_words(workers):
    a = _crand((16, 16), np.complex64, seed=3)
    with pytest.raises(JUsageError, match="single-device"):
        jsolve_system(a, np.ones(16, np.complex64), workers=workers)
    with pytest.raises(UsageError, match="single-device.*item 15"):
        solve_system(a, np.ones(16, np.complex64), workers=workers,
                     device="cpu")


# ------------------------------------------------------------------ CLI


@pytest.mark.parametrize("argv", [
    ["96", "16", "--dtype", "complex64", "--generator", "crand"],
    ["96", "16", "--dtype", "complex64", "--generator", "crand",
     "--workload", "solve"],
    ["96", "16", "--dtype", "complex64", "--generator", "crand",
     "--workload", "lstsq"]])
def test_cli_complex_runs(argv, capsys):
    assert tmain(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out
    assert jmain(argv + ["--quiet"]) == 0


def test_cli_crand_with_a_real_dtype_exits_1(capsys):
    argv = ["16", "8", "--generator", "crand"]
    assert jmain(argv) == 1
    assert tmain(argv + ["--device", "cpu"]) == 1
    assert "imaginary part" in capsys.readouterr().err


def test_cli_complex_needs_a_card():
    assert tmain(["16", "8", "--dtype", "complex64", "--generator",
                  "crand"]) == 2


# -------------------------------------------------------------- interop


@pytest.mark.parametrize("np_dt", CDTYPES)
def test_from_numpy_carries_complex(np_dt):
    a = _crand((5, 3), np_dt, seed=2)
    t = from_numpy(a, "cpu")
    assert t.dtype == resolve_dtype(np.dtype(np_dt)) == resolve_dtype(
        np.dtype(np_dt).name)
    assert np.array_equal(t.numpy(), a)
    assert from_numpy(a.real.copy(), "cpu", np_dt).dtype == t.dtype


@pytest.mark.parametrize("np_dt", CDTYPES)
def test_newton_schulz_refines_complex_like_jax(np_dt):
    from tpu_jordan.ops.refine import newton_schulz as jrefine

    from tpu_jordan_torch.ops import newton_schulz

    a = _crand((32, 32), np_dt, seed=11)
    x0 = (np.linalg.inv(a.astype(np.complex128))
          * (1 + 1e-3)).astype(np_dt)
    xj = np.asarray(jrefine(jnp.asarray(a), jnp.asarray(x0), 2))
    xt = newton_schulz(*(torch.from_numpy(v) for v in (a, x0)), 2).numpy()
    eps = np.finfo(np_dt).eps
    kappa = _inf(a) * _inf(xj)
    assert xt.dtype == np_dt
    assert _inf(xt - xj) / _inf(xj) <= 100 * eps * kappa
    assert _inf(a @ xt - np.eye(32)) < _inf(a @ x0 - np.eye(32)) / 100
