"""The port's 2D in-place engines (``parallel/jordan2d_inplace.py``) over
``torch.distributed`` against the JAX package's
``sharded_jordan_invert_inplace_2d`` on its virtual CPU devices, mesh shape
for mesh shape.

One gloo world of 4 CPU ranks (its subgroups give the meshes (2, 2),
(1, 4) and (4, 1)) and one of 6 ranks (the mesh (2, 3)), each spawned once
for the module (``parallel.run_calls``).  The same numpy fixtures go
through both packages: the JAX package's 2D-cyclic storage array, split
into the ranks' shards (``jordan2d.split_shards_2d``).

  * The pivot sequence equals the JAX plain engine's exactly (its segment
    executable exposes the swap record), for every engine; the inverse
    lies within 16·eps·n·κ∞ (relative ∞-norm) of the JAX engine of the
    same option (grouped k = 2 and 3 against the JAX grouped engine).
  * Fixtures: gaussian; ``|i − j|`` (tied pivots whose swaps cross mesh
    columns, pc = 4); forced swaps (the diagonal blocks weakest); a zero
    row (``singular`` on every rank, as in JAX); a ragged n on (2, 3); an
    fp32 diagonally dominant matrix; Nr = 65 (the JAX fori engine's side).
  * lookahead and swapfree bit-match inplace on the same world, and both
    probe layouts bit-match; on every step the rows probed across the
    ranks are the live rows, each probed by exactly one rank.
  * lookahead above MAX_UNROLL_NR, and with swapfree or a group, are
    refused, typed, in the JAX words.
  * ``driver.solve(workers=(2, 2))`` and ``python -m tpu_jordan_torch 64 8
    --workers 2x2 --no-gather -v``: the inverse, residual and κ∞, and the
    verbose corner (from the owning blocks), equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec

from tpu_jordan import driver as jdriver
from tpu_jordan.__main__ import main as jmain
from tpu_jordan.config import eps_for as jeps
from tpu_jordan.driver import UsageError as JUsageError
from tpu_jordan.parallel import jordan2d as jj2
from tpu_jordan.parallel import jordan2d_inplace as jji
from tpu_jordan.parallel import layout as jl
from tpu_jordan.parallel import make_mesh_2d

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.parallel import jordan2d as tj2
from tpu_jordan_torch.parallel import jordan2d_inplace as tji
from tpu_jordan_torch.parallel import run_calls, run_workers
from tpu_jordan_torch.parallel.layout import CyclicLayout2D


def _fixture(kind, n, dtype="float64"):
    rng = np.random.default_rng(3 * n + len(kind))
    if kind == "absdiff":
        i = np.arange(n)
        a = np.abs(i[:, None] - i[None, :]).astype(float)
    elif kind == "swaps":
        a = rng.standard_normal((n, n)) + 2.0 * n * np.eye(n)
        a = np.roll(a, 8, axis=0)
    elif kind == "dominant":
        a = rng.standard_normal((n, n)) + 2.0 * n * np.eye(n)
    elif kind == "zero_row":
        a = rng.standard_normal((n, n))
        a[n // 2] = 0.0
    else:
        a = rng.standard_normal((n, n))
    return a.astype(dtype)


# (name, shape, kind, n, m, dtype, [(engine, k, probe layout), ...])
CASES = {
    4: [("gauss22", (2, 2), "gauss", 48, 8, "float64",
         [("inplace", 0, "column"), ("inplace", 0, "owner"),
          ("lookahead", 0, "auto"), ("grouped", 2, "auto"),
          ("grouped", 3, "auto"), ("swapfree", 0, "column"),
          ("swapfree", 0, "owner")]),
        ("absdiff14", (1, 4), "absdiff", 64, 8, "float64",
         [("inplace", 0, "column"), ("lookahead", 0, "column"),
          ("swapfree", 0, "column"), ("grouped", 2, "owner")]),
        ("swaps41", (4, 1), "swaps", 48, 8, "float64",
         [("inplace", 0, "auto"), ("lookahead", 0, "auto"),
          ("swapfree", 0, "auto")]),
        ("zero_row22", (2, 2), "zero_row", 48, 8, "float64",
         [("inplace", 0, "column"), ("grouped", 2, "auto"),
          ("swapfree", 0, "owner")]),
        ("dominant22", (2, 2), "dominant", 64, 8, "float32",
         [("inplace", 0, "column"), ("lookahead", 0, "owner")]),
        ("nr65", (2, 2), "gauss", 130, 2, "float64",
         [("inplace", 0, "column")])],
    6: [("ragged23", (2, 3), "gauss", 45, 8, "float64",
         [("inplace", 0, "column"), ("lookahead", 0, "owner"),
          ("swapfree", 0, "column"), ("grouped", 2, "column")])],
}
NAMES = {c[0]: (p, i) for p, cases in CASES.items()
         for i, c in enumerate(cases)}
_WORLDS = {}


def _jax_storage(a, shape, m):
    mesh = make_mesh_2d(*shape)
    lay = jl.CyclicLayout2D.create(a.shape[0], m, *shape)
    return mesh, lay, jj2.scatter_matrix_2d(jnp.asarray(a), lay, mesh)


def _world(p):
    """Every case of one world size in one spawn: ``{name: [per-variant
    list of rank outcomes]}``."""
    if p in _WORLDS:
        return _WORLDS[p]
    calls, labels = [], []
    for name, shape, kind, n, m, dt, variants in CASES[p]:
        _, jlay, W = _jax_storage(_fixture(kind, n, dt), shape, m)
        lay = CyclicLayout2D.create(n, m, *shape)
        shards = [x.numpy() for x in tj2.split_shards_2d(
            torch.from_numpy(np.array(W)), lay)]
        for engine, k, layout in variants:
            calls.append((tji.invert_shards_2d,
                          (shards, shape, n, m, engine, k, layout)))
            labels.append((name, engine, k, layout))
    res = run_workers(p, run_calls, calls, deadline_s=600,
                      device_type="cpu")
    out = {}
    for i, label in enumerate(labels):
        out[label] = [res[r][i] for r in range(p)]
    _WORLDS[p] = out
    return out


def _case(name):
    p, i = NAMES[name]
    return p, CASES[p][i]


def _jax_plain(W, mesh, lay, n):
    """The JAX plain 2D engine's swap record, flag and inverse, from its
    segment executable (the fori body beyond MAX_UNROLL_NR) and its
    finalize: the monolithic engine's steps and unscramble."""
    shape = (lay.pr, lay.pc)
    sing = jax.device_put(jnp.zeros(shape, bool),
                          NamedSharding(mesh, PartitionSpec("pr", "pc")))
    sw = jax.device_put(jnp.zeros(shape + (lay.Nr,), jnp.int32),
                        NamedSharding(mesh, PartitionSpec("pr", "pc", None)))
    W, s, sw = jji._sharded_jordan2d_inplace_segment(
        W, sing, sw, mesh, lay, 0, lay.Nr, jeps(W.dtype),
        lax.Precision.HIGHEST, False, lay.Nr <= jji.MAX_UNROLL_NR)
    inv = jji.gather_inverse_inplace_2d(
        jji._sharded_jordan2d_inplace_finalize(W, sw, mesh, lay), lay, n)
    sw = np.asarray(sw)
    assert all((row == sw[0, 0]).all() for row in sw.reshape(-1, lay.Nr))
    return sw[0, 0].tolist(), bool(np.asarray(s).any()), np.asarray(inv)


_JAX = {}


def _jax_ref(name):
    if name in _JAX:
        return _JAX[name]
    _, (_, shape, kind, n, m, dt, variants) = _case(name)
    a = _fixture(kind, n, dt)
    mesh, jlay, W = _jax_storage(a, shape, m)
    pivots, singular, inv = _jax_plain(W, mesh, jlay, n)
    invs = {0: inv}
    if not singular:
        for k in sorted({k for e, k, _ in variants if e == "grouped"}):
            inv, _ = jji.sharded_jordan_invert_inplace_2d(
                jnp.asarray(a), mesh, m, group=k)
            invs[k] = np.asarray(inv)
    _JAX[name] = (a, pivots, singular, invs)
    return _JAX[name]


def _gathered(ranks, name):
    _, (_, shape, kind, n, m, dt, _) = _case(name)
    lay = CyclicLayout2D.create(n, m, *shape)
    return tji.gather_inverse_inplace_2d([r["blocks"] for r in ranks], lay,
                                         n).numpy()


def _variant_ids():
    out = []
    for p, cases in CASES.items():
        for name, _, _, _, _, _, variants in cases:
            out += [(name, e, k, lay) for e, k, lay in variants]
    return out


VARIANTS = _variant_ids()
IDS = [f"{n}-{e}{k or ''}-{lay}" for n, e, k, lay in VARIANTS]


@pytest.mark.parametrize("name,engine,k,layout", VARIANTS, ids=IDS)
def test_engine_matches_jax(name, engine, k, layout):
    p, (_, shape, kind, n, m, dt, _) = _case(name)
    ranks = _world(p)[(name, engine, k, layout)]
    a, pivots, singular, invs = _jax_ref(name)
    head = ranks[0]
    assert all(r["pivots"] == head["pivots"] for r in ranks)
    assert all(r["singular"] == singular for r in ranks)
    if singular:
        return
    # swapfree records swap coordinates: the swap engines' pivots.
    assert head["pivots"] == pivots
    inv = _gathered(ranks, name)
    ref = invs.get(k, invs[0])
    eps = np.finfo(dt).eps
    kappa = np.abs(a).sum(1).max() * np.abs(ref).sum(1).max()
    rel = np.abs(inv - ref).sum(1).max() / np.abs(ref).sum(1).max()
    assert rel <= 16 * eps * n * kappa


def _retired_rows(swaps, Nr):
    """The physical rows the swap-free engine retires, step by step, from
    its swap-coordinate record."""
    pos, ipos, out = list(range(Nr)), list(range(Nr)), []
    for t, piv_pos in enumerate(swaps):
        g, x = ipos[piv_pos], ipos[t]
        out.append(g)
        pos[x], pos[g] = piv_pos, t
        ipos[t], ipos[piv_pos] = g, x
    return out


@pytest.mark.parametrize("name,engine,k,layout", VARIANTS, ids=IDS)
def test_each_live_candidate_is_probed_by_one_rank(name, engine, k, layout):
    p, (_, shape, kind, n, m, dt, _) = _case(name)
    ranks = _world(p)[(name, engine, k, layout)]
    Nr = CyclicLayout2D.create(n, m, *shape).Nr
    by_step = {}
    for r in ranks:
        assert r["probe_steps"] == [t for t, _ in r["probed"]]
        for t, rows in r["probed"]:
            assert rows
            by_step.setdefault(t, []).extend(rows)
    if engine == "swapfree":
        retired = _retired_rows(ranks[0]["pivots"], Nr)
        live = [sorted(set(range(Nr)) - set(retired[:t]))
                for t in range(Nr)]
    else:
        live = [list(range(t, Nr)) for t in range(Nr)]
    assert [sorted(by_step.get(t, [])) for t in range(Nr)] == live


@pytest.mark.parametrize("name", [c[0] for cases in CASES.values()
                                  for c in cases if c[2] != "zero_row"])
def test_lookahead_swapfree_and_layouts_bitmatch_inplace(name):
    p, (_, shape, kind, n, m, dt, variants) = _case(name)
    world = _world(p)
    base = next(world[(name, e, k, lay)] for e, k, lay in variants
                if e == "inplace")
    for e, k, lay in variants:
        if e == "grouped":
            continue
        ranks = world[(name, e, k, lay)]
        assert all(torch.equal(x["blocks"], y["blocks"])
                   for x, y in zip(ranks, base)), (e, lay)


def test_lookahead_refusals_are_typed_in_jax_words():
    a = _fixture("gauss", 130)
    mesh, jlay, W = _jax_storage(a, (2, 2), 2)
    lay = CyclicLayout2D.create(130, 2, 2, 2)
    with pytest.raises(JUsageError) as ej:
        jji.compile_sharded_jordan_inplace_2d(W, mesh, jlay, lookahead=True)
    with pytest.raises(UsageError) as et:
        tji.compile_sharded_jordan_inplace_2d(lay, lookahead=True)
    assert str(et.value) == str(ej.value)
    small = CyclicLayout2D.create(48, 8, 2, 2)
    mesh, jsmall, W = _jax_storage(_fixture("gauss", 48), (2, 2), 8)
    for kw in ({"swapfree": True}, {"group": 2}):
        with pytest.raises(JUsageError) as ej:
            jji.compile_sharded_jordan_inplace_2d(W, mesh, jsmall,
                                                  lookahead=True, **kw)
        with pytest.raises(UsageError) as et:
            tji.compile_sharded_jordan_inplace_2d(small, lookahead=True,
                                                  **kw)
        assert str(et.value) == str(ej.value)
    with pytest.raises(UsageError):
        tdriver.solve(130, 2, workers=(2, 2), engine="lookahead",
                      device="cpu")
    # The augmented engine on a mesh was refused here; it runs now
    # (tests/test_torch_sharded_augmented.py holds it against JAX).
    assert tdriver.solve(48, 8, workers=(2, 2), engine="augmented",
                         device="cpu").engine == "augmented"
    with pytest.raises(ValueError, match="probe_layout"):
        tji.resolve_probe_layout("rows", "gloo")
    assert tji.resolve_probe_layout("auto", "nccl")
    assert not tji.resolve_probe_layout("auto", "gloo")


def test_driver_solve_on_a_mesh_matches_jax():
    res = tdriver.solve(64, 8, workers=(2, 2), dtype="float64",
                        device="cpu")
    ref = jdriver.solve(64, 8, workers=(2, 2), dtype=jnp.float64)
    assert res.engine == "inplace" and res.device == "cpu 2x2 (gloo)"
    assert [r["mesh"] for r in res.ranks] == [[2, 2]] * 4
    assert [(r["kr"], r["kc"]) for r in res.ranks] == [(0, 0), (0, 1),
                                                       (1, 0), (1, 1)]
    bound = 16 * np.finfo(np.float64).eps * 64 * ref.kappa
    inv, jinv = res.inverse.numpy(), np.asarray(ref.inverse)
    assert (np.abs(inv - jinv).sum(1).max() / np.abs(jinv).sum(1).max()
            <= bound)
    assert abs(res.residual - ref.residual) <= bound
    assert res.kappa == pytest.approx(ref.kappa, rel=1e-9)


def _corner(lines):
    """The printed corner's values (a printed -0.00 equals 0.00)."""
    i = lines.index("inverse matrix:")
    return [[float(x) for x in ln.split()] for ln in lines[i + 1:]
            if ln.strip() and not ln.startswith(("residual", "kappa",
                                                 "engine", "plan"))]


def test_cli_mesh_and_its_corner_equal_jax(capsys):
    argv = ["64", "8", "--workers", "2x2"]
    assert jmain(argv) == 0                 # verbose unless --quiet
    jout = capsys.readouterr().out.splitlines()
    # --no-gather: the corner from the owning blocks alone.
    assert tmain(argv + ["-v", "--no-gather", "--device", "cpu"]) == 0
    tout = capsys.readouterr().out.splitlines()
    assert _corner(tout) == _corner(jout)
    assert any(ln.startswith("engine: inplace on cpu 2x2") for ln in tout)
