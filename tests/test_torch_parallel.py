"""The port's 1D row-block-cyclic engines over ``torch.distributed`` against
the JAX package's ``parallel/`` on its 8 virtual CPU devices.

One ``gloo`` world of CPU ranks per p ∈ {2, 3, 4} (a module-scoped fixture:
every case of one p runs in one spawn, ``parallel.run_calls``); p = 3 at
n = 50, m = 12 covers a ragged last block and block rows that do not divide
over the ranks (Nr = 5, padded to 6).  The same numpy fixtures go through
both packages: the JAX package's identity-padded cyclic block tensor
(``ring_gemm._to_identity_padded_blocks``), split into the ranks' shards
(``interop.split_cyclic_blocks``).

  * Each engine (inplace, lookahead, grouped k=2, swapfree) against
    ``sharded_jordan_invert_inplace`` on ``make_mesh(p)`` with the same
    option.  The pivot sequence is held exactly to the JAX plain engine's
    (its segment executable exposes the swap record): in fp64 on gaussian
    and absdiff fixtures, in fp32 (at p = 3) on a diagonally dominant one
    that fp32 carries (κ∞·eps32 ≪ 1; ROADMAP.md Queue C: fp32 pivots can part where
    two keys lie within eps·κ).  The inverse is held within 16·eps·n·κ∞
    (relative ∞-norm; 16 is the gate's constant, the sums' order differs).
  * A fixture with a zero row: ``singular`` on every rank, in both.
  * Nr = 65 > 64 at p = 2, the JAX fori engine's side.
  * Each rank probes exactly at the steps where it holds a live candidate.
  * ``sharded_generate``: each rank's strip equals the JAX package's, bit
    for bit.
  * The ring residual against the JAX ``distributed_residual`` on the same
    operands, within 16·eps·n·‖A‖∞‖X‖∞.
  * ``driver.solve(workers=p)`` against the JAX ``solve(workers=p)``:
    pivots, residual, κ∞; ``--workers 2`` and its exit codes in both CLIs.
  * A rank that raises fails the world within its deadline, naming it.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec

from tpu_jordan import driver as jdriver
from tpu_jordan.__main__ import main as jmain
from tpu_jordan.config import eps_for as jeps
from tpu_jordan.parallel import make_mesh
from tpu_jordan.parallel import generate as jgen
from tpu_jordan.parallel import layout as jl
from tpu_jordan.parallel import ring_gemm as jring
from tpu_jordan.parallel import sharded_inplace as jsi

from tpu_jordan_torch import driver as tdriver
from tpu_jordan_torch.__main__ import main as tmain
from tpu_jordan_torch.interop import join_cyclic_blocks, split_cyclic_blocks
from tpu_jordan_torch.parallel import (WorkerError, distributed_residual,
                                       generate_shard, invert_shards,
                                       residual_shards, ring_matmul,
                                       run_calls, run_workers)
from tpu_jordan_torch.parallel import layout as tl
from tpu_jordan_torch.parallel.sharded_inplace import gather_inverse_inplace

ENGINES = ("inplace", "lookahead", "grouped", "swapfree")
SIZES = {2: (48, 16), 3: (50, 12), 4: (64, 16)}


def _fixture(kind, n, dtype):
    rng = np.random.default_rng(7 * n + len(kind))
    if kind == "gauss":
        a = rng.standard_normal((n, n))
    elif kind == "absdiff":
        i = np.arange(n)
        a = np.abs(i[:, None] - i[None, :]).astype(float)
    elif kind == "dominant":
        a = rng.standard_normal((n, n)) + 2.0 * n * np.eye(n)
    elif kind == "zero_row":
        a = rng.standard_normal((n, n))
        a[n // 2] = 0.0
    return a.astype(dtype)


def _cases(p):
    n, m = SIZES[p]
    cases = [("gauss", "float64", e) for e in ENGINES]
    cases += [("absdiff", "float64", "inplace"),
              ("absdiff", "float64", "swapfree"),
              ("zero_row", "float64", "inplace"),
              ("zero_row", "float64", "swapfree")]
    if p == 3:
        cases += [("dominant", "float32", "inplace"),
                  ("dominant", "float32", "grouped")]
    out = [(kind, dt, eng, n, m) for kind, dt, eng in cases]
    if p == 2:
        out.append(("gauss", "float64", "inplace", 130, 2))   # Nr = 65
    return out


def _jax_blocks(a, m, p):
    mesh = make_mesh(p)
    lay = jl.CyclicLayout.create(a.shape[0], m, p)
    return mesh, lay, jring._to_identity_padded_blocks(jnp.asarray(a), lay,
                                                      mesh)


def _jax_pivots(blocks, mesh, lay):
    """The JAX plain engine's swap record, from its segment executable."""
    spec = NamedSharding(mesh, PartitionSpec("p"))
    sing = jax.device_put(jnp.zeros((lay.p,), bool), spec)
    sw = jax.device_put(jnp.zeros((lay.p, lay.Nr), jnp.int32),
                        NamedSharding(mesh, PartitionSpec("p", None)))
    _, s, sw = jsi._sharded_jordan_inplace_segment(
        blocks, sing, sw, mesh, lay, 0, lay.Nr, jeps(blocks.dtype),
        lax.Precision.HIGHEST, False, lay.Nr <= jsi.MAX_UNROLL_NR)
    return np.asarray(sw)[0].tolist(), bool(np.asarray(s).any())


_WORLDS = {}


def _world(p):
    """Every case of one p in one spawned world: the engines, then the
    generators, then the ring residuals."""
    if p in _WORLDS:
        return _WORLDS[p]
    calls, meta = [], []
    for kind, dt, eng, n, m in _cases(p):
        a = _fixture(kind, n, dt)
        mesh, lay, blocks = _jax_blocks(a, m, p)
        tlay = tl.CyclicLayout.create(n, m, p)
        calls.append((invert_shards,
                      (split_cyclic_blocks(np.asarray(blocks), p), tlay, eng,
                       2 if eng == "grouped" else 0)))
        meta.append(("engine", kind, dt, eng, n, m, a, mesh, lay, blocks))
    n, m = SIZES[p]
    tlay = tl.CyclicLayout.create(n, m, p)
    for g in ("absdiff", "rand", "hilbert"):
        calls.append((generate_shard, (g, tlay, "float64")))
        meta.append(("generate", g, n, m))
    a = _fixture("gauss", n, "float64")
    x = np.linalg.inv(a)
    mesh, lay, ab = _jax_blocks(a, m, p)
    _, _, xb = _jax_blocks(x, m, p)
    calls.append((distributed_residual, (a, x, tlay)))
    meta.append(("residual_whole", a, x, mesh, m))
    b = _fixture("dominant", n, "float64")
    calls.append((ring_matmul, (a, b, tlay)))
    meta.append(("ring_matmul", a, b, n, m))
    calls.append((residual_shards, (split_cyclic_blocks(np.asarray(ab), p),
                                    split_cyclic_blocks(np.asarray(xb), p),
                                    tlay)))
    meta.append(("residual", a, x, mesh, m))
    t0 = time.perf_counter()
    results = run_workers(p, run_calls, calls, deadline_s=300,
                          device_type="cpu")
    _WORLDS[p] = (meta, results, time.perf_counter() - t0)
    return _WORLDS[p]


def _engine_ids(p):
    return [f"{kind}-{dt}-{eng}-n{n}" for kind, dt, eng, n, m in _cases(p)]


PARAMS = [(p, i) for p in SIZES for i in range(len(_cases(p)))]
IDS = [f"p{p}-{_engine_ids(p)[i]}" for p, i in PARAMS]


@pytest.mark.parametrize("p,i", PARAMS, ids=IDS)
def test_engine_matches_jax(p, i):
    meta, results, _ = _world(p)
    _, kind, dt, eng, n, m, a, mesh, lay, blocks = meta[i]
    ranks = [results[r][i] for r in range(p)]
    tlay = tl.CyclicLayout.create(n, m, p)
    # One pivot sequence and one verdict on every rank.
    assert all(r["pivots"] == ranks[0]["pivots"] for r in ranks)
    assert len({r["singular"] for r in ranks}) == 1
    jinv, jsing = jsi.sharded_jordan_invert_inplace(
        jnp.asarray(a), mesh, m, group=2 if eng == "grouped" else 0,
        swapfree=eng == "swapfree", lookahead=eng == "lookahead")
    assert ranks[0]["singular"] is bool(jsing)
    if kind == "zero_row":
        assert ranks[0]["singular"]
        return
    jpiv, _ = _jax_pivots(blocks, mesh, lay)
    assert ranks[0]["pivots"] == jpiv
    # Each rank probed exactly where it held a live candidate.
    bpw = tlay.blocks_per_worker
    for k, r in enumerate(ranks):
        if eng == "swapfree":
            owned = [sum(1 for g in _physical(jpiv)[:t] if g % p == k)
                     for t in range(tlay.Nr)]
            want = [t for t in range(tlay.Nr) if owned[t] < bpw]
        else:
            want = [t for t in range(tlay.Nr) if (bpw - 1) * p + k >= t]
        assert r["probe_steps"] == want
    tinv = gather_inverse_inplace([r["blocks"] for r in ranks], tlay,
                                  n).numpy()
    jinv = np.asarray(jinv)
    eps = float(np.finfo(dt).eps)
    kappa = np.abs(a).sum(1).max() * np.abs(jinv).sum(1).max()
    diff = np.abs(tinv - jinv).sum(1).max() / np.abs(jinv).sum(1).max()
    assert diff <= 16 * eps * n * kappa


def _physical(swaps):
    """The physical rows the swap engines' pivot record moves into place,
    step by step: the swap-free engine retires exactly these rows."""
    rows = list(range(len(swaps)))
    out = []
    for t, s in enumerate(swaps):
        out.append(rows[s])
        rows[t], rows[s] = rows[s], rows[t]
    return out


@pytest.mark.parametrize("p", sorted(SIZES))
def test_sharded_generate_bits_match_jax(p):
    meta, results, _ = _world(p)
    for i, row in enumerate(meta):
        if row[0] != "generate":
            continue
        _, g, n, m = row
        lay = jl.CyclicLayout.create(n, m, p)
        ref = np.asarray(jgen.sharded_generate(g, lay, make_mesh(p),
                                               jnp.float64))
        got = join_cyclic_blocks([results[r][i] for r in range(p)])
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("p", sorted(SIZES))
def test_ring_residual_matches_jax(p):
    """From the ranks' shards and from whole operands, the same float on
    every rank, the JAX ``distributed_residual``'s within rounding."""
    meta, results, seconds = _world(p)
    _, a, x, mesh, m = meta[-1]
    ref = float(jring.distributed_residual(jnp.asarray(a), jnp.asarray(x),
                                           mesh, m))
    n = a.shape[0]
    scale = np.abs(a).sum(1).max() * np.abs(x).sum(1).max()
    for i in (-1, -3):
        got = {results[r][i] for r in range(p)}
        assert len(got) == 1
        assert abs(got.pop() - ref) <= (16 * np.finfo(np.float64).eps * n
                                        * scale)
    assert seconds < 120


@pytest.mark.parametrize("p", sorted(SIZES))
def test_ring_matmul_matches_jax(p):
    meta, results, _ = _world(p)
    _, a, b, n, m = meta[-2]
    lay = tl.CyclicLayout.create(n, m, p)
    got = gather_inverse_inplace([results[r][-2] for r in range(p)], lay,
                                 n).numpy()
    ref = np.asarray(jring.ring_matmul(jnp.asarray(a), jnp.asarray(b),
                                       make_mesh(p), m))
    eps = np.finfo(np.float64).eps
    np.testing.assert_allclose(got, ref, rtol=0, atol=16 * eps * n * (
        np.abs(a).max() * np.abs(b).max()))


@pytest.mark.parametrize("p,engine,gather", [(2, "auto", True),
                                             (3, "swapfree", False)])
def test_driver_solve_matches_jax(p, engine, gather):
    n, m = SIZES[p]
    t = tdriver.solve(n, m, generator="absdiff", dtype="float64", workers=p,
                      gather=gather, engine=engine, device="cpu")
    j = jdriver.solve(n, m, generator="absdiff", dtype=jnp.float64,
                      workers=p, gather=gather, engine=engine)
    assert t.engine == j.engine
    assert t.ranks[0]["backend"] == "gloo"
    lay = jl.CyclicLayout.create(n, m, p)
    blocks = jgen.sharded_generate("absdiff", lay, make_mesh(p),
                                   jnp.float64)
    jpiv, _ = _jax_pivots(blocks, make_mesh(p), lay)
    assert all(r["pivots"] == jpiv for r in t.ranks)
    eps = np.finfo(np.float64).eps
    assert abs(t.kappa - j.kappa) <= 16 * eps * n * j.kappa * j.kappa
    assert t.rel_residual <= 16 * eps * n * t.kappa
    assert j.rel_residual <= 16 * eps * n * j.kappa
    if gather:
        np.testing.assert_allclose(
            t.inverse.numpy(), np.asarray(j.inverse), rtol=0,
            atol=16 * eps * n * j.kappa * np.abs(j.inverse).max())
    else:
        assert t.inverse is None and len(t.inverse_blocks) == p
        assert t.layout.blocks_per_worker == lay.blocks_per_worker
        np.testing.assert_allclose(
            join_cyclic_blocks(t.inverse_blocks),
            np.asarray(j.inverse_blocks), rtol=0,
            atol=16 * eps * n * j.kappa * np.abs(j.inverse_blocks).max())


def test_cli_workers_2_in_both(capsys):
    argv = ["48", "8", "--workers", "2", "--dtype", "float64"]
    assert jmain(argv) == 0
    capsys.readouterr()
    assert tmain(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "engine: inplace on cpu x2 (gloo)" in out


@pytest.mark.parametrize("argv", [
    ["48", "8", "--workers", "2", "--engine", "grouped_pallas"],
    ["48", "8", "--workers", "2", "--no-gather", "--refine", "1"],
    ["48", "8", "--workers", "2", "--numerics", "trace"],
    ["48", "8", "--workers", "2", "--batch", "2"],
    ["48", "8", "--workers", "2", "--workload", "lstsq"],
    ["48", "8", "--engine", "swapfree"],
    ["48", "8", "--no-gather"],
    ["48", "8", "--workers", "2", "--engine", "swapfree", "--group", "2"],
])
def test_cli_distributed_flag_contract_exit_1(argv):
    assert jmain(argv) == 1
    assert tmain(argv + ["--device", "cpu"]) == 1


def test_a_raising_rank_fails_the_world_in_time():
    lay = tl.CyclicLayout.create(48, 8, 2)
    good = split_cyclic_blocks(
        np.asarray(_jax_blocks(_fixture("gauss", 48, "float64"), 8, 2)[2]),
        2)
    t0 = time.monotonic()
    with pytest.raises(WorkerError) as e:
        run_workers(2, run_calls,
                    [(invert_shards, ([good[0], None], lay, "inplace", 0))],
                    deadline_s=60, device_type="cpu")
    assert e.value.rank == 1 and "TypeError" in e.value.detail
    assert time.monotonic() - t0 < 60
    with pytest.raises(WorkerError, match="no report within"):
        run_workers(2, run_calls, [], deadline_s=0.01, device_type="cpu")


def test_backend_rule_is_written_not_probed():
    """nccl when every rank has its own card, gloo otherwise; gloo's
    point-to-point ops stage through the host on the card."""
    from tpu_jordan_torch.parallel import TRANSPORT, backend_rule

    assert backend_rule(4, "cuda", 4)[0] == "nccl"
    assert backend_rule(1, "cuda", 1)[0] == "nccl"
    assert backend_rule(4, "cuda", 1)[0] == "gloo"
    assert backend_rule(3, "cpu", 0)[0] == "gloo"
    assert TRANSPORT[("gloo", "cuda", "p2p")] == "host"
    assert TRANSPORT[("gloo", "cuda", "broadcast")] == "device"
    assert all(TRANSPORT[("nccl", "cuda", op)] == "device"
               for op in ("all_reduce", "broadcast", "p2p"))


def test_distributed_flag_without_a_world_exits_2(monkeypatch, capsys):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert tmain(["48", "8", "--workers", "2", "--distributed",
                  "--device", "cpu"]) == 2
    assert "torchrun" in capsys.readouterr().err


def test_distributed_fault_points_match_jax():
    """``compile`` fires under the policy's retry and ``execute``
    unretried, in both packages: the same per-point call counts."""
    from tpu_jordan import resilience as jres
    from tpu_jordan_torch import resilience as tres

    kw = dict(generator="absdiff", workers=2)
    jplan = jres.FaultPlan([jres.FaultSpec("compile", (1,), "transient")])
    tplan = tres.FaultPlan([tres.FaultSpec("compile", (1,), "transient")])
    with jres.activate(jplan):
        j = jdriver.solve(48, 16, dtype=jnp.float64,
                          policy=jres.ResiliencePolicy(), **kw)
    with tres.activate(tplan):
        t = tdriver.solve(48, 16, dtype="float64", device="cpu",
                          policy=tres.ResiliencePolicy(), **kw)
    assert tplan.calls() == jplan.calls()
    assert tplan.injections == jplan.injections
    assert abs(t.kappa - j.kappa) <= 1e-6 * j.kappa
    jplan = jres.FaultPlan([jres.FaultSpec("execute", (1,), "transient")])
    tplan = tres.FaultPlan([tres.FaultSpec("execute", (1,), "transient")])
    with jres.activate(jplan), pytest.raises(ConnectionError):
        jdriver.solve(48, 16, dtype=jnp.float64,
                      policy=jres.ResiliencePolicy(), **kw)
    with tres.activate(tplan), pytest.raises(ConnectionError):
        tdriver.solve(48, 16, dtype="float64", device="cpu",
                      policy=tres.ResiliencePolicy(), **kw)
    assert tplan.calls() == jplan.calls()


@pytest.mark.parametrize("n,m,p,want", [
    (1024, 128, 2, "inplace"), (2048, 128, 4, "lookahead"),
    (4096, 128, 4, "lookahead"), (8192, 384, 4, "lookahead"),
    (8192, 128, 2, "lookahead")])
def test_auto_picks_the_jax_rules_distributed_engine(n, m, p, want):
    """The cost-only pick at a distributed point equals the JAX rule's on
    the CPU, and the H100 model's agrees (below COST_MODEL_FLOOR_N the
    plain engine by the floor)."""
    from tpu_jordan.tuning import registry as jreg
    from tpu_jordan_torch.tuning import registry as treg

    jpt = jreg.TunePoint.create(n, m, "float32", p, True, backend="cpu")
    assert jreg.select_by_cost(jpt).name == want
    for kw in ({"device": "cpu"}, {"backend": "cuda", "chip": "h100"}):
        tpt = treg.TunePoint.create(n, m, "float32", p, True, **kw)
        assert treg.select_by_cost(tpt).name == want
        assert treg.candidates(tpt)[0].legal(tpt)


def test_cli_distributed_joins_an_outside_world():
    """Two CLI processes launched as torchrun would (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) join one gloo world with ``--distributed``:
    both exit 0 and only rank 0 prints."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpu_jordan_torch", "48", "8",
             "--workers", "2", "--distributed", "--dtype", "float64",
             "--device", "cpu"], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "engine: inplace on cpu x2 (gloo)" in outs[0][0]
    assert outs[1][0] == ""
