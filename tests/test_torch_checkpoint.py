"""The port's superstep checkpoint/resume against the JAX package's, on the
CPU: twins of ``tests/test_checkpoint.py``'s store, single-device and
refusal cases, and checkpoints that cross between the packages.

Bit-identity is checked within the port: a checkpointed run, and a
preempted run resumed, give the bytes of the port's monolithic engine of
the same flavor.  Against the JAX package: the pivot sequences (the stored
swap records, ``collect_stats``) are equal, and inverses and solutions
agree within min(100·eps·κ∞, 1e-3) (relative ∞-norm).  The store's ledger
invariant ``written == resumed + discarded + live`` is checked after every
test that uses a store.
"""

import os

import numpy as np
import pytest
import torch

import jax

from tpu_jordan.linalg.engine import block_jordan_solve_fori as j_solve_fori
from tpu_jordan.ops.jordan_inplace import (
    block_jordan_invert_inplace as j_inplace)
from tpu_jordan.resilience import FaultPlan as JPlan
from tpu_jordan.resilience import FaultSpec as JSpec
from tpu_jordan.resilience import activate as jactivate
from tpu_jordan.resilience import checkpoint as jckpt

from tpu_jordan_torch.linalg import block_jordan_solve
from tpu_jordan_torch.obs.metrics import REGISTRY
from tpu_jordan_torch.obs.recorder import RECORDER
from tpu_jordan_torch.ops import (block_jordan_invert_inplace,
                                  block_jordan_invert_inplace_grouped)
from tpu_jordan_torch.resilience import (
    CheckpointCorruptError, CheckpointKey, CheckpointMismatchError,
    CheckpointNotFoundError, CheckpointStore, CheckpointUnsupportedError,
    FaultPlan, FaultSpec, PreemptedError, activate, checkpointed_invert,
    checkpointed_solve, fingerprint)


def _mat(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + n * np.eye(n)).astype(dtype)


def _rhs(n, k=3, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(dtype)


def _key(run_id="t:key", **kw):
    base = dict(run_id=run_id, workload="invert", engine="fori",
                topology="single", n=32, m=8, Nr=4, dtype="float32",
                nrhs=0, cadence=2)
    base.update(kw)
    return CheckpointKey(**base)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"V": rng.standard_normal((4, 8, 8)).astype(np.float32),
            "swaps": np.arange(8, dtype=np.int32)}


def _preempt_plan(call):
    return FaultPlan([FaultSpec("preempt", (call,), "permanent")])


def _close(x, ref, a):
    a = np.asarray(a)
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    x, ref, aw = (np.asarray(v).astype(wide) for v in (x, ref, a))
    kappa = (np.linalg.norm(aw, np.inf)
             * np.linalg.norm(np.linalg.inv(aw), np.inf))
    tol = min(100 * np.finfo(a.dtype).eps * kappa, 1e-3)
    return (np.linalg.norm(x - ref, np.inf)
            <= tol * np.linalg.norm(ref, np.inf))


@pytest.fixture
def store(tmp_path):
    st = CheckpointStore(str(tmp_path))
    yield st
    assert st.ledger()["invariant_holds"], st.ledger()


def _inv(a, m):
    return block_jordan_invert_inplace(torch.from_numpy(a), m)


class TestStore:
    def test_write_peek_resume_roundtrip_bit_exact(self, store):
        key = _key()
        st = _state()
        assert store.write(key, 2, st) > 0
        assert store.has_live("t:key")
        step, arrays = store.resume(key)
        assert step == 2
        for name in st:
            assert arrays[name].dtype == st[name].dtype
            np.testing.assert_array_equal(arrays[name], st[name])
        led = store.ledger()
        assert led["written"] == 1 and led["resumed"] == 1
        assert not store.has_live("t:key")
        with pytest.raises(CheckpointNotFoundError):
            store.resume(key)

    def test_supersede_discards_previous_token(self, store):
        key = _key()
        store.write(key, 1, _state(1))
        store.write(key, 2, _state(2))
        led = store.ledger()
        assert led["written"] == 2 and led["discarded"] == 1
        assert led["live"] == 1
        step, arrays = store.resume(key)
        assert step == 2
        np.testing.assert_array_equal(arrays["V"], _state(2)["V"])

    def test_corrupt_entry_quarantined_typed_and_counted(self, store,
                                                         tmp_path):
        key = _key()
        store.write(key, 2, _state())
        path = [p for p in os.listdir(tmp_path) if p.endswith(".ckpt")]
        assert len(path) == 1
        full = tmp_path / path[0]
        raw = bytearray(full.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        full.write_bytes(bytes(raw))
        name = "tpu_jordan_torch_ckpt_corrupt_total"
        before = REGISTRY.counter(name).total()
        with pytest.raises(CheckpointCorruptError, match="checksum"):
            store.resume(key)
        assert REGISTRY.counter(name).total() == before + 1
        assert any(p.endswith(".corrupt") for p in os.listdir(tmp_path))
        assert store.ledger()["corrupt"] == 1
        assert not store.has_live("t:key")

    @pytest.mark.parametrize("damage,match", [
        (lambda raw: b"NOTCKPT\n" + raw[8:], "bad magic"),
        (lambda raw: raw[:-5], "truncated")])
    def test_damaged_file_refused_by_kind(self, store, tmp_path, damage,
                                          match):
        key = _key()
        store.write(key, 2, _state())
        full = tmp_path / "t_key.ckpt"
        full.write_bytes(damage(full.read_bytes()))
        with pytest.raises(CheckpointCorruptError, match=match):
            store.resume(key)

    def test_mismatched_key_typed_refusal_names_fields(self, store):
        store.write(_key(), 2, _state())
        with pytest.raises(CheckpointMismatchError,
                           match="dtype.*silent corruption"):
            store.resume(_key(dtype="float64"))
        # cadence is the one field a later leg may change.
        store.write(_key(), 2, _state())
        step, _ = store.resume(_key(cadence=4))
        assert step == 2
        store.discard("t:key")

    def test_ledger_persists_across_reopen(self, store, tmp_path):
        key = _key()
        store.write(key, 1, _state())
        store.resume(key)
        led0 = store.ledger()
        led1 = CheckpointStore(str(tmp_path)).ledger()
        for k in ("written", "resumed", "discarded", "corrupt", "live"):
            assert led1[k] == led0[k], k
        assert led1["invariant_holds"]

    def test_resume_unknown_run_typed(self, store):
        with pytest.raises(CheckpointNotFoundError, match="never silently"):
            store.resume(_key(run_id="t:nobody"))

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_file_format_read_by_the_other_package(self, tmp_path, writer):
        """The same magic, header and npz payload: each package's file is
        read by the other's store, key and arrays unchanged."""
        key = _key()
        jkey = jckpt.CheckpointKey(**key.to_json())
        if writer == "port":
            CheckpointStore(str(tmp_path)).write(key, 2, _state())
            got_key, step, arrays = jckpt.CheckpointStore(
                str(tmp_path)).peek("t:key")
            assert got_key == jkey
        else:
            jckpt.CheckpointStore(str(tmp_path)).write(jkey, 2, _state())
            got_key, step, arrays = CheckpointStore(
                str(tmp_path)).peek("t:key")
            assert got_key == key
        assert step == 2
        for name, want in _state().items():
            assert arrays[name].dtype == want.dtype
            np.testing.assert_array_equal(arrays[name], want)


class TestSingleDevice:
    @pytest.mark.parametrize("engine", ["fori", "unrolled"])
    def test_invert_bitmatches_monolithic_and_warm_resume_free(
            self, store, engine):
        a = _mat(64, seed=3)
        ref, sing = _inv(a, 16)
        assert not bool(sing)
        inv, sing2, info = checkpointed_invert(
            a, 16, store=store, run_id=f"t:s64{engine}", cadence=2,
            engine=engine, device="cpu")
        assert not sing2
        assert fingerprint(inv) == fingerprint(ref)
        assert info["ckpt_written"] == 1
        run = f"t:s64p{engine}"
        with activate(_preempt_plan(2)):
            with pytest.raises(PreemptedError) as ei:
                checkpointed_invert(a, 16, store=store, run_id=run,
                                    cadence=2, engine=engine, device="cpu")
        assert ei.value.step == 2
        assert store.has_live(run)
        # The durable swap record is the JAX engine's pivot sequence.
        _, _, stored = store.peek(run)
        _, _, jstats = j_inplace(a, 16, collect_stats=True)
        np.testing.assert_array_equal(
            stored["swaps"][:2], np.asarray(jstats["pivot_block"])[:2])
        mark = RECORDER.total
        inv2, _, info2 = checkpointed_invert(
            a, 16, store=store, run_id=run, cadence=2, engine=engine,
            resume_from=run, device="cpu")
        assert fingerprint(inv2) == fingerprint(ref)
        assert info2["resumed"] and info2["start_step"] == 2
        assert info2["segments_run"] == [(2, 4)]
        assert info2["segment_compiles"] == 0
        evs = [e["kind"] for e in RECORDER.since(mark)
               if str(e.get("kind", "")).startswith("ckpt_")]
        assert evs == ["ckpt_resumed"]
        jref, _ = jax.jit(lambda x: j_inplace(x, 16))(a)
        assert _close(inv2.numpy(), jref, a)

    def test_solve_bitmatches_monolithic(self, store):
        a, b = _mat(48, seed=5), _rhs(48, k=2, seed=6)
        ref, sing = block_jordan_solve(torch.from_numpy(a),
                                       torch.from_numpy(b), 8)
        assert not bool(sing)
        x, sing2, info = checkpointed_solve(
            a, b, 8, store=store, run_id="t:sv", cadence=2, engine="fori",
            device="cpu")
        assert not sing2
        assert fingerprint(x) == fingerprint(ref)
        assert info["Nr"] == 6 and info["ckpt_written"] == 2
        jx, _ = jax.jit(lambda aa, bb: j_solve_fori(aa, bb, 8))(a, b)
        assert _close(x.numpy(), jx, a)

    def test_complex_solve_checkpoints_as_jax_does(self, store, tmp_path):
        """A complex64 solve checkpoints and resumes in both packages
        (JAX's complex invert does not; see TestRefusals)."""
        rng = np.random.default_rng(7)
        a = (_mat(32, seed=7) + 1j * rng.standard_normal((32, 32))
             ).astype(np.complex64)
        b = (rng.standard_normal((32, 2))
             + 1j * rng.standard_normal((32, 2))).astype(np.complex64)
        ref, _ = block_jordan_solve(torch.from_numpy(a), torch.from_numpy(b),
                                    8)
        with activate(_preempt_plan(2)):
            with pytest.raises(PreemptedError):
                checkpointed_solve(a, b, 8, store=store, run_id="t:cx",
                                   cadence=2, device="cpu")
        x, _, info = checkpointed_solve(a, b, 8, store=store, run_id="t:cx",
                                        cadence=2, resume_from="t:cx",
                                        device="cpu")
        assert fingerprint(x) == fingerprint(ref)
        assert info["start_step"] == 2
        jx, jsing, _ = jckpt.checkpointed_solve(
            a, b, 8, store=jckpt.CheckpointStore(str(tmp_path / "j")),
            run_id="t:cx", cadence=2, engine="fori")
        assert not jsing
        assert _close(x.numpy(), jx, a)

    def test_cadence_over_nr_writes_nothing_resume_typed(self, store):
        a = _mat(32, seed=7)
        _, _, info = checkpointed_invert(
            a, 8, store=store, run_id="t:wide", cadence=99, engine="fori",
            device="cpu")
        assert info["ckpt_written"] == 0
        assert info["segments_run"] == [(0, 4)]
        assert store.ledger()["written"] == 0
        with pytest.raises(CheckpointNotFoundError):
            checkpointed_invert(a, 8, store=store, run_id="t:wide",
                                cadence=99, engine="fori",
                                resume_from="t:wide", device="cpu")

    def test_cadence_one_and_ragged_tail_bitmatch(self, store):
        """Cadence 1 on a ragged n (70 = 4·16 + 6) still bit-matches, and
        preempt/resume crosses the ragged boundary."""
        a = _mat(70, seed=9)
        ref, sing = _inv(a, 16)
        assert not bool(sing)
        inv, _, info = checkpointed_invert(
            a, 16, store=store, run_id="t:rag", cadence=1, engine="fori",
            device="cpu")
        assert fingerprint(inv) == fingerprint(ref)
        assert info["Nr"] == 5 and info["ckpt_written"] == 4
        with activate(_preempt_plan(5)):
            with pytest.raises(PreemptedError) as ei:
                checkpointed_invert(a, 16, store=store, run_id="t:ragp",
                                    cadence=1, engine="fori", device="cpu")
        assert ei.value.step == 4
        inv2, _, info2 = checkpointed_invert(
            a, 16, store=store, run_id="t:ragp", cadence=1, engine="fori",
            resume_from="t:ragp", device="cpu")
        assert fingerprint(inv2) == fingerprint(ref)
        assert info2["segments_run"] == [(4, 5)]

    def test_grouped_cadence_snaps_to_group_boundary(self, store):
        a = _mat(64, seed=11)
        ref, sing = block_jordan_invert_inplace_grouped(
            torch.from_numpy(a), 8, group=4)
        assert not bool(sing)
        inv, _, info = checkpointed_invert(
            a, 8, store=store, run_id="t:grp", cadence=2, engine="grouped",
            group=4, device="cpu")
        assert fingerprint(inv) == fingerprint(ref)
        assert info["cadence"] == 4
        assert info["ckpt_written"] == 1
        with activate(_preempt_plan(2)):
            with pytest.raises(PreemptedError) as ei:
                checkpointed_invert(a, 8, store=store, run_id="t:grpp",
                                    cadence=2, engine="grouped", group=4,
                                    device="cpu")
        assert ei.value.step == 4
        inv2, _, info2 = checkpointed_invert(
            a, 8, store=store, run_id="t:grpp", cadence=2, engine="grouped",
            group=4, resume_from="t:grpp", device="cpu")
        assert fingerprint(inv2) == fingerprint(ref)
        assert info2["start_step"] == 4

    def test_preempt_before_first_boundary_carries_step_none(self, store):
        with activate(_preempt_plan(1)):
            with pytest.raises(PreemptedError) as ei:
                checkpointed_invert(_mat(32), 8, store=store,
                                    run_id="t:early", cadence=2,
                                    engine="fori", device="cpu")
        assert ei.value.step is None
        assert not store.has_live("t:early")

    def test_abort_hook_checked_at_boundaries(self, store):
        """``abort()`` returning an exception stops the run at the next
        boundary, after the last write is durable."""
        seen = []

        def abort():
            seen.append(1)
            return RuntimeError("replica gone") if len(seen) == 3 else None

        with pytest.raises(RuntimeError, match="replica gone"):
            checkpointed_invert(_mat(32), 8, store=store, run_id="t:ab",
                                cadence=1, engine="fori", abort=abort,
                                device="cpu")
        step, _ = store.resume(_key(run_id="t:ab", engine="fori"))
        assert step == 2


class TestRefusals:
    def test_resume_key_must_name_this_run(self, store):
        with pytest.raises(CheckpointMismatchError,
                           match="exactly its own run"):
            checkpointed_invert(_mat(32), 8, store=store, run_id="t:a",
                                cadence=2, engine="fori", resume_from="t:b",
                                device="cpu")

    def test_mismatched_layout_refused_on_resume(self, store):
        a = _mat(64, seed=13)
        with activate(_preempt_plan(2)):
            with pytest.raises(PreemptedError):
                checkpointed_invert(a, 16, store=store, run_id="t:mm",
                                    cadence=2, engine="fori", device="cpu")
        with pytest.raises(CheckpointMismatchError,
                           match="does not describe"):
            checkpointed_invert(a, 8, store=store, run_id="t:mm",
                                cadence=2, engine="fori", resume_from="t:mm",
                                device="cpu")
        store.discard("t:mm")

    @pytest.mark.parametrize("step,arrays,match", [
        (3, None, "group-4 boundary grid"),
        (4, {"V": np.zeros((8, 8), np.float32)}, "lacks state arrays"),
        (4, {"V": np.zeros((64, 64), np.float64),
             "singular": np.asarray(False),
             "swaps": np.zeros(8, np.int32)}, "'V' is float64")])
    def test_stored_step_and_arrays_checked(self, store, step, arrays,
                                            match):
        key = _key(run_id="t:st", engine="grouped", n=64, m=8, Nr=8)
        if arrays is None:
            arrays = {"V": np.zeros((64, 64), np.float32),
                      "singular": np.asarray(False),
                      "swaps": np.zeros(8, np.int32)}
        store.write(key, step, arrays)
        with pytest.raises(CheckpointMismatchError, match=match):
            checkpointed_invert(_mat(64), 8, store=store, run_id="t:st",
                                cadence=4, engine="grouped", group=4,
                                resume_from="t:st", device="cpu")

    def test_spd_fast_path_unsupported(self, store):
        with pytest.raises(CheckpointUnsupportedError, match="SPD fast path"):
            checkpointed_solve(_mat(32), _rhs(32), 8, store=store,
                               run_id="t:spd", cadence=2, engine="fori",
                               spd=True, device="cpu")

    @pytest.mark.parametrize("engine", ["lookahead", "grouped_pallas",
                                        "grouped_pallas_bf16", "augmented"])
    def test_pipeline_engines_unsupported(self, store, engine):
        with pytest.raises(CheckpointUnsupportedError,
                           match="not checkpointable"):
            checkpointed_invert(_mat(32), 8, store=store, run_id="t:look",
                                cadence=2, engine=engine, device="cpu")

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_sub_fp32_storage_unsupported(self, store, dtype):
        a = torch.from_numpy(_mat(32)).to(dtype)
        with pytest.raises(CheckpointUnsupportedError, match="sub-fp32"):
            checkpointed_invert(a, 8, store=store, run_id="t:bf",
                                cadence=2, engine="fori", device="cpu")

    # {"mesh": object()} and {"workers": 2} were item 15b's refusals, then
    # the 2D mesh's (item 15c).  Both runners are ported, so the ids hold
    # the JAX refusals that remain on a mesh: the pipeline engines, typed
    # before any world starts.
    @pytest.mark.parametrize("kw", [{"mesh": (2, 2), "engine": "grouped"},
                                    {"workers": (2, 4),
                                     "engine": "swapfree"}])
    def test_distributed_unsupported_names_item_15(self, store, kw):
        with pytest.raises(CheckpointUnsupportedError,
                           match="not checkpointable on distributed"):
            checkpointed_invert(_mat(32), 8, store=store, run_id="t:d",
                                cadence=2, device="cpu", **kw)

    def test_complex_invert_unsupported_where_jax_fails_untyped(
            self, store, tmp_path):
        """The port's in-place engines are real-dtype, so a complex
        checkpointed invert is a typed refusal; the JAX package's fails
        untyped in its pivot comparison (ROADMAP.md Queue C)."""
        a = (_mat(32) + 1j * _mat(32, seed=1)).astype(np.complex64)
        with pytest.raises(CheckpointUnsupportedError, match="complex"):
            checkpointed_invert(a, 8, store=store, run_id="t:ci",
                                cadence=2, engine="fori", device="cpu")
        with pytest.raises(TypeError):
            jckpt.checkpointed_invert(
                a, 8, store=jckpt.CheckpointStore(str(tmp_path / "j")),
                run_id="t:ci", cadence=2, engine="fori")

    def test_cadence_below_one_refused(self, store):
        with pytest.raises(ValueError, match="cadence must be >= 1"):
            checkpointed_invert(_mat(32), 8, store=store, run_id="t:c0",
                                cadence=0, engine="fori", device="cpu")


class TestCrossPackage:
    """A (64, 16) fp64 run preempted in one package and resumed in the
    other: the result matches the writer's uninterrupted inverse, with the
    pivot sequence (the swap records each package stores) equal."""

    def _jax_reference(self, a):
        ref, sing, stats = jax.jit(
            lambda x: j_inplace(x, 16, collect_stats=True))(a)
        assert not bool(sing)
        return np.asarray(ref), np.asarray(stats["pivot_block"])

    def test_port_resumes_jax_checkpoint(self, tmp_path):
        a = _mat(64, seed=21, dtype=np.float64)
        ref, pivots = self._jax_reference(a)
        jstore = jckpt.CheckpointStore(str(tmp_path))
        with jactivate(JPlan([JSpec("preempt", (3,), "permanent")])):
            with pytest.raises(jckpt.PreemptedError) as ei:
                jckpt.checkpointed_invert(a, 16, store=jstore, run_id="x",
                                          cadence=1, engine="fori")
        assert ei.value.step == 2
        store = CheckpointStore(str(tmp_path))
        assert store.has_live("x")
        # Resume in the port, preempted once more after one segment: its
        # own checkpoint holds the swap record through step 3.
        with activate(_preempt_plan(2)):
            with pytest.raises(PreemptedError) as ei:
                checkpointed_invert(a, 16, store=store, run_id="x",
                                    cadence=1, engine="fori",
                                    resume_from="x", device="cpu")
        assert ei.value.step == 3
        _, step, stored = jckpt.CheckpointStore(str(tmp_path)).peek("x")
        assert step == 3
        np.testing.assert_array_equal(stored["swaps"][:3], pivots[:3])
        inv, sing, info = checkpointed_invert(
            a, 16, store=store, run_id="x", cadence=1, engine="fori",
            resume_from="x", device="cpu")
        assert not sing and info["segments_run"] == [(3, 4)]
        assert _close(inv.numpy(), ref, a)
        assert store.ledger()["invariant_holds"]

    def test_jax_resumes_port_checkpoint(self, tmp_path):
        a = _mat(64, seed=22, dtype=np.float64)
        ref, _ = _inv(a, 16)
        _, _, stats = block_jordan_invert_inplace(torch.from_numpy(a), 16,
                                                  collect_stats=True)
        store = CheckpointStore(str(tmp_path))
        with activate(_preempt_plan(3)):
            with pytest.raises(PreemptedError) as ei:
                checkpointed_invert(a, 16, store=store, run_id="y",
                                    cadence=1, engine="unrolled",
                                    device="cpu")
        assert ei.value.step == 2
        jstore = jckpt.CheckpointStore(str(tmp_path))
        _, _, stored = jstore.peek("y")
        np.testing.assert_array_equal(stored["swaps"][:2],
                                      stats["pivot_block"].numpy()[:2])
        inv, sing, info = jckpt.checkpointed_invert(
            a, 16, store=jstore, run_id="y", cadence=1, engine="unrolled",
            resume_from="y")
        assert not sing and info["start_step"] == 2
        assert _close(inv, ref.numpy(), a)
        _, _, jstats = j_inplace(a, 16, collect_stats=True)
        np.testing.assert_array_equal(np.asarray(jstats["pivot_block"]),
                                      stats["pivot_block"].numpy())
        assert jstore.ledger()["invariant_holds"]
