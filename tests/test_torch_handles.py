"""The port's resident-handle store and capacity budget, on the CPU.

``tpu_jordan_torch.serve.handles`` is held to the JAX package's
``serve/handles.py`` case for case (``tests/test_capacity.py``'s budgeted
store, ``tests/test_update.py``'s store and races): the byte unit equals the
JAX one for every dtype both packages have; LRU order with pins exempt; a
failed transaction does not refresh the LRU stamp; concurrent creates of
distinct ids never overshoot the budget; a same-id re-create is credited
with the bytes it replaces; an all-pinned admission is refused typed;
eviction events carry their cause; an eviction (the caller's or the
budget's) waits out a transaction in flight; a seeded race of updates
against evictions neither deadlocks nor orphans a commit; a transaction on
a replaced handle lands on its successor.  The states hold torch tensors
(the service's device; here the CPU), as the port keeps them.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tpu_jordan.serve import handles as jhandles

from tpu_jordan_torch.errors import UsageError
from tpu_jordan_torch.obs import capacity as cap
from tpu_jordan_torch.obs.capacity import CapacityBudget, lru_policy
from tpu_jordan_torch.obs.recorder import RECORDER
from tpu_jordan_torch.resilience import CapacityExceededError
from tpu_jordan_torch.serve import (HandleRef, HandleState, HandleStore,
                                    UnknownHandleError, build_handle_store,
                                    create_resident_handle,
                                    resident_handle_bytes)

PER = resident_handle_bytes(64, torch.float32)


def _state(hid, bucket=64, n=4, scale=1.0):
    eye = torch.eye(n, dtype=torch.float32)
    return HandleState(handle_id=hid, n=n, bucket_n=bucket,
                       dtype="float32", a=scale * eye, inverse=eye / scale)


def _ticking_clock():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


def _commit_noop(store, hid):
    """One COMMITTED serve of a handle (only a commit refreshes its LRU
    stamp)."""
    with store.txn(hid) as st:
        store.commit(st, a=st.a, inverse=st.inverse, kappa=1.0,
                     rel_residual=0.0, drift=0.0)


@pytest.mark.parametrize("bucket", [64, 128, 2048])
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "bfloat16", "float16"])
def test_resident_handle_bytes_equal_jax(bucket, dtype):
    import jax.numpy as jnp

    want = jhandles.resident_handle_bytes(bucket, jnp.dtype(dtype))
    assert resident_handle_bytes(bucket, dtype) == want
    assert resident_handle_bytes(bucket, getattr(torch, dtype)) == want
    assert resident_handle_bytes(64, torch.float32) == 2 * 64 * 64 * 4


def test_unknown_handle_typed_and_evict_of_nothing():
    store = HandleStore()
    with pytest.raises(UnknownHandleError):
        store.get("nope")
    with pytest.raises(UnknownHandleError):
        with store.txn("nope"):
            pass
    assert not store.evict("nope")
    assert issubclass(UnknownHandleError, KeyError)


def test_commit_replaces_tensors_and_counts():
    store = HandleStore()
    ref = store.create(_state("x"))
    assert ref == HandleRef("x", 4, 64, "float32") and len(store) == 1
    old = store.get("x").inverse
    new_inv = 0.5 * torch.eye(4)
    with store.txn("x") as live:
        v = store.commit(live, a=2 * torch.eye(4), inverse=new_inv,
                         kappa=1.0, rel_residual=1e-6, drift=1e-6,
                         reinverted=True)
    got = store.get("x")
    assert v == 1 and got.version == 1 and got.updates_applied == 1
    assert got.reinverts == 1 and got.inverse is new_inv
    assert torch.equal(old, torch.eye(4))      # never edited in place
    snap = store.snapshot()["x"]
    assert snap["version"] == 1 and snap["nbytes"] == PER
    assert not any(isinstance(x, torch.Tensor) for x in snap.values())
    assert store.evict("x") and len(store) == 0


def test_lru_eviction_order_and_pin_exemption():
    store = HandleStore(budget=CapacityBudget(max_bytes=2 * PER),
                        clock=_ticking_clock())
    store.create(_state("h1"))
    store.create(_state("h2"))
    _commit_noop(store, "h1")          # h2 becomes the LRU
    store.create(_state("h3"))         # evicts h2
    assert store.ids() == ["h1", "h3"]
    snap = store.budget_snapshot()
    assert snap["budget_evictions"] == 1 and snap["live_bytes"] == 2 * PER
    _commit_noop(store, "h3")          # h1 is now the LRU ...
    store.pin("h1")                    # ... but pinned
    store.create(_state("h4"))
    assert store.ids() == ["h1", "h4"]
    assert store.budget_snapshot()["pinned"] == ["h1"]


def test_lru_policy_orders_by_last_served():
    class S:
        def __init__(self, hid, t):
            self.handle_id, self.last_served = hid, t

    got = lru_policy([S("a", 3.0), S("b", 1.0), S("c", 2.0)])
    assert [s.handle_id for s in got] == ["b", "c", "a"]
    budget = CapacityBudget(max_bytes=10)
    assert [s.handle_id for s in budget.victims([S("a", 2), S("b", 1)])] \
        == ["b", "a"]
    with pytest.raises(ValueError):
        CapacityBudget(max_bytes=0)


def test_failed_txn_does_not_refresh_lru():
    store = HandleStore(budget=CapacityBudget(max_bytes=2 * PER),
                        clock=_ticking_clock())
    store.create(_state("sick"))
    store.create(_state("healthy"))
    _commit_noop(store, "healthy")
    with pytest.raises(RuntimeError):
        with store.txn("sick"):
            raise RuntimeError("gate exhausted, nothing committed")
    assert store.get("sick").version == 0
    store.create(_state("h3"))         # evicts the SICK handle
    assert store.ids() == ["h3", "healthy"]


def test_concurrent_distinct_creates_never_overshoot_budget():
    store = HandleStore(budget=CapacityBudget(max_bytes=2 * PER))
    store.create(_state("seed"))
    peak, refused = [], []

    def creator(i):
        try:
            store.create(_state(f"d{i}"))
        except CapacityExceededError:
            refused.append(i)
        with store._lock:
            peak.append(store._live_bytes)

    threads = [threading.Thread(target=creator, args=(i,))
               for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads)
    assert max(peak) <= 2 * PER
    assert store.budget_snapshot()["live_bytes"] <= 2 * PER
    assert len(store) == 2


def test_same_id_recreate_credits_replaced_bytes():
    store = HandleStore(budget=CapacityBudget(max_bytes=2 * PER))
    store.create(_state("h1"))
    store.create(_state("h2"))
    store.create(_state("h1", scale=2.0))      # net-zero replacement
    assert store.ids() == ["h1", "h2"]
    snap = store.budget_snapshot()
    assert snap["budget_evictions"] == 0 and snap["refusals"] == 0
    assert snap["live_bytes"] == 2 * PER
    tight = HandleStore(budget=CapacityBudget(max_bytes=PER))
    tight.create(_state("x"))
    tight.create(_state("x"))
    assert tight.ids() == ["x"]
    assert tight.budget_snapshot()["refusals"] == 0


def test_all_pinned_admission_typed_refusal():
    mark = RECORDER.total
    store = HandleStore(budget=CapacityBudget(max_bytes=2 * PER))
    store.create(_state("h1"))
    store.create(_state("h2"))
    store.pin("h1")
    store.pin("h2")
    with pytest.raises(CapacityExceededError):
        store.create(_state("h3"))
    assert issubclass(CapacityExceededError, MemoryError)
    assert store.ids() == ["h1", "h2"]         # nothing installed
    assert store.budget_snapshot()["refusals"] == 1
    refused = [e for e in RECORDER.since(mark)
               if e["kind"] == "capacity_refused"]
    assert len(refused) == 1 and refused[0]["pinned"] == 2
    store.unpin("h2")
    store.create(_state("h3"))                 # now h2 is evictable
    assert store.ids() == ["h1", "h3"]


def test_eviction_events_recorded_with_cause():
    store = HandleStore(budget=CapacityBudget(max_bytes=PER))
    mark = RECORDER.total
    store.create(_state("h1"))
    store.create(_state("h2"))                 # budget-evicts h1
    store.evict("h2")                          # caller lifecycle
    evs = [e for e in RECORDER.since(mark)
           if e["kind"] == "capacity_eviction"]
    assert [(e["handle_id"], e["cause"]) for e in evs] == [
        ("h1", "budget"), ("h2", "caller")]
    assert evs[0]["budget_bytes"] == PER and evs[0]["nbytes"] == PER


def test_ledger_reconciles_across_create_replace_evict():
    before = cap.snapshot()["components"].get("handles", {})
    store = HandleStore()
    store.create(_state("a"))
    store.create(_state("a"))                  # replaced: old evicted
    store.create(_state("b"))
    store.evict("a")
    doc = cap.snapshot()["components"]["handles"]
    assert doc["bytes_created"] == doc["bytes_live"] + doc["bytes_evicted"]
    assert (doc["bytes_created"] - before.get("bytes_created", 0)
            == 3 * PER)
    assert (doc["bytes_evicted"] - before.get("bytes_evicted", 0)
            == 2 * PER)
    store.evict("b")


@pytest.mark.parametrize("budgeted", [False, True])
def test_evict_waits_out_in_flight_txn(budgeted):
    """An eviction, the caller's or the budget's, waits for the
    transaction in flight: the commit lands first, then the removal."""
    store = HandleStore(budget=(CapacityBudget(max_bytes=PER)
                                if budgeted else None))
    store.create(_state("x"))
    entered, release = threading.Event(), threading.Event()
    versions, admitted = [], []

    def updater():
        with store.txn("x") as live:
            entered.set()
            release.wait(10)
            store.commit(live, a=torch.eye(4), inverse=torch.eye(4),
                         kappa=1.0, rel_residual=0.0, drift=0.0)
            versions.append(live.version)

    t = threading.Thread(target=updater)
    t.start()
    assert entered.wait(10)
    if budgeted:
        evictor = threading.Thread(
            target=lambda: admitted.extend(store.ensure_capacity(PER)))
    else:
        evictor = threading.Thread(target=lambda: store.evict("x"))
    evictor.start()
    time.sleep(0.05)
    assert evictor.is_alive()        # blocked on the txn, not racing it
    release.set()
    t.join(10)
    evictor.join(10)
    assert versions == [1]
    assert admitted == (["x"] if budgeted else [])
    with pytest.raises(UnknownHandleError):
        store.get("x")


def test_seeded_concurrent_updates_vs_budget_evictions():
    rng = np.random.default_rng(7)
    store = HandleStore(budget=CapacityBudget(max_bytes=2 * PER))
    store.create(_state("a"))
    store.create(_state("b"))
    outcomes = {"committed": 0, "typed": 0}
    lock = threading.Lock()
    order = rng.permutation(24)

    def worker(i):
        hid = "a" if order[i] % 2 else "b"
        try:
            with store.txn(hid) as st:
                store.commit(st, a=st.a, inverse=st.inverse, kappa=1.0,
                             rel_residual=0.0, drift=0.0)
            with lock:
                outcomes["committed"] += 1
        except UnknownHandleError:
            with lock:
                outcomes["typed"] += 1

    def evictor(i):
        try:
            store.ensure_capacity(PER)
            store.create(_state("a" if order[i] % 2 else "b"))
        except CapacityExceededError:
            pass

    threads = ([threading.Thread(target=worker, args=(i,))
                for i in range(16)]
               + [threading.Thread(target=evictor, args=(i,))
                  for i in range(8)])
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads)
    assert outcomes["committed"] + outcomes["typed"] == 16
    assert store.budget_snapshot()["live_bytes"] <= 2 * PER


def test_txn_on_replaced_handle_lands_on_successor():
    store = HandleStore()
    store.create(_state("x"))
    fresh = _state("x", scale=2.0)
    store.create(fresh)
    with store.txn("x") as live:
        assert live is fresh and live.version == 0


def test_build_handle_store_wiring():
    shared = HandleStore()
    assert build_handle_store(shared, None, "svc") is shared
    own = build_handle_store(None, 4 * PER, "svc")
    assert own.budget.max_bytes == 4 * PER
    assert build_handle_store(None, None, "svc").budget is None
    with pytest.raises(UsageError, match="shared store"):
        build_handle_store(shared, 1024, "svc")


def test_create_resident_handle_pads_with_identity():
    from tpu_jordan_torch.serve.batcher import InvertResult

    n, bucket = 5, 64
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n))
    inv = torch.from_numpy(np.linalg.inv(a))
    res = InvertResult(inverse=inv, n=n, bucket_n=bucket, singular=False,
                       kappa=3.0, rel_residual=1e-15, queue_seconds=0.0,
                       execute_seconds=0.0, batch_occupancy=1)
    store = HandleStore()
    ref = create_resident_handle(store, torch.float64, a, res, "p")
    assert ref.result is res and ref.dtype == "float64"
    st = store.get("p")
    want_a = np.eye(bucket)
    want_a[:n, :n] = a
    want_inv = np.eye(bucket)
    want_inv[:n, :n] = np.linalg.inv(a)
    assert st.a.dtype == torch.float64 and st.a.device == inv.device
    np.testing.assert_array_equal(st.a.numpy(), want_a)
    np.testing.assert_array_equal(st.inverse.numpy(), want_inv)
    assert st.nbytes == resident_handle_bytes(bucket, torch.float64)
