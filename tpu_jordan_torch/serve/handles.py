"""Resident-inverse handles: the store of live (A, A⁻¹) pairs the update
lanes mutate.  Counterpart of the JAX package's ``serve/handles.py``.

A :class:`HandleState` is one resident pair: the identity-padded MUTATED
matrix, its padded inverse, the committed version and the accumulated drift
the update gate judges (``linalg/update.py``).  The pair lives on the
service's device as two tensors: a create pads on the device, an update
copies only its U and V there (2·n·k elements), and a commit replaces the
tensors wholesale, never editing them in place, so a reader between
transactions sees one committed version.  Nothing n × n crosses to the
host on the update path; :meth:`HandleState.snapshot` holds no tensor.

States live in a :class:`HandleStore`, which several services may share
(``JordanService(shared_handles=...)``):

  * an update reads the committed state and writes through under the
    handle's own lock, so updates of one handle serialize and updates of
    different handles run concurrently;
  * the lock order is STATE → STORE wherever a state lock is held (the
    transaction's identity re-check, evict's and create's replacement
    checks), which lets evict and create wait out an update in flight, and
    an update never commits to a state the store no longer holds;
  * with a :class:`~..obs.capacity.CapacityBudget` attached, admission
    evicts least-recently-served unpinned handles until the new state fits,
    or refuses it with the typed ``CapacityExceededError``; every create,
    evict and re-create meters the ``handles`` class of the capacity
    ledger.

Callers hold a :class:`HandleRef` (coordinates, no tensors) and pass it to
``JordanService.update(handle, u, v)``.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from ..interop import resolve_dtype
from ..obs import capacity as _capacity


def resident_handle_bytes(bucket_n: int, dtype) -> int:
    """The bytes ONE resident handle pins: the padded mutated matrix and
    its padded inverse, 2·bucket²·itemsize (the unit of every capacity
    budget), the item size from the torch dtype."""
    itemsize = torch.empty((), dtype=resolve_dtype(dtype)).element_size()
    return 2 * int(bucket_n) * int(bucket_n) * itemsize


class UnknownHandleError(KeyError):
    """The handle id names no resident state: never created here, or
    already evicted.  An update of a missing handle fails typed."""


@dataclass(frozen=True)
class HandleRef:
    """What a caller holds for one resident inverse: the id and the
    coordinates an update request needs to land on its lane.  ``result``
    (when present) is the creating invert's ``InvertResult``."""

    handle_id: str
    n: int
    bucket_n: int
    dtype: str
    result: object = None

    def __repr__(self) -> str:
        return (f"HandleRef({self.handle_id!r}, n={self.n}, "
                f"bucket={self.bucket_n}, dtype={self.dtype})")


@dataclass
class HandleState:
    """One committed resident state, its tensors padded to the bucket and on
    the service's device.  ``drift`` is the accumulated per-update
    rel_residual since the last fresh elimination; ``version`` counts
    committed mutations (0 = as created).  ``nbytes`` (stamped by the store
    at create), ``last_served`` (the LRU clock, stamped at create and by
    every committed transaction) and ``pinned`` (exempt from budget
    eviction) are the capacity accounting."""

    handle_id: str
    n: int
    bucket_n: int
    dtype: str
    a: object                     # (bucket, bucket) tensor: mutated matrix
    inverse: object               # (bucket, bucket) tensor: resident A⁻¹
    version: int = 0
    drift: float = 0.0
    updates_applied: int = 0
    reinverts: int = 0
    kappa: float = 0.0
    rel_residual: float = 0.0
    nbytes: int = 0
    last_served: float = 0.0
    pinned: bool = False
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False)

    def snapshot(self) -> dict:
        """The JSON-able row of ``service.stats()["handles"]`` (no
        tensors), taken under the handle's lock so a row is never torn by
        a concurrent commit; never call it inside ``txn()`` of the same
        handle (the lock is not reentrant)."""
        with self.lock:
            return {
                "handle_id": self.handle_id, "n": self.n,
                "bucket_n": self.bucket_n, "dtype": self.dtype,
                "version": self.version, "drift": float(self.drift),
                "updates_applied": self.updates_applied,
                "reinverts": self.reinverts,
                "rel_residual": float(self.rel_residual),
                "nbytes": int(self.nbytes),
                "pinned": bool(self.pinned),
            }


class HandleStore:
    """The thread-safe home of resident handles.  The store lock guards the
    id → state map; each state carries its own lock (``txn()``), so updates
    of different handles never serialize on the store.  ``budget`` is an
    optional :class:`~..obs.capacity.CapacityBudget`; ``clock`` the LRU
    clock (``time.monotonic`` by default)."""

    def __init__(self, budget=None, clock=None):
        self._lock = threading.Lock()
        self._handles: dict[str, HandleState] = {}
        self.budget = budget
        self._clock = clock if clock is not None else time.monotonic
        self._live_bytes = 0
        self._budget_evictions = 0
        self._refusals = 0

    def create(self, state: HandleState) -> HandleRef:
        """Install a freshly inverted state; an existing id is REPLACED
        (the new state is the truth, its version restarts at 0), after any
        transaction in flight on the old state is waited out.

        Budget admission runs first (evicting LRU unpinned handles, or
        raising ``CapacityExceededError`` before anything is installed)
        and is re-checked under the store lock at the install: of two
        racing creates of distinct ids, only one that still fits installs,
        and the other loops back to evict or refuse.  A same-id
        replacement is credited with the bytes it replaces."""
        state.nbytes = resident_handle_bytes(state.bucket_n, state.dtype)
        state.last_served = self._clock()
        ref = HandleRef(state.handle_id, state.n, state.bucket_n,
                        state.dtype)
        while True:
            if self.budget is not None:
                self.ensure_capacity(state.nbytes,
                                     replacing=state.handle_id)
            with self._lock:
                old = self._handles.get(state.handle_id)
                if old is None:
                    if self._fits_locked(state.nbytes):
                        self._install(state)
                        return ref
                    continue            # admission raced: evict again
            with old.lock:
                with self._lock:
                    if (self._handles.get(state.handle_id) is old
                            and self._fits_locked(state.nbytes
                                                  - old.nbytes)):
                        self._live_bytes -= old.nbytes
                        self._install(state)
                        return ref
            # The old state was replaced or evicted between the reads, or
            # a racer took the credit: admit again.

    def _fits_locked(self, delta: int) -> bool:
        """Does ``delta`` more net bytes fit the budget?  (Caller holds
        the store lock: the install-time re-check.)"""
        return (self.budget is None
                or self._live_bytes + delta <= self.budget.max_bytes)

    def _install(self, state: HandleState) -> None:
        """The map write and the ledger entry (caller holds the store
        lock); the ledger counts a same-id replacement's old bytes as
        evicted."""
        self._handles[state.handle_id] = state
        self._live_bytes += state.nbytes
        _capacity.register("handles", (id(self), state.handle_id),
                           state.nbytes, detail=f"n{state.bucket_n}")

    def get(self, handle_id: str) -> HandleState:
        with self._lock:
            st = self._handles.get(handle_id)
        if st is None:
            raise UnknownHandleError(
                f"unknown resident handle {handle_id!r} — never "
                f"created, or already evicted")
        return st

    @contextmanager
    def txn(self, handle_id: str):
        """One serialized mutation window of a handle: yields the live
        state under ITS lock, its identity in the store re-checked under
        that lock (an evicted state raises :class:`UnknownHandleError`, a
        replaced one retries onto its successor).  Compute first and
        :meth:`commit` last: an exception inside the window leaves the
        committed state untouched.  Only a committed transaction refreshes
        the handle's LRU stamp."""
        while True:
            st = self.get(handle_id)
            with st.lock:
                with self._lock:
                    current = self._handles.get(handle_id)
                if current is st:
                    v0 = st.version
                    try:
                        yield st
                    finally:
                        if st.version != v0:
                            st.last_served = self._clock()
                    return

    @staticmethod
    def commit(state: HandleState, *, a, inverse, kappa: float,
               rel_residual: float, drift: float,
               reinverted: bool = False) -> int:
        """Write one applied update through (caller inside ``txn()``):
        tensors replaced wholesale, version bumped, the drift ledger
        advanced (reset by a re_invert rung).  Returns the new version."""
        state.a = a
        state.inverse = inverse
        state.kappa = float(kappa)
        state.rel_residual = float(rel_residual)
        state.drift = float(drift)
        state.version += 1
        state.updates_applied += 1
        if reinverted:
            state.reinverts += 1
        return state.version

    def evict(self, handle_id: str, cause: str = "caller") -> bool:
        """Drop a resident handle (False when already gone): the caller's
        lifecycle call, or the budget's evictor (``cause="budget"``).  A
        transaction in flight is waited out first, so a committed update
        is never orphaned.  Every eviction releases the ledger entry and
        records a ``capacity_eviction`` event."""
        while True:
            with self._lock:
                st = self._handles.get(handle_id)
            if st is None:
                return False
            with st.lock:
                with self._lock:
                    if self._handles.get(handle_id) is st:
                        del self._handles[handle_id]
                        self._live_bytes -= st.nbytes
                        if cause == "budget":
                            self._budget_evictions += 1
                        live = self._live_bytes
                        _capacity.release("handles",
                                          (id(self), handle_id))
                        _capacity.record_eviction(
                            handle_id, st.nbytes, cause, live,
                            budget_bytes=(self.budget.max_bytes
                                          if self.budget is not None
                                          else None))
                        return True

    # ---- capacity admission -----------------------------------------

    def pin(self, handle_id: str) -> None:
        """Exempt a handle from budget eviction (its bytes still count)."""
        self.get(handle_id).pinned = True

    def unpin(self, handle_id: str) -> None:
        self.get(handle_id).pinned = False

    def ensure_capacity(self, nbytes: int, exempt=frozenset(),
                        hop=None, replacing: str | None = None
                        ) -> list[str]:
        """Make room for ``nbytes`` of new resident state under the budget:
        evict least-recently-served unpinned handles (through
        :meth:`evict`) until it fits, or raise the typed
        ``CapacityExceededError`` (counted and recorded) when nothing
        evictable remains.  A no-op without a budget.

        ``replacing`` names the id a same-id re-create will replace: its
        bytes are credited and it is exempt from eviction.  ``hop`` (the
        creating request's journey ``ctx.event``) records one
        ``capacity_evict`` hop per victim.  Returns the evicted ids."""
        if self.budget is None:
            return []
        from ..resilience.policy import CapacityExceededError

        nbytes = int(nbytes)
        if replacing is not None:
            exempt = frozenset(exempt) | {replacing}
            with self._lock:
                old = self._handles.get(replacing)
                if old is not None:
                    nbytes = max(0, nbytes - old.nbytes)
        evicted: list[str] = []
        while True:
            with self._lock:
                if self._live_bytes + nbytes <= self.budget.max_bytes:
                    return evicted
                candidates = [st for st in self._handles.values()
                              if not st.pinned
                              and st.handle_id not in exempt]
                pinned = len(self._handles) - len(candidates)
                live = self._live_bytes
                if not candidates:
                    self._refusals += 1
            if not candidates:
                _capacity.record_refusal(nbytes, live,
                                         self.budget.max_bytes, pinned)
                raise CapacityExceededError(
                    f"resident-handle budget exceeded: {nbytes} new "
                    f"bytes would not fit ({live} live of "
                    f"{self.budget.max_bytes} budget, {pinned} "
                    f"pinned/exempt handle(s), nothing evictable) — "
                    f"evict or unpin a handle, or raise the budget")
            victim = self.budget.victims(candidates)[0]
            if self.evict(victim.handle_id, cause="budget"):
                evicted.append(victim.handle_id)
                if hop is not None:
                    hop("capacity_evict", handle=victim.handle_id,
                        bytes=victim.nbytes, cause="budget")
            # A racing evictor may have removed the victim first: the
            # live-bytes re-check above decides.

    def budget_snapshot(self) -> dict:
        """The store's capacity block (``service.stats()``, the demo)."""
        with self._lock:
            return {
                "max_bytes": (self.budget.max_bytes
                              if self.budget is not None else None),
                "live_bytes": self._live_bytes,
                "handles": len(self._handles),
                "pinned": sorted(h for h, st in self._handles.items()
                                 if st.pinned),
                "budget_evictions": self._budget_evictions,
                "refusals": self._refusals,
            }

    def ids(self) -> list[str]:
        with self._lock:
            return sorted(self._handles)

    def snapshot(self) -> dict:
        """{handle_id: state.snapshot()}."""
        with self._lock:
            states = list(self._handles.values())
        return {st.handle_id: st.snapshot() for st in states}

    def __len__(self) -> int:
        with self._lock:
            return len(self._handles)


def build_handle_store(shared, budget_bytes: int | None,
                       owner: str) -> HandleStore:
    """The handle store of a service: the shared one, a budgeted one of its
    own, or an unbudgeted one.  A shared store carries its own budget, so
    passing both is refused typed (``owner`` names the consumer)."""
    if shared is not None and budget_bytes is not None:
        from ..errors import UsageError

        raise UsageError(
            f"handle_budget_bytes builds {owner}'s own budgeted store; "
            f"a pre-built shared store carries its own budget "
            f"(HandleStore(budget=CapacityBudget(...)): one admission "
            f"policy for everyone sharing it)")
    if shared is not None:
        return shared
    if budget_bytes is not None:
        return HandleStore(budget=_capacity.CapacityBudget(
            max_bytes=budget_bytes))
    return HandleStore()


def create_resident_handle(store: HandleStore, dtype, a, res,
                           handle_id: str) -> HandleRef:
    """Install one resident handle from a completed invert: the matrix
    ``a`` (n × n, any device) and ``res.inverse`` are padded with the
    identity on the inverse's device (the bucketed inverse is [[A⁻¹, 0],
    [0, I]], ``ops/padding.py``).  The returned ref carries ``res``."""
    dtype = resolve_dtype(dtype)
    bucket, n = res.bucket_n, res.n
    dev = res.inverse.device
    a_pad = torch.eye(bucket, dtype=dtype, device=dev)
    a_pad[:n, :n] = torch.as_tensor(a).to(device=dev, dtype=dtype)
    inv_pad = torch.eye(bucket, dtype=dtype, device=dev)
    inv_pad[:n, :n] = res.inverse
    ref = store.create(HandleState(
        handle_id=handle_id, n=n, bucket_n=bucket,
        dtype=str(dtype).removeprefix("torch."), a=a_pad, inverse=inv_pad,
        kappa=res.kappa, rel_residual=res.rel_residual))
    return HandleRef(ref.handle_id, ref.n, ref.bucket_n, ref.dtype,
                     result=res)
