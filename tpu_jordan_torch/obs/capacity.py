"""The process-wide capacity ledger: what is resident, per byte class, and
the budget that turns it into actuation.  Counterpart of the JAX package's
``obs/capacity.py``.

The paper's MPI program sizes every rank's block buffers up front from the
row-cyclic decomposition (main.cpp:95-123).  Here two kinds of byte class
are accounted:

  * **metered**: residency with an explicit lifecycle registers and
    releases through :data:`LEDGER`: the tuner's plan document
    (``plan_cache``), the serving lanes' executors (``executor_lanes``,
    their projected argument + output bytes, ``serve/executors.py``) and
    the resident handles (``handles``, 2·bucket²·itemsize each,
    ``serve/handles.py``).  ``bytes_created == bytes_live +
    bytes_evicted`` holds per class by construction.
  * **sampled**: probed at :func:`snapshot` time, the flight-recorder
    ring (``flight_recorder``) and the CUDA caching allocator's live and
    peak bytes through ``hwcost.WATERMARK`` (``device``; ``available=
    False`` for good on the CPU, never zeroed).

A :class:`CapacityBudget` on a handle store evicts the least-recently-served
unpinned handles (:func:`lru_policy`) until an admission fits, or refuses it
with the typed ``CapacityExceededError`` at submit; every eviction and
refusal leaves a counter and a flight-recorder event (:func:`record_eviction`,
:func:`record_refusal`), and a lane's bytes are projected before its build
(:func:`record_projection`).  :func:`capacity_demo` (the CLI's
``--capacity-demo``) proves the chain for ``tools/check_capacity.py``.

Exported as ``tpu_jordan_torch_capacity_*`` gauges and counters; the CLI's
``--capacity-report PATH`` writes :func:`snapshot`.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass

from . import metrics as _metrics

_M_LIVE = _metrics.gauge(
    "tpu_jordan_torch_capacity_bytes",
    "live resident bytes per capacity component (plan_cache; sampled "
    "components export at probe time)")
_M_HIGH = _metrics.gauge(
    "tpu_jordan_torch_capacity_high_water_bytes",
    "high-water mark of live resident bytes per capacity component")
_M_CREATED = _metrics.counter(
    "tpu_jordan_torch_capacity_bytes_created_total",
    "resident bytes registered per capacity component (the ledger's "
    "create side; created == live + evicted per component)")
_M_EVICTED = _metrics.counter(
    "tpu_jordan_torch_capacity_bytes_evicted_total",
    "resident bytes released per capacity component (the ledger's "
    "evict side)")
_M_EVICTIONS = _metrics.counter(
    "tpu_jordan_torch_capacity_evictions_total",
    "resident-handle evictions, labeled by cause (budget = the "
    "CapacityBudget's LRU evictor made room; caller = an explicit "
    "lifecycle evict)")
_M_REFUSED = _metrics.counter(
    "tpu_jordan_torch_capacity_exceeded_total",
    "typed CapacityExceededError admission refusals: an over-budget "
    "resident invert the evictor could not make room for (everything "
    "evictable pinned), refused at submit")
_M_PROJECTED = _metrics.gauge(
    "tpu_jordan_torch_capacity_projected_lane_bytes",
    "projected argument + output bytes of a serve lane, recorded before "
    "its build (warmup/project_capacity)")


class _Component:
    """One metered byte class: {key: (bytes, detail)} and its running
    counters, mutated under the ledger's lock."""

    def __init__(self):
        self.entries: dict[object, tuple[int, str | None]] = {}
        self.live = 0
        self.created = 0
        self.evicted = 0
        self.high_water = 0


class CapacityLedger:
    """The thread-safe ledger.  ``register``/``release`` meter explicit
    residency; ``register_probe`` attaches a sampled class.  Registering a
    live key again replaces it: the old bytes count as evicted, so the
    reconciliation survives re-creates (a re-saved plan cache)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._components: dict[str, _Component] = {}
        self._probes: dict[str, object] = {}

    def register(self, component: str, key, nbytes: int,
                 detail: str | None = None) -> None:
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError("nbytes must be >= 0")
        with self._lock:
            comp = self._components.setdefault(component, _Component())
            old = comp.entries.pop(key, None)
            if old is not None:
                comp.live -= old[0]
                comp.evicted += old[0]
            comp.entries[key] = (nbytes, detail)
            comp.live += nbytes
            comp.created += nbytes
            comp.high_water = max(comp.high_water, comp.live)
            live, high = comp.live, comp.high_water
            evicted_delta = old[0] if old is not None else 0
        _M_CREATED.inc(nbytes, component=component)
        if evicted_delta:
            _M_EVICTED.inc(evicted_delta, component=component)
        _M_LIVE.set(live, component=component)
        _M_HIGH.set(high, component=component)

    def release(self, component: str, key) -> int:
        """Release one entry; returns its bytes (0 for an unknown key: a
        double release is a no-op)."""
        with self._lock:
            comp = self._components.get(component)
            if comp is None:
                return 0
            old = comp.entries.pop(key, None)
            if old is None:
                return 0
            comp.live -= old[0]
            comp.evicted += old[0]
            live = comp.live
        _M_EVICTED.inc(old[0], component=component)
        _M_LIVE.set(live, component=component)
        return old[0]

    def live_bytes(self, component: str | None = None) -> int:
        with self._lock:
            if component is not None:
                comp = self._components.get(component)
                return comp.live if comp is not None else 0
            return sum(c.live for c in self._components.values())

    def register_probe(self, component: str, probe) -> None:
        """Attach a sampled class: ``probe()`` returns ``{"bytes": int,
        ...}``, or None when its source reports nothing (then
        ``available=False``)."""
        with self._lock:
            self._probes[component] = probe

    def snapshot(self) -> dict:
        """The per-component document: metered classes with created, live,
        evicted, high water and a per-detail breakdown; sampled classes
        probed now."""
        with self._lock:
            doc = {
                name: {
                    "kind": "metered",
                    "entries": len(c.entries),
                    "bytes_live": c.live,
                    "bytes_created": c.created,
                    "bytes_evicted": c.evicted,
                    "high_water_bytes": c.high_water,
                    "breakdown": _breakdown(c.entries),
                }
                for name, c in sorted(self._components.items())
            }
            probes = dict(self._probes)
        for name, probe in sorted(probes.items()):
            try:
                sampled = probe()
            except Exception:                        # noqa: BLE001
                sampled = None
            entry = {"kind": "sampled", "available": sampled is not None}
            if sampled is not None:
                entry["bytes_live"] = int(sampled.get("bytes", 0))
                entry.update({k: v for k, v in sampled.items()
                              if k != "bytes"})
                _M_LIVE.set(entry["bytes_live"], component=name)
            doc[name] = entry
        return {
            "components": doc,
            "metered_bytes_live": sum(
                d["bytes_live"] for d in doc.values()
                if d["kind"] == "metered"),
        }

    def reset(self) -> None:
        """Drop every entry and probe (tests only)."""
        with self._lock:
            self._components.clear()
            self._probes.clear()


def _breakdown(entries: dict) -> dict:
    out: dict[str, int] = {}
    for nbytes, detail in entries.values():
        label = detail if detail is not None else "unlabeled"
        out[label] = out.get(label, 0) + nbytes
    return dict(sorted(out.items()))


# ---- the eviction budget (accounting -> actuation) ------------------


def lru_policy(candidates):
    """The default eviction order: least-recently-served first
    (``HandleState.last_served``, stamped at create and on every committed
    update)."""
    return sorted(candidates, key=lambda st: st.last_served)


@dataclass
class CapacityBudget:
    """A resident-bytes ceiling for a :class:`~..serve.handles.HandleStore`:
    admitting a new resident handle evicts least-recently-served unpinned
    handles until it fits; when nothing evictable remains, the admission is
    refused with the typed ``CapacityExceededError``, at submit
    (:func:`lru_policy` is the eviction order)."""

    max_bytes: int

    def __post_init__(self):
        self.max_bytes = int(self.max_bytes)
        if self.max_bytes < 1:
            raise ValueError("CapacityBudget.max_bytes must be >= 1")

    def victims(self, candidates):
        return lru_policy(candidates)


def record_eviction(handle_id: str, nbytes: int, cause: str,
                    live_bytes: int,
                    budget_bytes: int | None = None) -> None:
    """One eviction's counter (by cause) and ``capacity_eviction``
    flight-recorder event, the evidence ``tools/check_capacity.py`` pairs
    every budget eviction with."""
    from . import recorder as _recorder

    _M_EVICTIONS.inc(cause=cause)
    ev = {"handle_id": handle_id, "nbytes": int(nbytes),
          "cause": cause, "live_bytes": int(live_bytes)}
    if budget_bytes is not None:
        ev["budget_bytes"] = int(budget_bytes)
    _recorder.record("capacity_eviction", **ev)


def record_refusal(requested: int, live_bytes: int, budget_bytes: int,
                   pinned: int) -> None:
    """A typed admission refusal's counter and ``capacity_refused``
    event."""
    from . import recorder as _recorder

    _M_REFUSED.inc()
    _recorder.record("capacity_refused", requested=int(requested),
                     live_bytes=int(live_bytes),
                     budget_bytes=int(budget_bytes), pinned=int(pinned))


def record_projection(lane: str, nbytes: int) -> None:
    """One lane's projected argument + output bytes, recorded before its
    build (``JordanService.project_capacity``/``warmup``)."""
    _M_PROJECTED.set(int(nbytes), lane=str(lane))


#: THE process-wide ledger.
LEDGER = CapacityLedger()


def register(component: str, key, nbytes: int,
             detail: str | None = None) -> None:
    LEDGER.register(component, key, nbytes, detail=detail)


def release(component: str, key) -> int:
    return LEDGER.release(component, key)


def live_bytes(component: str | None = None) -> int:
    return LEDGER.live_bytes(component)


def _recorder_probe() -> dict:
    """The flight-recorder ring's retained bytes, as JSON."""
    from . import recorder as _recorder

    evs = _recorder.RECORDER.events()
    return {
        "bytes": sum(len(json.dumps(e, default=str)) for e in evs),
        "events_retained": len(evs),
        "ring_capacity": _recorder.RECORDER.capacity,
    }


def _device_probe() -> dict | None:
    """The caching allocator's live and peak bytes through the sticky
    ``hwcost.WATERMARK`` (None on the CPU)."""
    from . import hwcost as _hwcost

    stats = _hwcost.WATERMARK.sample()
    if stats is None:
        return None
    out = {"bytes": int(stats.get("bytes_in_use", 0))}
    if stats.get("peak_bytes_in_use") is not None:
        out["peak_bytes_in_use"] = int(stats["peak_bytes_in_use"])
    return out


LEDGER.register_probe("flight_recorder", _recorder_probe)
LEDGER.register_probe("device", _device_probe)


def snapshot() -> dict:
    """The process-wide capacity document (the CLI's
    ``--capacity-report``)."""
    return LEDGER.snapshot()


def write_report(path: str) -> None:
    """Write :func:`snapshot` as one JSON document."""
    with open(path, "w") as f:
        json.dump(snapshot(), f)


# ---- the acceptance demo --------------------------------------------


def capacity_demo(n: int = 96, block_size: int | None = None,
                  seed: int = 0, dtype=None, budget_handles: int = 2,
                  device=None) -> dict:
    """The ``--capacity-demo`` run: one warmed service under a
    :class:`CapacityBudget` sized for ``budget_handles`` resident handles
    of n × n (seeded standard-normal fixtures, the JAX demo's):

      1. the lanes' bytes are projected before any build
         (``project_capacity``), then metered at the build;
      2. resident creates fill the budget, an update refreshes the first
         handle's LRU stamp, and the next create evicts the
         least-recently-served handle with a ``capacity_evict`` journey
         hop and a ``capacity_eviction`` event;
      3. with every survivor pinned, one more resident invert is the typed
         ``CapacityExceededError`` at submit (nothing launched);
      4. an update of the evicted handle is the typed
         ``UnknownHandleError``;
      5. the ledger reconciles (created == live + evicted per metered
         class), with zero builds (``tpu_jordan_torch_compiles_total``) and
         zero plan-cache measurements after the warmup.

    Returns the one-line JSON report ``tools/check_capacity.py`` validates
    (its exit 2: unmetered residency or a silent eviction)."""
    import time

    import numpy as np
    import torch

    from ..interop import resolve_device, resolve_dtype
    from ..resilience.policy import CapacityExceededError
    from ..serve.executors import bucket_for
    from ..serve.handles import (HandleStore, UnknownHandleError,
                                 resident_handle_bytes)
    from ..serve.service import JordanService
    from .metrics import REGISTRY
    from .recorder import RECORDER

    t0 = time.perf_counter()
    dtype = resolve_dtype(torch.float32 if dtype is None else dtype)
    dev = resolve_device(device)
    if budget_handles < 2:
        raise ValueError("capacity_demo needs budget_handles >= 2 "
                         "(the LRU order needs two candidates)")
    bucket = bucket_for(n)
    per = resident_handle_bytes(bucket, dtype)
    budget_bytes = budget_handles * per + per // 2
    store = HandleStore(budget=CapacityBudget(max_bytes=budget_bytes))
    rank = 8
    # Sub-fp32 fixtures are made in fp32 (numpy has no bfloat16) and
    # rounded at submit.
    np_dtype = (np.float32 if dtype in (torch.bfloat16, torch.float16)
                else np.dtype(str(dtype).removeprefix("torch.")))
    rng = np.random.default_rng(seed)
    mats = [rng.standard_normal((n, n)).astype(np_dtype)
            for _ in range(budget_handles + 2)]
    scale = 1.0 / np.sqrt(float(n) * rank)
    u = rng.standard_normal((n, rank)).astype(np_dtype) * scale
    v = rng.standard_normal((n, rank)).astype(np_dtype) * scale

    def counters():
        c = REGISTRY.counter
        return {
            "compiles": c("tpu_jordan_torch_compiles_total").total(),
            "measurements":
                c("tpu_jordan_torch_tuner_measurements_total").total(),
            "budget_evictions": _M_EVICTIONS.value(cause="budget"),
            "refusals": _M_REFUSED.total(),
        }

    mark = RECORDER.total
    with JordanService(engine="auto", dtype=dtype, batch_cap=1,
                       max_wait_ms=0.5, block_size=block_size,
                       shared_handles=store, device=dev) as svc:
        projected = svc.project_capacity(update_shapes=[(n, rank)])
        svc.warmup(update_shapes=[(n, rank)])
        after_warm = counters()
        refs = {}
        for i in range(budget_handles):
            hid = f"h{i + 1}"
            refs[hid] = svc.invert(mats[i], resident=True,
                                   handle_id=hid, timeout=600)
        # Refresh h1's LRU stamp: h2 becomes the least-recently-served
        # candidate the next admission evicts.
        svc.update(refs["h1"], u, v, timeout=600)
        over_id = f"h{budget_handles + 1}"
        refs[over_id] = svc.invert(mats[budget_handles], resident=True,
                                   handle_id=over_id, timeout=600)
        alive = store.ids()
        for hid in alive:
            store.pin(hid)
        typed_overflow = None
        try:
            svc.invert(mats[budget_handles + 1], resident=True,
                       handle_id=f"h{budget_handles + 2}", timeout=600)
        except CapacityExceededError as e:
            typed_overflow = type(e).__name__
        update_after_evict = None
        try:
            svc.update(refs["h2"], u, v, timeout=600)
        except UnknownHandleError as e:
            update_after_evict = type(e).__name__
        end = counters()
        budget_snap = store.budget_snapshot()
        handles_snap = store.snapshot()
    blackbox = RECORDER.dump(events=RECORDER.since(mark))
    ledger = snapshot()

    eviction_events = [e for e in blackbox["events"]
                       if e["kind"] == "capacity_eviction"]
    budget_events = [e for e in eviction_events
                     if e.get("cause") == "budget"]
    journey_evicts = [e for e in blackbox["events"]
                      if e["kind"] == "journey"
                      and e.get("event") == "capacity_evict"]
    budget_evictions = int(end["budget_evictions"]
                           - after_warm["budget_evictions"])
    unmetered = [name for name, doc in ledger["components"].items()
                 if doc["kind"] == "metered"
                 and doc["bytes_created"] != (doc["bytes_live"]
                                              + doc["bytes_evicted"])]
    silent_eviction = (budget_evictions != len(budget_events)
                       or len(journey_evicts) < len(budget_events))
    compiles_on_path = int(end["compiles"] - after_warm["compiles"])
    silent_capacity = (
        bool(unmetered) or silent_eviction
        or typed_overflow != "CapacityExceededError"
        or update_after_evict != "UnknownHandleError"
        or "h2" in alive or compiles_on_path != 0)
    return {
        "metric": "capacity_demo",
        "n": n, "bucket_n": bucket,
        "dtype": str(dtype).removeprefix("torch."), "seed": seed,
        "device": str(dev),
        "handle_bytes": per,
        "budget_bytes": budget_bytes,
        "budget_handles": budget_handles,
        "projected_lanes": projected,
        "ledger": ledger,
        "budget": budget_snap,
        "handles_alive": alive,
        "handles": handles_snap,
        "evictions": eviction_events,
        "journey_evict_hops": len(journey_evicts),
        "budget_evictions": budget_evictions,
        "typed_overflow": {
            "raised": typed_overflow == "CapacityExceededError",
            "error": typed_overflow,
            "refusals": int(end["refusals"] - after_warm["refusals"]),
        },
        "update_after_evict_typed": update_after_evict,
        "compiles_on_capacity_path": compiles_on_path,
        "measurements": int(end["measurements"]
                            - after_warm["measurements"]),
        "unmetered_components": unmetered,
        "silent_capacity": bool(silent_capacity),
        "blackbox": blackbox,
        "elapsed_s": round(time.perf_counter() - t0, 3),
    }
