"""The process-wide capacity ledger: what is resident, per byte class.
The ledger core of the JAX package's ``obs/capacity.py``.

The paper's MPI program sizes every rank's block buffers up front from the
row-cyclic decomposition (main.cpp:95-123).  Here two kinds of byte class
are accounted:

  * **metered**: residency with an explicit lifecycle registers and
    releases through :data:`LEDGER`: the tuner's plan document
    (``plan_cache``) and the serving lanes' executors (``executor_lanes``,
    their projected argument + output bytes, ``serve/executors.py``).  ``bytes_created == bytes_live +
    bytes_evicted`` holds per class by construction.
  * **sampled**: probed at :func:`snapshot` time, the flight-recorder
    ring (``flight_recorder``) and the CUDA caching allocator's live and
    peak bytes through ``hwcost.WATERMARK`` (``device``; ``available=
    False`` for good on the CPU, never zeroed).

Exported as ``tpu_jordan_torch_capacity_*`` gauges and counters; the CLI's
``--capacity-report PATH`` writes :func:`snapshot`.  The eviction budget,
the eviction/refusal/projection records and the capacity demo come with
the resident handles (ROADMAP.md Queue A item 14b).
"""

from __future__ import annotations

import json
import threading

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
