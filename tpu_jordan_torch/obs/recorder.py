"""The always-on flight recorder: a bounded ring of structured events with
a process-wide monotone sequence number, dumped as one JSON document.
Counterpart of the JAX package's ``obs/recorder.py``.

Recording is one dict build, one lock and one deque append; nothing is
formatted until ``dump()``.  The ring keeps the ``capacity`` most recent
events, and ``dump`` reports how many were dropped.  Every event carries
``seq`` (dense and monotone), ``t`` (the recorder's clock, any zero-arg
monotonic callable) and ``kind``.  The tuner's plan cache
(``plan_cache_write_failure``), the fault points (``fault_injected``),
``RetryPolicy`` (``retry``), the numerics observatory
(``numerics_spike``) and the degradation ladders
(``residual_gate_failure``, ``recovery_rung``) record into it; the CLI
dumps it with ``--blackbox-out`` and on every exit 2.  The per-request
``journey`` events come with the serving stack (ROADMAP.md Queue A item
14).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

#: Events the process-wide ring keeps.
DEFAULT_CAPACITY = 8192


class FlightRecorder:
    """The bounded, thread-safe event ring.  ``record(kind, **fields)``
    appends ``{**fields, "kind", "t", "seq"}``; ``since(seq)`` slices the
    events after a mark taken with ``total``."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0

    def record(self, kind: str, t: float | None = None, **fields) -> int:
        """Append one event; returns its ``seq``.  ``t`` stamps the event
        with a time the caller already read."""
        ev = dict(fields)
        ev["kind"] = str(kind)
        ev["t"] = float(t) if t is not None else self.clock()
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
            return self._seq

    @property
    def total(self) -> int:
        """Events recorded over the recorder's life; the next event gets
        ``total + 1``."""
        with self._lock:
            return self._seq

    def events(self, kind: str | None = None) -> list[dict]:
        """The retained window, oldest first, optionally of one kind."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def since(self, seq: int) -> list[dict]:
        """The retained events with a ``seq`` above ``seq``."""
        with self._lock:
            return [e for e in self._ring if e["seq"] > seq]

    def dump(self, events: list[dict] | None = None) -> dict:
        """The retained window (or ``events``, a slice of it) with
        ``recorded_total`` and ``dropped``: events lost to the ring
        before the window's first one (for the whole window), or gaps in
        the slice's sequence numbers."""
        with self._lock:
            window = list(self._ring) if events is None else list(events)
            total = self._seq
        if events is None:
            dropped = (window[0]["seq"] - 1) if window else total
        else:
            seqs = [e["seq"] for e in window]
            dropped = (seqs[-1] - seqs[0] + 1 - len(seqs)) if seqs else 0
        return {
            "metric": "blackbox",
            "capacity": self.capacity,
            "recorded_total": total,
            "retained": len(window),
            "dropped": dropped,
            "events": window,
        }

    def write(self, path: str, events: list[dict] | None = None) -> None:
        """Write ``dump(events)`` to ``path`` as one JSON document."""
        with open(path, "w") as f:
            json.dump(self.dump(events), f)

    def reset(self) -> None:
        """Drop the ring and the sequence (tests only)."""
        with self._lock:
            self._ring.clear()
            self._seq = 0


#: The process-wide recorder.
RECORDER = FlightRecorder()


def record(kind: str, t: float | None = None, **fields) -> int:
    """Record one event into the process-wide ring."""
    return RECORDER.record(kind, t=t, **fields)
