"""Phase spans: a thread-safe span tree with an injectable monotonic clock.
Counterpart of the JAX package's ``obs/spans.py``.

The reference's only timing is one max-allreduced ``MPI_Wtime`` bracket
printed as ``glob_time`` (main.cpp:427-458).  Here each solve is a tree:

  * ``solve`` (root) → ``select`` (the tuner's ladder) / ``load`` /
    ``execute`` / ``residual`` (/ ``recover`` with its rungs).  Torch has
    no compile step, so there is no ``compile`` span: the first call of a
    process builds the kernels inside its ``execute``, as ``elapsed``
    already counts them.
  * Under ``execute``, the paper's hot-loop phases ``pivot`` (the
    candidate probe and the selection), ``permute`` (the block-row swaps)
    and ``eliminate`` (normalize and the trailing update).  The fused
    engines' phases are MEASURED (:func:`attribute_phases_measured`, from
    ``ops/fused_update.measured_phase_fractions``' kernel brackets); the
    others are MODELED (:func:`attribute_phases`, ``modeled=True`` on every
    child).

:func:`timed_blocking` is the port's one timing bracket.  On the card it
runs the call between two CUDA events and synchronizes on the stop event:
the span's end is its start plus the events' seconds (``clock=
"cuda_event"``, the host wall in ``host_seconds``), so ``SolveResult.
elapsed`` and the ``execute`` span are one number.  On the CPU both ends
are the telemetry's clock.

Each thread nests spans on its own stack (the lookahead engines use a
side CUDA stream, not a thread); only the root list takes the lock.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

#: The hot-loop phases of the paper's superstep, in execution order
#: (main.cpp:1026-1196).
PHASES = ("pivot", "permute", "eliminate")

#: Finished roots retained per collector; beyond it the oldest drop first.
MAX_ROOT_SPANS = 4096


@dataclass
class Span:
    """One timed interval of the tree, in the telemetry clock's seconds."""

    name: str
    t_start: float
    t_end: float | None = None
    attrs: dict = field(default_factory=dict)
    children: list = field(default_factory=list)
    thread: int = 0

    @property
    def duration(self) -> float:
        """Seconds (0.0 while the span is open)."""
        return 0.0 if self.t_end is None else self.t_end - self.t_start

    def child(self, name: str, t_start: float, t_end: float,
              **attrs) -> "Span":
        """Attach an explicitly timed child (the phase attribution's
        sub-intervals)."""
        sp = Span(name, t_start, t_end, dict(attrs), thread=self.thread)
        self.children.append(sp)
        return sp

    def walk(self):
        """This span and its subtree, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> "Span | None":
        """The first span named ``name`` in this subtree, depth first."""
        for sp in self.walk():
            if sp.name == name:
                return sp
        return None

    def to_dict(self) -> dict:
        """Plain JSON (the one-line exporter's span payload)."""
        return {
            "name": self.name,
            "start": self.t_start,
            "duration": self.duration,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }


class Telemetry:
    """A span collector: ``span(name)`` opens a child of the thread's
    innermost open span, or a new root.  ``clock`` is any zero-argument
    monotonic callable (``time.perf_counter`` by default; tests inject a
    fake).  At most ``max_roots`` finished roots are kept."""

    #: ``NullTelemetry`` clears it: spans are timed but not kept.
    retain = True

    def __init__(self, clock=None, max_roots: int = MAX_ROOT_SPANS):
        self.clock = clock if clock is not None else time.perf_counter
        self.max_roots = int(max_roots)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._roots: list[Span] = []

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        sp = Span(name, t_start=self.clock(), attrs=dict(attrs),
                  thread=threading.get_ident())
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.t_end = self.clock()
            stack.pop()
            if self.retain:
                if parent is not None:
                    parent.children.append(sp)
                else:
                    with self._lock:
                        self._roots.append(sp)
                        del self._roots[:-self.max_roots]

    @property
    def roots(self) -> list[Span]:
        with self._lock:
            return list(self._roots)

    def spans(self):
        """Every finished span, depth first across the roots."""
        for r in self.roots:
            yield from r.walk()

    def find(self, name: str) -> Span | None:
        """The first finished span named ``name``, across the roots."""
        for sp in self.spans():
            if sp.name == name:
                return sp
        return None


class NullTelemetry(Telemetry):
    """Times its spans but keeps none: the sink when no telemetry is
    passed, so an instrumented path costs a clock pair and never grows."""

    retain = False


#: The shared discard-only sink.
NULL = NullTelemetry()


def timed_blocking(fn, *args, telemetry=None, name: str = "execute",
                   device=None, **attrs):
    """THE timing bracket: run ``fn(*args)`` inside span ``name`` and
    return ``(result, span)``.

    On a CUDA ``device`` the call runs between two CUDA events on the
    current stream and the bracket synchronizes on the stop event (no
    synchronize before the start event): ``span.t_end = span.t_start +``
    the events' seconds, with ``clock="cuda_event"`` and the host wall in
    ``host_seconds``.  Otherwise the span's ends are the telemetry clock's
    (``clock="host"``).  ``result.elapsed`` of every entry point is this
    span's ``duration``."""
    import torch

    tel = telemetry if telemetry is not None else NULL
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        with tel.span(name, clock="host", **attrs) as sp:
            out = fn(*args)
        return out, sp
    with tel.span(name, clock="cuda_event", **attrs) as sp:
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            out = fn(*args)
            stop.record()
            stop.synchronize()
            host = time.perf_counter() - h0
    sp.t_end = sp.t_start + start.elapsed_time(stop) / 1e3
    sp.attrs["host_seconds"] = host
    return out, sp


def attribute_phases_measured(span: Span, fractions: dict,
                              source: str = "kernel_bracket"
                              ) -> list[Span]:
    """Tile a measured ``execute`` span with the hot-loop phases by
    MEASURED fractions (``measured=True`` and ``source`` on every child,
    no ``modeled``: ``tools/check_telemetry.py`` tells the two apart).
    The fractions are renormalized so the children tile the span
    exactly."""
    total = sum(float(fractions[p]) for p in PHASES)
    out = []
    t = span.t_start
    for i, phase in enumerate(PHASES):
        frac = (float(fractions[phase]) / total) if total > 0 else (
            1.0 / len(PHASES))
        t1 = (span.t_end if i == len(PHASES) - 1
              else t + frac * span.duration)
        out.append(span.child(phase, t, t1, measured=True, source=source,
                              fraction=round(frac, 6)))
        t = t1
    return out


def attribute_phases(span: Span, n: int, block_size: int,
                     distributed: bool = False,
                     lookahead: bool = False) -> list[Span]:
    """Tile a measured ``execute`` span with the hot-loop phases as
    MODELED children (``modeled=True`` and the fraction on each), by the
    first-order weights of the tuner's cost hooks: ``eliminate`` the 2n³
    sweep, ``pivot`` the Nr·2m³ = 2nm² probe, ``permute`` an O(n²) data
    term (heavier on a mesh).

    ``lookahead=True`` (the probe-ahead engines) keeps the three children
    and nests a ``probe_ahead`` child in ``eliminate``: the next step's
    probe issued inside the trailing-update window.  Its ``fraction`` is
    the hideable probe share (bounded by the eliminate share), with
    ``overlapped=True`` so a reader never sums it into the tiling."""
    m = max(1, min(block_size, n))
    weights = {
        "pivot": 2.0 * n * m * m,
        "permute": (64.0 if distributed else 8.0) * float(n) * n,
        "eliminate": 2.0 * float(n) ** 3,
    }
    total = sum(weights.values())
    out = []
    t = span.t_start
    for i, phase in enumerate(PHASES):
        frac = weights[phase] / total
        t1 = (span.t_end if i == len(PHASES) - 1
              else t + frac * span.duration)
        sp = span.child(phase, t, t1, modeled=True,
                        fraction=round(frac, 6))
        if lookahead and phase == "eliminate":
            hid = min(weights["pivot"], weights["eliminate"])
            sp.child("probe_ahead", t,
                     t + (hid / weights["eliminate"]) * (t1 - t),
                     modeled=True, overlapped=True,
                     fraction=round(hid / total, 6))
        out.append(sp)
        t = t1
    return out
