"""Phase spans: a thread-safe span tree with an injectable monotonic clock.
Counterpart of the JAX package's ``obs/spans.py``.

The reference's only timing is one max-allreduced ``MPI_Wtime`` bracket
printed as ``glob_time`` (main.cpp:427-458).  Here each solve is a tree:

  * ``solve`` (root) → ``select`` (the tuner's ladder) / ``load`` /
    ``execute`` / ``residual`` (/ ``recover`` with its rungs);
    ``JordanSolver.invert``/``invert_batch`` are ``invert``/
    ``invert_batch`` roots with an ``execute`` child.  Torch has no
    compile step, so there is no ``compile`` span: the first call of a
    process builds the kernels inside its ``execute``.
  * Under ``execute``, the engines' own spans, put where the work
    happens (``ops/jordan_inplace.py``, ``ops/batched.py``): ``setup``
    (padding or clone), one ``step`` a superstep (its ``t``) with the
    paper's hot-loop phases ``pivot`` (candidate copy, probe, selection),
    ``permute`` (the block-row swap) and ``eliminate`` (normalize, the
    trailing update, the write-back; the group close), then ``finalize``
    (its child ``readback``, the call's one read of the swap record) and
    ``refine``.  A probe-ahead ``pivot`` launched on the lookahead side
    stream carries ``overlapped=True``.  An engine that records no steps
    (``augmented``) has no phase children: a missing number is missing.

**When spans are on.**  A span opened with ``device=`` records a CUDA
event pair on that device's current stream (the stream its work launches
on); :attr:`Span.device_seconds` reads the pair lazily, so no span adds a
synchronisation (on the CPU it is the host duration).  While a
``torch.profiler`` collects, every span also opens a host-only profiler
range ``tj::<name>`` (a FUNCTION-scope ``_RecordFunctionFast``, never a
``record_function`` user annotation, which the profiler twins on the
device timeline), so the trace's idle gaps can be named after the span
the host was in.  The engines ask :func:`sink` once a call: the retaining
:class:`Telemetry` with a span open on the thread, else :data:`PROFILED`
(bounded, process-wide) while a profiler collects, else None, and then
each span site costs one test of that value and allocates nothing
(:data:`NOSPAN`).  The discard-only :data:`NULL` sink forwards to
:data:`PROFILED` while a profiler collects.

:func:`timed_blocking` is the port's one synchronising timing bracket.
On the card it runs the call between two CUDA events and synchronizes on
the stop event: the span's end is its start plus the events' seconds
(``clock="cuda_event"``, the host wall in ``host_seconds``), so
``SolveResult.elapsed`` and the ``execute`` span are one number.  On the
CPU both ends are the telemetry's clock.

Each thread nests spans on its own stack (the lookahead engines use a
side CUDA stream, not a thread); only the root list takes the lock.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import torch

#: The hot-loop phases of the paper's superstep, in execution order
#: (main.cpp:1026-1196).
PHASES = ("pivot", "permute", "eliminate")

#: Finished roots retained per collector; beyond it the oldest drop first.
MAX_ROOT_SPANS = 4096

#: Finished roots :data:`PROFILED` retains: a traced stretch of calls and
#: some to spare, each root holding its CUDA events until it drops.
PROFILED_ROOTS = 256

try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:                               # pragma: no cover
    _Range = None

_profiling = torch._C._autograd._profiler_enabled

#: ``.tel``: the retaining Telemetry with a span open on this thread.
_OPEN = threading.local()


@dataclass
class Span:
    """One timed interval of the tree, in the telemetry clock's seconds."""

    name: str
    t_start: float
    t_end: float | None = None
    attrs: dict = field(default_factory=dict)
    children: list = field(default_factory=list)
    thread: int = 0
    #: The (start, stop) CUDA events of a device-timed span until read.
    _events: tuple | None = field(default=None, repr=False, compare=False)
    _device_s: float | None = field(default=None, repr=False, compare=False)

    @property
    def duration(self) -> float:
        """Seconds (0.0 while the span is open)."""
        return 0.0 if self.t_end is None else self.t_end - self.t_start

    @property
    def device_seconds(self) -> float | None:
        """The span's device time: the seconds between its CUDA event pair
        on the stream its work launched on (the first read waits for the
        stop event, so read after the call's own synchronisation), the
        host duration on the CPU, None for a span opened without
        ``device=``."""
        if self._events is not None:
            start, stop = self._events
            stop.synchronize()
            self._device_s = start.elapsed_time(stop) / 1e3
            self._events = None
        return self._device_s

    def child(self, name: str, t_start: float, t_end: float,
              **attrs) -> "Span":
        """Attach an explicitly timed child."""
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
        """Plain JSON (the one-line exporter's span payload); a
        device-timed span adds ``device_seconds``."""
        doc = {
            "name": self.name,
            "start": self.t_start,
            "duration": self.duration,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }
        if self._events is not None or self._device_s is not None:
            doc["device_seconds"] = self.device_seconds
        return doc


class _NoSpan:
    """The span site of a call with spans off: enters and leaves, holds
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


#: ``with tel.span(...) if tel else NOSPAN:`` at an engine's span sites.
NOSPAN = _NoSpan()


class _Scope:
    """One open span of a :class:`Telemetry` (``Telemetry.span``)."""

    __slots__ = ("tel", "name", "attrs", "device", "sp", "parent", "prev",
                 "range", "start")

    def __init__(self, tel, name, attrs, device):
        self.tel, self.name, self.attrs = tel, name, attrs
        self.device = device
        self.range = self.start = None

    def __enter__(self) -> Span:
        tel = self.tel
        if _Range is not None and _profiling():
            self.range = _Range("tj::" + self.name)
            self.range.__enter__()
        dev = self.device
        if dev is not None and dev.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(dev))
        sp = self.sp = Span(self.name, t_start=tel.clock(), attrs=self.attrs,
                            thread=threading.get_ident())
        stack = tel._stack()
        self.parent = stack[-1] if stack else None
        stack.append(sp)
        if tel.retain:
            self.prev = getattr(_OPEN, "tel", None)
            _OPEN.tel = tel
        return sp

    def __exit__(self, *exc):
        tel, sp = self.tel, self.sp
        sp.t_end = tel.clock()
        if self.start is not None:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record(torch.cuda.current_stream(self.device))
            sp._events = (self.start, stop)
        elif self.device is not None:
            sp._device_s = sp.duration
        if self.range is not None:
            self.range.__exit__(None, None, None)
        tel._stack().pop()
        if tel.retain:
            _OPEN.tel = self.prev
            if self.parent is not None:
                self.parent.children.append(sp)
            else:
                with tel._lock:
                    tel._roots.append(sp)
                    del tel._roots[:-tel.max_roots]
        return False


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

    def span(self, name: str, *, device=None, **attrs):
        """A context manager that opens span ``name`` and yields its
        :class:`Span`.  ``device`` (a ``torch.device``) times the span on
        that device too (:attr:`Span.device_seconds`)."""
        return _Scope(self, name, attrs, device)

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


#: The process-wide sink of the spans a call records while a
#: ``torch.profiler`` collects and no retaining telemetry was given; the
#: benchmark's span readers read it after a traced stretch.
PROFILED = Telemetry(max_roots=PROFILED_ROOTS)


class NullTelemetry(Telemetry):
    """Times its spans but keeps none: the sink when no telemetry is
    passed, so an instrumented path costs a clock pair and never grows.
    While a profiler collects its spans go to :data:`PROFILED`."""

    retain = False

    def span(self, name: str, *, device=None, **attrs):
        if _profiling():
            return PROFILED.span(name, device=device, **attrs)
        return _Scope(self, name, attrs, device)


#: The shared discard-only sink.
NULL = NullTelemetry()


def active(telemetry=None) -> Telemetry | None:
    """Where an entry point's spans go: ``telemetry`` if it retains spans,
    else :data:`PROFILED` while a profiler collects, else None (spans
    off)."""
    if telemetry is not None and telemetry.retain:
        return telemetry
    return PROFILED if _profiling() else None


def sink() -> Telemetry | None:
    """Where an engine's spans go on this thread: the retaining telemetry
    with a span open here, else :data:`PROFILED` while a profiler
    collects, else None (spans off)."""
    tel = getattr(_OPEN, "tel", None)
    if tel is None and _profiling():
        return PROFILED
    return tel


def timed_blocking(fn, *args, telemetry=None, name: str = "execute",
                   device=None, **attrs):
    """THE synchronising timing bracket: run ``fn(*args)`` inside span
    ``name`` and return ``(result, span)``.

    On a CUDA ``device`` the call runs between two CUDA events on the
    current stream and the bracket synchronizes on the stop event (no
    synchronize before the start event): ``span.t_end = span.t_start +``
    the events' seconds, with ``clock="cuda_event"`` and the host wall in
    ``host_seconds``; ``device_seconds`` is the same number.  Otherwise
    the span's ends are the telemetry clock's (``clock="host"``).
    ``result.elapsed`` of every entry point is this span's
    ``duration``."""
    tel = telemetry if telemetry is not None else NULL
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        with tel.span(name, device=dev, clock="host", **attrs) as sp:
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
    sp._device_s = sp.duration
    sp.attrs["host_seconds"] = host
    return out, sp
