"""Reduction of a ``torch.profiler`` trace to what the readers take.

The bucket rule and the interval union are the arithmetic of the port's
``profile_solve.py`` (``_kind``, ``_union_us``), copied so that the
benchmark does not depend on a module of the program.  Times in the trace
are microseconds; everything returned here is in seconds.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

KINDS = ("probe", "update", "gemm", "other")


def kind(name: str) -> str:
    """The bucket of a device operation: the two hand-written kernel
    families by name, cuBLAS (gemm, cutlass, xmma), everything else."""
    low = name.lower()
    if "gj_probe" in low:
        return "probe"
    if "fused_update" in low:
        return "update"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    return "other"


def is_kernel(name: str) -> bool:
    """A kernel launch, as against a copy or a fill on the device."""
    return not name.startswith(("Memcpy", "Memset"))


def union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short_name(name: str) -> str:
    """A device operation's name without its return type and argument
    list."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return head.strip().removeprefix("void ").strip() or name


@dataclass
class Profile:
    """The device and host operations of a traced stretch of calls.

    ``device``: (name, start_us, end_us) of every operation that ran on
    the device; ``host``: the same of the host's operations (aten ops and
    CUDA runtime calls); ``calls``: the calls traced; ``window_s``: the
    host clock's length of the traced stretch."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    calls: int = 0
    window_s: float = 0.0

    @property
    def kernels(self) -> list:
        return [d for d in self.device if is_kernel(d[0])]

    @property
    def busy_s(self) -> float:
        return union((a, b) for _, a, b in self.device) / 1e6

    def seconds_by_kind(self) -> dict[str, float]:
        out = dict.fromkeys(KINDS, 0.0)
        for name, a, b in self.kernels:
            out[kind(name)] += (b - a) / 1e6
        return out

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: [name, seconds]."""
        total: dict[str, float] = {}
        for name, a, b in self.device:
            key = short_name(name)
            total[key] = total.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time between device operations, summed by what the host
        was doing at each gap's middle (the innermost host operation that
        spans it; "host: untraced" where none does): [name, seconds]."""
        busy = merged((a, b) for _, a, b in self.device)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        total: dict[str, float] = {}
        for (_, end), (start, _) in zip(busy, busy[1:]):
            mid = 0.5 * (end + start)
            label = "host: untraced"
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(-1, i - 4096), -1):
                if host[j][2] >= mid:
                    label = host[j][0]
                    break
            total[label] = total.get(label, 0.0) + (start - end) / 1e6
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def from_profiler(prof, calls: int, window_s: float) -> Profile:
    """A :class:`Profile` from a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = Profile(calls=calls, window_s=window_s)
    for evt in prof.events():
        rec = (evt.name, float(evt.time_range.start),
               float(evt.time_range.end))
        (out.device if evt.device_type == cuda else out.host).append(rec)
    return out
