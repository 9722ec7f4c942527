"""One run of one cell: set-up, the measured window, the trace, the
judgement, the result line.

A run is a closed loop with one caller: each call is made once the
previous call's result is synchronised.  Calls cycle over a pool of
inputs drawn from the seed (``inputs.py``); the engines leave their input
as it was, so no copy is made inside the window.  Each call is timed by
the host clock and by CUDA events recorded on the stream around it.  With
``--trace 1`` the window is followed by a stretch of calls under
``torch.profiler``.  After the window (and trace) the peak memory is read,
the program's state is let go, and the plain reference judges every
call's singular flag and a sample of the answers drawn from the seed.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from dataclasses import dataclass, field

import torch

from . import inputs, reference, spec, trace, work

#: Top-level modules that no run may load (the JAX package and JAX).
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_jordan")
#: A singular flag is judged where the reference's margin (``reference.
#: invert``) lies outside [1/BAND, BAND]: inside it the verdict turns on
#: the rounding of a pivot within a factor of 10 of the threshold, which
#: two correct implementations need not share (one flag in about 40
#: fp32 matrices at 16384/m128 on the card).
BAND = 10.0


class NoDevice(RuntimeError):
    """The run found fewer cards than its cell asks for."""


class Forbidden(RuntimeError):
    """The run's process loaded JAX or the JAX package."""


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared as
    whole names (``tpu_jordan_torch`` is not ``tpu_jordan``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def require_cards(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} found")


class _Clock:
    """CUDA events around each call on a card; the host clock on the CPU
    (tests only)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        evt = torch.cuda.Event(enable_timing=True)
        evt.record()
        return evt

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, start, stop) -> float:
        if self.cuda:
            return float(start.elapsed_time(stop))
        return (stop - start) * 1e3


@dataclass
class Window:
    """What the measured window recorded."""

    host_s: list = field(default_factory=list)
    event_ms: list = field(default_factory=list)
    pool_index: list = field(default_factory=list)
    flags: list = field(default_factory=list)
    #: The judged sample: (call index, answer) pairs.
    sample: list = field(default_factory=list)
    window_s: float = 0.0

    @property
    def calls(self) -> int:
        return len(self.host_s)


@dataclass
class Run:
    """Everything a metric reader may read."""

    cell: spec.Cell
    setup_s: float
    window: Window
    work_per_call: float
    peaks: dict | None
    profile: trace.Profile | None = None


@dataclass
class Checks:
    """The numbers compared, each with its limit."""

    residual_ratio: float
    residual_ratio_limit: float
    singular_mismatches: int
    judged: int
    failed: int
    #: The worst judged matrix's ratio, its answer's residual and the
    #: reference's (for the record; not compared).
    worst_ratio: float = math.nan
    residual: float = math.nan
    reference_residual: float = math.nan
    #: Each pool matrix's singularity margin (the least over a stack).
    margins: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return (self.residual_ratio <= self.residual_ratio_limit
                and self.singular_mismatches == 0)

    def as_dict(self) -> dict:
        return {"residual_ratio": {"value": self.residual_ratio,
                                   "limit": self.residual_ratio_limit},
                "singular_mismatches": {"value": self.singular_mismatches,
                                        "limit": 0}}


class Session:
    """The program driven for one cell in one process: the entry is built
    once, and any number of seeds can be run through it (a benchmark run
    takes one; the calibration of the limits takes many)."""

    def __init__(self, cell: spec.Cell, device="cuda", entry=None):
        self.cell = cell
        self.device = torch.device(device)
        self.dtype = inputs.DTYPES[cell.dtype_name]
        if self.device.type == "cuda":
            tf32 = bool(cell.config.get("tf32", False))
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
        self.entry = entry if entry is not None else spec.entry_module(
            cell.traffic["entry"]).make(cell, self.device)
        self.clock = _Clock(self.device)

    def pool(self, seed: int) -> list[torch.Tensor]:
        c = self.cell
        return [inputs.matrix(seed, j, c.batch, c.n, self.dtype, self.device)
                for j in range(int(c.traffic["pool"]))]

    def warm(self, pool) -> None:
        """Every shape of the window, with as many answers held as the
        window holds (the judged sample and the call in flight), so that
        the allocator has grown before the window opens."""
        held = [self.entry(pool[i % len(pool)])
                for i in range(int(self.cell.traffic["judge_sample"]) + 1)]
        self.clock.sync()
        del held

    def window(self, pool, seconds: float, seed: int,
               min_calls: int = 1) -> Window:
        """Calls in a closed loop until ``seconds`` have passed (and at
        least ``min_calls`` were made); a reservoir drawn from the seed
        keeps ``judge_sample`` answers for the judgement."""
        keep = int(self.cell.traffic["judge_sample"])
        rng = inputs.sampler(seed)
        marks, w = [], Window()
        clock = self.clock
        start = time.perf_counter()
        i = 0
        while True:
            j = i % len(pool)
            t0 = time.perf_counter()
            e0 = clock.mark()
            out, flags = self.entry(pool[j])
            e1 = clock.mark()
            clock.sync()
            t1 = time.perf_counter()
            w.host_s.append(t1 - t0)
            marks.append((e0, e1))
            w.pool_index.append(j)
            w.flags.append(flags)
            if i < keep:
                w.sample.append((i, out))
            else:
                slot = rng.randrange(i + 1)
                if slot < keep:
                    w.sample[slot] = (i, out)
            del out
            i += 1
            if t1 - start >= seconds and i >= min_calls:
                w.window_s = t1 - start
                break
        w.event_ms = [clock.ms(a, b) for a, b in marks]
        return w

    def profile(self, pool, calls: int) -> trace.Profile:
        """``calls`` calls under ``torch.profiler``, after one call under a
        throw-away profiler (the tracer's own start-up)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with warnings.catch_warnings():
            # The profiler's note that each profile keeps its own events.
            warnings.filterwarnings("ignore", message=".*clears events")
            with profile(activities=acts):
                self.entry(pool[0])
                self.clock.sync()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for i in range(calls):
                    self.entry(pool[i % len(pool)])
                    self.clock.sync()
                window_s = time.perf_counter() - t0
        return trace.from_profiler(prof, calls, window_s)

    def close(self) -> None:
        close = getattr(self.entry, "close", None)
        if close is not None:
            close()
        self.entry = None


def judge(cell: spec.Cell, seed: int, w: Window, device) -> Checks:
    """The reference's judgement of a window.  For each pool matrix the
    window used, the reference's own inverse in the configuration's
    arithmetic gives the singular verdict, its margin, and the residual to
    compare with; every call's singular flag is held to the verdict where
    the margin is decisive (``BAND``); the residual ratio is the median,
    over the sampled answers' matrices that the reference can invert, of
    the answer's residual over the reference's (``reference.py``)."""
    dtype = inputs.DTYPES[cell.dtype_name]
    device = torch.device(device)
    eps = float(cell.config["singular_eps"])
    r_ref, margin = {}, {}
    for j in sorted(set(w.pool_index)):
        a = inputs.matrix(seed, j, cell.batch, cell.n, dtype, device)
        x, mj = reference.invert(a, cell.block_size, cell.dtype_name, eps)
        r_ref[j] = reference.residuals(a, x).tolist()
        margin[j] = mj.tolist()
        del a, x
    mismatches = 0
    for j, flags in zip(w.pool_index, w.flags):
        for flag, mu in zip(flags.reshape(-1).tolist(), margin[j]):
            decisive = not 1.0 / BAND <= mu <= BAND
            mismatches += int(decisive and flag != (mu < 1.0))
    ratios, worst = [], (0.0, math.nan, math.nan)
    for i, out in sorted(w.sample, key=lambda s: s[0]):
        j = w.pool_index[i]
        a = inputs.matrix(seed, j, cell.batch, cell.n, dtype, device)
        r = reference.residuals(a, out.reshape(a.shape)).tolist()
        for rk, ref, mu in zip(r, r_ref[j], margin[j]):
            # A matrix the reference finds singular has no inverse to judge.
            if mu < 1.0:
                continue
            q = rk / ref if rk == rk else math.inf
            ratios.append(q)
            if q > worst[0]:
                worst = (q, rk, ref)
        del a
    median = statistics.median(ratios) if ratios else 0.0
    limit = float(cell.limits["residual_ratio"])
    return Checks(residual_ratio=median, residual_ratio_limit=limit,
                  singular_mismatches=mismatches, judged=len(ratios),
                  failed=mismatches + int(not median <= limit),
                  worst_ratio=worst[0], residual=worst[1],
                  reference_residual=worst[2],
                  margins=[min(m) for _, m in sorted(margin.items())])


def profile_calls(w: Window) -> int:
    """Calls traced: about a second of them at the window's median call
    time, 3 to 64."""
    med_s = sorted(w.event_ms)[len(w.event_ms) // 2] / 1e3
    return max(3, min(math.ceil(1.0 / max(med_s, 1e-6)), 64))


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def read_metrics(run: Run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device="cuda", entry=None) -> dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    if torch.device(device).type == "cuda":
        require_cards(cell.chips)
    marks = [("imports", time.perf_counter())]
    session = Session(cell, device, entry)
    marks.append(("solver", time.perf_counter()))
    pool = session.pool(seed)
    session.clock.sync()
    marks.append(("inputs", time.perf_counter()))
    session.warm(pool)
    marks.append(("warm", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    split, last = {}, t_start
    for stage, t in marks:
        split[stage] = t - last
        last = t
    w = session.window(pool, seconds, seed)
    cuda = session.device.type == "cuda"
    prof = session.profile(pool, profile_calls(w)) if traced else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    session.close()
    del pool, session
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise Forbidden("modules that no run may load were loaded: "
                        + ", ".join(found))
    checks = judge(cell, seed, w, device)
    run = Run(cell=cell, setup_s=setup_s, window=w,
              work_per_call=work.invert_flops(cell.n, cell.batch),
              peaks=work.peaks(name), profile=prof)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": checks.correct, "attempted": w.calls,
              "failed": checks.failed,
              "metrics": read_metrics(
                  run, cell.per_layer if traced else cell.end_to_end),
              "device": dev}
    if traced:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
        result["breakdown"] = {"device_ops": prof.device_ops(),
                               "idle_gaps": prof.idle_gaps()}
    if cuda:
        dev["power_limit"] = power_limit()
    result["setup_split_s"] = split
    result["judged"] = checks.judged
    result["worst_ratio"] = checks.worst_ratio
    result["checks"] = checks.as_dict()
    return result


def _finite(x):
    """``x`` with every float that is not finite (an answer that held a
    NaN, say) as its name, so the line stays strict JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="gpubench/run.py",
        description="Run one cell of BENCHMARK.json and print one JSON "
                    "line of results last.")
    ap.add_argument("--workload", required=True,
                    help="the cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: report the per-layer metrics from a traced "
                         "stretch after the window")
    args = ap.parse_args(argv)
    try:
        cell = spec.load_cell(args.workload)
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          t_start)
    except (spec.SpecError, NoDevice, Forbidden) as exc:
        print(f"gpubench: {exc}", file=sys.stderr)
        return 2
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0
