"""Per-superstep numerical health.  Counterpart of the JAX package's
``obs/numerics.py``.

The paper's two signals, the condition-based pivot criterion (the ∞-norm
of each candidate block's inverse, main.cpp:1026-1074) and the final
residual ‖A·A⁻¹ − I‖∞ (main.cpp:490-513), are computed on every solve and
discarded after one comparison.  This module keeps them, behind the
``numerics=`` knob of the entry points:

  * ``"off"`` (the default): nothing collected, nothing observed.
  * ``"summary"``: a :class:`NumericsReport` from numbers the solve
    already returns (rel_residual, κ∞, ‖A‖∞); no extra device work.
  * ``"trace"``: the per-superstep record of the engine run with
    ``collect_stats=True`` (``ops/jordan_inplace.py::_StepStats``, kept on
    the device until the end of the run): per step the chosen pivot block,
    the ∞-norm of its inverse (the step's key minimum), the worst finite
    candidate norm, the singular-candidate count and the running growth
    watermark max|V|.  The pivot sequence is the uninstrumented run's.

Every non-off report is mirrored into the ``tpu_jordan_torch_residual``,
``_pivot_condition`` and ``_growth_factor`` histograms, and threshold
exceedances are recorded as ``numerics_spike`` flight-recorder events
BEFORE the degradation ladder runs, so every ``recovery_rung`` event is
preceded by the evidence that explains it (``tools/check_numerics.py``).

The per-step ``residual_est`` (eps·n·growth/‖A‖∞) is the one MODELED
field, named in ``NumericsReport.modeled_fields``; everything else is read
off the executed solve.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from . import metrics as _metrics
from . import recorder as _recorder

MODES = ("off", "summary", "trace")

#: The modeled per-step residual estimate: rel_residual ≈ eps·n·growth
#: (Higham, Accuracy and Stability, ch. 14).
_EST_NOTE = "eps*n*growth/norm_a (modeled; Higham-style growth bound)"


def resolve_mode(mode) -> str:
    """Validate the ``numerics=`` knob (None means "off")."""
    if mode is None:
        return "off"
    if mode not in MODES:
        from ..errors import UsageError

        raise UsageError(f"unknown numerics mode {mode!r}; choose from "
                         f"{'/'.join(MODES)}")
    return mode


_M_PIVOT = _metrics.histogram(
    "tpu_jordan_torch_pivot_condition",
    "per-superstep ∞-norm of the CHOSEN pivot block inverse — the "
    "paper's selection criterion (main.cpp:1026-1074); trace mode only")
_M_GROWTH = _metrics.histogram(
    "tpu_jordan_torch_growth_factor",
    "element-growth watermark max|V|/‖A‖∞ of the working matrix over "
    "the elimination; trace mode only")
_M_RESIDUAL = _metrics.histogram(
    "tpu_jordan_torch_residual",
    "verified relative residual ‖A·X−I‖∞/‖A‖∞ per solve (summary and "
    "trace modes)")
_M_SPIKES = _metrics.counter(
    "tpu_jordan_torch_numerics_spikes_total",
    "numerics threshold exceedances recorded as flight-recorder "
    "events, labeled by signal")


@dataclass
class NumericsReport:
    """One solve's numerical health record (``SolveResult.numerics``).
    The per-step lists are set in ``"trace"`` mode only; ``modeled_fields``
    names the fields that come from an error model."""

    mode: str
    n: int
    block_size: int
    engine: str
    rel_residual: float
    kappa: float
    norm_a: float
    eps: float
    #: "invert", or a solve workload, whose rel_residual is the κ-free
    #: backward error and whose ``kappa`` is the ‖A‖‖X‖/‖B‖ estimate.
    workload: str = "invert"
    trace_engine: str | None = None
    pivot_block: list | None = None
    pivot_inv_norm: list | None = None
    cand_norm_max: list | None = None
    singular_candidates: list | None = None
    growth: list | None = None
    residual_est: list | None = None
    residual_est_model: str = _EST_NOTE
    modeled_fields: tuple = ("residual_est",)
    spikes: list = field(default_factory=list)

    @property
    def growth_factor(self) -> float | None:
        """The final growth watermark over ‖A‖∞."""
        if not self.growth or not self.norm_a:
            return None
        return float(self.growth[-1]) / self.norm_a

    @property
    def max_pivot_inv_norm(self) -> float | None:
        vals = [v for v in (self.pivot_inv_norm or ())
                if math.isfinite(v)]
        return max(vals) if vals else None

    @property
    def pivot_spread_max(self) -> float | None:
        """The worst per-step spread: the largest finite candidate norm
        over the chosen one."""
        if not self.pivot_inv_norm:
            return None
        spreads = [mx / mn for mn, mx in zip(self.pivot_inv_norm,
                                             self.cand_norm_max)
                   if math.isfinite(mn) and math.isfinite(mx) and mn > 0]
        return max(spreads) if spreads else None

    def to_json(self) -> dict:
        doc = {
            "mode": self.mode, "n": self.n,
            "block_size": self.block_size, "engine": self.engine,
            "workload": self.workload,
            "rel_residual": self.rel_residual, "kappa": self.kappa,
            "norm_a": self.norm_a, "eps": self.eps,
            "spikes": list(self.spikes),
        }
        if self.mode == "trace":
            doc.update({
                "trace_engine": self.trace_engine,
                "pivot_block": self.pivot_block,
                "pivot_inv_norm": self.pivot_inv_norm,
                "cand_norm_max": self.cand_norm_max,
                "singular_candidates": self.singular_candidates,
                "growth": self.growth,
                "growth_factor": self.growth_factor,
                "max_pivot_inv_norm": self.max_pivot_inv_norm,
                "pivot_spread_max": self.pivot_spread_max,
                "residual_est": self.residual_est,
                "residual_est_model": self.residual_est_model,
                "modeled_fields": list(self.modeled_fields),
            })
        return doc


def _eps(dtype) -> float:
    import torch

    from ..config import real_dtype
    from ..interop import resolve_dtype

    return float(torch.finfo(real_dtype(resolve_dtype(dtype))).eps)


def _host(values, kind):
    import torch

    if not isinstance(values, torch.Tensor):
        return [kind(v) for v in values]
    return [kind(v) for v in values.detach().to("cpu",
                                                torch.float64).tolist()]


def summary_report(*, n: int, block_size: int, engine: str,
                   rel_residual: float, kappa: float, norm_a: float,
                   dtype, workload: str = "invert") -> NumericsReport:
    """``"summary"`` mode: only what the solve already returned."""
    return NumericsReport(
        mode="summary", n=n, block_size=block_size, engine=engine,
        rel_residual=float(rel_residual), kappa=float(kappa),
        norm_a=float(norm_a), eps=_eps(dtype), workload=workload)


def trace_report(stats: dict, *, n: int, block_size: int, engine: str,
                 trace_engine: str, rel_residual: float, kappa: float,
                 norm_a: float, dtype,
                 workload: str = "invert") -> NumericsReport:
    """``"trace"`` mode: the engine's stacked per-superstep record
    (``_StepStats.stacked()``, read to the host here, once) and the
    verified end state; the modeled ``residual_est`` is derived on the
    host."""
    rep = summary_report(n=n, block_size=block_size, engine=engine,
                         rel_residual=rel_residual, kappa=kappa,
                         norm_a=norm_a, dtype=dtype, workload=workload)
    rep.mode = "trace"
    rep.trace_engine = trace_engine
    rep.pivot_block = _host(stats["pivot_block"], int)
    rep.pivot_inv_norm = _host(stats["pivot_inv_norm"], float)
    rep.cand_norm_max = _host(stats["cand_norm_max"], float)
    rep.singular_candidates = _host(stats["singular_candidates"], int)
    rep.growth = _host(stats["growth"], float)
    na = rep.norm_a if rep.norm_a else 1.0
    rep.residual_est = [rep.eps * n * g / na for g in rep.growth]
    return rep


def observe(report: NumericsReport) -> None:
    """Mirror a report into the registry (engine-labeled series); the
    trace-only signals only where measured."""
    if math.isfinite(report.rel_residual):
        labels = {"engine": report.engine}
        if report.workload != "invert":
            labels["workload"] = report.workload
        _M_RESIDUAL.observe(report.rel_residual, **labels)
    if report.mode != "trace":
        return
    for v in report.pivot_inv_norm or ():
        if math.isfinite(v):
            _M_PIVOT.observe(v, engine=report.engine)
    gf = report.growth_factor
    if gf is not None and math.isfinite(gf):
        _M_GROWTH.observe(gf, engine=report.engine)


@dataclass(frozen=True)
class SpikeThresholds:
    """When a health signal becomes a flight-recorder event.

    ``residual``: None means eps·n·max(1, κ∞) capped at 0.5; the entry
    points pass the policy's own gate threshold when a policy is attached,
    so a gate failure never outruns its spike.  ``pivot_condition`` fires
    on ‖H‖∞·‖A‖∞ above 1/sqrt(eps) (None); ``growth`` on the growth
    factor."""

    residual: float | None = None
    pivot_condition: float | None = None
    growth: float = 1e3

    def residual_threshold(self, rep: NumericsReport) -> float:
        if self.residual is not None:
            return self.residual
        kap = rep.kappa if math.isfinite(rep.kappa) else float("inf")
        return min(rep.eps * max(1, rep.n) * max(1.0, kap), 0.5)

    def pivot_threshold(self, rep: NumericsReport) -> float:
        if self.pivot_condition is not None:
            return self.pivot_condition
        return 1.0 / math.sqrt(rep.eps)


def record_spikes(report: NumericsReport,
                  thresholds: SpikeThresholds | None = None,
                  recorder=None) -> list[dict]:
    """One ``numerics_spike`` event per exceedance (also appended to
    ``report.spikes``, and returned).  Called BEFORE the ladder runs."""
    thr = thresholds if thresholds is not None else SpikeThresholds()
    rec = recorder if recorder is not None else _recorder.record
    spikes = []

    def spike(signal: str, value: float, threshold: float, **extra):
        ev = {"signal": signal, "value": float(value),
              "threshold": float(threshold), **extra}
        spikes.append(ev)
        _M_SPIKES.inc(signal=signal)
        rec("numerics_spike", n=report.n, engine=report.engine,
            mode=report.mode, **ev)

    rthr = thr.residual_threshold(report)
    rel = report.rel_residual
    if not math.isfinite(rel) or rel > rthr:
        spike("residual", rel, rthr)
    if report.mode == "trace":
        pthr = thr.pivot_threshold(report)
        for t, v in enumerate(report.pivot_inv_norm or ()):
            cond = v * report.norm_a
            if not math.isfinite(cond) or cond > pthr:
                spike("pivot_condition", cond, pthr, step=t,
                      pivot_block=report.pivot_block[t])
        gf = report.growth_factor
        if gf is not None and (not math.isfinite(gf) or gf > thr.growth):
            spike("growth", gf, thr.growth)
    report.spikes.extend(spikes)
    return spikes


def record_drift_spike(*, n: int, engine: str, value: float,
                       threshold: float, recorder=None) -> dict:
    """The resident update's accumulated-drift budget exceedance as a
    ``numerics_spike`` (signal "drift"): the breadcrumb of a
    ``re_invert`` rung that composition fired while each update passed
    the gate on its own."""
    rec = recorder if recorder is not None else _recorder.record
    ev = {"signal": "drift", "value": float(value),
          "threshold": float(threshold)}
    _M_SPIKES.inc(signal="drift")
    rec("numerics_spike", n=n, engine=engine, mode="summary",
        workload="update", **ev)
    return ev


def ill_conditioned(n: int, kappa_decades: float = 4.5,
                    seed: int = 7):
    """A well-scaled dense matrix with κ∞ ≈ 10^``kappa_decades``: a graded
    diagonal between two random orthogonal factors (numpy, the JAX
    package's recipe)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q1 * np.logspace(0, -kappa_decades, n)) @ q2


def numerics_demo(n: int = 16, block_size: int = 8, seed: int = 7,
                  kappa_decades: float = 4.5, workload: str = "invert",
                  device=None) -> dict:
    """The observatory's acceptance run: a seeded ill-conditioned solve at
    bf16 storage under ``ResiliencePolicy(gate_dtype="float32")``, on the
    card unless ``device="cpu"``.

    ``workload="invert"``: ``driver.solve`` with ``numerics="trace"`` (the
    matrix handed over in memory; every reload re-reads it from the host):
    the bf16-grade residual fails the fp32 gate, refine diverges and the
    fp32 re-solve passes.  ``workload="solve"``: ``linalg.solve_system``
    with ``numerics="summary"`` on the same fixture.  Either way the
    flight recorder holds the ``numerics_spike`` events before the
    ``residual_gate_failure``/``recovery_rung`` events they explain.
    Returns the one-line JSON report ``tools/check_numerics.py`` validates
    (exit 2: a rung with no preceding spike)."""
    import numpy as np
    import torch

    from ..interop import from_numpy, resolve_device
    from ..resilience import ResiliencePolicy
    from .spans import Telemetry

    if workload not in ("invert", "solve"):
        from ..errors import UsageError

        raise UsageError(f"--numerics-demo supports workload "
                         f"invert/solve, not {workload!r}")
    dev = resolve_device(device)
    mark = _recorder.RECORDER.total
    tel = Telemetry()
    policy = ResiliencePolicy(gate_dtype="float32")
    a = ill_conditioned(n, kappa_decades, seed)
    if workload == "solve":
        from ..linalg import solve_system

        b = np.random.default_rng(seed + 1).standard_normal((n, 2))
        res = solve_system(a, b, block_size=block_size,
                           dtype=torch.bfloat16, policy=policy,
                           telemetry=tel, numerics="summary", device=dev)
    else:
        from ..driver import _solve_traced

        res = _solve_traced(
            n, block_size, lambda dt: from_numpy(a, dev, dt), None,
            dtype=torch.bfloat16, device=dev, policy=policy,
            telemetry=tel, numerics="trace")

    blackbox = _recorder.RECORDER.dump(
        events=_recorder.RECORDER.since(mark))
    events = blackbox["events"]
    spike_seqs = [e["seq"] for e in events
                  if e["kind"] == "numerics_spike"]
    unexplained = [
        e for e in events
        if e["kind"] in ("recovery_rung", "residual_gate_failure")
        and not any(s < e["seq"] for s in spike_seqs)]
    rep = res.numerics
    return {
        "metric": "numerics_demo",
        "workload": workload,
        "n": n, "block_size": block_size, "seed": seed,
        "kappa_decades": kappa_decades,
        "engine": res.engine,
        "device": str(dev),
        "numerics": rep.to_json() if rep is not None else None,
        "recovery": [dict(r) for r in res.recovery],
        "rel_residual": res.rel_residual,
        "spike_count": len(spike_seqs),
        "rung_count": sum(1 for e in events
                          if e["kind"] == "recovery_rung"),
        "unexplained_rungs": [
            {"kind": e["kind"], "seq": e["seq"]} for e in unexplained],
        "silent_rung": bool(unexplained),
        "blackbox": blackbox,
    }
