"""The numerical degradation ladder of the JAX package's
``resilience/degrade.py``: the residual gate

    rel_residual <= gate_tol * eps * n * kappa_inf   (capped at 0.5)

(eps of ``policy.gate_dtype`` when set, else of the dtype the caller
names; a NaN rel_residual always fails) and, on failure, the recovery
rungs:

  1. **refine**: Newton–Schulz refinement (``ops/refine.newton_schulz``) in
     at least fp32, on the inverse in hand.  Needs the initial residual
     below 1 to converge: a bf16-grade miss on an ill-conditioned matrix
     diverges here and falls through.
  2. **resolve**: a full re-solve at escalated precision (the caller's
     ``resolve``; the driver promotes sub-fp32 storage to fp32 and the bf16
     fused-update engine to its fp32 sibling).

The solve workloads (``linalg/``) have their own gate and ladder
(:func:`solve_gate_threshold`, :func:`solve_recover`): the κ-free normwise
backward error, then refine, repivot and resolve rungs.

Each rung is recorded on the returned ``recovery`` tuple with the JAX
package's keys, as a child span of ``recover`` (``refine``, ``repivot``,
``resolve``) and as a ``recovery_rung`` flight-recorder event, and counted
in ``tpu_jordan_torch_recovery_rungs_total``; a failed gate is counted in
``tpu_jordan_torch_residual_gate_failures_total`` and recorded as a
``residual_gate_failure`` event.  A ladder that exhausts without passing
raises :class:`~.policy.ResidualGateError`, never a silent wrong answer.
"""

from __future__ import annotations

import math

import torch

from ..config import real_dtype
from ..interop import resolve_dtype
from ..obs import metrics as _obs_metrics
from ..obs import recorder as _recorder
from ..obs.spans import NULL
from .policy import ResidualGateError, ResiliencePolicy

_M_RUNGS = _obs_metrics.counter(
    "tpu_jordan_torch_recovery_rungs_total",
    "degradation-ladder rungs executed (refine / repivot / resolve / "
    "re_invert), labeled by rung and outcome")
_M_GATE_FAIL = _obs_metrics.counter(
    "tpu_jordan_torch_residual_gate_failures_total",
    "solves whose residual gate failed and entered the recovery ladder")


def record_rung(rung: str, passed: bool, rel_residual: float,
                **fields) -> None:
    """One rung's counter increment and ``recovery_rung`` event."""
    outcome = "passed" if passed else "failed"
    _M_RUNGS.inc(rung=rung, outcome=outcome)
    _recorder.record("recovery_rung", rung=rung, outcome=outcome,
                     rel_residual=float(rel_residual), **fields)


def record_gate_failure(n: int, rel_residual: float, threshold: float,
                        **fields) -> None:
    """A failed gate's counter increment and ``residual_gate_failure``
    event, recorded before the first rung runs."""
    _M_GATE_FAIL.inc()
    _recorder.record("residual_gate_failure", n=n,
                     rel_residual=float(rel_residual),
                     threshold=float(threshold), **fields)


def gate_eps(dtype) -> float:
    """Machine epsilon of the gate's reference dtype (a torch dtype, a
    numpy dtype or a name such as ``"bfloat16"``); a complex dtype's is its
    component dtype's, as in the JAX package."""
    return float(torch.finfo(real_dtype(resolve_dtype(dtype))).eps)


def gate_threshold(policy: ResiliencePolicy, n: int, kappa: float,
                   dtype) -> float:
    """``gate_tol * eps * n * kappa``, with κ floored at 1 and capped at
    0.5: a rel residual ≥ 0.5 means ‖I−AX‖ ≈ ‖I‖, no inverse at all,
    whatever κ claims (the cap keeps the gate from passing a
    bf16-computed non-inverse).  A non-finite κ (corrupt inverse) yields
    NaN, which fails the gate."""
    eps = gate_eps(policy.gate_dtype if policy.gate_dtype is not None
                   else dtype)
    if not math.isfinite(kappa):
        return float("nan")
    return min(policy.gate_tol * eps * max(1, n) * max(1.0, kappa), 0.5)


def gate_passes(rel_residual: float, threshold: float) -> bool:
    """NaN-hostile comparison: any NaN (residual or threshold) fails."""
    return bool(rel_residual <= threshold) and math.isfinite(rel_residual)


def solve_gate_threshold(policy: ResiliencePolicy, n: int, dtype) -> float:
    """The residual gate of the solve workloads, on the normwise backward
    error ``‖A·X − B‖∞ / (‖A‖∞·‖X‖∞ + ‖B‖∞) <= gate_tol · eps · n``: κ-free
    (a backward-stable solve has a small backward error whatever the
    conditioning), with :func:`gate_threshold`'s 0.5 cap and
    ``gate_dtype`` override."""
    eps = gate_eps(policy.gate_dtype if policy.gate_dtype is not None
                   else dtype)
    return min(policy.gate_tol * eps * max(1, n), 0.5)


def backward_error(residual: float, norm_a: float, norm_x: float,
                   norm_b: float) -> float:
    """``residual / (norm_a·norm_x + norm_b)``, the residual itself when
    the denominator is 0."""
    denom = norm_a * norm_x + norm_b
    return residual / denom if denom else residual


def solve_recover(policy: ResiliencePolicy, tel=None, *, a, b, x, stats,
                  n: int, dtype, spd: bool, rerun, fresh,
                  workload: str = "solve"):
    """The solve workloads' gate and ladder (the JAX package's
    ``linalg/api.py::_solve_recover``).  ``stats`` is ``(residual, norm_a,
    norm_x, norm_b)`` of ``x`` against the caller's ``a`` and ``b``;
    ``rerun(a, r)`` runs the solve's own engine on a new right-hand side
    and ``fresh(a, b, spd)`` a fresh solve, each returning ``(x,
    singular)``.  The rungs, each a span under ``recover`` of ``tel``:

      1. **refine** (``policy.refine_steps > 0``): one pass of iterative
         refinement, X += A⁻¹(B − A·X) with the residual in at least fp32,
         through ``rerun``;
      2. **repivot** (under the spd promise only): a fresh solve with the
         condition-based pivoting (a broken promise is the one failure
         refinement cannot fix);
      3. **resolve** (``policy.escalate``, sub-fp32 storage only): a fresh
         solve in fp32.

    Every rung is judged at the gate of ``policy.gate_dtype`` or ``dtype``.
    Returns ``(x, stats, recovery)``; raises ResidualGateError when the
    ladder runs out."""
    from ..ops.residual import solve_residual_stats

    tel = tel if tel is not None else NULL
    threshold = solve_gate_threshold(policy, n, dtype)
    rel = backward_error(*stats)
    if gate_passes(rel, threshold):
        return x, stats, ()
    record_gate_failure(n, rel, threshold, workload=workload)
    recovery = []

    def judge(x2, singular, span, rung, **extra):
        stats2 = solve_residual_stats(a, x2, b)
        rel2 = backward_error(*stats2)
        passed = gate_passes(rel2, threshold)
        span.attrs.update(rel_residual=float(rel2), passed=passed)
        recovery.append({"rung": rung, "rel_residual_before": float(rel),
                         "rel_residual_after": float(rel2),
                         "passed": passed, **extra})
        record_rung(rung, passed, rel2, workload=workload)
        return passed and not bool(singular), stats2

    with tel.span("recover", n=n, workload=workload,
                  rel_residual=float(rel),
                  threshold=float(threshold)) as rsp:
        if policy.refine_steps > 0:
            with tel.span("refine", steps=1) as sp:
                work = torch.promote_types(a.dtype, torch.float32)
                xw = x.to(work)
                r = b.to(work) - a.to(work) @ xw
                d, dsing = rerun(a, r.to(a.dtype))
                x2 = xw + d.to(work)
                ok, stats2 = judge(x2, dsing, sp, "refine")
            if ok:
                rsp.attrs["recovered_by"] = "refine"
                return x2, stats2, tuple(recovery)
        if spd:
            with tel.span("repivot") as sp:
                x3, sing3 = fresh(a, b, False)
                ok, stats3 = judge(x3, sing3, sp, "repivot")
            if ok:
                rsp.attrs["recovered_by"] = "repivot"
                return x3, stats3, tuple(recovery)
        if policy.escalate and a.dtype.itemsize < 4:
            with tel.span("resolve") as sp:
                x4, sing4 = fresh(a.float(), b.float(), spd)
                ok, stats4 = judge(x4, sing4, sp, "resolve",
                                   dtype=str(x4.dtype)[6:])
            if ok:
                rsp.attrs["recovered_by"] = "resolve"
                return x4, stats4, tuple(recovery)
    raise ResidualGateError(
        f"solve residual gate failed (rel {rel:.3e} > {threshold:.3e}) "
        f"and the recovery ladder exhausted "
        f"({' -> '.join(r['rung'] for r in recovery) or 'no rungs'})",
        recovery=tuple(recovery))


def maybe_recover(policy: ResiliencePolicy, tel=None, *, a_fresh, inv,
                  residual: float, norm_a: float, kappa: float, n: int,
                  dtype, resolve):
    """The driver's post-residual hook: run the gate and, on failure, the
    ladder, each rung a span under ``recover`` of ``tel``.

    ``a_fresh`` is the freshly re-loaded A the residual was verified
    against; ``resolve`` is a zero-argument callable that runs the
    escalated re-solve and returns a ``SolveResult`` (the driver runs it
    under the same telemetry, so its spans nest under ``resolve``).
    Returns ``(inv, residual, norm_a, kappa, recovery)``; ``recovery`` is
    empty when the gate passed outright.  A refined or re-solved inverse
    is returned at the precision that produced it (fp32 after a refine of
    a bf16 solve).
    """
    tel = tel if tel is not None else NULL
    rel = residual / norm_a if norm_a else residual
    threshold = gate_threshold(policy, n, kappa, dtype)
    if gate_passes(rel, threshold):
        return inv, residual, norm_a, kappa, ()

    record_gate_failure(n, rel, threshold)
    recovery = []
    with tel.span("recover", n=n, rel_residual=float(rel),
                  threshold=float(threshold)) as rsp:
        if policy.refine_steps > 0:
            with tel.span("refine", steps=policy.refine_steps) as sp:
                inv2, res2, norm2, kap2 = _refine(a_fresh, inv,
                                                  policy.refine_steps)
                rel2 = res2 / norm2 if norm2 else res2
                # Judged at the refine work dtype (>= fp32, never below
                # the request) unless the policy pins a gate_dtype.
                passed = gate_passes(rel2, gate_threshold(
                    policy, n, kap2, inv2.dtype))
                sp.attrs.update(rel_residual=float(rel2), passed=passed)
            recovery.append({
                "rung": "refine", "steps": policy.refine_steps,
                "rel_residual_before": float(rel),
                "rel_residual_after": float(rel2), "passed": passed,
            })
            record_rung("refine", passed, rel2)
            if passed:
                rsp.attrs["recovered_by"] = "refine"
                return inv2, res2, norm2, kap2, tuple(recovery)

        if policy.escalate:
            with tel.span("resolve") as sp:
                res = resolve()
                rel3 = res.rel_residual
                passed = gate_passes(rel3, gate_threshold(
                    policy, n, res.kappa, res.inverse.dtype))
                sp.attrs.update(rel_residual=float(rel3), passed=passed,
                                dtype=str(res.inverse.dtype)[6:])
            recovery.append({
                "rung": "resolve", "dtype": str(res.inverse.dtype)[6:],
                "rel_residual_before": float(rel),
                "rel_residual_after": float(rel3), "passed": passed,
            })
            record_rung("resolve", passed, rel3)
            if passed:
                rsp.attrs["recovered_by"] = "resolve"
                return (res.inverse, res.residual, res._norm_a, res.kappa,
                        tuple(recovery))

    raise ResidualGateError(
        f"residual gate failed (rel {rel:.3e} > {threshold:.3e}) and "
        f"the recovery ladder exhausted "
        f"({' -> '.join(r['rung'] for r in recovery) or 'no rungs'})",
        recovery=tuple(recovery))


def _refine(a_fresh, inv, steps: int):
    """Newton–Schulz in the solve's working dtype, at least fp32 and never
    below the request; returns the refreshed (inv, residual, norm_a,
    kappa) at that dtype."""
    from ..ops import inf_norm, newton_schulz, residual_inf_norm

    work = torch.promote_types(a_fresh.dtype, torch.float32)
    aw = a_fresh.to(work)
    xw = newton_schulz(aw, inv.to(work), steps)
    residual = float(residual_inf_norm(aw, xw))
    norm_a = float(inf_norm(aw))
    kappa = norm_a * float(inf_norm(xw))
    return xw, residual, norm_a, kappa
