"""Sherman–Morrison–Woodbury rank-k updates of a resident inverse.

Given A⁻¹ and a rank-k mutation A ← A + U·Vᵀ, the inverse follows by

    (A + U·Vᵀ)⁻¹ = A⁻¹ − A⁻¹U · (I + VᵀA⁻¹U)⁻¹ · VᵀA⁻¹

at ~4n²k + O(nk²) flops (:func:`update_flops`) instead of a fresh ~(8/3)n³
elimination.  The k×k *capacitance* system S = I + VᵀA⁻¹U is solved by the
port's own ``block_jordan_solve``: its probe on the card is
``csrc/gj_probe.cu`` at k=16 (m=8 has no panel width) and
``gj_probe_fused_panel.cu`` at k=64 (m=16) in a real dtype, and
``gj_probe.cu``'s complex body at every k in a complex one.  Its singular
flag is the mutated matrix's singularity
signal (det(A + UVᵀ) = det(A)·det(S)), typed out, never garbage.  Complex
dtypes use the plain transpose throughout (the identity as written; a
Hermitian update is the caller's U = conj(V)).

:func:`smw_update_with_metrics` mutates A, updates the inverse and
re-verifies ‖A_new·X_new − I‖∞ against the mutated matrix
(``driver.batch_metrics``); :func:`smw_update_batched_with_metrics` does so
for a stack of distinct resident pairs (the serve update lanes' executor,
one pair at batch cap 1), with one capacitance probe call a superstep for
the stack.  Per-update residuals accumulate into a drift budget
(:func:`drift_budget`): past ``DRIFT_BUDGET_FACTOR`` gate-widths, or on a
failed gate, :func:`solve_update` with a policy fires the "re_invert" rung,
a fresh elimination of the mutated matrix that resets the drift.

Zero-padded columns of U and V are exact: they add nothing to U·Vᵀ, make
the capacitance [[S, 0], [0, I]] and drop out of the correction.

:func:`solve_update` takes ``telemetry`` (a ``solve_update`` span with
``execute`` and, on a rung, ``recover``/``re_invert``), ``numerics=
"summary"`` (spiked before the rung, with a ``drift`` spike when the
budget fires it), counts in ``tpu_jordan_torch_workload_requests_total``
as ``update`` and puts the analytical rate of :func:`update_flops` on its
execute span.  It crosses the ``compile``, ``execute`` and
``result_corrupt_nan`` fault points (``resilience/faults.py``) as the JAX
package's does.  Counterpart of the JAX package's ``linalg/update.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..driver import batch_metrics
from ..errors import SingularMatrixError, UsageError
from ..interop import from_numpy, resolve_device, resolve_dtype
from ..obs import hwcost as _hwcost
from ..obs import metrics as _obs_metrics
from ..obs.spans import NULL as _NULL_TEL
from ..obs.spans import timed_blocking
from ..ops.jordan_inplace import _SUB_FP32
from ..resilience import faults as _faults
from ..resilience.policy import ResiliencePolicy
from .engine import block_jordan_solve, block_jordan_solve_batched

#: How many gate-widths of accumulated per-update drift a resident inverse
#: may carry before the "re_invert" rung fires even though the latest
#: update passed the gate on its own.
DRIFT_BUDGET_FACTOR = 4.0


def update_flops(n: int, k: int) -> float:
    """The JAX package's flop convention of one rank-k update
    (``obs/hwcost.baseline_workload_flops(n, "update", k)``): 4n²k + 2nk²,
    the A⁻¹U and VᵀA⁻¹ products and the capacitance's nk² term; a complex
    flop counts as one."""
    n, k = float(n), float(max(1, k))
    return 4.0 * n * n * k + 2.0 * n * k * k


def drift_budget(threshold: float, factor: float | None = None) -> float:
    """The accumulated-drift ceiling of one resident inverse:
    ``DRIFT_BUDGET_FACTOR`` (or ``factor``) times the per-update residual
    gate's threshold (``resilience.gate_threshold``)."""
    return (DRIFT_BUDGET_FACTOR if factor is None
            else float(factor)) * threshold


def drift_exceeded(drift: float, budget: float) -> bool:
    """NaN-hostile budget check: a NaN drift or budget always exceeds."""
    return not (drift <= budget) or not math.isfinite(drift)


def as_update_factors(u, v, n: int, dtype, error=ValueError, device="cpu"):
    """``u`` and ``v`` as (n, k) tensors of ``dtype`` on ``device``: 1-D
    vectors become (n, 1) columns, and anything but matching (n, k ≥ 1)
    factors raises ``error``.  Returns ``(u, v, k)``."""
    u, v = from_numpy((u, v), device, dtype)
    if u.dim() == 1:
        u = u[:, None]
    if v.dim() == 1:
        v = v[:, None]
    if (u.dim() != 2 or v.dim() != 2 or u.shape != v.shape
            or u.shape[0] != n or u.shape[1] < 1):
        raise error(
            f"u/v must be matching (n, k>=1) factors with n={n} rows, "
            f"got {tuple(u.shape)} / {tuple(v.shape)}")
    return u, v, int(u.shape[1])


def smw_update(inv: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """(A + U·Vᵀ)⁻¹ from A⁻¹, with no verification.  ``inv`` is (n, n),
    ``u`` and ``v`` (n, k) (cast to ``inv``'s dtype); sub-fp32 storage is
    computed in fp32 and rounded once.  Returns ``(inv_new, singular)``:
    the updated inverse (garbage if singular) and the capacitance solve's
    flag, True when the mutated matrix is numerically singular."""
    if inv.dtype in _SUB_FP32:
        inv_new, singular = smw_update(inv.float(), u.float(), v.float())
        return inv_new.to(inv.dtype), singular
    u = u.to(inv.dtype)
    v = v.to(inv.dtype)
    k = u.shape[-1]
    w = inv @ u                                                # A⁻¹U (n, k)
    z = v.T @ inv                                              # VᵀA⁻¹ (k, n)
    s = torch.eye(k, dtype=inv.dtype, device=inv.device) + v.T @ w
    y, singular = block_jordan_solve(s, z)
    return inv - w @ y, singular


def smw_update_with_metrics(a, inv, u, v, n_real=None):
    """Mutate A, update the inverse by :func:`smw_update` and verify it
    against the mutated matrix.  Returns ``(a_new, inv_new, singular,
    kappa, rel_residual)`` with ``driver.batch_metrics``' conventions:
    ``kappa`` = ‖A_new‖∞·‖X_new‖∞ and ``rel_residual`` =
    ‖A_new·X_new − I‖∞ / ‖A_new‖∞, as 0-d tensors (norms masked to
    ``n_real`` rows under identity padding)."""
    a_new = a + u @ v.T
    inv_new, singular = smw_update(inv, u, v)
    nr = None if n_real is None else torch.as_tensor(
        n_real, device=a.device).reshape(1)
    met = batch_metrics(a_new[None], inv_new[None].to(a_new.dtype), nr)
    return (a_new, inv_new, singular, met["kappa"][0],
            met["rel_residual"][0])


def smw_update_batched(inv: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """:func:`smw_update` of a (B, n, n) stack of inverses with (B, n, k)
    factors: the three n×n·k products are one ``bmm``/``baddbmm`` each, and
    the B capacitance systems S_i·Y_i = Z_i go through
    :func:`~.engine.block_jordan_solve_batched`, one probe call a superstep
    for the whole batch, each element with the pivots it picks alone.
    Returns ``(inv_new, singular)``, singular a (B,) bool tensor."""
    if inv.dtype in _SUB_FP32:
        inv_new, singular = smw_update_batched(inv.float(), u.float(),
                                               v.float())
        return inv_new.to(inv.dtype), singular
    u = u.to(inv.dtype)
    v = v.to(inv.dtype)
    k = u.shape[-1]
    vt = v.transpose(-1, -2)
    w = torch.bmm(inv, u)                                      # A⁻¹U
    z = torch.bmm(vt, inv)                                     # VᵀA⁻¹
    eye = torch.eye(k, dtype=inv.dtype, device=inv.device)
    s = torch.baddbmm(eye.expand(inv.shape[0], k, k), vt, w)
    y, singular = block_jordan_solve_batched(s, z)
    return torch.baddbmm(inv, w, y, alpha=-1), singular


def smw_update_batched_with_metrics(a, inv, u, v, n_real):
    """The batched twin of :func:`smw_update_with_metrics` (the JAX package
    maps the single update over the batch): every element of the (B, N, N)
    stacks ``a`` and ``inv`` gets its own (N, K) factors and its own
    ``n_real`` ((B,) ints) row mask, and comes back with its own singular
    flag, κ∞ and rel_residual as (B,) tensors.  An inert filler slot
    (identity A and A⁻¹, zero U and V, n_real = 0) stays the identity and
    touches no real element's flags."""
    a_new = torch.baddbmm(a, u.to(a.dtype), v.to(a.dtype).transpose(-1, -2))
    inv_new, singular = smw_update_batched(inv, u, v)
    met = batch_metrics(a_new, inv_new.to(a_new.dtype), n_real)
    return a_new, inv_new, singular, met["kappa"], met["rel_residual"]


@dataclass
class UpdateResult:
    """One :func:`solve_update` outcome.  ``inverse`` is (A + UVᵀ)⁻¹ (None
    when singular); ``a_new`` the mutated matrix (a chained update feeds
    both back in); ``drift`` the new accumulated drift (0 after a
    re_invert rung); ``recovery`` the ladder's record under a policy."""

    inverse: torch.Tensor | None
    a_new: torch.Tensor | None
    n: int
    k: int
    elapsed: float                # seconds of the update, CUDA events
    rel_residual: float
    kappa: float
    drift: float
    gflops: float                 # update_flops(n, k) / elapsed
    engine: str = "smw_update"
    workload: str = "update"
    singular: bool = False
    recovery: tuple = ()
    device: str = ""
    numerics: object | None = None  # obs.numerics.NumericsReport


def solve_update(
    a,
    inv,
    u,
    v,
    dtype=None,
    drift: float = 0.0,
    policy=None,
    telemetry=None,
    numerics: str = "off",
    check: bool = True,
    verbose: bool = False,
    device=None,
) -> UpdateResult:
    """Apply one rank-k SMW update to a resident inverse.

    ``a`` and ``inv`` are the current matrix and its inverse, ``u`` and
    ``v`` the (n, k) mutation factors (numpy arrays or tensors, moved to
    ``device``, the card unless "cpu", as ``dtype``, ``a``'s own unless
    given); ``drift`` the drift accumulated by earlier updates of the same
    inverse (thread ``result.drift`` back in).  The update is timed with
    CUDA events on the card.  With a ``policy`` (a
    ``resilience.ResiliencePolicy``) its retry wraps the update, and the
    result must pass the residual gate against the mutated matrix with the
    accumulated drift within :func:`drift_budget`; else the "re_invert"
    rung (:func:`reinvert_fresh`) inverts the mutated matrix afresh and
    resets the drift, and ``ResidualGateError`` is raised when that fails
    too.  ``check=False`` reports a singular mutated matrix on
    ``result.singular`` with ``inverse=None`` instead of raising
    SingularMatrixError.  ``telemetry`` and ``numerics="summary"`` as in
    the module docstring; ``numerics="trace"`` is refused in the JAX
    package's words.  Counterpart of the JAX package's ``solve_update``."""
    from ..obs.numerics import resolve_mode

    if policy is not None and not isinstance(policy, ResiliencePolicy):
        raise UsageError("policy must be a tpu_jordan_torch.resilience."
                         "ResiliencePolicy")
    tel = telemetry if telemetry is not None else _NULL_TEL
    dev = resolve_device(device)
    a = from_numpy(a, dev, None if dtype is None else resolve_dtype(dtype))
    dtype = a.dtype
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise UsageError(f"expected a square (n, n) matrix, got shape "
                         f"{tuple(a.shape)}")
    n = int(a.shape[0])
    inv = from_numpy(inv, dev, dtype)
    if inv.shape != a.shape:
        raise UsageError(f"inv must match a's shape {tuple(a.shape)}, "
                         f"got {tuple(inv.shape)}")
    u, v, k = as_update_factors(u, v, n, dtype, UsageError, dev)
    numerics = resolve_mode(numerics)
    if numerics == "trace":
        raise UsageError(
            "numerics='trace' instruments the unrolled elimination "
            "engines; the SMW update is three matmuls and a k×k solve "
            "— use numerics='summary'")
    from .api import count_workload

    count_workload("update")
    with tel.span("solve_update", n=n, k=k, workload="update"):
        result = _solve_update_impl(a, inv, u, v, n, k, dtype, float(drift),
                                    tel, policy, numerics, verbose, dev)
    if result.singular and check:
        raise SingularMatrixError("singular matrix (rank-k update made "
                                  "the matrix singular)")
    return result


def _solve_update_impl(a, inv, u, v, n, k, dtype, drift, tel, policy,
                       numerics, verbose, dev):
    if dev.type == "cuda":
        # Full fp32 products on the card (the JAX package's HIGHEST).
        torch.backends.cuda.matmul.allow_tf32 = False

    def ready():
        # The compile analogue (resilience/faults.py).
        _faults.fire("compile")
        return smw_update_with_metrics

    run = (policy.retry.call(ready, component="solve_update.compile")
           if policy is not None else ready())

    def execute():
        _faults.fire("execute")
        return timed_blocking(run, a, inv, u, v,
                              telemetry=tel, name="execute", device=dev,
                              engine="smw_update", workload="update")

    (a_new, inv_new, singular, kappa, rel), esp = (
        policy.retry.call(execute, component="solve_update.execute")
        if policy is not None else execute())
    elapsed = esp.duration
    flops = update_flops(n, k)
    _hwcost.attach_execute_cost(esp, analytical_flops=flops)
    if _faults.corrupt("result_corrupt_nan"):
        rel = float("nan")
    if bool(singular):
        _obs_metrics.counter("tpu_jordan_torch_singular_total",
                             "solves/requests flagged singular"
                             ).inc(component="solve_update")
        return UpdateResult(
            inverse=None, a_new=a_new, n=n, k=k, elapsed=elapsed,
            rel_residual=float("inf"), kappa=float("inf"), drift=drift,
            gflops=0.0, singular=True, device=str(dev))
    rel, kappa = float(rel), float(kappa)

    nreport = None
    if numerics == "summary":
        from ..obs import numerics as _numerics

        nreport = _numerics.summary_report(
            n=n, block_size=n, engine="smw_update", rel_residual=rel,
            kappa=kappa, norm_a=0.0, dtype=dtype, workload="update")
        _numerics.observe(nreport)
        thresholds = None
        if policy is not None:
            from ..resilience.degrade import gate_threshold

            gd = (policy.gate_dtype if policy.gate_dtype is not None
                  else dtype)
            thresholds = _numerics.SpikeThresholds(
                residual=gate_threshold(policy, n, kappa, gd))
        _numerics.record_spikes(nreport, thresholds)

    new_drift = drift + max(rel, 0.0) if rel == rel else float("nan")
    recovery = ()
    if policy is not None:
        inv_new, rel, kappa, new_drift, recovery = _update_recover(
            policy, tel, a_new=a_new, inv_new=inv_new, rel=rel,
            kappa=kappa, drift=drift, n=n, dtype=dtype, numerics=numerics)
    if verbose:
        print(f"glob_time: {elapsed:.2f}")
        print(f"rel_residual: {rel:e}")
    return UpdateResult(
        inverse=inv_new, a_new=a_new, n=n, k=k, elapsed=elapsed,
        rel_residual=rel, kappa=kappa, drift=new_drift,
        gflops=(flops / elapsed / 1e9) if elapsed > 0 else 0.0,
        recovery=recovery, device=str(inv_new.device), numerics=nreport)


def reinvert_fresh(a_new: torch.Tensor, block_size: int | None = None):
    """The "re_invert" rung's fresh elimination of the mutated matrix: the
    in-place engine, or for a complex matrix the augmented one (the
    port's complex invert engine; the JAX package's in-place engine fails
    on complex input).  Returns ``(inv, singular, kappa, rel_residual)``
    with ``batch_metrics``' conventions."""
    from ..ops import block_jordan_invert, block_jordan_invert_inplace

    if a_new.is_complex():
        x, sing = block_jordan_invert(a_new, block_size=block_size,
                                      global_scale=True)
    else:
        x, sing = block_jordan_invert_inplace(a_new, block_size=block_size)
    met = batch_metrics(a_new[None], x[None])
    return (x, bool(sing), float(met["kappa"][0]),
            float(met["rel_residual"][0]))


def _update_recover(policy, tel, *, a_new, inv_new, rel, kappa, drift, n,
                    dtype, numerics="off"):
    """The residual gate, the drift budget and the re_invert rung, as a
    ``recover``/``re_invert`` span pair of ``tel``.  Returns ``(inv, rel,
    kappa, new_drift, recovery)``."""
    from ..resilience.degrade import (gate_passes, gate_threshold,
                                      record_gate_failure, record_rung)
    from ..resilience.policy import ResidualGateError

    gate_dtype = (policy.gate_dtype if policy.gate_dtype is not None
                  else dtype)
    threshold = gate_threshold(policy, n, kappa, gate_dtype)
    budget = drift_budget(threshold)
    new_drift = drift + max(rel, 0.0) if rel == rel else float("nan")
    if gate_passes(rel, threshold) and not drift_exceeded(new_drift,
                                                          budget):
        return inv_new, rel, kappa, new_drift, ()
    cause = ("drift_budget" if gate_passes(rel, threshold)
             else "residual_gate")
    if numerics == "summary" and cause == "drift_budget":
        # The residual spike cannot explain a drift-caused rung: the
        # budget exceedance records its own breadcrumb.
        from ..obs.numerics import record_drift_spike

        record_drift_spike(n=n, engine="smw_update", value=new_drift,
                           threshold=budget)
    record_gate_failure(n, rel, threshold, workload="update",
                        drift=float(new_drift), budget=float(budget),
                        cause=cause)
    with tel.span("recover", n=n, workload="update", cause=cause,
                  rel_residual=float(rel), drift=float(new_drift)) as rsp:
        with tel.span("re_invert") as sp:
            inv2, sing2, kap2, rel2 = reinvert_fresh(a_new)
            passed = (gate_passes(rel2, gate_threshold(policy, n, kap2,
                                                       gate_dtype))
                      and not sing2)
            sp.attrs.update(rel_residual=float(rel2), passed=passed)
        recovery = ({"rung": "re_invert", "cause": cause,
                     "rel_residual_before": float(rel),
                     "rel_residual_after": float(rel2),
                     "drift_before": float(new_drift), "passed": passed},)
        record_rung("re_invert", passed, rel2, workload="update")
        if passed:
            rsp.attrs["recovered_by"] = "re_invert"
            return inv2, float(rel2), float(kap2), 0.0, recovery
    raise ResidualGateError(
        f"update residual gate failed ({cause}: rel {rel:.3e}, drift "
        f"{new_drift:.3e} vs threshold {threshold:.3e} / budget "
        f"{budget:.3e}) and the re_invert rung did not recover",
        recovery=recovery)
