"""Seeded LP/QP instances and the KKT convergence judge.  The port's own
copy of the JAX package's ``lpqp/problem.py`` (pure numpy: the same seeds
give the same arrays, bit for bit), with the judge over the port's
``resilience/degrade.py``.

Every instance is deterministic and carries its own optimality
certificate, built so that the exact solution is known in closed form:

  * **LP** (standard form, ``min cᵀx  s.t.  Ax = b, x ≥ 0``):
    ``A = [G | I]`` with G ≥ 0 and diagonally boosted, so the slack basis
    is a feasible simplex start (``x_slack = b > 0``) and the G columns
    form the optimal basis.  ``c`` comes from a dual certificate
    (``c_G = Gᵀy``, ``c_slack = y + s`` with ``s > 0``), so complementary
    slackness holds EXACTLY at the constructed vertex and ``obj_star`` is
    the true optimum.
  * **QP** (box-constrained, ``min ½xᵀQx + cᵀx  s.t.  lo ≤ x ≤ hi``): Q is
    SPD (Gram plus identity for the well family; geometric column scaling
    before the Gram product for the ill family), and ``c`` is derived from
    a chosen ``x_star`` and active set so the KKT conditions hold exactly
    (free gradient 0, bound multipliers strictly positive).

The judge REUSES the solver's own backward-error gate
(:func:`~..resilience.degrade.gate_threshold` /
:func:`~..resilience.degrade.gate_passes`), never a looser twin: an
iterate "converged" by the same eps·n·κ model that judges every inverse
the port serves.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "LPInstance", "QPInstance", "lp_instance", "qp_instance",
    "lp_kkt_residual", "qp_kkt_residual", "kkt_gate", "kkt_converged",
]

_CONDS = ("well", "ill")


def _check_cond(cond: str) -> str:
    if cond not in _CONDS:
        raise ValueError(f"cond must be one of {_CONDS}, got {cond!r}")
    return cond


@dataclass(frozen=True)
class LPInstance:
    """One standard-form LP: ``min cᵀx  s.t.  Ax = b, x ≥ 0`` with a
    known optimal vertex.  ``basis0`` is the slack basis (the feasible
    simplex start, B = I); ``x_star``/``obj_star`` the constructed
    optimum the driver's result is checked against."""

    name: str
    cond: str
    a: np.ndarray            # (m, n) constraint matrix [G | I]
    b: np.ndarray            # (m,) RHS, strictly positive
    c: np.ndarray            # (n,) objective
    basis0: tuple            # m slack column indices (B = I start)
    x_star: np.ndarray       # (n,) the constructed optimal vertex
    obj_star: float
    m: int
    n: int


@dataclass(frozen=True)
class QPInstance:
    """One box-constrained QP: ``min ½xᵀQx + cᵀx  s.t. lo ≤ x ≤ hi``
    with Q SPD and a known optimum ``x_star`` (active set chosen at
    construction, multiplier signs exact)."""

    name: str
    cond: str
    q: np.ndarray            # (n, n) SPD Hessian
    c: np.ndarray            # (n,)
    lo: np.ndarray           # (n,)
    hi: np.ndarray           # (n,)
    x_star: np.ndarray
    obj_star: float
    n: int


def lp_instance(m: int = 24, seed: int = 0, cond: str = "well",
                dtype=np.float64, ill_decades: float = 4.0) -> LPInstance:
    """Generate one seeded LP (see module docstring for the
    construction).  ``n = 2m`` (m structural + m slack columns).  The
    ill family geometrically scales G's columns over ``ill_decades``
    orders of magnitude, driving the basis matrices the simplex visits
    toward large κ — the drift budget's natural prey."""
    _check_cond(cond)
    if m < 2:
        raise ValueError("m must be >= 2")
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    g = np.abs(rng.standard_normal((m, m))) + m * np.eye(m)
    if cond == "ill":
        g = g * np.power(10.0, -np.linspace(0.0, ill_decades, m))[None, :]
    a = np.concatenate([g, np.eye(m)], axis=1).astype(dtype)
    x_g = 0.5 + rng.random(m)                 # optimal basic values > 0
    b = (g @ x_g).astype(dtype)               # > 0: slack start feasible
    y = rng.standard_normal(m)
    c_g = g.T @ y                             # s_G = 0 (complementarity)
    c_s = y + 0.1 + rng.random(m)             # s_slack > 0 strictly
    c = np.concatenate([c_g, c_s]).astype(dtype)
    x_star = np.concatenate([x_g, np.zeros(m)]).astype(dtype)
    return LPInstance(
        name=f"lp_{cond}_m{m}_s{seed}", cond=cond, a=a, b=b, c=c,
        basis0=tuple(range(m, 2 * m)), x_star=x_star,
        obj_star=float(c @ x_star), m=m, n=2 * m)


def qp_instance(n: int = 24, seed: int = 0, cond: str = "well",
                dtype=np.float64, ill_decades: float = 3.0,
                frac_active: float = 0.4) -> QPInstance:
    """Generate one seeded box QP (see module docstring).  A
    ``frac_active`` fraction of coordinates sits at a bound in the
    constructed optimum (half lo, half hi), the rest strictly
    interior; multipliers are strictly positive so the active set is
    nondegenerate and the driver's termination test is clean."""
    _check_cond(cond)
    if n < 2:
        raise ValueError("n must be >= 2")
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    mfac = rng.standard_normal((n, n))
    if cond == "ill":
        mfac = mfac * np.power(
            10.0, -np.linspace(0.0, ill_decades, n))[None, :]
    q = (mfac.T @ mfac)
    q = q + (1e-6 * np.trace(q) / n + (1.0 if cond == "well" else 0.0)
             ) * np.eye(n)
    q = q.astype(dtype)
    lo = np.zeros(n, dtype)
    hi = np.ones(n, dtype)
    n_act = int(round(frac_active * n))
    idx = rng.permutation(n)
    at_lo = idx[: n_act // 2]
    at_hi = idx[n_act // 2: n_act]
    free = idx[n_act:]
    x_star = np.empty(n, dtype)
    x_star[at_lo] = lo[at_lo]
    x_star[at_hi] = hi[at_hi]
    x_star[free] = 0.2 + 0.6 * rng.random(free.size)
    # Reverse-engineer c from the KKT conditions at x_star: g = Qx + c
    # must vanish on the free set, be strictly positive at lo-active
    # coordinates and strictly negative at hi-active ones.
    g = np.zeros(n, dtype)
    g[at_lo] = 0.1 + rng.random(at_lo.size)
    g[at_hi] = -(0.1 + rng.random(at_hi.size))
    c = (g - q @ x_star).astype(dtype)
    return QPInstance(
        name=f"qp_{cond}_n{n}_s{seed}", cond=cond, q=q, c=c, lo=lo,
        hi=hi, x_star=x_star,
        obj_star=float(0.5 * x_star @ q @ x_star + c @ x_star), n=n)


def lp_kkt_residual(prob: LPInstance, x: np.ndarray,
                    y: np.ndarray) -> float:
    """The scaled KKT residual of an LP iterate (x, y): the max of
    relative primal infeasibility, bound violation, dual infeasibility
    and the duality gap — one number, 0 at an exact optimal pair.
    NaN-propagating on corrupt iterates (the judge is NaN-hostile)."""
    a, b, c = prob.a, prob.b, prob.c
    primal = np.max(np.abs(a @ x - b)) / (1.0 + np.max(np.abs(b)))
    bound = max(0.0, float(-np.min(x))) / (1.0 + np.max(np.abs(x)))
    s = c - a.T @ y
    dual = max(0.0, float(-np.min(s))) / (1.0 + np.max(np.abs(c)))
    cx, by = float(c @ x), float(b @ y)
    gap = abs(cx - by) / (1.0 + abs(cx) + abs(by))
    return float(max(primal, bound, dual, gap))


def qp_kkt_residual(prob: QPInstance, x: np.ndarray,
                    atol: float = 1e-9) -> float:
    """The scaled projected-gradient KKT residual of a QP iterate:
    |g_i| on free coordinates, the one-sided multiplier violation at
    coordinates within ``atol`` of a bound, plus any box violation —
    ∞-norm, scaled by (1 + ‖g‖∞)."""
    g = prob.q @ x + prob.c
    r = np.abs(g)
    at_lo = x <= prob.lo + atol
    at_hi = x >= prob.hi - atol
    r[at_lo] = np.maximum(0.0, -g[at_lo])
    r[at_hi] = np.maximum(0.0, g[at_hi])
    box = max(0.0, float(np.max(prob.lo - x)),
              float(np.max(x - prob.hi)))
    return float((np.max(r) + box) / (1.0 + np.max(np.abs(g))))


def kkt_gate(policy, n: int, kappa: float, dtype) -> float:
    """The LP/QP convergence threshold IS the solver's own residual
    gate — :func:`~..resilience.degrade.gate_threshold`'s eps·n·κ
    expected-error model (gate_tol-widened, 0.5-capped), evaluated at
    the KKT system's size and the driver's latest verified κ.  Reusing
    the gate (never a looser twin) means "converged" and "this inverse
    is trustworthy" are judged by one model."""
    from ..resilience.degrade import gate_threshold

    return gate_threshold(policy, n, kappa, dtype)


def kkt_converged(kkt_rel: float, threshold: float) -> bool:
    """NaN-hostile convergence test — literally the solver's
    :func:`~..resilience.degrade.gate_passes`."""
    from ..resilience.degrade import gate_passes

    return gate_passes(kkt_rel, threshold)
