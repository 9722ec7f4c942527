"""LP/QP optimization drivers over a :class:`~..fleet.pool.JordanFleet`.
Counterpart of the JAX package's ``lpqp/driver.py``.

Both drivers run the traffic the resident-handle machinery was built for:
one ``invert(resident=True)`` establishes the working inverse, then a long
correlated stream in which every iteration's system differs from the last
by a rank-k mutation:

  * :func:`solve_lp`: revised simplex (Bland's rule: no cycling, and a
    pivot sequence fixed by the instance).  The slack basis starts at
    B = I; every pivot swaps ONE basis column, the rank-1 update
    ``B += u·e_pᵀ`` riding ``fleet.update``: the resident inverse IS the
    simplex's basis inverse.
  * :func:`solve_qp`: primal active set on a box QP.  The working matrix
    ``M = E·Q·E + (I − E)`` (E = diag of the free mask) changes only in
    row and column *i* when coordinate *i* toggles, the rank-2 update
    ``U = [e_i, ΔM·e_i − ΔM_ii·e_i]``, ``V = [ΔMᵀ·e_i, e_i]``.

Every update's answer carries the serving layer's judgment (``refreshed``
| ``re_inverted`` | ``gated``), folded into the report's ledger; a drift
budget crossing walks the ``re_invert`` rung and the driver iterates on.
Verification solves (``fleet.solve_system``, every ``solve_every``
iterations) cross-check the updated inverse against a fresh solve of the
same system, judged by the solve lane's κ-free backward-error gate and a
κ-scaled agreement test.

The host arithmetic is the JAX driver's, in float64 numpy: the resident
inverse is copied to the host after each update (on the card, one n × n
copy a pivot), and pricing, ratio tests and multipliers run there.  So the
pivot and toggle sequence is a function of the inverse's values alone.
``report.timing`` splits each iteration's wall into the update's round
trip (its execute on the device within it), the inverse's copy to the
host, the verification solve and the host's own arithmetic.

Determinism: for one instance, fleet dtype and fault plan, the pivot or
toggle sequence, every iterate and the final fingerprint are the same bits
run to run; a mid-flight ``replica_kill`` re-queues through the router and
the retry re-reads committed state, so a chaos run bit-matches its
fault-free replay.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field

import numpy as np

from ..resilience.degrade import (gate_passes, gate_threshold,
                                  solve_gate_threshold)
from ..resilience.policy import ResidualGateError
from .problem import (LPInstance, QPInstance, kkt_converged, kkt_gate,
                      lp_kkt_residual, qp_kkt_residual)

__all__ = ["OptimizeError", "OptimizeReport", "solve_lp", "solve_qp"]

#: Every fleet.update outcome the drivers account (plus "error" for a
#: typed gate exhaustion): the ledger sums to the update count.
OUTCOMES = ("refreshed", "re_inverted", "gated")

_RATIO_EPS = 1e-10          # simplex ratio-test / QP step denominators

#: The per-iteration wall split ``report.timing`` carries (seconds).
TIMING_KEYS = ("iteration_s", "update_s", "execute_s", "copy_s",
               "verify_s", "host_s")


class OptimizeError(RuntimeError):
    """A typed driver failure: an unbounded or infeasible instance, the
    iteration cap, or a fleet-side typed refusal (``ResidualGateError``:
    the re_invert rung did not recover) the driver will not paper over.
    ``report`` carries the iterate trail up to the failure."""

    def __init__(self, msg: str, report: "OptimizeReport" = None):
        super().__init__(msg)
        self.report = report


@dataclass
class OptimizeReport:
    """One driver run's account, everything ``tools/check_lp.py``
    re-derives convergence from.  ``iterates`` holds one dict per
    iteration (KKT residual and threshold, the update outcome, drift, the
    committed handle version, and on verification iterations the solve
    lane's residual and threshold and the κ-scaled agreement).
    ``fingerprint`` hashes the final x bytes and the objective's bits, the
    chaos leg's bit-compare token.  ``timing`` (not serialized) lists the
    per-iteration wall split, :data:`TIMING_KEYS`."""

    kind: str                 # "lp" | "qp"
    name: str                 # instance name (seeded, self-describing)
    converged: bool
    iterations: int
    objective: float
    objective_ref: float      # the instance's constructed optimum
    kkt_rel_final: float
    kkt_threshold: float      # the solver-gate threshold at the end
    kappa: float              # last verified κ of the working matrix
    updates: int              # fleet.update calls issued
    solves: int               # fleet.solve_system verifications issued
    ledger: dict = field(default_factory=dict)   # outcome -> count
    iterates: list = field(default_factory=list)
    handle_id: str = ""
    fingerprint: str = ""
    x: np.ndarray = None
    timing: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "kind", "name", "converged", "iterations", "objective",
            "objective_ref", "kkt_rel_final", "kkt_threshold", "kappa",
            "updates", "solves", "ledger", "iterates", "handle_id",
            "fingerprint")}
        d["obj_rel_err"] = (
            abs(self.objective - self.objective_ref)
            / (1.0 + abs(self.objective_ref)))
        return d


def _fingerprint(x: np.ndarray, objective: float) -> str:
    h = hashlib.sha256(np.ascontiguousarray(x).tobytes())
    h.update(float(objective).hex().encode())
    return h.hexdigest()


def _host64(t) -> np.ndarray:
    """A result tensor (any device) as a float64 numpy array on the host."""
    return np.array(t.cpu().numpy(), dtype=np.float64)


def fleet_np_dtype(fleet) -> np.dtype:
    """The fleet's storage dtype as a numpy dtype."""
    return np.dtype(str(fleet.dtype).removeprefix("torch."))


class _FleetLane:
    """The drivers' fleet adapter: one resident handle, the per-update
    outcome ledger, the verification solve and the per-iteration timing,
    so the LP and QP loops stay pure algorithm."""

    def __init__(self, fleet, a0: np.ndarray, policy):
        self.fleet = fleet
        self.policy = (policy if policy is not None
                       else getattr(fleet, "policy", None))
        self.handle = fleet.invert(np.asarray(a0), resident=True)
        self.dtype = np.dtype(self.handle.dtype)
        self.inv = _host64(self.handle.result.inverse)
        self.kappa = max(float(self.handle.result.kappa), 1.0)
        self.updates = 0
        self.solves = 0
        self.ledger = {o: 0 for o in OUTCOMES}
        self.ledger["error"] = 0
        self.timing = {k: [] for k in TIMING_KEYS}
        self._it = {}

    def begin(self) -> None:
        """Open one iteration's timing record."""
        self._it = {"t0": time.perf_counter()}

    def end(self) -> None:
        """Close the iteration's record: the host's share is what the
        update, the copy and the verification did not take."""
        it = self._it
        wall = time.perf_counter() - it.pop("t0")
        parts = {k: it.get(k, 0.0)
                 for k in ("update_s", "execute_s", "copy_s", "verify_s")}
        self.timing["iteration_s"].append(wall)
        for k, v in parts.items():
            self.timing[k].append(v)
        self.timing["host_s"].append(
            wall - parts["update_s"] - parts["copy_s"] - parts["verify_s"])

    def update(self, u: np.ndarray, v: np.ndarray, report) -> dict:
        """One rank-k mutation through the fleet; returns the iterate fields
        the loop folds into its record.  Typed fleet refusals become
        :class:`OptimizeError` carrying the partial report."""
        from ..errors import SingularMatrixError

        self.updates += 1
        t0 = time.perf_counter()
        try:
            res = self.fleet.update(self.handle, np.asarray(u),
                                    np.asarray(v))
        except ResidualGateError as e:
            self.ledger["error"] += 1
            raise OptimizeError(
                f"fleet update refused typed (re_invert rung "
                f"exhausted): {e}", report) from e
        except SingularMatrixError as e:
            # The fleet's typed singularity answer (the committed state
            # untouched): the pivot choice destroyed rank.
            self.ledger["gated"] += 1
            raise OptimizeError(
                f"update would destroy rank (fleet gated it): {e}",
                report) from e
        t1 = time.perf_counter()
        self.ledger[res.update_outcome] += 1
        self.inv = _host64(res.inverse)
        self.kappa = max(float(res.kappa), 1.0)
        self._it.update(update_s=t1 - t0,
                        execute_s=float(res.execute_seconds),
                        copy_s=time.perf_counter() - t1)
        return {"outcome": res.update_outcome,
                "drift": float(res.drift),
                "version": int(res.handle_version),
                "kappa": float(res.kappa)}

    def verify(self, a: np.ndarray, rhs: np.ndarray,
               x_inv: np.ndarray) -> dict:
        """Cross-check the updated resident inverse against a FRESH fleet
        solve of the same system: the solve lane's κ-free backward-error
        gate judges the solve, and a κ-scaled forward-error gate judges
        the agreement ‖x_solve − x_inv‖.  The two routes may disagree by
        the drift budget plus one gate width (the resident inverse may
        carry the budget before re_invert fires, the fresh solve one more
        width), no more."""
        from ..linalg.update import drift_budget

        t0 = time.perf_counter()
        n = a.shape[0]
        self.solves += 1
        res = self.fleet.solve_system(np.asarray(a), rhs[:, None])
        x_solve = _host64(res.solution)[:, 0]
        solve_thr = solve_gate_threshold(self.policy, n, self.dtype)
        agree_rel = (np.max(np.abs(x_solve - x_inv))
                     / (1.0 + np.max(np.abs(x_solve))))
        gate_w = gate_threshold(self.policy, n, self.kappa, self.dtype)
        agree_thr = drift_budget(gate_w) + gate_w
        self._it["verify_s"] = time.perf_counter() - t0
        return {"solve_rel": float(res.rel_residual),
                "solve_threshold": float(solve_thr),
                "solve_pass": gate_passes(float(res.rel_residual),
                                          solve_thr),
                "agree_rel": float(agree_rel),
                "agree_threshold": float(agree_thr),
                "agree": gate_passes(float(agree_rel), agree_thr)}

    def gate(self, n: int) -> float:
        return kkt_gate(self.policy, n, self.kappa, self.dtype)

    # ---- checkpoint/resume ------------------------------------------

    def ckpt_arrays(self) -> tuple:
        """The lane's exact resident-handle bytes and counters, the stream
        checkpoint's payload: restoring them and replaying from the same
        iteration reproduces every later iterate bit for bit."""
        st = self.fleet.handles.get(self.handle.handle_id)
        with st.lock:
            arrays = {"handle_a": st.a.cpu().numpy().copy(),
                      "handle_inverse": st.inverse.cpu().numpy().copy()}
            meta = {"handle_id": st.handle_id, "n": st.n,
                    "bucket_n": st.bucket_n, "dtype": st.dtype,
                    "version": st.version, "drift": float(st.drift),
                    "updates_applied": st.updates_applied,
                    "reinverts": st.reinverts,
                    "kappa": float(st.kappa),
                    "rel_residual": float(st.rel_residual),
                    "nbytes": int(st.nbytes),
                    "pinned": bool(st.pinned)}
        meta.update(updates=self.updates, solves=self.solves,
                    ledger=dict(self.ledger))
        return arrays, meta

    @classmethod
    def restore(cls, fleet, policy, arrays: dict, meta: dict):
        """Re-install the checkpointed handle on the fleet's device (same
        id: ``HandleStore.create`` replaces any survivor, so a stale
        resident never leaks into the replay) and rebuild the counters as
        written."""
        import torch

        from ..serve.handles import HandleState

        lane = cls.__new__(cls)
        lane.fleet = fleet
        lane.policy = (policy if policy is not None
                       else getattr(fleet, "policy", None))

        def dev(key):
            return torch.from_numpy(np.array(arrays[key])).to(fleet.device)

        state = HandleState(
            handle_id=meta["handle_id"], n=meta["n"],
            bucket_n=meta["bucket_n"], dtype=meta["dtype"],
            a=dev("handle_a"), inverse=dev("handle_inverse"),
            version=meta["version"], drift=meta["drift"],
            updates_applied=meta["updates_applied"],
            reinverts=meta["reinverts"], kappa=meta["kappa"],
            rel_residual=meta["rel_residual"], nbytes=meta["nbytes"],
            pinned=meta.get("pinned", False))
        lane.handle = fleet.handles.create(state)
        lane.dtype = np.dtype(meta["dtype"])
        n = meta["n"]
        lane.inv = np.asarray(arrays["handle_inverse"],
                              np.float64)[:n, :n]
        lane.kappa = max(float(meta["kappa"]), 1.0)
        lane.updates = int(meta["updates"])
        lane.solves = int(meta["solves"])
        lane.ledger = {k: int(v) for k, v in meta["ledger"].items()}
        lane.timing = {k: [] for k in TIMING_KEYS}
        lane._it = {}
        return lane


# ---------------------------------------------------------------------
# Stream checkpointing: the loops persist the resident-handle bytes and
# the iterate audit every ``ckpt_every`` iterations; ``resume=True``
# re-enters at the stored iteration and replays to the same kkt_hex trail
# and fingerprint (the loops are functions of (instance, lane state)).
# ---------------------------------------------------------------------


def _opt_ckpt_key(kind: str, prob, run_id: str, lane_dtype,
                  max_iters: int, cadence: int):
    from ..resilience.checkpoint import CheckpointKey

    n = getattr(prob, "n", 0)
    m = getattr(prob, "m", n)
    return CheckpointKey(
        run_id=run_id, workload=kind,
        engine="simplex" if kind == "lp" else "active-set",
        topology="fleet", n=int(n), m=int(m), Nr=int(max_iters),
        dtype=np.dtype(lane_dtype).name, nrhs=0, cadence=int(cadence))


def _opt_ckpt_write(store, key, it: int, lane, report,
                    extra: dict) -> None:
    arrays, handle_meta = lane.ckpt_arrays()
    meta = {"it": int(it), "handle": handle_meta,
            "iterates": report.iterates,
            "iterations": report.iterations}
    meta.update(extra)
    arrays["meta"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), np.uint8).copy()
    store.write(key, it, arrays)


def _opt_ckpt_resume(store, key, fleet, policy):
    step, arrays = store.resume(key)
    meta = json.loads(bytes(arrays["meta"].tobytes()).decode())
    if int(meta["it"]) != step:
        from ..resilience.checkpoint import CheckpointMismatchError

        raise CheckpointMismatchError(
            f"stream checkpoint step {step} disagrees with its own "
            f"audit ({meta['it']}); refused")
    lane = _FleetLane.restore(fleet, policy, arrays, meta["handle"])
    return step, meta, lane


def _opt_preempt(run_id: str, durable: int | None) -> None:
    from ..resilience.checkpoint import _fire_preempt

    _fire_preempt(run_id, durable)


def _new_report(kind, prob, lane, start_it, stored_iterates):
    report = OptimizeReport(
        kind=kind, name=prob.name, converged=False,
        iterations=start_it, objective=float("nan"),
        objective_ref=prob.obj_star, kkt_rel_final=float("nan"),
        kkt_threshold=float("nan"), kappa=lane.kappa,
        updates=lane.updates, solves=lane.solves, ledger=lane.ledger,
        handle_id=lane.handle.handle_id)
    report.iterates = list(stored_iterates)
    report.timing = lane.timing
    return report


def solve_lp(prob: LPInstance, fleet, policy=None,
             max_iters: int | None = None,
             solve_every: int = 1, ckpt_store=None,
             ckpt_every: int = 0, run_id: str | None = None,
             resume: bool = False) -> OptimizeReport:
    """Revised simplex over the fleet.  The basis inverse lives in a
    resident handle seeded from the slack basis (B = I); each Bland pivot
    is one rank-1 ``fleet.update``; every ``solve_every``-th iteration
    cross-checks x_B = B⁻¹b against a fresh ``fleet.solve_system(B, b)``.
    Converged: no entering column remains AND the (x, y) pair's KKT
    residual passes the solver's own eps·n·κ gate.

    ``ckpt_store``/``ckpt_every`` persist the handle bytes and the iterate
    audit every k iterations; ``resume=True`` re-enters at the stored
    iteration and replays to the same ``kkt_hex`` trail and fingerprint.
    The ``preempt`` fault point fires at every iteration top under an
    active plan."""
    m, a, b, c = prob.m, np.asarray(prob.a, np.float64), prob.b, prob.c
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    if max_iters is None:
        max_iters = 6 * m
    if run_id is None:
        run_id = f"lp:{prob.name}"
    basis = list(prob.basis0)
    start_it, durable = 0, None
    ckpt_key = None
    stored_iterates: list = []
    if resume:
        if ckpt_store is None:
            raise ValueError("resume=True needs ckpt_store")
        ckpt_key = _opt_ckpt_key("lp", prob, run_id, fleet_np_dtype(fleet),
                                 max_iters, max(1, ckpt_every))
        start_it, meta, lane = _opt_ckpt_resume(ckpt_store, ckpt_key,
                                                fleet, policy)
        durable = start_it
        basis = [int(i) for i in meta["basis"]]
        stored_iterates = meta["iterates"]
    else:
        lane = _FleetLane(fleet, np.eye(m, dtype=a.dtype), policy)
    if ckpt_store is not None and ckpt_key is None:
        ckpt_key = _opt_ckpt_key("lp", prob, run_id, lane.dtype,
                                 max_iters, max(1, ckpt_every))
    report = _new_report("lp", prob, lane, start_it, stored_iterates)
    # Dtype- and κ-aware pricing tolerance: reduced costs through the
    # inverse carry ~eps·m·κ relative noise, so Bland's entering test must
    # not chase signs below that floor.
    eps = float(np.finfo(lane.dtype).eps)
    c_inf = float(np.max(np.abs(c)))
    x = np.zeros(prob.n)
    kkt_rel, thr, optimal = float("nan"), float("nan"), False
    for it in range(start_it, max_iters):
        if (ckpt_store is not None and ckpt_every > 0 and it > start_it
                and (it % ckpt_every) == 0):
            _opt_ckpt_write(ckpt_store, ckpt_key, it, lane, report,
                            {"basis": [int(i) for i in basis]})
            durable = it
        _opt_preempt(run_id, durable)
        lane.begin()
        red_tol = (1.0 + c_inf) * max(1e-9, 10.0 * eps * m * lane.kappa)
        report.iterations = it + 1
        x_b = lane.inv @ b
        x[:] = 0.0
        x[basis] = x_b
        y = lane.inv.T @ c[basis]
        kkt_rel = lp_kkt_residual(prob, x, y)
        thr = lane.gate(m)
        rec = {"i": it, "kkt_rel": kkt_rel, "kkt_threshold": thr,
               "kkt_hex": float(kkt_rel).hex()}
        reduced = c - a.T @ y
        reduced[basis] = 0.0
        entering = np.flatnonzero(reduced < -red_tol)
        if entering.size == 0:
            report.iterates.append(rec)
            lane.end()
            optimal = True
            break
        q = int(entering[0])                      # Bland: smallest index
        d = lane.inv @ a[:, q]
        pos = np.flatnonzero(d > _RATIO_EPS)
        if pos.size == 0:
            report.iterates.append(rec)
            lane.end()
            _finalize(report, x, c, kkt_rel, thr, lane)
            raise OptimizeError(
                f"LP unbounded below at iteration {it} "
                f"(entering column {q} has no blocking row)", report)
        ratios = x_b[pos] / d[pos]
        best = ratios.min()
        ties = pos[ratios <= best * (1.0 + 1e-12) + 1e-300]
        # Bland's leaving rule: among the minimum-ratio rows, evict the
        # smallest basis INDEX (with the entering rule, no cycling).
        p = int(ties[np.argmin(np.asarray(basis)[ties])])
        u = a[:, q] - a[:, basis[p]]
        v = np.zeros(m)
        v[p] = 1.0
        rec.update(lane.update(u[:, None], v[:, None], report))
        basis[p] = q
        if (it + 1) % max(1, solve_every) == 0:
            b_mat = a[:, basis]
            rec.update(lane.verify(b_mat, b, lane.inv @ b))
        report.iterates.append(rec)
        lane.end()
    x[:] = 0.0
    x[basis] = lane.inv @ b
    _finalize(report, x, c, kkt_rel, thr, lane)
    report.converged = bool(optimal and kkt_converged(kkt_rel, thr))
    if not optimal:
        raise OptimizeError(
            f"LP did not reach an optimal basis in {max_iters} "
            f"iterations", report)
    if ckpt_store is not None:
        ckpt_store.discard(run_id, reason="complete")
    return report


def _finalize(report: OptimizeReport, x, c_or_none, kkt_rel, thr,
              lane) -> None:
    report.kkt_rel_final = float(kkt_rel)
    report.kkt_threshold = float(thr)
    report.kappa = lane.kappa
    report.updates = lane.updates
    report.solves = lane.solves
    report.x = x.copy()
    if c_or_none is not None:
        report.objective = float(c_or_none @ x)
    report.fingerprint = _fingerprint(report.x, report.objective)


def _qp_working_matrix(q: np.ndarray, free: np.ndarray) -> np.ndarray:
    """M = E·Q·E + (I − E): the free block is Q_FF, active rows and
    columns identity, so M·z = rhs solves the equality-constrained
    subproblem and M stays SPD for every active set."""
    mat = np.where(np.outer(free, free), q, 0.0)
    mat[~free, ~free] = 1.0
    return mat


def _qp_toggle_factors(m_old: np.ndarray, m_new: np.ndarray,
                       i: int) -> tuple:
    """ΔM = M_new − M_old lies in row/column *i* when one coordinate
    toggles, so it factors exactly as the rank-2
    ``U·Vᵀ = e_i·ΔM[i,:] + (ΔM[:,i] − ΔM[i,i]·e_i)·e_iᵀ`` (the diagonal
    entry counted once)."""
    n = m_old.shape[0]
    delta = m_new - m_old
    e_i = np.zeros(n)
    e_i[i] = 1.0
    row = delta[i, :].copy()
    col = delta[:, i].copy()
    col[i] = 0.0
    u = np.stack([e_i, col], axis=1)
    v = np.stack([row, e_i], axis=1)
    return u, v


def solve_qp(prob: QPInstance, fleet, policy=None,
             max_iters: int | None = None,
             solve_every: int = 2, ckpt_store=None,
             ckpt_every: int = 0, run_id: str | None = None,
             resume: bool = False) -> OptimizeReport:
    """Primal active set over the fleet.  The working-matrix inverse is a
    resident handle seeded from M = Q (empty active set, feasible start
    x = lo); every bound addition or release is one rank-2
    ``fleet.update``; converged means the projected-gradient KKT residual
    passes the solver's own eps·n·κ gate.  The checkpoint contract is
    :func:`solve_lp`'s (the extra state is ``x`` and the free mask;
    ``m_work`` is re-derived from them)."""
    n = prob.n
    q = np.asarray(prob.q, np.float64)
    c = np.asarray(prob.c, np.float64)
    lo = np.asarray(prob.lo, np.float64)
    hi = np.asarray(prob.hi, np.float64)
    if max_iters is None:
        max_iters = 6 * n
    if run_id is None:
        run_id = f"qp:{prob.name}"
    start_it, durable = 0, None
    ckpt_key = None
    stored_iterates: list = []
    if resume:
        if ckpt_store is None:
            raise ValueError("resume=True needs ckpt_store")
        ckpt_key = _opt_ckpt_key("qp", prob, run_id, fleet_np_dtype(fleet),
                                 max_iters, max(1, ckpt_every))
        start_it, meta, lane = _opt_ckpt_resume(ckpt_store, ckpt_key,
                                                fleet, policy)
        durable = start_it
        free = np.asarray(meta["free"], dtype=bool)
        x = np.asarray(meta["x"], np.float64)
        m_work = _qp_working_matrix(q, free)
        stored_iterates = meta["iterates"]
    else:
        free = np.ones(n, dtype=bool)
        m_work = _qp_working_matrix(q, free)
        lane = _FleetLane(fleet, m_work.astype(prob.q.dtype), policy)
        x = lo.copy()
    if ckpt_store is not None and ckpt_key is None:
        ckpt_key = _opt_ckpt_key("qp", prob, run_id, lane.dtype,
                                 max_iters, max(1, ckpt_every))
    report = _new_report("qp", prob, lane, start_it, stored_iterates)
    eps = float(np.finfo(lane.dtype).eps)
    c_inf = float(np.max(np.abs(c)))
    kkt_rel, thr = float("nan"), float("nan")

    def toggle(i: int, now_free: bool, rec: dict) -> None:
        nonlocal m_work
        free[i] = now_free
        m_new = _qp_working_matrix(q, free)
        u, v = _qp_toggle_factors(m_work, m_new, i)
        rec.update(lane.update(u, v, report))
        m_work = m_new

    for it in range(start_it, max_iters):
        if (ckpt_store is not None and ckpt_every > 0 and it > start_it
                and (it % ckpt_every) == 0):
            _opt_ckpt_write(ckpt_store, ckpt_key, it, lane, report,
                            {"free": [bool(f) for f in free],
                             "x": [float(v) for v in x]})
            durable = it
        _opt_preempt(run_id, durable)
        lane.begin()
        report.iterations = it + 1
        mul_tol = (1.0 + c_inf) * max(1e-9,
                                      10.0 * eps * n * lane.kappa)
        kkt_rel = qp_kkt_residual(prob, x)
        thr = lane.gate(n)
        rec = {"i": it, "kkt_rel": kkt_rel, "kkt_threshold": thr,
               "kkt_hex": float(kkt_rel).hex()}
        # rhs of M·z = rhs: free rows ask Q_FF·z_F = −c_F − Q_FA·x_A,
        # active rows pin z to the bound value.
        x_bnd = np.where(free, 0.0, x)
        rhs = np.where(free, -(c + q @ x_bnd), x)
        z = lane.inv @ rhs
        z[~free] = x[~free]           # active coordinates exact
        if (it + 1) % max(1, solve_every) == 0:
            # Cross-check BEFORE any toggle mutates M: the fresh solve
            # targets the system z came from.
            rec.update(lane.verify(m_work, rhs, z))
        p = z - x
        step = float(np.max(np.abs(p)))
        if step <= 1e-12 * (1.0 + np.max(np.abs(x))):
            # The equality-constrained optimum of this active set: release
            # the bound whose multiplier says leaving it still improves
            # the objective most, or stop.
            g = q @ x + c
            lam = np.where(free, 0.0, np.where(x <= lo, g, -g))
            viol = np.flatnonzero((~free) & (lam < -mul_tol))
            if viol.size == 0:
                report.iterates.append(rec)
                lane.end()
                break
            j = int(viol[np.argmin(lam[viol])])   # most negative
            rec["release"] = j
            toggle(j, True, rec)
        else:
            alpha, blocker, side = 1.0, -1, 0.0
            for i in np.flatnonzero(free):
                if p[i] > _RATIO_EPS:
                    r, bnd = (hi[i] - x[i]) / p[i], hi[i]
                elif p[i] < -_RATIO_EPS:
                    r, bnd = (lo[i] - x[i]) / p[i], lo[i]
                else:
                    continue
                if r < alpha - 1e-15:
                    alpha, blocker, side = r, i, bnd
            x = x + max(0.0, min(1.0, alpha)) * p
            if blocker >= 0:
                blocker = int(blocker)
                x[blocker] = side
                rec["add"] = blocker
                toggle(blocker, False, rec)
        report.iterates.append(rec)
        lane.end()
    else:
        _finalize(report, x, None, kkt_rel, thr, lane)
        report.objective = float(0.5 * x @ q @ x + c @ x)
        report.fingerprint = _fingerprint(x, report.objective)
        raise OptimizeError(
            f"QP active-set did not terminate in {max_iters} "
            f"iterations", report)
    _finalize(report, x, None, kkt_rel, thr, lane)
    report.objective = float(0.5 * x @ q @ x + c @ x)
    report.fingerprint = _fingerprint(x, report.objective)
    report.converged = bool(kkt_converged(kkt_rel, thr))
    if ckpt_store is not None:
        ckpt_store.discard(run_id, reason="complete")
    return report
