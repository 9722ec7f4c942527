"""``lp_demo``, the ``--lp-demo`` run.  Counterpart of the JAX package's
``lpqp/demo.py``.

Four legs share ONE fleet-shared executor store:

  1. **driver convergence**: a warmed :class:`~..fleet.JordanFleet` serves
     four driver runs (LP well/ill, QP well/ill), each one
     ``invert(resident=True)`` and a correlated stream of rank-k updates
     and verification solves.  Zero builds and zero plan-cache
     measurements after warmup, every update accounted ``refreshed |
     re_inverted | gated``, convergence judged by the solver's own
     eps·n·κ gate (``tools/check_lp.py`` re-derives it from the iterate
     residuals; exit 2 = silent divergence).
  2. **drift-budget probe**: the well LP through a fleet with a ZERO drift
     budget: every update walks the ``re_invert`` rung and the driver
     still converges.
  3. **fleet chaos**: the ill LP twice through an N-replica fleet,
     fault-free (the replay) and under a seeded ``replica_kill`` schedule.
     The handles live in the shared store, so every per-iteration outcome
     tuple and the final fingerprint must bit-match the replay.
  4. **batched update lanes**: ``batch_cap`` distinct resident handles
     stream updates through the batched update lane: the warm per-update
     latency at occupancy > 1 against one launch per update, the
     zero-build pin held across the measurement.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..interop import resolve_device, resolve_dtype
from ..obs.metrics import REGISTRY
from ..resilience import FaultPlan, ResiliencePolicy
from ..resilience import activate as _activate
from ..resilience.policy import RetryPolicy
from ..serve.executors import ExecutorStore, bucket_for, k_bucket_for
from .driver import OptimizeError, solve_lp, solve_qp
from .problem import lp_instance, qp_instance


def _counters():
    c = REGISTRY.counter
    return {
        "compiles": c("tpu_jordan_torch_compiles_total").total(),
        "measurements": c("tpu_jordan_torch_tuner_measurements_total").total(),
        "rungs": c("tpu_jordan_torch_recovery_rungs_total").total(),
        "deaths": c("tpu_jordan_torch_fleet_replica_deaths_total").total(),
        "restarts": c("tpu_jordan_torch_fleet_restarts_total").total(),
        "reroutes": c("tpu_jordan_torch_fleet_reroutes_total").total(),
        "faults": c("tpu_jordan_torch_faults_injected_total").total(),
    }


def _median(samples):
    s = sorted(samples)
    return s[len(s) // 2] if s else None


def _iterate_trace(report: dict) -> list:
    """The chaos bit-compare token stream: one tuple per iteration —
    the fleet-judged outcome, the committed handle version, and the
    EXACT bits of the KKT residual (float hex)."""
    return [[r.get("outcome"), r.get("version"), r["kkt_hex"]]
            for r in report["iterates"]]


def _run_leg(fleet, prob, kind):
    """One driver run folded to its report dict; a typed driver
    failure becomes a non-converged report carrying the error (the
    checker treats it as divergence, never a crash)."""
    solver = solve_lp if kind == "lp" else solve_qp
    try:
        return solver(prob, fleet).to_dict(), None
    except OptimizeError as e:
        rep = (e.report.to_dict() if e.report is not None
               else {"converged": False, "iterates": [], "ledger": {},
                     "updates": 0, "solves": 0})
        return rep, f"{type(e).__name__}: {e}"


def lp_demo(n: int = 16, block_size: int | None = None, seed: int = 0,
            replicas: int = 3, kills: int = 1, batch_cap: int = 4,
            dtype=torch.float64, telemetry=None, device=None) -> dict:
    """Run the four-leg LP/QP driver demo; returns the one-line JSON report
    ``tools/check_lp.py`` judges (exit 2 = silent divergence).  ``device``:
    the card unless "cpu"."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if n < 4:
        raise ValueError("lp_demo needs n >= 4")
    if batch_cap < 2:
        raise ValueError("lp_demo needs batch_cap >= 2 (the batched "
                         "amortization leg measures occupancy > 1)")
    store = ExecutorStore()
    policy = ResiliencePolicy(
        retry=RetryPolicy(max_retries=max(4, kills + 2), backoff_s=0.0))
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    fleet_kw = dict(engine="auto", dtype=dtype, batch_cap=1,
                    max_wait_ms=0.5, block_size=block_size,
                    policy=policy, executor_store=store,
                    stable_after_s=0.2, liveness_deadline_s=5.0,
                    telemetry=telemetry, device=dev)
    probs = {
        "lp_well": ("lp", lp_instance(m=n, seed=seed, cond="well",
                                      dtype=np_dtype)),
        "lp_ill": ("lp", lp_instance(m=n, seed=seed, cond="ill",
                                     dtype=np_dtype)),
        "qp_well": ("qp", qp_instance(n=n, seed=seed, cond="well",
                                      dtype=np_dtype)),
        "qp_ill": ("qp", qp_instance(n=n, seed=seed, cond="ill",
                                     dtype=np_dtype)),
    }
    warm_kw = dict(update_shapes=[(n, 1), (n, 2)],
                   solve_shapes=[(n, 1)])
    errors: list[str] = []

    # ---- leg 1: the four driver runs through one warmed fleet -------
    from ..fleet import JordanFleet

    legs = {}
    with JordanFleet(replicas=replicas, **fleet_kw) as fleet:
        fleet.warmup([n], **warm_kw)
        after_warm = _counters()
        for name, (kind, prob) in probs.items():
            legs[name], err = _run_leg(fleet, prob, kind)
            if err:
                errors.append(f"{name}: {err}")
        fleet_stats = fleet.stats()
    leg1 = _counters()

    # ---- leg 2: zero drift budget -> every update rides re_invert ---
    with JordanFleet(replicas=min(2, replicas),
                     update_drift_budget_factor=0.0,
                     **fleet_kw) as dfleet:
        dfleet.warmup([n], **warm_kw)
        drift_rep, err = _run_leg(dfleet, probs["lp_well"][1], "lp")
        if err:
            errors.append(f"drift_probe: {err}")
    leg2 = _counters()

    # ---- leg 3: chaos vs fault-free replay --------------------------
    chaos_prob = probs["lp_ill"][1]
    before_base = leg2
    with JordanFleet(replicas=replicas, **fleet_kw) as bfleet:
        bfleet.warmup([n], **warm_kw)
        base_rep, err = _run_leg(bfleet, chaos_prob, "lp")
        if err:
            errors.append(f"chaos_baseline: {err}")
    after_base = _counters()
    horizon = max(3, 2 * n)
    plan = FaultPlan.seeded(seed,
                            points={"replica_kill": (kills, horizon)})
    with JordanFleet(replicas=replicas, **fleet_kw) as cfleet:
        cfleet.warmup([n], **warm_kw)
        chaos_warm = _counters()
        with _activate(plan):
            chaos_rep, err = _run_leg(cfleet, chaos_prob, "lp")
        if err:
            errors.append(f"chaos: {err}")
    after_chaos = _counters()

    base_trace = _iterate_trace(base_rep)
    chaos_trace = _iterate_trace(chaos_rep)
    mismatches = []
    matched = 0
    for i, (bt, ct) in enumerate(zip(base_trace, chaos_trace)):
        if bt == ct:
            matched += 1
        else:
            mismatches.append({"iterate": i, "why": (
                f"outcome diverged from the fault-free replay: "
                f"{bt} vs {ct}")})
    if len(base_trace) != len(chaos_trace):
        mismatches.append({"iterate": "length", "why": (
            f"iteration counts diverged: {len(base_trace)} fault-free "
            f"vs {len(chaos_trace)} under chaos")})
    fp_match = (base_rep.get("fingerprint") == chaos_rep.get("fingerprint")
                and bool(base_rep.get("fingerprint")))
    if not fp_match:
        mismatches.append({"iterate": "final", "why": (
            "final solution fingerprint diverged from the fault-free "
            "replay")})

    # ---- leg 4: batched update lanes --------------------------------
    from ..serve.service import JordanService

    rng = np.random.default_rng(seed + 1)
    scale = 1.0 / np.sqrt(float(n))
    seq_lat, batched_lat, occs = [], [], []
    rounds = 5
    with JordanService(engine="auto", dtype=dtype, batch_cap=batch_cap,
                       max_wait_ms=25.0, block_size=block_size,
                       policy=policy, shared_executors=store,
                       telemetry=telemetry, device=dev) as svc:
        svc.warmup(update_shapes=[(n, 1)])
        refs = []
        for i in range(batch_cap):
            a_i = (rng.standard_normal((n, n))
                   + n * np.eye(n)).astype(np_dtype)
            refs.append(svc.invert(a_i, resident=True,
                                   handle_id=f"amort-{i}", timeout=600))
        muts = [(rng.standard_normal((n, 1)).astype(np_dtype) * scale,
                 rng.standard_normal((n, 1)).astype(np_dtype) * scale)
                for _ in range(batch_cap)]
        amort_before = _counters()
        for _ in range(rounds):
            # One-per-launch baseline: strictly sequential, each
            # update is its own cap-1 launch (occupancy 1).
            for ref, (u, v) in zip(refs, muts):
                res = svc.update(ref, u, v, timeout=600)
                seq_lat.append(res.execute_seconds)
            # Batched: one update per DISTINCT handle submitted
            # together — the batcher fuses them into one batched
            # launch; per-update cost is the launch amortized over
            # the measured occupancy.
            futs = [svc.submit_update(ref, u, v)
                    for ref, (u, v) in zip(refs, muts)]
            results = [f.result(600) for f in futs]
            occs.append(max(r.batch_occupancy for r in results))
            batched_lat.extend(r.execute_seconds / r.batch_occupancy
                               for r in results)
        amort_after = _counters()
    occupancy = max(occs) if occs else 0
    seq_ms = _median(seq_lat) * 1e3 if seq_lat else None
    amort_ms = _median(batched_lat) * 1e3 if batched_lat else None
    speedup = (round(seq_ms / amort_ms, 3)
               if seq_ms and amort_ms else None)

    # ---- the silent-divergence verdict ------------------------------
    def _accounted(rep):
        led = rep.get("ledger", {})
        return sum(led.values()) == rep.get("updates", -1)

    pins_ok = (leg1["compiles"] - after_warm["compiles"] == 0
               and leg1["measurements"] - after_warm["measurements"] == 0
               and after_chaos["compiles"] - chaos_warm["compiles"] == 0
               and amort_after["compiles"] - amort_before["compiles"] == 0)
    drift_rungs = leg2["rungs"] - leg1["rungs"]
    drift_ok = (drift_rep.get("converged", False)
                and drift_rep.get("ledger", {}).get("re_inverted", 0)
                == drift_rep.get("updates", -1))
    silent = (bool(errors) or bool(mismatches)
              or not all(r.get("converged") for r in legs.values())
              or not all(_accounted(r) for r in legs.values())
              or not _accounted(drift_rep) or not _accounted(chaos_rep)
              or not drift_ok or not pins_ok
              or occupancy <= 1
              or not (speedup is not None and speedup > 1.0)
              or fleet_stats["ledger"]["outstanding"] != 0)

    report = {
        "metric": "lp_demo",
        "n": n, "seed": seed, "replicas": replicas, "kills": kills,
        "batch_cap": batch_cap, "dtype": np_dtype.name,
        "device": str(dev),
        "bucket_n": bucket_for(n),
        "k_buckets": [k_bucket_for(1), k_bucket_for(2)],
        "legs": legs,
        "compiles_after_warmup": leg1["compiles"] - after_warm["compiles"],
        "measurements_after_warmup": (leg1["measurements"]
                                      - after_warm["measurements"]),
        "drift_probe": {
            "forced_budget_factor": 0.0,
            "converged": bool(drift_rep.get("converged", False)),
            "ledger": drift_rep.get("ledger", {}),
            "updates": drift_rep.get("updates", 0),
            "rungs_fired": drift_rungs,
            "kkt_rel_final": drift_rep.get("kkt_rel_final"),
            "kkt_threshold": drift_rep.get("kkt_threshold"),
        },
        "chaos": {
            "faults": plan.report(),
            "kills_injected": int(after_chaos["faults"]
                                  - after_base["faults"]),
            "deaths": after_chaos["deaths"] - after_base["deaths"],
            "restarts": after_chaos["restarts"] - after_base["restarts"],
            "reroutes": after_chaos["reroutes"] - after_base["reroutes"],
            "compiles_delta_after_warmup": (after_chaos["compiles"]
                                            - chaos_warm["compiles"]),
            "ledger": chaos_rep.get("ledger", {}),
            "converged": bool(chaos_rep.get("converged", False)),
            "baseline_fingerprint": base_rep.get("fingerprint", ""),
            "chaos_fingerprint": chaos_rep.get("fingerprint", ""),
            "fingerprint_bitmatch": bool(fp_match),
            "iterates_matched": matched,
            "iterates_total": len(base_trace),
        },
        "batched": {
            "batch_cap": batch_cap,
            "rounds": rounds,
            "occupancy": int(occupancy),
            "warm_one_per_launch_ms": (round(seq_ms, 4)
                                       if seq_ms else None),
            "warm_batched_amortized_ms": (round(amort_ms, 4)
                                          if amort_ms else None),
            "speedup_x": speedup,
            "amortized_beats_one_per_launch": bool(
                speedup is not None and speedup > 1.0),
            "compiles_delta": (amort_after["compiles"]
                               - amort_before["compiles"]),
        },
        "errors": errors,
        "mismatches": mismatches,
        "fleet_ledger": fleet_stats["ledger"],
        "silent_divergence": bool(silent),
        "elapsed_s": round(time.perf_counter() - t0, 3),
    }
    return report
