"""``update_demo``, the ``--update-demo`` run.  Counterpart of the JAX
package's ``serve/update_demo.py``.

One run proves the resident-inverse contract end to end, in three legs that
share one executor store:

  1. **serve ledger**: a warmed :class:`~.service.JordanService` creates a
     resident handle and streams ``updates`` rank-``rank`` mutations
     through the update lane, with one rank-destroying mutation mid-stream
     (its typed ``gated`` outcome must ride the ledger) and a service with
     a zero drift budget, whose update walks the ``re_invert`` rung.  Zero
     builds and zero plan-cache measurements on the warm update path, and
     every update accounted ``refreshed | re_inverted | gated``.
  2. **warm latency**: the median warm update against the median warm
     re-invert at the same bucket (the update must win).  Eager PyTorch
     has no compiled executable to ask for its FLOPs
     (``hwcost.UNAVAILABLE``), so ``flops_below_invert`` is None, which
     ``tools/check_update.py`` notes and does not fail.
  3. **fleet chaos**: the same stream twice through an N-replica
     :class:`~..fleet.JordanFleet`: fault-free (the replay baseline), then
     under a seeded ``replica_kill`` schedule.  Handles live in the fleet's
     shared store, so every per-update outcome and the final resident
     inverse must bit-match the replay, and the final inverse must pass
     the residual gate against the mutated matrix, beside a from-scratch
     invert of it through the warm invert lane.

``_fixture``, ``_singular_factors``, ``_classify_update`` and
``_run_update_stream`` are the JAX package's, including its recipe for the
rank-destroying update (zero column 0 of the committed A), whose verdict
sits on a knife edge at gaussian fixtures (ROADMAP.md Queue C).
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
from .executors import ExecutorStore, bucket_for, k_bucket_for
from .service import JordanService


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fixture(n: int, rank: int, updates: int, seed: int, dtype):
    """The deterministic fixture: one seeded gaussian A and an update
    stream scaled so each mutation perturbs without destroying the
    conditioning.  Update ``updates // 2`` is replaced at stream time by
    the rank-destroying mutation (against the then-committed A)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(dtype)
    scale = 1.0 / np.sqrt(float(n) * rank)
    stream = [(rng.standard_normal((n, rank)).astype(dtype) * scale,
               rng.standard_normal((n, rank)).astype(dtype) * scale)
              for _ in range(updates)]
    return a, stream


def _singular_factors(a_committed: np.ndarray, n: int, rank: int, dtype):
    """Rank-destroying factors against the committed matrix: zero its
    column 0 (u = −A·e₀, padded to rank k with zero columns), so the
    capacitance determinant det(A+UVᵀ)/det(A) is the singularity signal the
    typed ``gated`` outcome must carry."""
    u = np.zeros((n, rank), dtype)
    v = np.zeros((n, rank), dtype)
    u[:, 0] = -np.asarray(a_committed[:n, 0])
    v[0, 0] = 1.0
    return u, v


def _classify_update(target, ref, u, v, timeout: float = 600.0):
    """One update's outcome tuple for the replay comparison: ("ok",
    outcome, version, inverse bytes) or ("error", type name).  ``target``
    is a JordanService or a JordanFleet (the same surface)."""
    try:
        res = target.submit_update(ref, u, v).result(timeout)
        if res.singular:
            return ("ok", "gated", res.handle_version, b"")
        return ("ok", res.update_outcome, res.handle_version,
                _host(res.inverse).tobytes())
    except Exception as e:                           # noqa: BLE001
        return ("error", type(e).__name__)


def _run_update_stream(target, ref, a0, stream, n, rank, dtype,
                       singular_at: int | None):
    """Apply the stream in order (per-handle order is the determinism
    contract) and track the mutated matrix on the host, the from-scratch
    verification's target.  Returns (outcomes, a_track)."""
    a_track = np.asarray(a0, dtype).copy()
    outcomes = []
    for i, (u, v) in enumerate(stream):
        if singular_at is not None and i == singular_at:
            u, v = _singular_factors(a_track, n, rank, dtype)
        out = _classify_update(target, ref, u, v)
        outcomes.append(out)
        if out[0] == "ok" and out[1] in ("refreshed", "re_inverted"):
            a_track = a_track + u @ v.T
    return outcomes, a_track


def _median_latency(samples):
    s = sorted(samples)
    return s[len(s) // 2] if s else None


def update_demo(n: int = 2048, block_size: int | None = None,
                rank: int = 32, updates: int = 8, replicas: int = 3,
                kills: int = 1, seed: int = 0, dtype=torch.float32,
                telemetry=None, device=None) -> dict:
    """Run the three-leg resident-update demo; returns the one-line report
    ``tools/check_update.py`` judges (exit 2: a silently stale inverse).
    ``device``: the card unless "cpu"."""
    t0 = time.perf_counter()
    if updates < 3:
        raise ValueError("update_demo needs updates >= 3 (the ledger "
                         "must show refreshed + gated outcomes)")
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    # numpy has no bfloat16: sub-fp32 fixtures are made in fp32.
    np_dtype = (np.dtype(np.float32) if dtype.itemsize < 4
                else np.dtype(str(dtype).removeprefix("torch.")))
    a0, stream = _fixture(n, rank, updates, seed, np_dtype)
    singular_at = updates // 2
    store = ExecutorStore()
    policy = ResiliencePolicy(
        retry=RetryPolicy(max_retries=max(4, kills + 2), backoff_s=0.0))
    bucket = bucket_for(n)
    kb = k_bucket_for(rank)

    def counters():
        c = REGISTRY.counter
        return {
            "compiles": c("tpu_jordan_torch_compiles_total").total(),
            "measurements":
                c("tpu_jordan_torch_tuner_measurements_total").total(),
            "rungs": c("tpu_jordan_torch_recovery_rungs_total").total(),
            "deaths":
                c("tpu_jordan_torch_fleet_replica_deaths_total").total(),
            "restarts": c("tpu_jordan_torch_fleet_restarts_total").total(),
            "reroutes": c("tpu_jordan_torch_fleet_reroutes_total").total(),
            "faults": c("tpu_jordan_torch_faults_injected_total").total(),
        }

    svc_kw = dict(engine="auto", dtype=dtype, batch_cap=1, max_wait_ms=0.5,
                  block_size=block_size, policy=policy,
                  shared_executors=store, device=dev)

    # ---- leg 1: serve ledger ----------------------------------------
    with JordanService(telemetry=telemetry, **svc_kw) as svc:
        svc.warmup(update_shapes=[(n, rank)])
        after_warm = counters()
        ref = svc.invert(a0, resident=True, handle_id="svc", timeout=600)
        ledger_outcomes, a_track = _run_update_stream(
            svc, ref, a0, stream, n, rank, np_dtype, singular_at)

        # ---- leg 2: warm latency, same warm service -----------------
        upd_lat, inv_lat = [], []
        for i in range(3):
            u, v = stream[i % len(stream)]
            res = svc.update(ref, u, v, timeout=600)
            upd_lat.append(res.execute_seconds)
            a_track = a_track + u @ v.T
            inv_res = svc.submit(a_track).result(600)
            inv_lat.append(inv_res.execute_seconds)
        ex_upd = svc.executors.get(bucket, 1, svc._batcher.block_size,
                                   workload="update", rhs=kb)
        ex_inv = svc.executors.get(bucket, 1, svc._batcher.block_size)
        svc_stats = svc.stats()
    serve_counters = counters()

    # The re_invert rung, deterministically: a zero drift budget trips it
    # on every update, whatever the fixture's conditioning.
    with JordanService(update_drift_budget_factor=0.0, **svc_kw) as svc2:
        svc2.warmup(update_shapes=[(n, rank)])
        ref2 = svc2.invert(a0, resident=True, handle_id="svc-drift",
                           timeout=600)
        u, v = stream[0]
        drift_res = svc2.update(ref2, u, v, timeout=600)
    drift_counters = counters()

    upd_ms = _median_latency(upd_lat) * 1e3
    inv_ms = _median_latency(inv_lat) * 1e3
    upd_flops = ex_upd.cost.flops if ex_upd.cost.available else None
    inv_flops = ex_inv.cost.flops if ex_inv.cost.available else None
    from ..obs import hwcost as _hwcost

    analytical = _hwcost.baseline_workload_flops(bucket, "update", k=kb)

    # ---- leg 3: fleet chaos against the fault-free replay -----------
    from ..fleet import JordanFleet

    fleet_kw = dict(engine="auto", dtype=dtype, batch_cap=1,
                    max_wait_ms=0.5, block_size=block_size,
                    policy=policy, executor_store=store,
                    stable_after_s=0.2, liveness_deadline_s=5.0,
                    max_queue=max(4 * updates, 64), device=dev)
    before = counters()
    with JordanFleet(replicas=replicas, **fleet_kw) as flt:
        flt.warmup([n], update_shapes=[(n, rank)])
        fref = flt.invert(a0, resident=True, handle_id="flt", timeout=600)
        baseline, _ = _run_update_stream(
            flt, fref, a0, stream, n, rank, np_dtype, singular_at)
        base_inv_bytes = _host(flt.handles.get("flt").inverse).tobytes()
    after_free = counters()

    horizon = max(3, updates)
    plan = FaultPlan.seeded(seed,
                            points={"replica_kill": (kills, horizon)})
    with JordanFleet(replicas=replicas, **fleet_kw) as cflt:
        cflt.warmup([n], update_shapes=[(n, rank)])
        chaos_warm = counters()
        with _activate(plan):
            cref = cflt.invert(a0, resident=True, handle_id="flt",
                               timeout=600)
            chaos, _ = _run_update_stream(
                cflt, cref, a0, stream, n, rank, np_dtype, singular_at)
        chaos_state = cflt.handles.get("flt")
        chaos_inv = _host(chaos_state.inverse).copy()
        chaos_a = _host(chaos_state.a).copy()
        chaos_snapshot = chaos_state.snapshot()
        # A from-scratch invert of the mutated matrix through the warm
        # invert lane: the independent verification target.
        fresh = cflt.invert(chaos_a[:n, :n], timeout=600)
        fleet_stats = cflt.stats()
    after = counters()
    delta = {k: after[k] - before[k] for k in before}

    # ---- chaos against the fault-free replay ------------------------
    mismatches = []
    matched = 0
    typed_errors: dict[str, int] = {}
    for i, (base, ch) in enumerate(zip(baseline, chaos)):
        if ch[0] == "error":
            typed_errors[ch[1]] = typed_errors.get(ch[1], 0) + 1
            continue
        if ch == base:
            matched += 1
        else:
            mismatches.append({"update": i, "why": (
                f"outcome diverged from the fault-free replay: "
                f"{base[:3]} vs {ch[:3]}")})
    final_bitmatch = (chaos_inv.tobytes() == base_inv_bytes)
    if not final_bitmatch:
        mismatches.append({"update": "final",
                           "why": "post-kill resident inverse bits "
                                  "diverged from the fault-free replay"})

    # ---- from-scratch verification of the post-kill inverse ---------
    from ..resilience.degrade import gate_threshold

    fresh_inv = _host(fresh.inverse)
    denom = float(np.abs(fresh_inv).sum(axis=-1).max())
    vs_fresh = (float(np.abs(chaos_inv[:n, :n] - fresh_inv)
                      .sum(axis=-1).max()) / denom if denom else 0.0)
    gate_thr = gate_threshold(policy, n, fresh.kappa, dtype)
    resident_rel = float(chaos_snapshot["rel_residual"])
    fresh_ok = bool(resident_rel <= gate_thr) and resident_rel == resident_rel

    # ---- the per-update ledgers -------------------------------------
    def tally(outs):
        t = {"refreshed": 0, "re_inverted": 0, "gated": 0, "error": 0}
        for o in outs:
            if o[0] == "error":
                t["error"] += 1
            else:
                t[o[1]] += 1
        return t

    serve_tally = tally(ledger_outcomes)
    chaos_tally = tally(chaos)
    ledger_ok = (sum(serve_tally.values()) == updates
                 and sum(chaos_tally.values()) == updates)

    silent_stale = (bool(mismatches) or not fresh_ok or not ledger_ok
                    or delta["compiles"] - (chaos_warm["compiles"]
                                            - before["compiles"]) != 0)

    return {
        "metric": "update_demo",
        "n": n, "rank": rank, "k_bucket": kb, "bucket_n": bucket,
        "updates": updates, "replicas": replicas, "seed": seed,
        "dtype": str(dtype).removeprefix("torch."),
        "device": str(dev),
        "serve": {
            "ledger": serve_tally,
            "outcomes": [list(o[:3]) for o in ledger_outcomes],
            "compiles_on_update_path": (
                serve_counters["compiles"] - after_warm["compiles"]),
            "measurements": serve_counters["measurements"]
                - after_warm["measurements"],
            "drift_rung": {
                "forced_budget_factor": 0.0,
                "outcome": drift_res.update_outcome,
                "drift_after": drift_res.drift,
                "rungs_fired": (drift_counters["rungs"]
                                - serve_counters["rungs"]),
            },
            "handles": svc_stats["handles"],
        },
        "latency": {
            "warm_update_ms": round(upd_ms, 3),
            "warm_reinvert_ms": round(inv_ms, 3),
            "update_beats_reinvert": bool(upd_ms < inv_ms),
            "speedup_x": round(inv_ms / upd_ms, 2) if upd_ms else None,
        },
        "hwcost": {
            "update_executable_flops": upd_flops,
            "invert_executable_flops": inv_flops,
            "update_vs_invert_flops": (
                round(upd_flops / inv_flops, 4)
                if upd_flops and inv_flops else None),
            "flops_below_invert": (
                bool(upd_flops < inv_flops)
                if upd_flops and inv_flops else None),
            "analytical_update_flops": analytical,
            "flops_convention": "4n^2k + 2nk^2",
            "k_over_n": round(kb / bucket, 4),
            "env": _hwcost.runtime_env(),
        },
        "chaos": {
            "faults": plan.report(),
            "kills_injected": int(delta["faults"]
                                  - (after_free["faults"]
                                     - before["faults"])),
            "deaths": delta["deaths"],
            "restarts": delta["restarts"],
            "reroutes": delta["reroutes"],
            "compiles_delta_after_warmup": (after["compiles"]
                                            - chaos_warm["compiles"]),
            "ledger": chaos_tally,
            "outcomes": [list(o[:3]) for o in chaos],
            "final_inverse_bitmatch_replay": final_bitmatch,
            "handle": chaos_snapshot,
        },
        "verification": {
            "resident_rel_residual": resident_rel,
            "gate_threshold": float(gate_thr),
            "gate_passes": fresh_ok,
            "vs_fresh_solve_rel_diff": vs_fresh,
            "fresh_solve_rel_residual": float(fresh.rel_residual),
        },
        "matched_bitwise": matched,
        "typed_errors": typed_errors,
        "mismatches": mismatches,
        "fleet_ledger": fleet_stats["ledger"],
        "silent_stale": bool(silent_stale),
        "elapsed_s": round(time.perf_counter() - t0, 3),
    }
