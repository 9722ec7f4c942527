"""``fleet_demo``, the ``--fleet-demo`` run.  Counterpart of the JAX
package's ``fleet/demo.py``.

Four phases share ONE :class:`~..serve.executors.ExecutorStore` and ONE
plan cache written once and then read only, so build accounting spans the
whole demo:

  0. **pretune**: a throwaway writable service warms every bucket,
     building each (bucket, batch_cap) executor once into the shared
     store and writing the engine plans to the plan-cache file; every
     later phase opens it ``read_only=True``.
  1. **baseline**: the deterministic mixed stream of the chaos demo (sizes
     {n, n/2}, seeded fixtures, rank-1 singular matrices at fixed indices)
     through a 1-replica fleet: one untimed warm lap, then the median of 3
     timed laps.
  2. **fleet, fault-free**: the same stream through an N-replica fleet,
     the same laps: throughput scaling and the replay baseline (shared
     executors make every replica's answer for an element the same
     bytes).
  3. **fleet, chaos**: the same stream again, staged (queued before the
     dispatchers start, so a killed replica provably holds queued work),
     under a seeded ``FaultPlan`` whose ``replica_kill`` crashes replicas
     mid-stream.  The supervisor warm-replaces each victim from the shared
     store (zero builds after warmup), the router re-queues the victim's
     queued requests, and every response must bit-match phase 2 or carry
     a typed error (``tools/check_fleet.py``; exit 2 = silent loss).

Scaling: the replicas are threads of one interpreter and launch on one
card's default stream, so the wall-clock ``scaling_x`` is near 1 on one
card; the report records it against an explicit ``scaling_floor``
(default 0.6: a fleet must not cost material throughput against one
replica).  ``slo_report=True`` brackets phases 2 and 3 with an
:class:`~..obs.slo.SLOMonitor` at demo-scaled windows and embeds its
evaluation (``tools/check_slo.py``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch

from ..interop import resolve_device, resolve_dtype
from ..obs import hwcost as _hwcost
from ..obs.journey import outcome_ledger
from ..obs.metrics import REGISTRY, percentiles
from ..obs.recorder import RECORDER
from ..obs.slo import SLOMonitor, bucket_specs
from ..resilience import FaultPlan, ResiliencePolicy
from ..resilience import activate as _activate
from ..resilience.policy import RetryPolicy
from ..serve.executors import ExecutorStore, bucket_for
from ..serve.service import (JordanService, _chaos_requests,
                             _classify_response, compare_outcomes)
from .pool import JordanFleet
from .replica import READY

#: The default scaling floor: a fleet of threads on one device must not
#: cost material single-replica throughput; the ~Nx claim needs parallel
#: devices and an explicit floor.
DEFAULT_SCALING_FLOOR = 0.6


def _run_fleet_stream(fleet: JordanFleet, mats, staged: bool,
                      timeout: float = 600.0):
    """Run the stream and classify every response: (outcomes, elapsed_s,
    latencies_ms).  ``staged=True`` queues everything before starting the
    dispatchers; latencies are then measured from the start."""
    futs = []
    t_submit = []
    t0 = time.perf_counter()
    for a in mats:
        t_submit.append(time.perf_counter())
        try:
            futs.append(fleet.submit(a))
        except Exception as e:                        # noqa: BLE001
            futs.append(e)
    if staged:
        fleet.start()
        t_start = time.perf_counter()
        t_submit = [t_start] * len(futs)
    out, lat_ms = [], []
    for ts, f in zip(t_submit, futs):
        out.append(_classify_response(f, timeout))
        if not isinstance(f, Exception):
            lat_ms.append((time.perf_counter() - ts) * 1e3)
    return out, time.perf_counter() - t0, lat_ms


def _counters():
    c = REGISTRY.counter
    shed = c("tpu_jordan_torch_fleet_shed_total")
    return {
        "compiles": c("tpu_jordan_torch_compiles_total").total(),
        "deaths": c("tpu_jordan_torch_fleet_replica_deaths_total").total(),
        "restarts": c("tpu_jordan_torch_fleet_restarts_total").total(),
        "restart_failures":
            c("tpu_jordan_torch_fleet_restart_failures_total").total(),
        "measurements":
            c("tpu_jordan_torch_tuner_measurements_total").total(),
        "reroutes": c("tpu_jordan_torch_fleet_reroutes_total").total(),
        "shed_dead": shed.value(reason="dead"),
        "shed_breaker": shed.value(reason="breaker"),
        "shed_overload": shed.value(reason="overload"),
        "faults_injected":
            c("tpu_jordan_torch_faults_injected_total").total(),
    }


def fleet_demo(n: int = 96, replicas: int = 3, requests: int = 60,
               batch_cap: int = 4, max_wait_ms: float = 2.0,
               kills: int = 2, seed: int = 0, block_size: int | None = None,
               dtype=torch.float32, plan_cache: str | None = None,
               scaling_floor: float | None = None,
               p99_bound_ms: float | None = None,
               telemetry=None, slo_report: bool = False,
               device=None) -> dict:
    """Run the four-phase fleet demo; returns the one-line JSON report
    ``tools/check_fleet.py`` judges.  ``plan_cache`` None: a temporary
    cache written by phase 0 and deleted after.  ``device``: the card
    unless "cpu"."""
    t_all = time.perf_counter()
    if replicas < 2:
        raise ValueError("fleet_demo needs replicas >= 2 (the scaling "
                         "and kill phases are fleet properties)")
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    mats = _chaos_requests(n, requests, seed, dtype)
    shapes = sorted({a.shape[0] for a in mats})
    store = ExecutorStore()
    # Each kill can re-queue a victim's whole backlog, and a request may
    # chase more than one kill.
    policy = ResiliencePolicy(
        retry=RetryPolicy(max_retries=max(4, kills + 2), backoff_s=0.0))
    scaling_floor = (DEFAULT_SCALING_FLOOR if scaling_floor is None
                     else float(scaling_floor))

    cache_dir = None
    if plan_cache is None:
        cache_dir = tempfile.mkdtemp(prefix="tpu_jordan_torch_fleet_")
        plan_cache = os.path.join(cache_dir, "plans.json")
    try:
        # ---- phase 0: pretune (the only writer) ----------------------
        with JordanService(engine="auto", plan_cache=plan_cache,
                           dtype=dtype, batch_cap=batch_cap,
                           max_wait_ms=max_wait_ms, autostart=False,
                           block_size=block_size, policy=policy,
                           shared_executors=store, telemetry=telemetry,
                           device=dev) as svc:
            svc.warmup(shapes=shapes)
            pretuned_keys = len(store)
        counters_pretune = _counters()
        compiles_pretune = counters_pretune["compiles"]

        fleet_kw = dict(
            engine="auto", plan_cache=plan_cache,
            plan_cache_read_only=True, dtype=dtype, batch_cap=batch_cap,
            max_wait_ms=max_wait_ms, max_queue=max(requests * 2, 64),
            block_size=block_size, policy=policy, telemetry=telemetry,
            executor_store=store, stable_after_s=0.2,
            liveness_deadline_s=5.0, device=dev)

        # ---- phase 1: single-replica baseline ------------------------
        # An untimed warm lap first (one-time process costs would deflate
        # the reference and inflate scaling_x), then the median of 3.
        with JordanFleet(replicas=1, **fleet_kw) as one:
            one.warmup(shapes)
            _run_fleet_stream(one, mats, staged=False)
            laps1 = [_run_fleet_stream(one, mats, staged=False)
                     for _ in range(3)]
        _, el1, lat1 = sorted(laps1, key=lambda r: r[1])[1]
        single_rps = requests / el1

        # ---- the SLO monitor (--slo-report) --------------------------
        # One sample before the fault-free fleet pass, one after it, one
        # after the chaos pass, at demo-scaled windows.  Availability 0.95:
        # the seeded chaos dose of typed errors spends budget visibly
        # without paging a healthy fleet.
        monitor = None
        if slo_report:
            monitor = SLOMonitor(
                bucket_specs((bucket_for(s) for s in shapes),
                             availability=0.95),
                windows=((60.0, 10.0, 14.4), (300.0, 60.0, 6.0)))
            monitor.sample()

        # ---- phase 2: N-replica fleet, fault-free --------------------
        with JordanFleet(replicas=replicas, **fleet_kw) as flt:
            flt.warmup(shapes)
            _run_fleet_stream(flt, mats, staged=False)
            laps2 = [_run_fleet_stream(flt, mats, staged=False)
                     for _ in range(3)]
            exec_spread = flt.stats()["exec_spread"]
        baseline, el2, lat2 = sorted(laps2, key=lambda r: r[1])[1]
        fleet_rps = requests / el2
        scaling_x = fleet_rps / single_rps
        if monitor is not None:
            monitor.sample()

        # ---- the seeded kill schedule: past the first few routed calls
        # (the victim holds queued work in the staged run), well inside
        # the stream.
        horizon = max(4, requests // 2)
        plan = FaultPlan.seeded(seed,
                                points={"replica_kill": (kills, horizon)})

        # ---- phase 3: N-replica fleet under seeded replica_kill ------
        before = _counters()
        chaos_fleet = JordanFleet(replicas=replicas, autostart=False,
                                  **fleet_kw)
        try:
            chaos_fleet.warmup(shapes)
            after_warm = _counters()
            # The black-box window of the chaos pass: every hop, kill,
            # restart, reroute and fault lands in the embedded slice.
            bb_mark = RECORDER.total
            with _activate(plan):
                chaos, el3, lat3 = _run_fleet_stream(chaos_fleet, mats,
                                                     staged=True)
            chaos_stats = chaos_fleet.stats()
        finally:
            chaos_fleet.close()
        blackbox = RECORDER.dump(events=RECORDER.since(bb_mark))
        journey_ledger = outcome_ledger(blackbox["events"])
        after = _counters()
        if monitor is not None:
            monitor.sample()
    finally:
        if cache_dir is not None:
            shutil.rmtree(cache_dir, ignore_errors=True)

    delta = {k: after[k] - before[k] for k in before}
    compiles_after_warmup = after["compiles"] - after_warm["compiles"]
    matched, singular, typed_errors, mismatches = compare_outcomes(
        baseline, chaos)

    ledger = chaos_stats["ledger"]
    typed_total = sum(typed_errors.values())
    # A journey GAP (submitted, never resolved) is silent loss whatever
    # the response-side ledger claims.
    silent_loss = (bool(mismatches)
                   or ledger["outstanding"] != 0
                   or matched + typed_total + len(mismatches) != requests
                   or bool(journey_ledger["gaps"]))
    # Process-wide over every serving phase (a killed replica's own tuner
    # would be discarded with it).
    measurements = after["measurements"] - counters_pretune["measurements"]
    # Deaths an OPEN restart breaker deliberately left unfilled.
    stranded_by_breaker = sum(
        1 for s in chaos_stats["slots"]
        if s["restart_breaker"] == "open"
        and (s["replica"] is None or s["replica"]["state"] != READY))

    def p99(xs):
        v = percentiles(xs)["p99"]
        return 0.0 if v is None else float(v)

    # The shared store's per-executor compiler cost (none in eager
    # PyTorch: an empty map, never a modeled one), the runtime
    # fingerprint and the device watermark.
    executables = {}
    for key, ex in store.entries():
        cost = getattr(ex, "cost", None)
        if cost is not None and cost.available:
            executables[f"{key.bucket_n}x{key.batch_cap}"
                        f"@{key.engine}"] = cost.to_json()
    hwcost_block = {
        "env": _hwcost.runtime_env(),
        "executables": executables,
        "device_memory": _hwcost.device_memory_stats(dev),
    }

    fleet_p99_ms = p99(lat2)
    if p99_bound_ms is None:
        # A runaway guard, not a performance SLO: the closed-loop p99 is
        # about the whole stream's drain time.
        p99_bound_ms = max(2000.0, 5e3 * el1)

    return {
        "metric": "fleet_demo",
        "n": n,
        "requests": requests,
        "request_sizes": shapes,
        "replicas": replicas,
        "batch_cap": batch_cap,
        "seed": seed,
        "device": str(dev),
        "worker_backend": "in-process-threads",
        "plan_cache": {
            "pretuned_keys": pretuned_keys,
            "read_only": True,
            "measurements": measurements,
            "compiles_pretune": compiles_pretune,
        },
        "throughput": {
            "single_rps": round(single_rps, 1),
            "fleet_rps": round(fleet_rps, 1),
            "scaling_x": round(scaling_x, 3),
            "scaling_floor": scaling_floor,
            "scaling_note": (
                "in-process worker backend: replicas share one "
                "interpreter and one device's default stream — ~Nx "
                "wall-clock scaling is a parallel-hardware claim; the "
                "floor pins 'a fleet never costs material throughput'"),
            "single_p99_ms": round(p99(lat1), 1),
            "fleet_p99_ms": round(fleet_p99_ms, 1),
            "chaos_p99_ms": round(p99(lat3), 1),
            "p99_bound_ms": round(p99_bound_ms, 1),
            # The fault-free fleet's per-replica execute p99s and their
            # max/min ratio (serve.stats.cross_replica_spread).
            "exec_spread": exec_spread,
        },
        "chaos": {
            "faults": plan.report(),
            "kills_injected": int(delta["faults_injected"]),
            "deaths": delta["deaths"],
            "restarts": delta["restarts"],
            "restart_failures": delta["restart_failures"],
            "stranded_by_breaker": stranded_by_breaker,
            "reroutes": delta["reroutes"],
            "shed": {"dead": delta["shed_dead"],
                     "breaker": delta["shed_breaker"],
                     "overload": delta["shed_overload"]},
            "compiles_delta_after_warmup": compiles_after_warmup,
            "lineage": {str(s["slot"]): s["lineage"]
                        for s in chaos_stats["slots"]},
            "elapsed_s": round(el3, 3),
        },
        "hwcost": hwcost_block,
        "ledger": ledger,
        "journey_ledger": journey_ledger,
        "blackbox": blackbox,
        "matched_bitwise": matched,
        "singular_flagged": singular,
        "typed_errors": typed_errors,
        "mismatches": mismatches,
        "silent_loss": silent_loss,
        **({"slo": monitor.evaluate()} if monitor is not None else {}),
        "elapsed_s": round(time.perf_counter() - t_all, 3),
    }
