"""``ckpt_demo``: the ``--ckpt-demo`` run.  Counterpart of the JAX
package's ``resilience/ckpt_demo.py``: four legs share one
:class:`~.checkpoint.CheckpointStore`, so the ledger invariant ``written ==
resumed + discarded + live`` spans the whole demo.

  1. **single_invert**: a single-device blocked invert is preempted
     mid-sweep by the seeded ``preempt`` fault (``FaultPlan.seeded``: a
     derived schedule, never a probability), typed ``PreemptedError``
     after the boundary's checkpoint is durable; the resume re-enters at
     that superstep and must give the bits of the uninterrupted run with
     zero segment compiles;
  2. **dist_solve**: the same on a 1D solve over ``workers`` ranks (the
     state is the distributed working set: the [A | X] strips, the ranks'
     singular flags);
  3. **lp_stream**: a resumable LP stream over a fleet: the driver
     persists the resident handle and the iterate audit every
     ``ckpt_every`` iterations; the preempted stream resumes to the same
     ``kkt_hex`` trail and final fingerprint;
  4. **fleet_kill**: a checkpointed 1D solve on ``workers`` ranks is
     routed to a replica, the replica is killed mid-sweep (the kill
     reaches the world of ranks at its next durable boundary,
     ``checkpoint.py``), and the router re-queues it with a resume (the
     ``ckpt_resume`` hop); the surviving replica finishes from the last
     durable superstep, bit for bit.  The kill races the sweep: the leg
     retries with fresh run ids (at most 3 attempts) until a kill
     interrupted a sweep that then resumed, and reports ``kill_attempts``.

The report is the JAX demo's, keys and verdict (``silent_loss``) alike;
``tools/check_ckpt.py`` validates it.  The JAX demo re-executes itself on
a forced 8-device CPU platform; the port's demo runs where it is asked to
(the card unless ``device="cpu"``), its ranks spawned there.
"""

from __future__ import annotations

import shutil
import tempfile
import threading
import time

import numpy as np

#: The thread-name prefix of a replica's checkpointed sweep
#: (``fleet/replica.submit_solve_ckpt``): the kill leg finds the serving
#: replica by it.
CKPT_THREAD_PREFIX = "tpu-jordan-torch-ckpt-"


def _preempt_plan(seed: int, horizon: int):
    """The seeded preempt schedule of one leg: one hit, its call index
    derived from the seed over ``horizon`` boundary calls."""
    from . import FaultPlan

    return FaultPlan.seeded(seed, points={"preempt": (1, horizon)})


def _run_preempted(fn, plan):
    """Run ``fn`` under ``plan``; the typed PreemptedError, or None when
    the schedule never fired."""
    from . import activate
    from .checkpoint import PreemptedError

    try:
        with activate(plan):
            fn()
    except PreemptedError as e:
        return e
    return None


def _leg(pe, info, **fields) -> dict:
    """A resumed leg's report fields (the JAX demo's keys)."""
    return dict(
        fields,
        preempt_step=(-1 if pe is None or pe.step is None else int(pe.step)),
        bit_match=fields["resume_fp"] == fields["baseline_fp"],
        resume_start_step=info["start_step"], resumed=info["resumed"],
        resume_segments=info["segments_run"],
        resume_compiles=info["segment_compiles"])


def ckpt_demo(n: int = 96, block_size: int = 16, cadence: int = 2,
              seed: int = 0, workers: int = 4, lp_m: int = 8,
              ckpt_dir: str | None = None, dtype=None,
              device=None) -> dict:
    """Run the four legs (module docstring); returns the report
    ``tools/check_ckpt.py`` validates.  ``ckpt_dir`` None: a temporary
    store, deleted after; a path keeps the checkpoint files and the
    ledger."""
    import torch

    from ..fleet import JordanFleet
    from ..interop import resolve_device, resolve_dtype
    from ..lpqp import lp_instance, solve_lp
    from ..obs.metrics import REGISTRY
    from ..obs.recorder import RECORDER
    from ..parallel.layout import CyclicLayout
    from . import ResiliencePolicy
    from .checkpoint import (CheckpointStore, checkpointed_invert,
                             checkpointed_solve, fingerprint)
    from .policy import RetryPolicy

    t_all = time.perf_counter()
    dev = resolve_device(device)
    dt = resolve_dtype(dtype if dtype is not None else torch.float64)
    if dt.is_complex:
        from ..errors import UsageError

        raise UsageError("--ckpt-demo checkpoints the DISTRIBUTED engines "
                         "and complex dtypes run single-device; use a real "
                         "dtype")
    np_dt = np.float32 if dt.itemsize < 4 else np.dtype(
        str(dt).removeprefix("torch."))
    m, cadence = int(block_size), int(cadence)
    tmp_dir = None
    if ckpt_dir is None:
        tmp_dir = tempfile.mkdtemp(prefix="tpu_jordan_torch_ckpt_")
        ckpt_dir = tmp_dir
    store = CheckpointStore(ckpt_dir)
    mark = RECORDER.total
    rng = np.random.default_rng(seed)

    def counters():
        c = REGISTRY.counter
        return {k: c(f"tpu_jordan_torch_ckpt_{k}_total").total()
                for k in ("written", "resumed", "corrupt", "discarded")}

    before = counters()
    legs = {}
    try:
        # ---- leg 1: single-device invert, seeded preempt -------------
        a1 = np.asarray(rng.standard_normal((n, n)) + n * np.eye(n), np_dt)
        Nr1 = -(-n // m)
        boundaries1 = len(range(0, Nr1, cadence))
        kw1 = dict(store=store, cadence=cadence, engine="fori", device=dev)
        inv_base, _, _ = checkpointed_invert(a1, m, run_id="demo:single:base",
                                             **kw1)
        plan1 = _preempt_plan(seed, max(1, boundaries1 - 1))
        pe1 = _run_preempted(lambda: checkpointed_invert(
            a1, m, run_id="demo:single", **kw1), plan1)
        inv_res, _, info1 = checkpointed_invert(
            a1, m, run_id="demo:single",
            resume_from=("demo:single" if pe1 is not None
                         and pe1.step is not None else None), **kw1)
        legs["single_invert"] = _leg(
            pe1, info1, run_id="demo:single", workload="invert",
            topology="single", engine="fori", n=n, block_size=m, Nr=Nr1,
            cadence=cadence, planned_calls=plan1.report(),
            baseline_fp=fingerprint(inv_base), resume_fp=fingerprint(inv_res))

        # ---- leg 2: 1D distributed solve, seeded preempt -------------
        a2 = np.asarray(rng.standard_normal((n, n)) + n * np.eye(n), np_dt)
        b2 = np.asarray(rng.standard_normal((n, 4)), np_dt)
        lay = CyclicLayout.create(n, m, workers)
        boundaries2 = len(range(0, lay.Nr, cadence))
        kw2 = dict(store=store, cadence=cadence, engine="fori",
                   workers=workers, device=dev)
        x_base, _, _ = checkpointed_solve(a2, b2, m, run_id="demo:dist:base",
                                          **kw2)
        plan2 = _preempt_plan(seed, max(1, boundaries2 - 1))
        pe2 = _run_preempted(lambda: checkpointed_solve(
            a2, b2, m, run_id="demo:dist", **kw2), plan2)
        x_res, _, info2 = checkpointed_solve(
            a2, b2, m, run_id="demo:dist",
            resume_from=("demo:dist" if pe2 is not None
                         and pe2.step is not None else None), **kw2)
        legs["dist_solve"] = _leg(
            pe2, info2, run_id="demo:dist", workload="solve",
            topology=f"1d:{workers}", engine="fori", n=n, block_size=m,
            Nr=lay.Nr, cadence=cadence, planned_calls=plan2.report(),
            baseline_fp=fingerprint(x_base), resume_fp=fingerprint(x_res))

        # ---- legs 3 and 4 share a fleet policy -----------------------
        policy = ResiliencePolicy(
            retry=RetryPolicy(max_retries=4, backoff_s=0.0))
        fleet_kw = dict(replicas=2, engine="auto", dtype=dt, batch_cap=1,
                        max_wait_ms=0.5, stable_after_s=0.2,
                        liveness_deadline_s=30.0, policy=policy,
                        device=dev)

        # ---- leg 3: resumable LP stream, seeded preempt --------------
        prob = lp_instance(m=lp_m, seed=seed + 3, cond="well")
        with JordanFleet(**fleet_kw) as flt:
            ref = solve_lp(prob, flt)
        lp_iters = ref.iterations
        ckpt_every = 3
        plan3 = _preempt_plan(seed, max(2, lp_iters - 2))
        with JordanFleet(**fleet_kw) as flt:
            pe3 = _run_preempted(lambda: solve_lp(
                prob, flt, ckpt_store=store, ckpt_every=ckpt_every,
                run_id="demo:lp"), plan3)
            # Nothing durable (preempted before the first write, or the
            # stream finished first): a from-scratch run is the correct
            # recovery, and the report says so.
            rep = solve_lp(prob, flt, ckpt_store=store,
                           ckpt_every=ckpt_every, run_id="demo:lp",
                           resume=(pe3 is not None and pe3.step is not None))
        durable3 = pe3 is not None and pe3.step is not None
        legs["lp_stream"] = {
            "run_id": "demo:lp", "workload": "lp", "topology": "fleet",
            "engine": "simplex", "n": prob.n, "Nr": lp_iters,
            "cadence": ckpt_every, "planned_calls": plan3.report(),
            "preempt_step": int(pe3.step) if durable3 else -1,
            "baseline_fp": ref.fingerprint, "resume_fp": rep.fingerprint,
            "bit_match": rep.fingerprint == ref.fingerprint,
            "resume_start_step": int(pe3.step) if durable3 else 0,
            "resumed": durable3,
            "kkt_trail_match": ([r["kkt_hex"] for r in ref.iterates]
                                == [r["kkt_hex"] for r in rep.iterates]),
            "resume_compiles": 0,
        }

        # ---- leg 4: the fleet's kill-path resume ---------------------
        a4 = np.asarray(rng.standard_normal((n, n)) + n * np.eye(n), np_dt)
        b4 = np.asarray(rng.standard_normal((n, 4)), np_dt)
        spec = {"store": store, "cadence": cadence, "engine": "fori",
                "mesh": workers, "block_size": m}
        with JordanFleet(**fleet_kw) as flt:
            res_b = flt.solve_system(a4, b4, timeout=600.0,
                                     ckpt=dict(spec, run_id="demo:fleet:base"))
            fp_base4 = fingerprint(res_b.solution)
            attempts = 0
            while True:
                attempts += 1
                run_id = f"demo:fleet:{attempts}"
                fut = flt.submit_solve(a4, b4,
                                       ckpt=dict(spec, run_id=run_id))
                t0 = time.monotonic()
                while not store.has_live(run_id):
                    if time.monotonic() - t0 > 300:
                        raise RuntimeError(
                            "fleet leg: no checkpoint became durable")
                    time.sleep(0.001)
                serving = {t.name.split(CKPT_THREAD_PREFIX)[1]
                           for t in threading.enumerate()
                           if t.name.startswith(CKPT_THREAD_PREFIX)}
                killed = [r.name for r in flt.live_replicas()
                          if r.name in serving and r.kill(reason="chaos")]
                res4 = fut.result(timeout=600.0)
                if res4.ckpt_info["resumed"] or attempts >= 3:
                    break
        info4 = res4.ckpt_info
        legs["fleet_kill"] = {
            "run_id": run_id, "workload": "solve",
            "topology": f"1d:{workers}", "engine": "fori", "n": n,
            "block_size": m, "Nr": lay.Nr, "cadence": cadence,
            "killed_replicas": killed, "kill_attempts": attempts,
            "preempt_step": info4["start_step"],
            "baseline_fp": fp_base4,
            "resume_fp": fingerprint(res4.solution),
            "bit_match": fingerprint(res4.solution) == fp_base4,
            "resume_start_step": info4["start_step"],
            "resumed": info4["resumed"],
            "resume_segments": info4["segments_run"],
            "resume_compiles": info4["segment_compiles"],
        }
    finally:
        if tmp_dir is not None:
            shutil.rmtree(tmp_dir, ignore_errors=True)

    after = counters()
    ledger = store.ledger()
    # The demo's own verdict (the checker re-derives it): a divergent
    # resume, a durable checkpoint silently ignored, a recompiling warm
    # resume, or a ledger that does not add up.
    silent_loss = (
        not ledger["invariant_holds"]
        or any(not leg["bit_match"]
               or leg.get("resume_compiles", 1) != 0
               or (leg.get("preempt_step", -1) >= 0
                   and not leg.get("resumed"))
               for leg in legs.values()))
    return {
        "metric": "ckpt_demo",
        "n": n, "block_size": m, "cadence": cadence, "seed": seed,
        "workers": workers, "dtype": str(np.dtype(np_dt)),
        "device": str(dev),
        "legs": legs,
        "ledger": ledger,
        "counters": {k: after[k] - before[k] for k in after},
        "silent_loss": silent_loss,
        "blackbox": RECORDER.dump(events=RECORDER.since(mark)),
        "elapsed_s": round(time.perf_counter() - t_all, 3),
    }
