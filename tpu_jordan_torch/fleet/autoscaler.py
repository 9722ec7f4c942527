""":class:`FleetAutoscaler`, the SLO-driven replica control loop, and
``autoscale_demo``, the ``--autoscale-demo`` run.  Counterpart of the JAX
package's ``fleet/autoscaler.py``.

One ``tick()`` is the whole policy (driven inline with a fake clock in the
tests; ``start()`` runs it on a daemon thread):

  * **scale up on sustained burn**: any objective paging (both windows of
    a pair above its threshold) grows the pool by one replica per
    cooldown, up to ``ceiling``; the new replica warms every lane the
    fleet has served against the shared store before it enters the slot
    table (``JordanFleet.grow``);
  * **capacity veto**: with ``scale_budget_bytes`` set, a grow while the
    capacity ledger (``obs/capacity.py``) holds that many live bytes is
    withheld, and recorded with the same evidence as an action
    (``scale_withheld``);
  * **pre-shed before breach**: while an objective pages or its p99 reaches
    ``preshed_p99_frac`` of its target, the router sheds NEW submissions
    typed at the front door (``router.pre_shed``); a ``skew_judge``
    (``obs.work.FleetSkewJudge``) whose ``veto()`` names a straggler vetoes
    a shed driven by p99 risk alone;
  * **drain to the floor when idle**: ``idle_after_s`` without a new
    request outcome (and no risk signal) parks one replica per cooldown,
    down to ``floor`` (``JordanFleet.drain_slot``: the queue drains first).

Every action and every withheld action is a flight-recorder ``autoscale``
event with the evidence it was derived from, and counts in
``tpu_jordan_torch_autoscale_actions_total{action}``;
``tools/check_autoscale.py`` re-derives each one from that evidence.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..obs import capacity as _capacity
from ..obs import metrics as _obs_metrics
from ..obs import recorder as _recorder
from ..obs.slo import _outcome_counts

_M_ACTIONS = _obs_metrics.counter(
    "tpu_jordan_torch_autoscale_actions_total",
    "autoscaler decisions, labeled by action (scale_up|drain|"
    "pre_shed_on|pre_shed_off|pre_shed_vetoed|scale_withheld)")


class FleetAutoscaler:
    """The control loop over one :class:`~.pool.JordanFleet` and one
    :class:`~..obs.slo.SLOMonitor`.

    Args:
      pool: the fleet (``ready_count``/``grow``/``drain_slot`` and
        ``router.pre_shed``; a fake with those four is a full harness).
      monitor: the burn-rate monitor; ``tick()`` samples and evaluates it.
      floor / ceiling: replica bounds.
      idle_after_s: seconds without a new request outcome (and no risk
        signal) before a drain step.
      scale_cooldown_s: least spacing of capacity actions, either way.
      preshed_p99_frac: pre-shed engages when an objective's p99 reaches
        this fraction of its target (or any pair pages).
      scale_budget_bytes: the capacity veto's ledger ceiling; None = none.
      skew_judge: the work observatory's ``obs.work.FleetSkewJudge`` (or
        anything with its ``veto()``: a dict with ``replica``, ``spread``,
        ``threshold``, or None): a verdict vetoes a pre-shed driven by p99
        risk alone (never one driven by paging).
      clock: injectable monotonic clock (default: the pool's).
    """

    def __init__(self, pool, monitor, floor: int = 1, ceiling: int = 4,
                 idle_after_s: float = 30.0,
                 scale_cooldown_s: float = 5.0,
                 preshed_p99_frac: float = 0.8,
                 scale_budget_bytes: int | None = None,
                 skew_judge=None, clock=None):
        if floor < 1:
            raise ValueError("floor must be >= 1")
        if ceiling < floor:
            raise ValueError("ceiling must be >= floor")
        self.pool = pool
        self.monitor = monitor
        self.floor = int(floor)
        self.ceiling = int(ceiling)
        self.idle_after_s = float(idle_after_s)
        self.scale_cooldown_s = float(scale_cooldown_s)
        self.preshed_p99_frac = float(preshed_p99_frac)
        self.scale_budget_bytes = (None if scale_budget_bytes is None
                                   else int(scale_budget_bytes))
        self.skew_judge = skew_judge
        self._last_vetoed = False
        self.clock = (clock if clock is not None
                      else getattr(pool, "clock", time.monotonic))
        self._last_action_t: float | None = None
        self._last_activity_t = self.clock()
        self._last_outcome_total: int | None = None
        #: Every recorded ``autoscale`` event, in order (the demo's report
        #: holds it beside the recorder's slice).
        self.actions: list[dict] = []
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---- the control policy -----------------------------------------

    def _record(self, action: str, ready_before: int,
                evidence: dict) -> dict:
        ev = {"action": action, "ready_before": ready_before,
              "ready_after": self.pool.ready_count(),
              "floor": self.floor, "ceiling": self.ceiling,
              "evidence": evidence}
        _M_ACTIONS.inc(action=action)
        _recorder.record("autoscale", **ev)
        self.actions.append(ev)
        return ev

    def _cooldown_ok(self, now: float) -> bool:
        return (self._last_action_t is None
                or now - self._last_action_t >= self.scale_cooldown_s)

    @staticmethod
    def _paging_evidence(report: dict) -> list[dict]:
        """Each paging objective with the window pairs that page, copied
        from the monitor's report (the checker re-derives the page from
        these numbers)."""
        return [{"name": obj["name"], "bucket": obj["bucket"],
                 "error_budget": obj["error_budget"],
                 "windows": [w for w in obj["windows"] if w["page"]]}
                for obj in report["objectives"] if obj["paging"]]

    def _p99_risk(self, report: dict) -> list[dict]:
        """Objectives whose p99 reached the pre-breach fraction of their
        target."""
        out = []
        for obj in report["objectives"]:
            target, p99 = obj["p99_target_ms"], obj["p99_ms"]
            if (target is not None and p99 is not None
                    and p99 >= self.preshed_p99_frac * target):
                out.append({"name": obj["name"], "p99_ms": p99,
                            "p99_target_ms": target,
                            "frac": self.preshed_p99_frac})
        return out

    def tick(self) -> dict:
        """One control pass: sample and evaluate the monitor, apply at most
        one capacity action (cooldown-spaced), reconcile the pre-shed flag.
        Returns the tick's summary."""
        now = self.clock()
        self.ticks += 1
        self.monitor.sample()
        report = self.monitor.evaluate()
        paging = self._paging_evidence(report)
        p99_risk = self._p99_risk(report)
        ready = self.pool.ready_count()

        # Any movement of the fleet-wide outcome total (the series the
        # burn windows integrate) resets the idle clock.
        ok, err = _outcome_counts(self.monitor.registry.snapshot(), None)
        total = ok + err
        if total != self._last_outcome_total:
            self._last_activity_t = now
        self._last_outcome_total = total
        idle_s = now - self._last_activity_t

        action = None
        if paging and ready < self.ceiling and self._cooldown_ok(now):
            live = _capacity.live_bytes()
            if (self.scale_budget_bytes is not None
                    and live >= self.scale_budget_bytes):
                # The capacity veto leaves the same trail as an action.
                action = self._record("scale_withheld", ready, {
                    "paging": paging, "live_bytes": live,
                    "scale_budget_bytes": self.scale_budget_bytes})
                self._last_action_t = now
            else:
                slot = self.pool.grow()
                if slot is not None:
                    action = self._record("scale_up", ready, {
                        "paging": paging, "slot": slot,
                        "live_bytes": live,
                        "scale_budget_bytes": self.scale_budget_bytes})
                    self._last_action_t = now
        elif (not paging and not p99_risk and ready > self.floor
                and idle_s >= self.idle_after_s
                and self._cooldown_ok(now)):
            slot = self.pool.drain_slot()
            if slot is not None:
                action = self._record("drain", ready, {
                    "idle_s": round(idle_s, 6),
                    "idle_after_s": self.idle_after_s, "slot": slot})
                self._last_action_t = now

        # Pre-shed is a flag, not a step: no cooldown.  The skew veto
        # applies to p99-risk-driven shedding only; paging is fleet-wide
        # evidence and is never vetoed.
        want_shed = bool(paging or p99_risk)
        skew_veto = None
        if p99_risk and not paging and self.skew_judge is not None:
            v = self.skew_judge.veto()
            if v is not None:
                skew_veto = {"replica": v.get("replica"),
                             "spread": v.get("spread"),
                             "threshold": v.get("threshold")}
                want_shed = False
        if skew_veto is not None and not self._last_vetoed:
            self._record("pre_shed_vetoed", ready, {
                "p99_risk": p99_risk, "skew_veto": skew_veto})
        self._last_vetoed = skew_veto is not None
        if want_shed != self.pool.router.pre_shed:
            self.pool.router.pre_shed = want_shed
            self._record("pre_shed_on" if want_shed else "pre_shed_off",
                         ready, {"paging": paging, "p99_risk": p99_risk})

        tick = {
            "t": round(now, 6),
            "ready": self.pool.ready_count(),
            "paging": [p["name"] for p in paging],
            "p99_risk": [p["name"] for p in p99_risk],
            "pre_shed": self.pool.router.pre_shed,
            "idle_s": round(idle_s, 6),
            "action": None if action is None else action["action"],
            "healthy": report["healthy"],
        }
        if skew_veto is not None:
            tick["skew_veto"] = skew_veto
        return tick

    # ---- optional background loop -----------------------------------

    def start(self, interval_s: float = 1.0) -> None:
        """Run ``tick()`` on a daemon thread every ``interval_s``."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                self.tick()

        self._thread = threading.Thread(
            target=loop, name="tpu-jordan-torch-fleet-autoscaler",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def autoscale_demo(n: int = 64, requests: int = 48, floor: int = 1,
                   ceiling: int = 3, batch_cap: int = 4,
                   max_wait_ms: float = 1.0, seed: int = 0,
                   block_size: int | None = None, dtype=torch.float32,
                   telemetry=None, device=None) -> dict:
    """The ``--autoscale-demo`` run: one seeded burst → idle → recovery
    trace through a floor-sized fleet under a :class:`FleetAutoscaler`.
    Returns the one-line report ``tools/check_autoscale.py`` judges (exit
    2: a silent p99 breach or an unexplained scale action).

    The burn source is deterministic: each burst wave mixes clean requests
    with requests whose ``deadline_ms`` (0.01) is already spent by the
    queue wait, so they resolve with the typed ``DeadlineExceededError``,
    an error outcome on the series the burn windows integrate.  The waves,
    windows, SLO and report keys are the JAX package's."""
    from ..interop import resolve_device, resolve_dtype
    from ..obs.journey import outcome_ledger
    from ..obs.metrics import REGISTRY
    from ..obs.recorder import RECORDER
    from ..obs.slo import SLOMonitor, bucket_specs
    from ..serve.executors import bucket_for
    from .pool import JordanFleet

    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    # numpy has no bfloat16: sub-fp32 fixtures are made in fp32 and
    # rounded at submit.
    np_dtype = (np.float32 if dtype.itemsize < 4
                else np.dtype(str(dtype).removeprefix("torch.")))
    t0 = time.monotonic()
    bucket = bucket_for(n)
    # Demo-scaled SLO: availability 0.7 (budget 0.3) with one (2 s, 0.4 s,
    # 1.2x) window pair: a ~50 %-error burst burns ~1.67x in both windows
    # within one wave, an idle fleet burns zero.  The p99 objective is a
    # generous runaway bound; the pre-shed trigger here is the burn.
    windows = ((2.0, 0.4, 1.2),)
    availability, p99_target_ms = 0.7, 60000.0
    idle_after_s, preshed_frac = 0.6, 0.8
    monitor = SLOMonitor(
        bucket_specs([bucket], availability=availability,
                     p99_latency_ms=p99_target_ms),
        windows=windows)

    def shed_pre() -> int:
        return int(REGISTRY.counter("tpu_jordan_torch_fleet_shed_total")
                   .value(reason="pre_shed"))

    waves, per_wave = 4, max(4, requests // 4)
    rng = np.random.default_rng(seed)
    bb_mark = RECORDER.total
    shed0 = shed_pre()
    ticks, trajectory = [], []
    phase_stats = {}

    with JordanFleet(replicas=floor, dtype=dtype, batch_cap=batch_cap,
                     max_wait_ms=max_wait_ms,
                     max_queue=max(requests * 2, 64),
                     block_size=block_size, telemetry=telemetry,
                     stable_after_s=0.05, device=dev) as fleet:
        scaler = FleetAutoscaler(fleet, monitor, floor=floor,
                                 ceiling=ceiling,
                                 idle_after_s=idle_after_s,
                                 scale_cooldown_s=0.0,
                                 preshed_p99_frac=preshed_frac)
        fleet.warmup([n])
        monitor.sample()                     # the pre-burst baseline

        def run_wave(n_ok: int, n_bad: int) -> dict:
            futs = []
            for i in range(n_ok + n_bad):
                a = rng.standard_normal((n, n)).astype(np_dtype)
                # The bad half's deadline is spent by the queue wait: a
                # deterministic typed DeadlineExceededError.
                dl = None if i < n_ok else 0.01
                try:
                    futs.append(fleet.submit(a, deadline_ms=dl))
                except Exception as e:       # noqa: BLE001 — typed shed
                    futs.append(e)
            out = {"ok": 0, "typed_errors": {}}
            for f in futs:
                try:
                    if isinstance(f, Exception):
                        raise f
                    f.result(120)
                    out["ok"] += 1
                except Exception as e:       # noqa: BLE001 — typed
                    name = type(e).__name__
                    out["typed_errors"][name] = (
                        out["typed_errors"].get(name, 0) + 1)
            return out

        # ---- phase 1: burst (sustained two-window burn) -------------
        burst = []
        for _ in range(waves):
            burst.append(run_wave(per_wave // 2,
                                  per_wave - per_wave // 2))
            ticks.append(scaler.tick())
            trajectory.append(ticks[-1]["ready"])
            time.sleep(0.15)
        phase_stats["burst"] = {"waves": burst,
                                "ready_after": fleet.ready_count(),
                                "pre_shed": fleet.router.pre_shed}

        # ---- phase 2: idle (burn clears, the fleet drains) ----------
        for _ in range(24):
            time.sleep(0.3)
            ticks.append(scaler.tick())
            trajectory.append(ticks[-1]["ready"])
            if (fleet.ready_count() <= floor
                    and not fleet.router.pre_shed):
                break
        phase_stats["idle"] = {"ready_after": fleet.ready_count(),
                               "pre_shed": fleet.router.pre_shed,
                               "ticks": len(ticks)}

        # ---- phase 3: recovery (clean traffic serves again) ---------
        recovery = run_wave(max(4, per_wave // 2), 0)
        ticks.append(scaler.tick())
        trajectory.append(ticks[-1]["ready"])
        phase_stats["recovery"] = recovery

        final_slo = monitor.evaluate()
        actions = list(scaler.actions)
        fleet_stats = fleet.stats()

    blackbox = RECORDER.dump(events=RECORDER.since(bb_mark))
    journey_ledger = outcome_ledger(blackbox["events"])
    by_action: dict[str, int] = {}
    for a in actions:
        by_action[a["action"]] = by_action.get(a["action"], 0) + 1
    # A tick that saw risk and left pre-shed off with no capacity action
    # is the silent breach; a skew-vetoed tick carries its evidence.
    silent_p99_breach = any(
        (t["paging"] or t["p99_risk"]) and not t["pre_shed"]
        and t["action"] not in ("scale_up", "scale_withheld")
        and not t.get("skew_veto")
        for t in ticks)
    return {
        "metric": "autoscale_demo",
        "n": n, "seed": seed,
        "floor": floor, "ceiling": ceiling,
        "requests_per_wave": per_wave, "waves": waves,
        "config": {
            "windows": [list(w) for w in windows],
            "availability": availability,
            "p99_target_ms": p99_target_ms,
            "idle_after_s": idle_after_s,
            "scale_cooldown_s": 0.0,
            "preshed_p99_frac": preshed_frac,
        },
        "phases": phase_stats,
        "ticks": ticks,
        "actions": actions,
        "actions_by_kind": by_action,
        "ready_trajectory": trajectory,
        "pre_shed_count": shed_pre() - shed0,
        "slo_final": final_slo,
        "ledger": fleet_stats["ledger"],
        "journey_ledger": journey_ledger,
        "blackbox": blackbox,
        "silent_p99_breach": silent_p99_breach,
        "elapsed_s": round(time.monotonic() - t0, 3),
        "device": str(dev),
    }
