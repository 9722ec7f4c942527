"""Per-lane serving counters and latency percentiles.  Counterpart of the
JAX package's ``serve/stats.py``: ``ServeStats`` and the fleet's
``cross_replica_spread``.

One :class:`ServeStats` rides a :class:`~.service.JordanService` for its
whole life; every mutation happens under one lock, because the writers are
two threads (the caller's on submit and reject, the dispatcher's on batch
completion and compile).  ``snapshot()`` returns plain JSON with the JAX
package's keys: per lane ``requests``, ``rejected``, ``batches``,
``mean_occupancy``, ``compiles``, ``cache_hits``, ``singular`` and the
p50/p95/p99 of queue wait and execute time in milliseconds, then totals,
per-workload rollups and the pooled execute percentiles.

Every mutation is mirrored into the process-wide registry
(``tpu_jordan_torch_serve_*``, ``tpu_jordan_torch_compiles_total``,
``tpu_jordan_torch_singular_total``) with a ``bucket`` label, so a warm
server is scrapeable as Prometheus text.  Queue seconds are host
``perf_counter`` deltas; execute seconds are what the dispatcher's
``obs.spans.timed_blocking`` measured (CUDA events on the card).
"""

from __future__ import annotations

import threading

from ..errors import UsageError
from ..obs import hwcost as _hwcost
from ..obs import metrics as _metrics
from ..obs.metrics import Reservoir

#: Latency samples kept per (lane, phase); the oldest drop first.
MAX_LATENCY_SAMPLES = _metrics.MAX_RESERVOIR_SAMPLES


def _percentiles(samples) -> dict:
    """p50/p95/p99 in milliseconds (3 decimals), the snapshot's unit."""
    pct = _metrics.percentiles(samples)
    return {k: (None if v is None else round(v * 1e3, 3))
            for k, v in pct.items()}


_M_REQUESTS = _metrics.counter("tpu_jordan_torch_serve_requests_total",
                               "requests admitted to the serve queue")
_M_REJECTED = _metrics.counter("tpu_jordan_torch_serve_rejected_total",
                               "requests rejected at submit (typed "
                               "backpressure or an open breaker)")
_M_BATCHES = _metrics.counter("tpu_jordan_torch_serve_batches_total",
                              "micro-batches dispatched")
_M_COMPILES = _metrics.counter(
    "tpu_jordan_torch_compiles_total",
    "serve executor builds (the stand-in for the JAX package's compiles)")
_M_CACHE_HITS = _metrics.counter(
    "tpu_jordan_torch_serve_executor_cache_hits_total",
    "serve dispatches satisfied by an already-built lane executor")
_M_SINGULAR = _metrics.counter("tpu_jordan_torch_singular_total",
                               "solves/requests flagged singular")
_M_OCCUPANCY = _metrics.histogram(
    "tpu_jordan_torch_serve_batch_occupancy",
    "occupied slots per dispatched batch (cap = batch_cap)")
_M_QUEUE_S = _metrics.histogram("tpu_jordan_torch_serve_queue_seconds",
                                "per-request queue wait (submit to "
                                "dispatch), host clock")
_M_EXEC_S = _metrics.histogram("tpu_jordan_torch_serve_execute_seconds",
                               "per-batch execute seconds (CUDA events on "
                               "the card)")


class _BucketStats:
    """Counters for one lane; mutated under the owner's lock only."""

    def __init__(self, workload: str = "invert"):
        self.workload = workload
        self.requests = 0
        self.rejected = 0
        self.batches = 0
        self.elements = 0          # occupied slots over all batches
        self.compiles = 0
        self.cache_hits = 0
        self.singular = 0
        self.queue_s = Reservoir(MAX_LATENCY_SAMPLES)
        self.exec_s = Reservoir(MAX_LATENCY_SAMPLES)
        self.executable = None     # hwcost.ExecutableCost json, if any

    def to_json(self) -> dict:
        occ = (self.elements / self.batches) if self.batches else 0.0
        doc = {
            "workload": self.workload,
            "mesh": "single",
            "requests": self.requests,
            "rejected": self.rejected,
            "batches": self.batches,
            "mean_occupancy": round(occ, 3),
            "compiles": self.compiles,
            "cache_hits": self.cache_hits,
            "singular": self.singular,
            "queue_ms": _percentiles(self.queue_s.samples),
            "execute_ms": _percentiles(self.exec_s.samples),
        }
        if self.executable is not None:
            doc["executable"] = self.executable
        return doc


class ServeStats:
    """The thread-safe serving scoreboard, keyed by lane label (the bucket
    int of an invert lane, ``"solve:<bucket>:k<rhs>"`` of a solve lane).
    ``labels`` are stamped on every mirrored series (a fleet replica's
    ``{"replica": slot}``)."""

    #: Label keys the mirror calls stamp themselves or that bind to the
    #: metric APIs' own parameters; as user labels they would raise deep in
    #: the request path or silently bind, so they are refused up front.
    RESERVED_LABELS = frozenset({"bucket", "component", "value",
                                 "exemplar", "mesh"})

    def __init__(self, labels: dict | None = None):
        self._lock = threading.Lock()
        self._labels = {str(k): str(v) for k, v in (labels or {}).items()}
        clash = self.RESERVED_LABELS & set(self._labels)
        if clash:
            raise UsageError(
                f"reserved metric label(s) {sorted(clash)} — these are "
                f"stamped by ServeStats itself; pick different names")
        self._buckets: dict = {}

    def _b(self, bucket, workload: str = "invert") -> _BucketStats:
        return self._buckets.setdefault(bucket, _BucketStats(workload))

    def _mirror(self, bucket, workload: str | None = None) -> dict:
        """The mirror labels of one mutation: the instance labels, the
        ``bucket``, and ``workload`` off the invert default."""
        labels = (self._labels if workload in (None, "invert")
                  else dict(self._labels, workload=workload))
        return dict(labels, bucket=bucket)

    def request(self, bucket, workload: str = "invert") -> None:
        with self._lock:
            self._b(bucket, workload).requests += 1
        _M_REQUESTS.inc(**self._mirror(bucket, workload))

    def rejected(self, bucket, workload: str = "invert") -> None:
        with self._lock:
            self._b(bucket, workload).rejected += 1
        _M_REJECTED.inc(**self._mirror(bucket, workload))

    def compile(self, bucket, workload: str = "invert") -> None:
        with self._lock:
            self._b(bucket, workload).compiles += 1
        _M_COMPILES.inc(component="serve", **self._mirror(bucket))

    def cache_hit(self, bucket, workload: str = "invert") -> None:
        with self._lock:
            self._b(bucket, workload).cache_hits += 1
        _M_CACHE_HITS.inc(**self._mirror(bucket))

    def executable_cost(self, bucket, cost) -> None:
        """A lane executor's compiler cost: the snapshot's ``executable``
        block and the ``tpu_jordan_torch_executable_*`` gauges.  Eager
        PyTorch has none (``hwcost.UNAVAILABLE``), which records nothing:
        absent, never zeroed."""
        if cost is None or not cost.available:
            return
        with self._lock:
            self._b(bucket).executable = cost.to_json()
        _hwcost.observe_cost(cost, bucket=bucket, **self._labels)

    def batch(self, bucket, occupancy: int, exec_seconds: float,
              queue_seconds, singular: int = 0,
              workload: str = "invert") -> None:
        """One dispatched batch: ``occupancy`` occupied slots,
        ``queue_seconds`` the per-request queue waits."""
        queue_seconds = [float(q) for q in queue_seconds]
        with self._lock:
            b = self._b(bucket, workload)
            b.batches += 1
            b.elements += occupancy
            b.singular += singular
            b.exec_s.add(float(exec_seconds))
            b.queue_s.extend(queue_seconds)
        lab = self._mirror(bucket)
        _M_BATCHES.inc(**self._mirror(bucket, workload))
        _M_OCCUPANCY.observe(occupancy, **lab)
        _M_EXEC_S.observe(float(exec_seconds), **lab)
        for q in queue_seconds:
            _M_QUEUE_S.observe(q, **lab)
        if singular:
            _M_SINGULAR.inc(singular, component="serve", **lab)
        # The device watermark: re-sampled every batch on the card, one
        # lock check on the CPU (hwcost.WATERMARK's sticky verdict).
        _hwcost.WATERMARK.sample(**self._labels)

    def snapshot(self) -> dict:
        with self._lock:
            # Lane keys mix ints and strings: sort by the string form.
            buckets = {str(k): v.to_json()
                       for k, v in sorted(self._buckets.items(),
                                          key=lambda kv: str(kv[0]))}
            exec_samples: list = []
            for v in self._buckets.values():
                exec_samples.extend(v.exec_s.samples)
        totals = {
            key: sum(b[key] for b in buckets.values())
            for key in ("requests", "rejected", "batches", "compiles",
                        "singular")}
        workloads: dict = {}
        for b in buckets.values():
            w = workloads.setdefault(b["workload"], {
                "requests": 0, "batches": 0, "singular": 0})
            w["requests"] += b["requests"]
            w["batches"] += b["batches"]
            w["singular"] += b["singular"]
        return {"buckets": buckets, "totals": totals,
                "workloads": workloads,
                "labels": dict(self._labels),
                "exec_ms": _percentiles(exec_samples)}


def cross_replica_spread(snapshots) -> dict:
    """The fleet's cross-replica execute-latency spread: given per-replica
    :meth:`ServeStats.snapshot` dicts, the max-over-min ratio of their
    pooled execute p99s, readable off ``JordanFleet.stats()`` without a
    scrape.  A replica is named by its snapshot's ``labels["replica"]``
    (the fleet stamps it at spawn), else by list position.  Fewer than two
    replicas with samples is ``judged: False``, never a made-up spread."""
    replicas = {}
    for i, snap in enumerate(snapshots):
        rep = str((snap.get("labels") or {}).get("replica", i))
        replicas[rep] = {
            "exec_ms": snap.get("exec_ms") or _percentiles(()),
            "batches": (snap.get("totals") or {}).get("batches", 0),
        }
    p99 = {r: d["exec_ms"].get("p99") for r, d in replicas.items()}
    live = {r: v for r, v in p99.items() if v}
    out: dict = {"replicas": replicas, "judged": len(live) >= 2,
                 "p99_spread": None, "max_replica": None,
                 "min_replica": None}
    if out["judged"]:
        mx = max(live, key=lambda r: live[r])
        mn = min(live, key=lambda r: live[r])
        out.update({"p99_spread": round(live[mx] / live[mn], 4),
                    "max_replica": mx, "min_replica": mn})
    return out
