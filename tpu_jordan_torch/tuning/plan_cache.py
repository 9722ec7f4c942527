"""The versioned, persistent JSON plan cache: counterpart of the JAX
package's ``tuning/plan_cache.py``.

A *plan* is one resolved engine choice for one plan key; the cache is a
flat ``{key: plan}`` JSON document with a format version.  Keys are
``backend|topology|n-bucket|dtype|memory-mode[|mM][|bB][|w<workload>]``
(``plan_key``), with n rounded up to a power of two.  On the card the
backend segment is ``cuda-h100``, so a plan measured on a TPU (or another
GPU) is never honored here, and the block size is a segment of its own
(``|m384``): the engines' times on the card turn on m (8192/m384 and
8192/m128 pick differently), so one block size's plan never serves
another.  A CPU point's key is byte-equal to the JAX package's, which
has no block-size segment.

Failure policy: a missing file is an empty cache; a corrupt file or a
version mismatch is an empty cache with ``fallback_reason`` set, and the
tuner falls back to cost ranking.  Saves are atomic (a temporary file and
``os.replace``).  A failed save degrades to in-memory plans: it counts in
``tpu_jordan_torch_plan_cache_write_failures_total``, records a
``plan_cache_write_failure`` event and sets ``last_write_error``; the
``plan_cache_write`` fault point simulates it.  ``load(path,
read_only=True)`` freezes the cache: a write is a ``UsageError``, and a
missing file too.  The capacity metering of the JAX cache comes with the
capacity ledger (ROADMAP.md Queue A item 12).
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import asdict, dataclass, field

from ..errors import UsageError
from ..obs import metrics as _obs_metrics
from ..obs import recorder as _recorder
from ..resilience import faults as _faults
from .registry import TunePoint

CACHE_VERSION = 1

_M_WRITE_FAILS = _obs_metrics.counter(
    "tpu_jordan_torch_plan_cache_write_failures_total",
    "plan-cache saves that failed (disk full, read-only directory) and "
    "degraded to in-memory plans")


def n_bucket(n: int) -> int:
    """``n`` rounded up to the next power of two (the key's bucket)."""
    return 1 << max(0, int(n - 1).bit_length())


def plan_key(point: TunePoint) -> str:
    """``backend|topology|n-bucket|dtype|memory-mode[|mM][|bB][|wW]``,
    e.g. ``cuda-h100|single|n8192|float32|gathered|m384`` or
    ``cpu|single|n4096|float32|gathered|wsolve``.  The block-size segment
    appears only on the card, the batch segment only for ``batch > 1``
    and the workload segment only for a workload other than "invert"."""
    backend = (f"{point.backend}-{point.chip}" if point.chip
               else point.backend)
    mem = "gathered" if point.gather else "sharded"
    key = (f"{backend}|{point.topology}|n{n_bucket(point.n)}|"
           f"{point.dtype}|{mem}")
    if point.backend == "cuda":
        key += f"|m{point.block_size}"
    if point.batch > 1:
        key += f"|b{point.batch}"
    if point.workload != "invert":
        key += f"|w{point.workload}"
    return key


@dataclass(frozen=True)
class Plan:
    """One resolved engine choice.  ``config`` is the registry name;
    ``engine``/``group`` are stored too, and the tuner re-validates them
    against the live registry before honoring a cached plan.
    ``projected`` against ``seconds`` is the model's drift; ``trials``
    holds the per-candidate records of the tuning run."""

    config: str
    engine: str
    group: int = 0
    source: str = "cost_model"       # "cost_model" | "measured"
    seconds: float | None = None     # measured median (None: cost-only)
    projected: float | None = None   # the model's seconds for the pick
    drift: float | None = None       # seconds / projected
    variance_flag: str | None = None
    trials: tuple = field(default=())

    def to_json(self) -> dict:
        d = asdict(self)
        d["trials"] = list(self.trials)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Plan":
        return cls(
            config=str(d["config"]),
            engine=str(d["engine"]),
            group=int(d.get("group", 0)),
            source=str(d.get("source", "cost_model")),
            seconds=d.get("seconds"),
            projected=d.get("projected"),
            drift=d.get("drift"),
            variance_flag=d.get("variance_flag"),
            trials=tuple(d.get("trials", ())),
        )


class PlanCache:
    """``get``/``put`` in memory, ``load``/``save`` against the versioned
    JSON file."""

    def __init__(self, path: str | None = None,
                 plans: dict[str, Plan] | None = None,
                 fallback_reason: str | None = None,
                 read_only: bool = False):
        self.path = path
        self.plans = dict(plans or {})
        self.read_only = bool(read_only)
        #: why a load gave an empty cache; None on a clean load.
        self.fallback_reason = fallback_reason
        #: the last save failure; None while writes succeed.
        self.last_write_error: str | None = None

    @classmethod
    def load(cls, path: str, read_only: bool = False) -> "PlanCache":
        """Load ``path``.  Bad contents never raise: the cache comes back
        empty with ``fallback_reason``.  With ``read_only=True`` a missing
        file is a ``UsageError``: read-only serves an existing pre-tuned
        file, so a misspelt path must not become an empty cache."""
        if not os.path.exists(path):
            if read_only:
                raise UsageError(
                    f"plan cache {path!r} does not exist — read-only "
                    f"mode serves a pre-tuned file; check the path or "
                    f"pretune first")
            return cls(path=path, read_only=read_only)
        try:
            with open(path, "r") as f:
                doc = json.load(f)
            version = doc.get("version")
            if version != CACHE_VERSION:
                return cls(path=path, read_only=read_only,
                           fallback_reason=(
                               f"plan cache version {version!r} != "
                               f"{CACHE_VERSION} — ignoring stale cache"))
            plans = {str(k): Plan.from_json(v)
                     for k, v in doc["plans"].items()}
            return cls(path=path, plans=plans, read_only=read_only)
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as e:
            return cls(path=path, read_only=read_only, fallback_reason=(
                f"corrupt plan cache ({type(e).__name__}: {e}) — "
                f"falling back to cost-model ranking"))

    def _refuse_write(self, what: str):
        raise UsageError(
            f"plan cache {self.path or '<memory>'} is read-only (the "
            f"fleet's shared pre-tuned plans); {what} is a write — "
            f"pre-tune with a writable cache, then serve it read-only")

    def get(self, key: str) -> Plan | None:
        return self.plans.get(key)

    def put(self, key: str, plan: Plan) -> None:
        if self.read_only:
            self._refuse_write(f"put({key!r})")
        self.plans[key] = plan

    def save(self, path: str | None = None) -> None:
        """Atomic write of the versioned document.  A write failure
        degrades instead of raising (see the module docstring); a later
        save retries."""
        if self.read_only:
            self._refuse_write("save()")
        path = path or self.path
        if path is None:
            return
        doc = {"version": CACHE_VERSION,
               "plans": {k: p.to_json() for k, p in
                         sorted(self.plans.items())}}
        text = json.dumps(doc, indent=1, sort_keys=True) + "\n"
        try:
            _faults.fire("plan_cache_write")
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".plan.tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(text)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError as e:
            self.last_write_error = str(e)
            _M_WRITE_FAILS.inc()
            _recorder.record("plan_cache_write_failure", error=str(e))
            return
        self.last_write_error = None
