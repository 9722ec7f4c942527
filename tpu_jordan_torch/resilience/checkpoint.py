"""Preemption-safe execution: superstep checkpoint/resume on one device.

Counterpart of the JAX package's ``resilience/checkpoint.py``, with its
on-disk format, key vocabulary, typed refusals, ledger and counters (here
``tpu_jordan_torch_ckpt_*_total``), so a checkpoint written by either
package is read by the other.

* The elimination state is closed: the identity-padded working set ((N, N)
  V for an invert; A and the zero-padded (N, k) X for a solve), the
  ``singular`` evidence so far, the (Nr,) row-swap record of an invert and
  the superstep index t determine every later superstep.  Snapshotting that
  tuple at a cadence boundary and re-entering at step t replays the same
  arithmetic.
* The engines' segment entries (``ops/jordan_inplace.invert_segment``,
  ``invert_segment_grouped``, ``invert_finalize``;
  ``linalg/engine.solve_segment``) run supersteps [t0, t1) with the
  monolithic engines' own loop body, on state that stays on the device
  between boundaries; only a boundary copies it to host numpy, which
  round-trips exactly.  So a checkpointed run, and a resume, give the
  bits of the monolithic engine.
* Snapshots go to a :class:`CheckpointStore`: one self-describing file per
  run (magic + JSON header + npz payload), sha256 over the payload, written
  to a temporary file and moved into place with ``os.replace``.  A corrupt,
  truncated or key-mismatched entry is a typed refusal
  (:class:`CheckpointCorruptError`, :class:`CheckpointMismatchError`),
  never a silent resume and never a silent from-scratch run.
* The ledger ``written == resumed + discarded + live`` is kept per store
  and persisted in ``ledger.json``.

The ``preempt`` fault point (``faults.py``) fires at each segment boundary
AFTER the previous boundary's checkpoint is durable, so at most ``cadence``
supersteps are recomputed.

The engine names are the JAX package's: ``unrolled`` and ``fori`` both run
the port's one in-place loop (eager PyTorch needs no fori twin), and
``grouped`` the delayed-group-update loop.  The distributed runners wait
for the distributed engines (ROADMAP.md Queue A item 15b).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import threading
from dataclasses import asdict, dataclass

import numpy as np

from ..obs import metrics as _obs_metrics
from ..obs import recorder as _recorder
from . import faults as _faults

_MAGIC = b"TJCKPT1\n"
FORMAT_VERSION = 1

#: The engine flavors the single-device runners accept (the JAX package's
#: vocabulary).  The rest are typed refusals: the SPD fast path has no
#: pivot probe; lookahead carries probe-ahead state outside the closed
#: (state, swaps, t) tuple; the fused ``grouped_pallas*`` engines fuse
#: across steps.
SINGLE_ENGINES = ("unrolled", "fori", "grouped")

_M_WRITTEN = _obs_metrics.counter(
    "tpu_jordan_torch_ckpt_written_total",
    "superstep checkpoints durably written (atomic rename complete)")
_M_RESUMED = _obs_metrics.counter(
    "tpu_jordan_torch_ckpt_resumed_total",
    "checkpoints consumed by a resume (key-matched, checksum-verified)")
_M_CORRUPT = _obs_metrics.counter(
    "tpu_jordan_torch_ckpt_corrupt_total",
    "checkpoint loads refused: bad magic/header/truncation/checksum")
_M_DISCARDED = _obs_metrics.counter(
    "tpu_jordan_torch_ckpt_discarded_total",
    "checkpoint tokens discarded (superseded, run complete, or "
    "corrupt-quarantined)")


class CheckpointError(RuntimeError):
    """Base of the checkpoint/resume failures."""


class CheckpointNotFoundError(CheckpointError):
    """``resume_from=`` named a run with no durable checkpoint (e.g. a
    cadence above Nr wrote none).  A resume never silently degrades to a
    from-scratch run."""


class CheckpointCorruptError(CheckpointError):
    """The stored entry failed the magic, header or checksum checks; the
    file is quarantined (renamed ``*.corrupt``) and its token counted
    discarded."""


class CheckpointMismatchError(CheckpointError):
    """The stored key, step or arrays do not describe this call."""


class CheckpointUnsupportedError(CheckpointError):
    """This engine, dtype or topology has no checkpointable closed state."""


class PreemptedError(CheckpointError):
    """The run was preempted mid-sweep (the ``preempt`` fault, or the
    ``abort`` hook).  Raised after the last boundary's checkpoint is
    durable; ``step`` is that boundary (None when nothing was written)."""

    def __init__(self, msg, *, run_id: str, step: int | None):
        super().__init__(msg)
        self.run_id = run_id
        self.step = step


@dataclass(frozen=True)
class CheckpointKey:
    """What a checkpoint is a checkpoint of.  Every field but ``cadence``
    must match at resume time (``cadence`` only schedules later writes)."""

    run_id: str
    workload: str          # "invert" | "solve"
    engine: str            # "unrolled" | "fori" | "grouped"
    topology: str          # "single" (distributed: Queue A item 15b)
    n: int
    m: int
    Nr: int                # padded block-row count
    dtype: str
    nrhs: int              # 0 for inverts
    cadence: int

    MATCH_FIELDS = ("workload", "engine", "topology", "n", "m", "Nr",
                    "dtype", "nrhs")

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "CheckpointKey":
        return cls(**{f: doc[f] for f in cls.__dataclass_fields__})

    def require_match(self, stored: "CheckpointKey") -> None:
        bad = [f for f in self.MATCH_FIELDS
               if getattr(self, f) != getattr(stored, f)]
        if bad:
            detail = ", ".join(
                f"{f}: stored {getattr(stored, f)!r} != requested "
                f"{getattr(self, f)!r}" for f in bad)
            raise CheckpointMismatchError(
                f"checkpoint for run {self.run_id!r} does not describe "
                f"this call ({detail}); resuming would be silent "
                f"corruption — refused")


def _replace_atomically(root: str, suffix: str, path: str, data: bytes):
    """Write ``data`` to a temporary file in ``root``, then move it onto
    ``path``: readers see the old file or the new one, never a tear."""
    fd, tmp = tempfile.mkstemp(dir=root, suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class CheckpointStore:
    """Host-side checkpoint files and the token ledger: one file per
    ``run_id`` (a new write supersedes the previous one) and
    ``ledger.json`` with the persisted counts.  Thread-safe."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._counts = {"written": 0, "resumed": 0, "discarded": 0,
                        "corrupt": 0}
        self._live: dict[str, bool] = {}
        self._load_ledger()

    def _path(self, run_id: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in run_id)
        return os.path.join(self.root, f"{safe}.ckpt")

    @property
    def _ledger_path(self) -> str:
        return os.path.join(self.root, "ledger.json")

    def _load_ledger(self) -> None:
        try:
            with open(self._ledger_path) as f:
                doc = json.load(f)
            self._counts.update({k: int(doc.get(k, 0))
                                 for k in self._counts})
            self._live = {r: True for r in doc.get("live_runs", [])}
        except (OSError, ValueError):
            pass

    def _persist_ledger_locked(self) -> None:
        doc = dict(self._counts)
        doc["live_runs"] = sorted(self._live)
        text = json.dumps(doc, indent=1, sort_keys=True) + "\n"
        _replace_atomically(self.root, ".ledger.tmp", self._ledger_path,
                            text.encode())

    def write(self, key: CheckpointKey, step: int,
              arrays: dict[str, np.ndarray]) -> int:
        """Durably persist ``arrays`` as run ``key.run_id``'s state at
        superstep ``step``; returns the payload's byte count."""
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        payload = buf.getvalue()
        digest = hashlib.sha256(payload).hexdigest()
        header = json.dumps({
            "version": FORMAT_VERSION, "key": key.to_json(),
            "step": int(step), "sha256": digest,
            "payload_bytes": len(payload),
        }, sort_keys=True).encode()
        _replace_atomically(
            self.root, ".ckpt.tmp", self._path(key.run_id),
            _MAGIC + len(header).to_bytes(4, "big") + header + payload)
        with self._lock:
            if self._live.get(key.run_id):
                # Supersede: the previous boundary's token is consumed.
                self._counts["discarded"] += 1
                _M_DISCARDED.inc()
            self._counts["written"] += 1
            self._live[key.run_id] = True
            self._persist_ledger_locked()
        _M_WRITTEN.inc()
        _recorder.record("ckpt_written", run_id=key.run_id,
                         step=int(step), bytes=len(payload),
                         sha=digest[:12], workload=key.workload,
                         topology=key.topology)
        return len(payload)

    def _quarantine(self, run_id: str, reason: str) -> None:
        path = self._path(run_id)
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        with self._lock:
            self._counts["corrupt"] += 1
            if self._live.pop(run_id, None):
                self._counts["discarded"] += 1
                _M_DISCARDED.inc()
            self._persist_ledger_locked()
        _M_CORRUPT.inc()
        _recorder.record("ckpt_corrupt", run_id=run_id, reason=reason)

    def _read(self, run_id: str):
        path = self._path(run_id)
        if not os.path.exists(path):
            raise CheckpointNotFoundError(
                f"no durable checkpoint for run {run_id!r} in "
                f"{self.root} (a cadence larger than the superstep "
                f"count writes none); a resume never silently degrades "
                f"to a from-scratch run")
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:len(_MAGIC)] != _MAGIC:
            self._quarantine(run_id, "bad magic")
            raise CheckpointCorruptError(
                f"checkpoint for run {run_id!r}: bad magic — not a "
                f"checkpoint file (quarantined)")
        try:
            hlen = int.from_bytes(blob[len(_MAGIC):len(_MAGIC) + 4],
                                  "big")
            header = json.loads(
                blob[len(_MAGIC) + 4:len(_MAGIC) + 4 + hlen])
            payload = blob[len(_MAGIC) + 4 + hlen:]
        except (ValueError, IndexError) as e:
            self._quarantine(run_id, "unparseable header")
            raise CheckpointCorruptError(
                f"checkpoint for run {run_id!r}: unparseable header "
                f"(quarantined)") from e
        if len(payload) != header.get("payload_bytes"):
            self._quarantine(run_id, "truncated payload")
            raise CheckpointCorruptError(
                f"checkpoint for run {run_id!r}: payload truncated "
                f"({len(payload)} of {header.get('payload_bytes')} "
                f"bytes; quarantined)")
        if hashlib.sha256(payload).hexdigest() != header.get("sha256"):
            self._quarantine(run_id, "checksum mismatch")
            raise CheckpointCorruptError(
                f"checkpoint for run {run_id!r}: payload checksum "
                f"mismatch (quarantined) — a resume from corrupt bits "
                f"is refused, never attempted")
        key = CheckpointKey.from_json(header["key"])
        with np.load(io.BytesIO(payload)) as z:
            arrays = {k: z[k] for k in z.files}
        return key, int(header["step"]), arrays

    def peek(self, run_id: str):
        """Read and verify ``(key, step, arrays)`` without consuming the
        token."""
        return self._read(run_id)

    def has_live(self, run_id: str) -> bool:
        """True while run ``run_id`` holds a live (unconsumed) token."""
        with self._lock:
            return bool(self._live.get(run_id))

    def resume(self, key: CheckpointKey):
        """Consume run ``key.run_id``'s live checkpoint: verify it, require
        its key to describe this call, account the token.  Returns
        ``(step, arrays)``.  A token already consumed is a typed miss,
        whatever bytes linger on disk."""
        with self._lock:
            if not self._live.get(key.run_id):
                raise CheckpointNotFoundError(
                    f"no live checkpoint token for run "
                    f"{key.run_id!r}: nothing durable was written, or "
                    f"the checkpoint was already consumed by a "
                    f"resume/discard; a resume never silently degrades "
                    f"to a from-scratch run")
        stored, step, arrays = self._read(key.run_id)
        key.require_match(stored)
        with self._lock:
            if not self._live.pop(key.run_id, None):
                raise CheckpointNotFoundError(
                    f"checkpoint for run {key.run_id!r} was consumed "
                    f"concurrently; a resume never silently degrades "
                    f"to a from-scratch run")
            self._counts["resumed"] += 1
            self._persist_ledger_locked()
        _M_RESUMED.inc()
        _recorder.record("ckpt_resumed", run_id=key.run_id,
                         step=int(step), workload=key.workload,
                         topology=key.topology)
        return step, arrays

    def discard(self, run_id: str, reason: str = "complete") -> bool:
        """Consume the live token (run finished, or the caller gave up).
        Idempotent: False when nothing was live."""
        with self._lock:
            live = self._live.pop(run_id, None)
            if live:
                self._counts["discarded"] += 1
                self._persist_ledger_locked()
        if not live:
            return False
        _M_DISCARDED.inc()
        try:
            os.unlink(self._path(run_id))
        except OSError:
            pass
        _recorder.record("ckpt_discarded", run_id=run_id, reason=reason)
        return True

    def ledger(self) -> dict:
        with self._lock:
            c = dict(self._counts)
            live = len(self._live)
        c["live"] = live
        c["invariant_holds"] = (
            c["written"] == c["resumed"] + c["discarded"] + live)
        return c


#: Signatures of the segments this process has run.  The JAX package
#: counts a jit compile per new signature; the port compiles nothing, but
#: counts the same way, so a warm resume whose segment grid the original
#: run already covered reports ``segment_compiles == 0``.
_SEG_SIGNATURES: set = set()
_SEG_LOCK = threading.Lock()


def _note_segment(sig: tuple) -> bool:
    """True when ``sig`` is new to this process."""
    with _SEG_LOCK:
        if sig in _SEG_SIGNATURES:
            return False
        _SEG_SIGNATURES.add(sig)
        return True


def _segments(start: int, Nr: int, cadence: int):
    t = start
    while t < Nr:
        t1 = min(t + cadence, Nr)
        yield t, t1
        t = t1


def fingerprint(arr) -> str:
    """sha256 of an array's (or a tensor's) bytes: the bit-identity
    witness."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _check_flavor(workload: str, engine: str, distributed: bool, dtype,
                  spd: bool) -> None:
    if distributed:
        raise CheckpointUnsupportedError(
            "mesh/workers: the distributed checkpoint runners come with "
            "the distributed engines (ROADMAP.md Queue A item 15b); "
            "checkpointing runs single-device")
    if engine not in SINGLE_ENGINES:
        raise CheckpointUnsupportedError(
            f"engine {engine!r} is not checkpointable on single-device "
            f"topologies (supported: {'/'.join(SINGLE_ENGINES)}): "
            f"swapfree/lookahead flavors carry pipeline state outside the "
            f"closed (state, swaps, t) tuple, and pallas grouped flavors "
            f"fuse across steps")
    if spd:
        raise CheckpointUnsupportedError(
            "the SPD fast path has no pivot probe — no pivot record "
            "to snapshot and no singularity evidence to carry across "
            "a resume; checkpointing it is refused")
    if dtype.is_complex and workload == "invert":
        raise CheckpointUnsupportedError(
            f"complex inverts run the augmented engine, which has no "
            f"segment entries; the in-place engines are real-dtype "
            f"({_dtype_name(dtype)}): checkpoint a complex solve with "
            f"checkpointed_solve")
    if dtype.is_floating_point and dtype.itemsize < 4:
        name = _dtype_name(dtype)
        raise CheckpointUnsupportedError(
            f"sub-fp32 storage dtype {name}: the engines compute "
            f"in fp32 with one final rounding, so there is no "
            f"byte-exact {name} elimination state to snapshot")


def _dtype_name(dtype) -> str:
    """The numpy name of a torch dtype ("float32"): the key's vocabulary."""
    return str(dtype).removeprefix("torch.")


def _fire_preempt(run_id: str, durable_step: int | None):
    """The ``preempt`` point at one segment boundary: a scheduled hit
    becomes the typed PreemptedError after the last boundary's checkpoint
    is durable (writes happen before this fires)."""
    try:
        _faults.fire("preempt")
    except (_faults.InjectedFaultError,
            _faults.InjectedTransientError) as e:
        _recorder.record("ckpt_preempted", run_id=run_id,
                         step=-1 if durable_step is None
                         else int(durable_step))
        raise PreemptedError(
            f"preempted mid-sweep (run {run_id!r}); last durable "
            f"checkpoint at superstep {durable_step} — resume from it "
            f"instead of recomputing", run_id=run_id,
            step=durable_step) from e


def _check_abort(abort, run_id: str, durable_step: int | None):
    """The real-revocation twin of the preempt fault: ``abort()`` returns
    an exception to raise, or None.  Checked at segment boundaries only."""
    if abort is None:
        return
    exc = abort()
    if exc is not None:
        _recorder.record("ckpt_preempted", run_id=run_id,
                         step=-1 if durable_step is None
                         else int(durable_step), cause="abort")
        raise exc


def checkpointed_invert(a, block_size=None, *, store: CheckpointStore,
                        run_id: str, cadence: int, engine: str = "unrolled",
                        group: int = 4, mesh=None, workers=None,
                        resume_from=None, abort=None, device=None):
    """Invert ``a`` (a numpy array or a tensor) with superstep
    checkpointing, on the card unless ``device="cpu"``.  Returns ``(inv,
    singular, info)``: the inverse (a tensor on the device) bit-matches the
    monolithic engine of the same flavor (``unrolled``/``fori``:
    ``block_jordan_invert_inplace``; ``grouped``:
    ``block_jordan_invert_inplace_grouped`` with ``group``), ``singular``
    is a bool.  ``resume_from=run_id`` re-enters at the last durable
    boundary (typed refusals for a missing, corrupt or mismatched
    checkpoint).  ``mesh``/``workers`` (the distributed runners) are
    refused until ROADMAP.md Queue A item 15b.  Counterpart of the JAX
    package's ``checkpointed_invert``; products run in full precision (the
    JAX package's ``Precision.HIGHEST``)."""
    return _run_checkpointed(
        "invert", a, None, block_size, store=store, run_id=run_id,
        cadence=cadence, engine=engine, group=group, mesh=mesh,
        workers=workers, resume_from=resume_from, abort=abort, spd=False,
        device=device)


def checkpointed_solve(a, b, block_size=None, *, store: CheckpointStore,
                       run_id: str, cadence: int, engine: str = "unrolled",
                       mesh=None, workers=None, resume_from=None,
                       abort=None, spd: bool = False, device=None):
    """Solve ``a @ x = b`` with superstep checkpointing: the
    :func:`checkpointed_invert` contract for the solve state (A, X,
    singular); ``x`` bit-matches ``linalg.block_jordan_solve``.  Real and
    complex dtypes.  Counterpart of the JAX package's
    ``checkpointed_solve``."""
    return _run_checkpointed(
        "solve", a, b, block_size, store=store, run_id=run_id,
        cadence=cadence, engine=engine, group=0, mesh=mesh, workers=workers,
        resume_from=resume_from, abort=abort, spd=spd, device=device)


def _run_checkpointed(workload, a, b, block_size, *, store, run_id, cadence,
                      engine, group, mesh, workers, resume_from, abort, spd,
                      device):
    import torch

    from ..config import default_block_size, eps_for
    from ..interop import from_numpy, resolve_device

    if cadence < 1:
        raise ValueError(f"cadence must be >= 1, got {cadence}")
    if resume_from is not None and resume_from != run_id:
        raise CheckpointMismatchError(
            f"resume_from={resume_from!r} does not name this run "
            f"({run_id!r}); a resume consumes exactly its own run's "
            f"checkpoint")
    dev = resolve_device(device)
    a = from_numpy(a, dev, None)
    dtype = a.dtype
    _check_flavor(workload, engine, mesh is not None or workers is not None,
                  dtype, spd)
    if dev.type == "cuda":
        # Full fp32 products on the card, as driver.solve runs them.
        torch.backends.cuda.matmul.allow_tf32 = False
    n = a.shape[-1]
    m = min(block_size or default_block_size(n), n)
    eps = eps_for(dtype)
    b2 = None
    nrhs = 0
    if workload == "solve":
        b = from_numpy(b, dev, dtype)
        b2 = b if b.dim() == 2 else b[:, None]
        nrhs = b2.shape[1]

    # The grouped cadence rounds UP to the group grid: the U/P panels live
    # within a group, so group boundaries are the only closed states.
    Nr = -(-n // m)
    grid = max(1, min(group, Nr)) if engine == "grouped" else 1
    cad = -(-cadence // grid) * grid
    key = CheckpointKey(run_id=run_id, workload=workload, engine=engine,
                        topology="single", n=int(n), m=int(m), Nr=int(Nr),
                        dtype=_dtype_name(dtype), nrhs=int(nrhs),
                        cadence=int(cad))

    start, durable, resumed = 0, None, False
    if resume_from is not None:
        step, arrays = store.resume(key)
        if step % grid:
            raise CheckpointMismatchError(
                f"resume superstep {step} is off the grouped engine's "
                f"group-{grid} boundary grid — the stored entry cannot "
                f"have come from this engine flavor; refused")
        if not (0 <= step < Nr):
            raise CheckpointMismatchError(
                f"resume superstep {step} outside [0, {Nr}) for this "
                f"layout; refused")
        state = _state_from_host(workload, arrays, key, dtype, dev)
        start, durable, resumed = step, step, True
    else:
        state = _fresh_state(workload, a, b2, key)

    info = {"run_id": run_id, "workload": workload, "engine": engine,
            "topology": "single", "n": int(n), "m": int(m),
            "Nr": int(Nr), "cadence": int(cad), "start_step": start,
            "resumed": resumed, "segments_run": [],
            "segment_compiles": 0, "ckpt_written": 0,
            "ckpt_bytes_last": 0}

    for t0, t1 in _segments(start, Nr, cad):
        _check_abort(abort, run_id, durable)
        _fire_preempt(run_id, durable)
        sig = ("seg", workload, engine, "single", int(n), int(m), int(Nr),
               key.dtype, int(nrhs), t0, t1, dev.type)
        if _note_segment(sig):
            info["segment_compiles"] += 1
        _run_segment(workload, engine, state, t0, t1, key, eps, group)
        info["segments_run"].append((t0, t1))
        if t1 < Nr:
            info["ckpt_bytes_last"] = store.write(key, t1,
                                                  _state_to_host(state))
            info["ckpt_written"] += 1
            durable = t1

    _check_abort(abort, run_id, durable)
    fsig = ("fin", workload, engine, "single", int(n), int(m), int(Nr),
            key.dtype, int(nrhs), dev.type)
    if _note_segment(fsig):
        info["segment_compiles"] += 1
    singular = bool(state["singular"])
    if workload == "solve":
        out = state["X"][:n]
    else:
        from ..ops.jordan_inplace import invert_finalize

        out = invert_finalize(state["V"], state["swaps"], n=n, Nr=Nr, m=m)
    store.discard(run_id, reason="complete")
    return out, singular, info


def _fresh_state(workload, a, b2, key: CheckpointKey) -> dict:
    """Superstep 0's state on ``a``'s device: the identity-padded working
    set, ``singular`` False and, for an invert, a zero swap record."""
    import torch

    from ..ops.padding import pad_with_identity

    N = key.Nr * key.m
    W = pad_with_identity(a, N)
    if W is a:
        W = a.clone()
    singular = torch.zeros((), dtype=torch.bool, device=a.device)
    if workload == "solve":
        X = W.new_zeros((N, key.nrhs))
        X[:key.n] = b2
        return {"A": W, "X": X, "singular": singular}
    return {"V": W, "singular": singular,
            "swaps": torch.zeros((key.Nr,), dtype=torch.int64,
                                 device=a.device)}


def _state_to_host(state: dict) -> dict:
    """The state as the JAX package stores it: numpy arrays of the same
    names and dtypes (the swap record int32)."""
    host = {name: t.cpu().numpy() for name, t in state.items()}
    if "swaps" in host:
        host["swaps"] = host["swaps"].astype(np.int32)
    return host


def _state_from_host(workload, arrays, key: CheckpointKey, dtype, dev):
    """A stored state checked against the shapes and dtypes this call
    needs, moved onto ``dev`` (the swap record as int64)."""
    import torch

    N = key.Nr * key.m
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    want = ({"A": ((N, N), np_dtype), "X": ((N, key.nrhs), np_dtype),
             "singular": ((), np.dtype(bool))} if workload == "solve" else
            {"V": ((N, N), np_dtype), "singular": ((), np.dtype(bool)),
             "swaps": ((key.Nr,), np.dtype(np.int32))})
    missing = set(want) - set(arrays)
    if missing:
        raise CheckpointMismatchError(
            f"checkpoint for run {key.run_id!r} lacks state arrays "
            f"{sorted(missing)}; refused")
    state = {}
    for name, (shape, dt) in want.items():
        arr = arrays[name]
        if arr.shape != shape or arr.dtype != dt:
            raise CheckpointMismatchError(
                f"checkpoint array {name!r} is {arr.dtype}{arr.shape}, "
                f"this call needs {dt}{shape}; refused")
        state[name] = torch.from_numpy(arr.copy()).to(dev)
    if "swaps" in state:
        state["swaps"] = state["swaps"].long()
    return state


def _run_segment(workload, engine, state, t0, t1, key: CheckpointKey, eps,
                 group) -> None:
    """Supersteps [t0, t1) on ``state``, in place."""
    Nr, m = key.Nr, key.m
    if workload == "solve":
        from ..linalg.engine import solve_segment

        solve_segment(state["A"], state["X"], state["singular"], t0=t0,
                      t1=t1, Nr=Nr, m=m, eps=eps)
        return
    from ..ops.jordan_inplace import invert_segment, invert_segment_grouped

    if engine == "grouped":
        invert_segment_grouped(state["V"], state["singular"],
                               state["swaps"], t0=t0, t1=t1, Nr=Nr, m=m,
                               group=group, eps=eps)
    else:
        invert_segment(state["V"], state["singular"], state["swaps"],
                       t0=t0, t1=t1, Nr=Nr, m=m, eps=eps)
