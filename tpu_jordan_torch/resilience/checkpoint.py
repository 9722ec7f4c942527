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
``grouped`` the delayed-group-update loop; the key records which name was
asked for, as the file format does.

``workers=p`` (``mesh=p`` is its alias) checkpoints the 1D distributed
engines (topology ``"1d:p"``, engines ``unrolled``/``fori``) through the
segment entries of ``parallel/sharded_inplace.py``.  Every segment of one
call runs in one world of p ranks.  At each cadence boundary rank 0
gathers the state and writes it in the JAX package's format (``W`` the
global (Nr, m, N) blocks in cyclic storage order, ``X`` (Nr, m, k),
``singular`` (p,), ``swaps`` (p, Nr) int32, every row the same history);
on a resume each rank takes its own slots.  The fault plan lives in the
caller's process: the boundaries are walked there first, in order, up to
the first at which ``preempt`` fires, so a seeded plan sees the calls the
single-device loop (and the JAX package) makes; the world runs the
segments before that boundary, and the caller raises the typed error once
their checkpoints are durable.  ``abort`` (the real revocation, a fleet
replica's kill) is checked before the world starts, by a watcher thread in
the caller while the world runs, and after it ends: when it returns an
error the watcher drops a flag file in the store, and after each durable
boundary write rank 0 reads the flag and broadcasts the verdict, so the
world stops at that boundary and the caller raises the error ``abort``
returned, its ``step`` the durable superstep (at most ``cadence``
supersteps are lost, as with ``preempt``).  Rank 0's boundary writes
update the store's ``ledger.json`` as they become durable, and
:meth:`CheckpointStore.has_live` reads it, so a live token is visible
while the world runs.  ``workers=(pr, pc)`` (or ``mesh=(pr, pc)``)
checkpoints the 2D engines (topology ``"2d:{pr}x{pc}"``, the same engines)
through the segment entries of ``parallel/jordan2d_inplace.py``, in the
JAX package's 2D format: ``W`` the global (Nr, m, N) tensor in 2D-cyclic
storage order on both axes, ``X`` (Nr, m, k) in row-cyclic order,
``singular`` (pr, pc) and ``swaps`` (pr, pc, Nr) int32.
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
#: The distributed runners' engine flavors (the JAX package's).
DIST_ENGINES = ("unrolled", "fori")

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
    topology: str          # "single" | "1d:{p}" | "2d:{pr}x{pc}"
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
        nbytes, digest = self._write_file(key, step, arrays)
        superseded = self._account_write(key)
        self._observe_write(key, step, nbytes, digest, superseded)
        return nbytes

    def reload(self) -> None:
        """Re-read the persisted ledger: after another process (a rank of
        a distributed checkpointed run) wrote to this store."""
        with self._lock:
            self._load_ledger()

    def _write_file(self, key: CheckpointKey, step: int, arrays):
        """The file half of :meth:`write`: returns (bytes, sha256)."""
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
        return len(payload), digest

    def _account_write(self, key: CheckpointKey) -> bool:
        """The ledger half of :meth:`write`, persisted; True when the write
        superseded a live token."""
        with self._lock:
            superseded = bool(self._live.get(key.run_id))
            if superseded:
                # Supersede: the previous boundary's token is consumed.
                self._counts["discarded"] += 1
            self._counts["written"] += 1
            self._live[key.run_id] = True
            self._persist_ledger_locked()
        return superseded

    @staticmethod
    def _observe_write(key: CheckpointKey, step: int, nbytes: int,
                       digest: str, superseded: bool) -> None:
        """The counters and the flight recorder of one write."""
        if superseded:
            _M_DISCARDED.inc()
        _M_WRITTEN.inc()
        _recorder.record("ckpt_written", run_id=key.run_id,
                         step=int(step), bytes=int(nbytes),
                         sha=digest[:12], workload=key.workload,
                         topology=key.topology)

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
        """True while run ``run_id`` holds a live (unconsumed) token, as
        the persisted ledger says (a rank of a distributed run writes it
        from its own process)."""
        with self._lock:
            self._load_ledger()
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


def _topology(mesh, workers) -> tuple[str, object]:
    """``(topology, spec)`` of a call: "single" and 1, "1d:{p}" and p for a
    rank count p > 1, or "2d:{pr}x{pc}" and (pr, pc) for a mesh
    (``workers``, or its alias ``mesh``)."""
    if mesh is not None and workers is not None and mesh != workers:
        raise CheckpointMismatchError(
            f"mesh={mesh!r} and workers={workers!r} name different "
            f"topologies; pass one")
    spec = workers if mesh is None else mesh
    if spec is None or (isinstance(spec, int) and spec == 1):
        return "single", 1
    if isinstance(spec, tuple):
        if (len(spec) != 2 or not all(isinstance(x, int) and x >= 1
                                      for x in spec)):
            raise CheckpointUnsupportedError(
                f"a mesh must be (pr, pc) with positive dimensions, got "
                f"{spec!r}")
        return f"2d:{spec[0]}x{spec[1]}", (int(spec[0]), int(spec[1]))
    if not isinstance(spec, int) or spec < 1:
        raise CheckpointUnsupportedError(
            f"mesh/workers must be a rank count p of the 1D layout, got "
            f"{spec!r}")
    return f"1d:{spec}", spec


def _check_flavor(workload: str, engine: str, distributed: bool, dtype,
                  spd: bool) -> None:
    engines = DIST_ENGINES if distributed else SINGLE_ENGINES
    if engine not in engines:
        raise CheckpointUnsupportedError(
            f"engine {engine!r} is not checkpointable on "
            f"{'distributed' if distributed else 'single-device'} "
            f"topologies (supported: {'/'.join(engines)}): "
            f"swapfree/lookahead flavors carry pipeline state outside the "
            f"closed (state, swaps, t) tuple, and pallas grouped flavors "
            f"fuse across steps")
    if spd:
        raise CheckpointUnsupportedError(
            "the SPD fast path has no pivot probe — no pivot record "
            "to snapshot and no singularity evidence to carry across "
            "a resume; checkpointing it is refused")
    if dtype.is_complex and distributed:
        raise CheckpointUnsupportedError(
            "complex distributed flavors do not exist yet "
            "(ROADMAP); checkpointing one cannot be meaningful — "
            "refused rather than invented")
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
    checkpoint).  ``workers=p`` (or ``mesh=p``) runs the 1D distributed
    engine on p ranks (module docstring; ``unrolled``/``fori``), whose
    inverse bit-matches ``parallel.invert_blocks`` on the same world;
    ``workers=(pr, pc)`` the 2D engine on a mesh, whose inverse
    bit-matches ``parallel.invert_blocks_2d``.
    Counterpart of the JAX package's ``checkpointed_invert``; products run
    in full precision (the JAX package's ``Precision.HIGHEST``)."""
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
    singular); ``x`` bit-matches ``linalg.block_jordan_solve`` (with
    ``workers=p``, ``parallel.solve_blocks`` on the same world; with
    ``workers=(pr, pc)``, ``parallel.solve_blocks_2d``).  Real and complex
    dtypes on one device, real on p ranks or a mesh.  Counterpart of the
    JAX package's ``checkpointed_solve``."""
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
    topology, p = _topology(mesh, workers)
    dev = resolve_device(device)
    a = from_numpy(a, dev, None)
    dtype = a.dtype
    _check_flavor(workload, engine, topology != "single", dtype, spd)
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
    if topology != "single":
        return _run_checkpointed_dist(
            workload, a, b2, m, p, store=store, run_id=run_id,
            cadence=cadence, engine=engine, resume_from=resume_from,
            abort=abort, dev=dev)

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


# --- The distributed runner (topologies "1d:p" and "2d:prxpc").


def _dist_layout(n: int, m: int, spec):
    """The layout of a distributed topology: ``spec`` p (1D) or (pr, pc)."""
    from ..parallel.layout import CyclicLayout, CyclicLayout2D

    if isinstance(spec, tuple):
        return CyclicLayout2D.create(n, m, *spec)
    return CyclicLayout.create(n, m, spec)


def _grid(lay) -> tuple:
    """The shape of the per-rank flag grid: (p,) or (pr, pc)."""
    return (lay.pr, lay.pc) if hasattr(lay, "pc") else (lay.p,)


def _dist_fresh_state(workload, a, b2, lay) -> dict:
    """Superstep 0's state in the JAX package's format (host numpy): the
    identity-padded (Nr, m, N) blocks in cyclic storage order (both axes
    on a mesh), X's zero-padded (Nr, m, k) rows in row-cyclic order, the
    per-rank singular flags and, for an invert, the int32 swap record, one
    row a rank."""
    import torch

    a = a.cpu()
    grid = _grid(lay)
    if len(grid) == 2:
        from ..parallel.jordan2d import join_shards_2d, scatter_matrix_2d
        from ..parallel.jordan2d_inplace import scatter_rhs_2d

        W = join_shards_2d([scatter_matrix_2d(a, lay, kr, kc)
                            for kr in range(lay.pr)
                            for kc in range(lay.pc)], lay)
        rhs = [lambda b, kr=kr: scatter_rhs_2d(b, lay, kr)
               for kr in range(lay.pr)]
    else:
        from ..parallel.sharded_inplace import (scatter_rhs_1d,
                                                to_identity_padded_blocks)

        W = torch.cat([to_identity_padded_blocks(a, lay, r)
                       for r in range(lay.p)])
        rhs = [lambda b, r=r: scatter_rhs_1d(b, lay, r)
               for r in range(lay.p)]
    state = {"W": W.numpy()}
    if workload == "solve":
        b2 = b2.cpu()
        state["X"] = np.concatenate([f(b2).numpy() for f in rhs])
    state["singular"] = np.zeros(grid, bool)
    if workload == "invert":
        state["swaps"] = np.zeros(grid + (lay.Nr,), np.int32)
    return state


def _dist_state_checked(workload, arrays, key: CheckpointKey, lay, dtype):
    """A stored distributed state checked against the shapes and dtypes
    this call needs."""
    np_dtype = np.dtype(_dtype_name(dtype))
    grid, Nr, m, N = _grid(lay), lay.Nr, lay.m, lay.N
    want = {"W": ((Nr, m, N), np_dtype),
            "singular": (grid, np.dtype(bool))}
    if workload == "solve":
        want["X"] = ((Nr, m, key.nrhs), np_dtype)
    else:
        want["swaps"] = (grid + (Nr,), np.dtype(np.int32))
    missing = set(want) - set(arrays)
    if missing:
        raise CheckpointMismatchError(
            f"checkpoint for run {key.run_id!r} lacks state arrays "
            f"{sorted(missing)}; refused")
    for name, (shape, dt) in want.items():
        arr = arrays[name]
        if arr.shape != shape or arr.dtype != dt:
            raise CheckpointMismatchError(
                f"checkpoint array {name!r} is {arr.dtype}{arr.shape}, "
                f"this call needs {dt}{shape}; refused")
    return {name: arrays[name] for name in want}


def _rank_shards(state: dict, lay) -> list:
    """Each rank's part of a distributed state, in rank order: its slots
    of W and X (its shard of W and its mesh row's X rows on a mesh), and
    its entries of singular and swaps."""
    if len(_grid(lay)) == 1:
        bpw = lay.blocks_per_worker
        return [{name: (arr[r * bpw:(r + 1) * bpw] if name in ("W", "X")
                        else arr[r:r + 1])
                 for name, arr in state.items()} for r in range(lay.p)]
    from ..parallel.jordan2d import split_shards_2d

    w = [x.numpy() for x in split_shards_2d(state["W"], lay)]
    out = []
    for r in range(lay.pr * lay.pc):
        kr, kc = divmod(r, lay.pc)
        sh = {"W": w[r], "singular": state["singular"][kr, kc:kc + 1]}
        if "X" in state:
            sh["X"] = state["X"][kr * lay.bpr:(kr + 1) * lay.bpr]
        if "swaps" in state:
            sh["swaps"] = state["swaps"][kr, kc:kc + 1]
        out.append(sh)
    return out


def _run_checkpointed_dist(workload, a, b2, m, spec, *, store, run_id,
                           cadence, engine, resume_from, abort, dev):
    """:func:`_run_checkpointed` on p ranks of the 1D layout or a (pr, pc)
    mesh of the 2D layout (module docstring)."""
    from ..driver import WORLD_DEADLINE_S
    from ..parallel.launch import run_workers

    n = a.shape[-1]
    lay = _dist_layout(n, m, spec)
    Nr = lay.Nr
    p = lay.pr * lay.pc if isinstance(spec, tuple) else spec
    nrhs = 0 if b2 is None else int(b2.shape[1])
    topology = (f"2d:{spec[0]}x{spec[1]}" if isinstance(spec, tuple)
                else f"1d:{p}")
    key = CheckpointKey(run_id=run_id, workload=workload, engine=engine,
                        topology=topology, n=int(n), m=int(m), Nr=int(Nr),
                        dtype=_dtype_name(a.dtype), nrhs=nrhs,
                        cadence=int(cadence))
    start, durable, resumed = 0, None, False
    if resume_from is not None:
        step, arrays = store.resume(key)
        if not (0 <= step < Nr):
            raise CheckpointMismatchError(
                f"resume superstep {step} outside [0, {Nr}) for this "
                f"layout; refused")
        state = _dist_state_checked(workload, arrays, key, lay, a.dtype)
        start, durable, resumed = step, step, True
    else:
        state = _dist_fresh_state(workload, a, b2, lay)
    info = {"run_id": run_id, "workload": workload, "engine": engine,
            "topology": topology, "n": int(n), "m": int(m), "Nr": int(Nr),
            "cadence": int(cadence), "start_step": start,
            "resumed": resumed, "segments_run": [], "segment_compiles": 0,
            "ckpt_written": 0, "ckpt_bytes_last": 0,
            "ckpt_write_seconds": []}

    # The boundaries, walked in this process in the single-device loop's
    # order up to the first preempt.
    _check_abort(abort, run_id, durable)
    segments, preempted, last = [], None, durable
    for t0, t1 in _segments(start, Nr, cadence):
        try:
            _fire_preempt(run_id, last)
        except PreemptedError as e:
            preempted = e
            break
        segments.append((t0, t1))
        if t1 < Nr:
            last = t1
    for t0, t1 in segments:
        sig = ("seg", workload, engine, topology, int(n), int(m), int(Nr),
               key.dtype, nrhs, t0, t1, dev.type)
        if _note_segment(sig):
            info["segment_compiles"] += 1
    results = None
    if segments:
        watch = _AbortWatcher(abort, store.root)
        rspec = {"workload": workload, "n": int(n), "m": int(m),
                 "mesh": list(spec) if isinstance(spec, tuple) else None,
                 "segments": segments, "key": key.to_json(),
                 "root": store.root, "finalize": preempted is None,
                 "revoke": watch.flag}
        shards = _rank_shards(state, lay)
        try:
            results = run_workers(p, checkpoint_rank, rspec,
                                  per_rank=[(sh,) for sh in shards],
                                  deadline_s=WORLD_DEADLINE_S,
                                  device_type=dev.type)
        finally:
            watch.stop()
            # Rank 0 wrote to the store's ledger from its own process.
            store.reload()
        for step, nbytes, digest, superseded, secs in results[0]["written"]:
            store._observe_write(key, step, nbytes, digest, superseded)
            info["ckpt_written"] += 1
            info["ckpt_bytes_last"] = nbytes
            info["ckpt_write_seconds"].append(secs)
        revoked = results[0].get("revoked_at")
        info["segments_run"] = (segments if revoked is None
                                else [s for s in segments if s[1] <= revoked])
        info["ranks"] = [{k: v for k, v in r.items() if k != "blocks"}
                         for r in results]
        if revoked is not None:
            exc = watch.error
            _recorder.record("ckpt_preempted", run_id=run_id,
                             step=int(revoked), cause="abort")
            exc.step = int(revoked)
            exc.info = info
            raise exc
    if preempted is not None:
        preempted.info = info           # what the world ran before it
        raise preempted
    _check_abort(abort, run_id, last)
    fsig = ("fin", workload, engine, topology, int(n), int(m), int(Nr),
            key.dtype, nrhs, dev.type)
    if _note_segment(fsig):
        info["segment_compiles"] += 1
    singular = any(r["singular"] for r in results)
    blocks = [r["blocks"] for r in results]
    if isinstance(spec, tuple):
        from ..parallel.jordan2d_inplace import (gather_inverse_inplace_2d,
                                                 gather_solution_2d)

        out = (gather_solution_2d(blocks, lay, n) if workload == "solve"
               else gather_inverse_inplace_2d(blocks, lay, n))
    else:
        from ..parallel.sharded_inplace import (gather_inverse_inplace,
                                                gather_solution_1d)

        out = (gather_solution_1d(blocks, lay, n) if workload == "solve"
               else gather_inverse_inplace(blocks, lay, n))
    out = out.to(dev)
    store.discard(run_id, reason="complete")
    return out, singular, info


class _AbortWatcher:
    """Polls ``abort()`` on a thread of the caller while a distributed
    checkpointed run's world runs; the first error it returns is kept
    (:attr:`error`) and announced to the ranks by creating the flag file
    :attr:`flag` in the store's directory.  No ``abort``: no thread, no
    flag."""

    POLL_S = 0.005

    def __init__(self, abort, root: str):
        import uuid

        self.error = None
        self.flag = None
        self._done = threading.Event()
        if abort is None:
            return
        self.flag = os.path.join(root, f".revoke-{uuid.uuid4().hex}")

        def watch():
            while not self._done.is_set():
                exc = abort()
                if exc is not None:
                    self.error = exc
                    with open(self.flag, "w"):
                        pass
                    return
                self._done.wait(self.POLL_S)

        self._thread = threading.Thread(target=watch, daemon=True,
                                        name="tpu-jordan-torch-ckpt-watch")
        self._thread.start()

    def stop(self) -> None:
        if self.flag is None:
            return
        self._done.set()
        self._thread.join(timeout=5)
        try:
            os.unlink(self.flag)
        except OSError:
            pass


def _revoked(group, flag: str | None) -> bool:
    """Rank 0 reads the revocation flag and every rank receives its
    verdict (one ``all_reduce`` of a flag; none without a flag)."""
    import torch

    if flag is None:
        return False
    t = torch.zeros(1, dtype=torch.float32, device=group.device)
    if group.rank == 0 and os.path.exists(flag):
        t += 1
    return bool(group.all_reduce(t, "max").item())


def checkpoint_rank(group, spec: dict, shard: dict) -> dict:
    """One rank of a distributed checkpointed run: the segments
    ``spec["segments"]`` on the rank's part of the state (``shard``: numpy
    ``W``, ``X`` or ``swaps``, ``singular``), rank 0 gathering and writing
    the state at every boundary before the last step, then reading the
    revocation flag ``spec["revoke"]`` (the world stops at a revoked
    boundary: ``revoked_at``); with ``spec["finalize"]`` the rank's X rows
    or unscrambled inverse blocks as ``blocks``.  ``spec["mesh"]`` is (pr, pc) on the 2D layout, None on
    the 1D.  Returns the rank's CPU outcome; rank 0's ``written`` lists
    (step, bytes, sha256, superseded, seconds) of its writes."""
    import time

    import torch

    from ..config import eps_for
    from ..parallel.dist_solve import _launches, gather_parts

    dev = group.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    solve = spec["workload"] == "solve"
    mesh = spec.get("mesh")
    if mesh is None:
        from ..parallel.layout import CyclicLayout
        from ..parallel.sharded_inplace import (inplace_finalize_1d,
                                                inplace_segment_1d,
                                                solve_segment_1d)

        lay = CyclicLayout.create(spec["n"], spec["m"], group.world_size)

        def segment(W, X, singular, swaps, t0, t1):
            if solve:
                return solve_segment_1d(W, X, singular, group, lay, t0, t1,
                                        eps)
            return inplace_segment_1d(W, singular, swaps, group, lay, t0,
                                      t1, eps)

        def finalize(W, swaps):
            return inplace_finalize_1d(W, swaps, lay)

        def storage(parts):
            return torch.cat(parts)

        def x_rows(parts):
            return torch.cat(parts)

        grid = (lay.p,)
    else:
        from ..parallel.group import mesh_group
        from ..parallel.jordan2d import join_shards_2d
        from ..parallel.jordan2d_inplace import (inplace_finalize_2d,
                                                 inplace_segment_2d,
                                                 solve_segment_2d)
        from ..parallel.layout import CyclicLayout2D

        pr, pc = mesh
        mg = mesh_group(group, pr, pc)
        lay = CyclicLayout2D.create(spec["n"], spec["m"], pr, pc)

        def segment(W, X, singular, swaps, t0, t1):
            if solve:
                probed = solve_segment_2d(W, X, singular, mg, lay, t0, t1,
                                          eps)
            else:
                probed = inplace_segment_2d(W, singular, swaps, mg, lay, t0,
                                            t1, eps)
            return [t for t, _ in probed]

        def finalize(W, swaps):
            return inplace_finalize_2d(W, swaps, mg, lay)

        def storage(parts):
            return join_shards_2d(parts, lay)

        def x_rows(parts):
            # X is replicated along pc: mesh column 0's rows, by mesh row.
            return torch.cat([parts[kr * pc] for kr in range(pr)])

        grid = (pr, pc)
    key = CheckpointKey.from_json(spec["key"])
    W = torch.from_numpy(np.ascontiguousarray(shard["W"])).to(dev)
    X = (torch.from_numpy(np.ascontiguousarray(shard["X"])).to(dev)
         if solve else None)
    singular = torch.from_numpy(shard["singular"].copy()).to(dev)
    swaps = (None if solve
             else torch.from_numpy(shard["swaps"][0].astype(np.int64)))
    eps = eps_for(W.dtype)
    store = CheckpointStore(spec["root"]) if group.rank == 0 else None
    written, steps, revoked_at = [], [], None
    before = _launches()
    for t0, t1 in spec["segments"]:
        steps += segment(W, X, singular, swaps, t0, t1)
        if t1 >= lay.Nr:
            continue
        h0 = time.perf_counter()
        w_parts = gather_parts(W, group)
        x_parts = gather_parts(X, group) if solve else None
        flags = gather_parts(singular.to(torch.uint8), group)
        if store is not None:
            arrays = {"W": storage(w_parts).cpu().numpy()}
            if solve:
                arrays["X"] = x_rows(x_parts).cpu().numpy()
            arrays["singular"] = (torch.cat(flags).cpu().numpy()
                                  .astype(bool).reshape(grid))
            if not solve:
                arrays["swaps"] = np.tile(
                    swaps.numpy().astype(np.int32), grid + (1,))
            nbytes, digest = store._write_file(key, t1, arrays)
            superseded = store._account_write(key)
            written.append((t1, nbytes, digest, superseded,
                            time.perf_counter() - h0))
        if _revoked(group, spec.get("revoke")):
            revoked_at = t1
            break
    after = _launches()
    out = {"rank": group.rank, "written": written, "probe_steps": steps,
           "launches": {k: after[k] - before[k] for k in after},
           "singular": bool(singular.any()), "backend": group.backend,
           "blocks": None, "revoked_at": revoked_at}
    if spec["finalize"] and revoked_at is None:
        out["blocks"] = (X if solve else finalize(W, swaps)).cpu()
    return out
