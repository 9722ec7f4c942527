"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``tpu_jordan_torch/build/`` and
loaded with ``ctypes``; the pointers and the stream go in as integers.  The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded.  No ``--use_fast_math``:
the probe divides by its pivots and must divide exactly.

:func:`load` is safe to call from several threads (a serving dispatcher
beside the caller's thread): the first load of a library runs under one
lock, and every build writes a temporary file named for its process and
thread before the atomic rename.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelCompileError("nvcc not found (set CUDA_HOME or put nvcc "
                             "on PATH); the CUDA kernels are built at first "
                             "use")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives once built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def _start(name: str, verbose: bool):
    """Start nvcc for one source; returns (process, temp path, final path),
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names, verbose: bool = False) -> dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together.  Returns each name's compiler output ("" when it
    was already built).  Raises KernelCompileError if any build fails."""
    started = {name: _start(name, verbose) for name in names}
    logs, failed = {}, []
    for name, job in started.items():
        if job is None:
            logs[name] = ""
            continue
        proc, tmp, out = job
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelCompileError("\n".join(failed))
    return logs


_LOAD_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed
    (once per process, whichever thread asks first; the others wait)."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
