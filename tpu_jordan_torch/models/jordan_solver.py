"""JordanSolver: a configured inversion pipeline, reused across many
matrices of one shape.

The reference re-runs its whole program per matrix (main.cpp:65-93).  The
JAX package's solver caches a compiled executable; torch has none to
compile, so this one caches what the port can: the resolved engine, as a
callable, and its block size, fixed at construction; ``engine="auto"``
resolves once, through the tuner, at construction.  Single device; the JAX
constructor's distributed and telemetry fields are kept and refused by
name (ROADMAP.md Queue A items 15 and 12).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any

import torch

from ..config import default_block_size
from ..errors import UsageError
from ..interop import from_numpy, resolve_device, resolve_dtype
from ..ops import residual_inf_norm
from ..ops.jordan_inplace import _SUB_FP32


@dataclass
class JordanSolver:
    """Configured blocked Gauss–Jordan inversion on one device.

    ``n`` the matrix dimension; ``block_size`` the pivot block size m
    (``config.default_block_size(n)`` unless given); ``dtype`` the storage
    dtype (sub-fp32 computes in fp32 and rounds once at the end; complex64
    and complex128 run the augmented engine); ``refine`` Newton–Schulz
    steps after every inversion; ``precision`` "highest" only (as
    ``driver.solve``); ``engine``/``group`` as ``driver.resolve_engine``,
    "auto" resolved by the tuner's ladder as in ``driver.solve`` (the plan
    cache ``plan_cache``, the cost ranking, measurement with ``tune=True``;
    complex: "augmented"), the plan kept on ``plan``; ``policy`` a
    ``resilience.ResiliencePolicy`` whose retry wraps every engine call;
    ``device`` the card unless "cpu".  ``workers > 1`` and
    ``gather=False`` (item 15) and ``telemetry`` (item 12) are refused by
    name.  Counterpart of the JAX package's ``models.JordanSolver``."""

    n: int
    block_size: int | None = None
    dtype: Any = torch.float32
    refine: int = 0
    workers: Any = 1
    precision: str = "highest"
    gather: bool = True
    engine: str = "auto"
    group: int = 0
    tune: bool = False
    plan_cache: str | None = None
    telemetry: Any = None
    policy: Any = None
    device: Any = None
    plan: Any = field(default=None, repr=False)
    _run: Any = field(default=None, repr=False)

    def __post_init__(self):
        from ..driver import (invert, refuse_later_options,
                              resolve_invert_engine)
        from ..ops.refine import resolve_precision

        refuse_later_options(self.workers, self.gather, self.telemetry,
                             self.policy, "off", self.dtype)
        self.dtype = resolve_dtype(self.dtype)
        self._device = resolve_device(self.device)
        if self.block_size is None:
            self.block_size = default_block_size(self.n)
        _, self.refine = resolve_precision(self.precision, self.refine)
        # The resolution of driver.solve, once: the pick is pinned on
        # engine/group/plan.
        self.engine, self.group, self.plan = resolve_invert_engine(
            self.engine, self.group, self.n, self.block_size, self.dtype,
            tune=self.tune, plan_cache=self.plan_cache,
            workers=self.workers, gather=self.gather, device=self._device)
        self._work_dtype = (torch.float32 if self.dtype in _SUB_FP32
                            else self.dtype)
        self._run = partial(invert, engine=self.engine, group=self.group,
                            block_size=self.block_size, refine=self.refine)

    def _matrix(self, a, shape):
        a = from_numpy(a, self._device, self._work_dtype)
        if tuple(a.shape[-2:]) != shape[-2:] or (
                len(shape) == 2 and a.dim() != 2):
            raise ValueError(f"expected {shape}, got {tuple(a.shape)}")
        return a

    def _execute(self, fn):
        if self._device.type == "cuda":
            # Full fp32 products on the card (the JAX package's HIGHEST).
            torch.backends.cuda.matmul.allow_tf32 = False
        return (self.policy.retry.call(fn) if self.policy is not None
                else fn())

    def invert(self, a):
        """Invert one (n, n) matrix (a numpy array or a tensor); returns
        ``(inverse, singular)``, the inverse in the storage dtype and
        ``singular`` a 0-d bool tensor."""
        a = self._matrix(a, (self.n, self.n))
        inv, singular = self._execute(lambda: self._run(a))
        return inv.to(self.dtype), singular

    def invert_batch(self, stack):
        """Invert a (B, n, n) stack through the batched engine
        (``ops/batched.py``, one probe call a superstep for the whole
        stack); returns ``(inverses, singular_flags)`` of shapes (B, n, n)
        and (B,).  Real dtypes only: the batched engine is the in-place
        one."""
        from ..ops import batched_jordan_invert

        if self.dtype.is_complex:
            raise UsageError("invert_batch runs the batched in-place "
                             "engine, a real-dtype engine; invert complex "
                             "matrices one at a time")
        a = self._matrix(stack, (-1, self.n, self.n))
        inv, sing = self._execute(lambda: batched_jordan_invert(
            a, block_size=self.block_size, refine=self.refine))
        return inv.to(self.dtype), sing

    def residual(self, a, inv) -> float:
        """The independent ‖A·A⁻¹ − I‖∞ of ``inv`` (whatever ``invert``
        returned, or any inverse) against ``a``."""
        a = self._matrix(a, (self.n, self.n))
        inv = from_numpy(inv, self._device, self._work_dtype)
        return float(residual_inf_norm(a, inv))
