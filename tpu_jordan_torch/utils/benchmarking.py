"""Slope timing: per-iteration seconds with every fixed cost cancelled.

``fn`` runs r1 and then r2 times in one loop whose iterations depend on
each other through the data, and the reported time is the slope between
the two trip counts, so launch, synchronization and readback costs cancel.
On the card the clock stops only after ``torch.cuda.synchronize()``.
Counterpart of the JAX package's ``utils/benchmarking.py``.
"""

from __future__ import annotations

import time

import torch


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def slope_time(fn, args, r1: int = 4, r2: int = 12, trials: int = 3,
               samples: int = 1):
    """Per-iteration seconds of ``fn(*args)``, fixed costs cancelled.

    ``fn`` returns a tensor; its sum, times 1e-30, is added to ``args[0]``
    before the next iteration, which chains the iterations without
    changing the computation.  Each trip count is timed ``trials`` times
    after one warm run and its fastest time kept.  ``samples > 1`` repeats
    the whole (r1, r2) measurement and returns the list of slopes."""
    args = tuple(args)

    def many(reps):
        carry = args
        for _ in range(reps):
            out = fn(*carry)
            a0 = carry[0] + (1e-30 * out.sum()).to(carry[0].dtype)
            carry = (a0,) + carry[1:]
        return carry[0].sum()

    def measure(reps):
        _sync(many(reps))
        ts = []
        for _ in range(trials):
            t0 = time.perf_counter()
            _sync(many(reps))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    def sample():
        t1, t2 = measure(r1), measure(r2)
        return (t2 - t1) / (r2 - r1)

    if samples == 1:
        return sample()
    return [sample() for _ in range(samples)]
