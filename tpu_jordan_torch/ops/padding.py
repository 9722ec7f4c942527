"""Identity padding for ragged shapes.

The reference carries a ragged last block (height ``l = n - m*(Nr-1)``,
main.cpp:133-137) through every kernel.  Here A is embedded into the
top-left of a padded matrix

    A_pad = [[A, 0], [0, I]]

whose inverse is exactly [[A^-1, 0], [0, I]].  The identity tail is inert
under the pivoted block elimination: padded rows are zero in every real
column, so they are never picked as real pivots.
"""

from __future__ import annotations

import torch


def pad_with_identity(a: torch.Tensor, N: int) -> torch.Tensor:
    """Embed (..., n, n) ``a`` into an (..., N, N) identity-padded stack.
    Returns ``a`` itself when no padding is needed."""
    n = a.shape[-1]
    if N == n:
        return a
    if N < n:
        raise ValueError(f"cannot pad {n} down to {N}")
    out = torch.eye(N, dtype=a.dtype, device=a.device).expand(
        a.shape[:-2] + (N, N)).clone()
    out[..., :n, :n] = a
    return out


def unpad(a: torch.Tensor, n: int) -> torch.Tensor:
    """Slice the (n, n) top-left corner back out."""
    return a[..., :n, :n]
