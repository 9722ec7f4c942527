"""The typed errors of the entry points, and the exit codes they map to."""

from __future__ import annotations


class UsageError(ValueError):
    """Invalid option or flag combination, or one that a later slice of the
    port brings: the reference's usage exit code 1 (main.cpp:77-85),
    distinct from internal ValueErrors."""


class SingularMatrixError(ArithmeticError):
    """No block column had an invertible pivot candidate: the reference's
    "singular matrix" exit (main.cpp:1075-1083, 435-437)."""


class DeviceUnavailableError(RuntimeError):
    """The requested device (by default the CUDA card) is not present."""


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused or failed a kernel launch."""
