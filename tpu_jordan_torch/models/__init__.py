"""The configured inversion pipeline (``JordanSolver``)."""

from .jordan_solver import DistributedInverse, JordanSolver

__all__ = ["DistributedInverse", "JordanSolver"]
