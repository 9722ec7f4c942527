"""The configured inversion pipeline (``JordanSolver``)."""

from .jordan_solver import JordanSolver

__all__ = ["JordanSolver"]
