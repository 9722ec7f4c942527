"""tpu_jordan_torch: block Gauss–Jordan matrix inversion with
condition-based block pivoting, in PyTorch for an NVIDIA H100.

The port of the JAX package ``tpu_jordan`` (which stays the reference): the
same algorithm, module names and results, with the pivot-candidate probe as
a hand-written CUDA kernel (``csrc/gj_probe.cu``).  Imports torch and numpy,
never JAX.
"""

from .driver import SolveResult, solve
from .errors import DeviceUnavailableError, SingularMatrixError, UsageError

__all__ = ["DeviceUnavailableError", "SingularMatrixError", "SolveResult",
           "UsageError", "solve"]
