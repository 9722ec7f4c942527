"""Host-side helpers."""

from .printing import format_corner, print_corner
from .profiling import Scoreboard, invert_flops, timed, trace

__all__ = ["Scoreboard", "format_corner", "invert_flops", "print_corner",
           "timed", "trace"]
