"""Stage timers, stage-split profiling and traces, and convergence
curves."""

from .profile import (profile_jacobi_stages, profile_xpbd_stages,
                      step_rate, trace, trace_summary)
from .timing import StepStats

__all__ = ["StepStats", "profile_jacobi_stages", "profile_xpbd_stages",
           "step_rate", "trace", "trace_summary"]
