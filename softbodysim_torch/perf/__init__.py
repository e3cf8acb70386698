"""Stage timers and convergence curves."""

from .timing import StepStats

__all__ = ["StepStats"]
