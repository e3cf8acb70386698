"""User-facing API: the Engine."""

from .engine import Engine

__all__ = ["Engine"]
