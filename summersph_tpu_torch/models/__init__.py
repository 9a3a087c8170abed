"""Initial conditions."""

from .disc import collapse_ic, disc_ic

__all__ = ["disc_ic", "collapse_ic"]
