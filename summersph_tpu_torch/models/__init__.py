"""Initial conditions."""

from .disc import disc_ic

__all__ = ["disc_ic"]
