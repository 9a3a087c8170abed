"""Initial conditions: the disc and collapse sphere, the thin ring and the
Sod shock tube."""

from .disc import collapse_ic, disc_ic
from .ring import ring_ic
from .sod import sod_ic

__all__ = ["disc_ic", "collapse_ic", "ring_ic", "sod_ic"]
