"""Unit system: AU, M_sun, yr, in which G = 4 pi^2.

Counterpart of `summersph_tpu/utils/units.py`, with the same constants.
"""

import math

# Gravitational constant in AU^3 / (M_sun * yr^2), the value the reference
# code hardcodes.
G = 39.47841760435743

PI = math.pi

__all__ = ["G", "PI"]
