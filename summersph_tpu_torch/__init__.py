"""summersph_tpu_torch: the PyTorch / CUDA port of summersph_tpu.

The first slice runs the fixed-h, gravity='none' Keplerian-disc main path
on one NVIDIA H100: SFC sort -> hand-written CUDA density and force pair
kernels (csrc/sph_pairs.cu) -> EOS -> sink gravity -> KDK leapfrog with
the adaptive global timestep, sink accretion and bounds culling.  On the
CPU every kernel is replaced by its plain PyTorch version.  The package
imports torch and numpy, never jax.
"""

from .config import SimConfig
from .integrate import force_eval, prime, run_steps, step
from .state import Particles, SimState, Sinks, from_numpy, to_numpy

__version__ = "0.1.0"

__all__ = [
    "SimConfig", "Particles", "Sinks", "SimState", "to_numpy", "from_numpy",
    "force_eval", "prime", "step", "run_steps",
]
