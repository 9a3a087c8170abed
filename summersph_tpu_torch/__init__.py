"""summersph_tpu_torch: the PyTorch / CUDA port of summersph_tpu.

It runs the Keplerian disc and the self-gravitating collapse on one
NVIDIA H100: SFC sort -> hand-written CUDA density and force pair kernels
(csrc/sph_pairs.cu), with fixed h or in their grad-h variable-h forms ->
EOS -> self-gravity (direct, or TreePM: the CIC mesh with torch.fft and
the short-range CUDA kernel, or its form fused into the force kernel,
with the far field optionally held for cfg.pm_every steps) -> sink
gravity -> KDK leapfrog with the adaptive global timestep, or with
cfg.dt_bins > 1 block timesteps on power-of-two rungs, whose substeps run
the pair kernels in their gated forms on the closing rows only -> with
variable h the Newton h-iteration and sink creation -> sink accretion,
merging and bounds culling.  `run_until` and `simulate` drive it to an end
time with the reference's `.txt` snapshots (`io`), and `python -m
summersph_tpu_torch` is its command line (`cli`).  Entry points put their
state on the card unless the caller asks for the CPU; on the CPU every
kernel is replaced by its plain PyTorch version.  The package imports torch
and numpy, never jax.
"""

from .config import SimConfig, read_parameters_txt, write_parameters_txt
from .integrate import force_eval, prime, run_steps, run_until, simulate, step
from .blockstep import step_binned
from .state import Particles, SimState, Sinks, from_numpy, to_numpy

__version__ = "0.1.0"

__all__ = [
    "SimConfig", "read_parameters_txt", "write_parameters_txt",
    "Particles", "Sinks", "SimState", "to_numpy", "from_numpy",
    "force_eval", "prime", "step", "run_steps", "run_until", "simulate",
    "step_binned",
]
