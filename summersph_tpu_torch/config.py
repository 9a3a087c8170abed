"""Simulation configuration: the port's own copy of `SimConfig`.

Field for field the same as `summersph_tpu/config.py` (names, order and
defaults; a test holds the two equal).  The port keeps its own copy because
importing `summersph_tpu.config` imports the whole JAX package.  The
comments there say what each knob does; the notes here say what it does in
the port.

Knobs that only shape the TPU kernels' memory layout are accepted and have
no effect: `pallas_interpret`, `pallas_exact_windows`, `pallas_window`,
`pallas_fetch_window`, `window_blocks`, `grav_window_blocks`,
`grav_pallas_window`, `grav_pallas_fetch`, `grav_overflow_items`, and
`sorted_block` beyond the padding granule.  The CUDA pair kernels walk every
window group's true candidate range, so no window size can drop a pair.
`use_pallas` only keeps the JAX package's rule that `grav_fuse_short`
needs it; `grav_fft='matmul'` names the one `torch.fft` path.
`neighbor_mode='grid'` runs on the sorted engine: the hashed grid exists
in the JAX package for the TPU's gather costs, and both engines sum the
same pairs.

`read_parameters_txt` / `write_parameters_txt` read and write the
reference `parameters.txt`, byte for byte as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SimConfig:
    # --- the reference `parameters.txt` nine
    bounding_size: float = 1500.0
    max_depth: int = 1000
    theta: float = 0.5
    gamma: float = 1.4
    eta: float = 1.2
    convergence_criteria: float = 1.0e-3
    max_length: float = 100.0
    timestep_scale: float = 0.25
    end_time: float = 1000.0

    # --- smoothing length: fixed, or None for the grad-h h-iteration
    fixed_h: Optional[float] = 2.5

    # --- artificial viscosity (Monaghan + Morris-Monaghan switch)
    alpha_min: float = 0.1
    alpha_decay: float = 0.15
    beta_factor: float = 2.0
    av_eps: float = 0.01

    # --- timestep control
    dt_init: float = 1.0e-2
    dt_max: float = 0.1
    dt_min: float = 1.0e-4
    dt_grow: float = 1.5
    dt_shrink: float = 0.5
    dt_bound_candidate: bool = True
    dt_bins: int = 1                    # > 1: block timesteps

    # --- output cadence
    n_saves: int = 1000

    # --- sinks
    sink_radius: float = 3.5
    sink_capacity: int = 8
    sink_create_density: float = 0.5
    sink_create_mass: float = 1.0e-11
    sink_merge_factor: float = 0.0      # > 0 merges close sinks

    # --- gravity: 'none', 'direct', TreePM ('pm'/'bh'/'treepm')
    gravity: str = "none"
    grav_chunk: int = 1024
    grav_grid: int = 128
    grav_split_rs: float = 1.0
    grav_rcut_rs: Optional[float] = None
    grav_window_blocks: int = 8         # no effect
    grav_gradient: str = "fd"
    grav_fft: str = "matmul"            # 'matmul' and 'xla': torch.fft
    grav_overflow_items: int = 0        # no effect (nothing overflows)
    grav_fuse_short: bool = False       # short range in the force kernel
    pm_every: int = 1                   # far field held between solves

    # --- neighbour search: 'sorted', and 'grid' run on the sorted engine
    neighbor_mode: str = "grid"
    cell_cap: int = 64
    sorted_block: int = 128             # padding granule only
    window_group: int = 32              # rows per CUDA block
    window_blocks: int = 3              # no effect (XLA engine's reach)
    use_pallas: bool = False            # grav_fuse_short needs it
    pallas_window: int = 256            # no effect
    pallas_fetch_window: int = 768      # no effect
    pallas_interpret: bool = False      # no effect
    pallas_exact_windows: bool = False  # no effect
    grav_pallas_window: int = 1024      # no effect
    grav_pallas_fetch: int = 1408       # no effect

    # --- h-iteration (variable-h mode, fixed_h=None)
    h_iter_max: int = 3
    sort_h_pad: float = 1.2
    cell_h_quantile: float = 1.0

    # --- multi-device decomposition (parallel/): 'gather' or 'slab'
    # (parallel/decomp.py), whose rims, migration chunks and splitter
    # samples these knobs size
    decomp: str = "gather"
    halo_rows: int = 1024
    grav_halo_rows: int = 2048
    halo_hops: int = 1
    migrate_rows: int = 1024
    decomp_samples: int = 256

    # --- integrator
    reuse_forces: bool = True

    # --- numerics
    dtype: str = "float32"              # 'float32' | 'float64' (CPU only)
    kahan_u: bool = False

    def np_dtype(self) -> torch.dtype:
        """The state's torch dtype (the name mirrors the JAX config)."""
        return torch.float64 if self.dtype == "float64" else torch.float32

    def with_(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def effective_rcut_rs(self) -> float:
        """Short-range cutoff in units of r_s, derived from `theta` if unset
        (clip(2.25 / theta, 3, 8), as in the JAX config)."""
        if self.grav_rcut_rs is not None:
            return float(self.grav_rcut_rs)
        t = max(float(self.theta), 1.0e-3)
        return min(max(2.25 / t, 3.0), 8.0)


_PARAM_FIELDS = (
    "bounding_size", "max_depth", "theta", "gamma", "eta",
    "convergence_criteria", "max_length", "timestep_scale", "end_time",
)


def read_parameters_txt(path, base: Optional[SimConfig] = None) -> SimConfig:
    """Read the reference `parameters.txt`: a header line, then one line of
    the nine fields in `_PARAM_FIELDS` order.  A parameter file implies the
    variable-h code path, so `fixed_h` is cleared unless `base` is given."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if len(lines) < 2:
        raise ValueError(f"{path}: expected header + data line")
    vals = lines[-1].split()
    if len(vals) < 9:
        raise ValueError(f"{path}: expected 9 fields, got {len(vals)}")
    kw = {name: int(raw) if name == "max_depth" else float(raw)
          for name, raw in zip(_PARAM_FIELDS, vals)}
    cfg = base if base is not None else SimConfig(fixed_h=None)
    return cfg.with_(**kw)


def write_parameters_txt(path, cfg: SimConfig) -> None:
    """Write a reference-compatible `parameters.txt`."""
    with open(path, "w") as f:
        f.write(" ".join(_PARAM_FIELDS) + "\n")
        f.write(" ".join(
            str(int(getattr(cfg, n))) if n == "max_depth"
            else repr(float(getattr(cfg, n))) for n in _PARAM_FIELDS) + "\n")


__all__ = ["SimConfig", "read_parameters_txt", "write_parameters_txt"]
