"""SPH density projection images.  Counterpart of
`summersph_tpu/tools/density_image.py`.

The density on a resolution^3 grid over [-box, box]^3 is the dense sum
sum_j m_j W(|x_g - x_j|, h) over every particle, taken in batches of grid
points in float32 in plain torch, then projected along z.  (It is no TPU
kernel in the JAX package either.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..ops.kernels import kernel_w
from ..state import Particles, Sinks

# Bytes of temporaries per (grid point, particle) pair in one batch: the
# [B, N, 3] difference and its square, then about ten [B, N] float32 arrays
# in kernel_w.  Batches are sized to keep them under BATCH_BYTES.
_BYTES_PER_PAIR = 64
BATCH_BYTES = 2 << 30


def density_grid(pos, mass, h, resolution: int = 120, box: float = 100.0,
                 device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """SPH density on a resolution^3 grid over [-box, box]^3, computed on
    `device` (the card unless the caller asks for another).  `h` is one
    value or one per particle.  Returns (density [R, R, R] float32 numpy,
    axis coordinates [R])."""
    xi = np.linspace(-box, box, resolution)
    X, Y, Z = np.meshgrid(xi, xi, xi, indexing="ij")
    pts = torch.as_tensor(np.stack([X, Y, Z], axis=-1).reshape(-1, 3),
                          dtype=torch.float32, device=device)

    posj = torch.as_tensor(np.asarray(pos), dtype=torch.float32, device=device)
    mj = torch.as_tensor(np.asarray(mass), dtype=torch.float32, device=device)
    hj = torch.broadcast_to(torch.as_tensor(np.asarray(h), dtype=torch.float32,
                                            device=device), mj.shape)

    batch = max(1, BATCH_BYTES // (_BYTES_PER_PAIR * max(len(mj), 1)))
    out = torch.empty(len(pts), dtype=torch.float32, device=device)
    for i in range(0, len(pts), batch):
        d = pts[i:i + batch, None, :] - posj[None, :, :]
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        out[i:i + batch] = torch.sum(mj[None, :] * kernel_w(r, hj[None, :]),
                                     dim=-1)
    return out.cpu().numpy().reshape(resolution, resolution, resolution), xi


def projected_density_from_snapshot(path, h: Optional[float] = None,
                                    resolution: int = 120, box: float = 100.0,
                                    device="cuda"):
    """Load a reference-format snapshot and z-project its SPH density on
    `device`.  Returns (projected [R, R], axis [R], sink_xy [S, 2]); the
    sinks are the u == 0 rows, however many there are."""
    from ..io.txt import read_ic_txt

    p, s = read_ic_txt(path, SimConfig(), device=device)
    return projected_density(p, s, h=h, resolution=resolution, box=box,
                             device=device)


def projected_density(p: Particles, s: Sinks, h: Optional[float] = None,
                      resolution: int = 120, box: float = 100.0,
                      device="cuda"):
    alive = p.alive.cpu().numpy()
    pos = p.pos.cpu().numpy()[alive]
    mass = p.mass.cpu().numpy()[alive]
    hval = h if h is not None else p.h.cpu().numpy()[alive]

    inside = np.all(np.abs(pos) < box, axis=1)
    grid, xi = density_grid(pos[inside], mass[inside],
                            hval if np.isscalar(hval) else hval[inside],
                            resolution=resolution, box=box, device=device)
    projected = grid.sum(axis=2)
    sink_alive = s.alive.cpu().numpy()
    sink_xy = s.pos.cpu().numpy()[sink_alive][:, :2]
    return projected, xi, sink_xy


def save_image(projected, xi, sink_xy, out_path,
               title="Integrated SPH density"):
    """Render the projection (inferno, origin lower, sinks in red)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(projected.T, origin="lower",
                   extent=[xi[0], xi[-1], xi[0], xi[-1]], cmap="inferno")
    fig.colorbar(im, ax=ax, label="Integrated density")
    ax.set_title(title)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    for sx, sy in sink_xy:
        if abs(sx) < xi[-1] and abs(sy) < xi[-1]:
            ax.plot(sx, sy, ".", color="red", markersize=3)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)


__all__ = ["density_grid", "projected_density",
           "projected_density_from_snapshot", "save_image"]
