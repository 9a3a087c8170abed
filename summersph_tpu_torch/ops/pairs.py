"""Core SPH pair sums in the gather form.  Counterpart of
`summersph_tpu/ops/pairs.py`, whose docstring gives the formulas and the
reference lines.

Pair tensors are [..., C] with the candidate axis last; the row fields are
[..., 1].  Every division is guarded so that masked, self and degenerate
pairs contribute exactly zero instead of NaN.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..utils.units import PI
from .kernels import kernel_dwdh, kernel_w, kernel_w_dw


def _safe_inv(x, cond):
    """1/x where cond else 0 (no NaN from masked lanes)."""
    return torch.where(cond, 1.0 / torch.where(cond, x, 1.0), 0.0)


def density_sums(dxx, dxy, dxz, h_i, m_j, mask):
    """(rho, omega_raw) over neighbour lanes, self excluded: zero-distance
    lanes are masked out and `finalize_density` adds the self term, so a
    truncated window can never lose it."""
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    r = torch.sqrt(r2)
    w = kernel_w(r, h_i)
    dwdh = kernel_dwdh(r, h_i)
    m = torch.where(mask & (r2 > 0.0), m_j, 0.0)
    return torch.sum(m * w, dim=-1), torch.sum(m * dwdh, dim=-1)


def finalize_density(rho, omega_raw, h, alive, m):
    """Add the analytic self term, apply the grad-h Omega correction and
    make dead lanes inert (rho = 1, Omega = 1)."""
    inv_h3 = 1.0 / (PI * h * h * h)
    rho = rho + m * inv_h3
    omega_raw = omega_raw - 3.0 * m * inv_h3 / h
    ok = alive & (rho > 0.0)
    rho_safe = torch.where(ok, rho, 1.0)
    omega = 1.0 + (h / (3.0 * rho_safe)) * torch.where(ok, omega_raw, 0.0)
    omega = torch.where(torch.abs(omega) > 1.0e-4, omega, 1.0)
    return rho_safe, omega


def force_sums(dxx, dxy, dxz, vx, vy, vz, h_i, h_j, p_i, p_j, rho_i, rho_j,
               om_i, om_j, cs_i, cs_j, al_i, al_j, m_j, mask,
               cfg: SimConfig):
    """Pressure + artificial-viscosity pair sums (ax, ay, az, du,
    alpha_raw); self pairs (r == 0) are excluded by the r > 0 guard."""
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    r = torch.sqrt(r2)
    valid = mask & (r > 0.0)
    inv_r = _safe_inv(r, valid)

    _, dw_i = kernel_w_dw(r, h_i)
    _, dw_j = kernel_w_dw(r, h_j)
    dwbar = 0.5 * (dw_i + dw_j)

    vdotr = vx * dxx + vy * dxy + vz * dxz
    vdotr_neg = torch.clamp(vdotr, max=0.0)

    hbar = 0.5 * (h_i + h_j)
    mu = hbar * vdotr_neg / (r2 + cfg.av_eps * hbar * hbar)
    cbar = 0.5 * (cs_i + cs_j)
    abar = 0.5 * (al_i + al_j)
    rhobar = 0.5 * (rho_i + rho_j)
    visc = (-abar * cbar * mu + cfg.beta_factor * abar * mu * mu) * _safe_inv(
        rhobar, valid & (rhobar > 0.0))

    pterm_i = p_i * _safe_inv(om_i * rho_i * rho_i, valid)
    pterm_j = p_j * _safe_inv(om_j * rho_j * rho_j, valid)

    m = torch.where(valid, m_j, 0.0)
    scal = pterm_i * dw_i + pterm_j * dw_j + visc * dwbar
    coef = -m * scal * inv_r
    ax = torch.sum(coef * dxx, dim=-1)
    ay = torch.sum(coef * dxy, dim=-1)
    az = torch.sum(coef * dxz, dim=-1)

    vdotgradw = vdotr * inv_r * dwbar
    du = torch.sum(m * vdotgradw * (pterm_i + 0.5 * visc), dim=-1)
    alpha_raw = torch.sum(m * vdotgradw, dim=-1)
    return ax, ay, az, du, alpha_raw


def alpha_rate(alpha_raw, rho, alpha, cs, h, cfg: SimConfig):
    """Morris-Monaghan switch: max(araw / rho, 0) + alpha_decay
    (alpha_min - alpha) cs / h."""
    src = torch.clamp(alpha_raw / torch.where(rho > 0.0, rho, 1.0), min=0.0)
    return src + cfg.alpha_decay * (cfg.alpha_min - alpha) * cs / h


__all__ = ["density_sums", "finalize_density", "force_sums", "alpha_rate"]
