"""Cubic-spline SPH kernel and gravitational softening, in closed form.

Counterpart of `summersph_tpu/ops/kernels.py` (3D cubic spline with
support 2h, q = r / h):

    W(r, h) = w(q) / (pi h^3)      w(q) = 1 - 1.5 q^2 + 0.75 q^3   q <= 1
                                        = 0.25 (2 - q)^3          q <= 2
    dW/dr   = w'(q) / (pi h^4)     dW/dh = -(3 W + r dW/dr) / h

and the spline softening factor f(q) that multiplies G M / r^2.
`dwdh_reference_compat` is the reference's variable-h dW/dh expression and
`KernelTable` its tabulated kernel; both exist for parity checks only.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.units import PI


def w_shape(q):
    """Dimensionless cubic-spline shape function w(q), support [0, 2]."""
    inner = 1.0 - 1.5 * q * q + 0.75 * q * q * q
    two_m_q = 2.0 - q
    outer = 0.25 * two_m_q * two_m_q * two_m_q
    return torch.where(q <= 1.0, inner,
                       torch.where(q <= 2.0, outer, torch.zeros_like(q)))


def dw_shape(q):
    """Dimensionless derivative w'(q) of the shape function."""
    inner = -3.0 * q + 2.25 * q * q
    two_m_q = 2.0 - q
    outer = -0.75 * two_m_q * two_m_q
    return torch.where(q <= 1.0, inner,
                       torch.where(q <= 2.0, outer, torch.zeros_like(q)))


def kernel_w(r, h):
    """W(r, h) = w(r/h) / (pi h^3)."""
    q = r / h
    return w_shape(q) / (PI * h ** 3)


def kernel_dw(r, h):
    """dW/dr = w'(r/h) / (pi h^4)."""
    q = r / h
    return dw_shape(q) / (PI * h ** 4)


def kernel_w_dw(r, h):
    """(W, dW/dr) from one q."""
    q = r / h
    inv_pih3 = 1.0 / (PI * h ** 3)
    return w_shape(q) * inv_pih3, dw_shape(q) * inv_pih3 / h


def kernel_dwdh(r, h):
    """Exact dW/dh = -(3 W + r dW/dr) / h."""
    w, dw = kernel_w_dw(r, h)
    return -(3.0 * w + r * dw) / h


def dwdh_reference_compat(r, h):
    """The reference variable-h generation's dW/dh, (3W - r dW/dr) / h
    (a sign slip on the 3W term).  For parity checks only; the engine uses
    `kernel_dwdh`."""
    w, dw = kernel_w_dw(r, h)
    return (3.0 * w - r * dw) / h


def grav_shape(q):
    """Softening factor f(q) for the force G M f(q) / r^2; 1 beyond 2h."""
    q2 = q * q
    q3 = q2 * q
    inner = (40.0 * q3 - 36.0 * q3 * q2 + 15.0 * q3 * q3) / 30.0
    outer = (80.0 * q3 - 90.0 * q2 * q2 + 36.0 * q3 * q2 - 5.0 * q3 * q3
             - 2.0) / 30.0
    return torch.where(q <= 1.0, inner,
                       torch.where(q <= 2.0, outer, torch.ones_like(q)))


def grav_softening(r, h):
    """f(r/h): multiplies G M / r^2."""
    return grav_shape(r / h)


@dataclasses.dataclass(frozen=True)
class KernelTable:
    """The kernel tabulated on nq + 1 points over q in [0, 2] and linearly
    interpolated, as the reference does (nq = 5000 in its fixed-h
    generation).  The tables are float64 on the CPU; `w`, `dw` and `grav`
    take tensors and return the interpolated values."""

    nq: int = 5000

    def __post_init__(self):
        dq = 2.0 / self.nq
        q = torch.arange(self.nq + 1, dtype=torch.float64) * dq
        object.__setattr__(self, "_w", w_shape(q))
        object.__setattr__(self, "_dw", dw_shape(q))
        object.__setattr__(self, "_g", grav_shape(q))
        object.__setattr__(self, "_dq", dq)

    def _interp(self, table, q):
        table = table.to(device=q.device, dtype=q.dtype)
        i = torch.clamp((q / self._dq).to(torch.int64), 0, self.nq - 1)
        frac = (q - i.to(q.dtype) * self._dq) / self._dq
        return (1.0 - frac) * table[i] + frac * table[i + 1]

    def _lookup(self, table, r, h, outside):
        q = torch.as_tensor(r / h)
        val = self._interp(table, torch.clamp(q, max=2.0))
        return torch.where(q <= 2.0, val, torch.full_like(val, outside))

    def w(self, r, h):
        return self._lookup(self._w, r, h, 0.0) / (PI * h ** 3)

    def dw(self, r, h):
        return self._lookup(self._dw, r, h, 0.0) / (PI * h ** 4)

    def grav(self, r, h):
        return self._lookup(self._g, r, h, 1.0)


__all__ = ["w_shape", "dw_shape", "kernel_w", "kernel_dw", "kernel_w_dw",
           "kernel_dwdh", "dwdh_reference_compat", "grav_shape",
           "grav_softening", "KernelTable"]
