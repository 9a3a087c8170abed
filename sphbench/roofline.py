"""Roofline arithmetic: the least time a kernel could take on the chip.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of HBM3.
A kernel's counts live in `kernels/<name>.json`: FP32 operations per pair
inside the support, bytes read and written per row and per window group,
and which pairs it needs (`density`, `force`, `gravity`, or none).  The
least time of one launch is the larger of its operations over the FP32
peak and its bytes over the memory rate; the pairs are those the data
need, counted on a state, never the candidates a kernel tests.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAK_FP32 = 67e12      # FLOP/s
PEAK_BYTES = 3.35e12   # bytes/s
KERNEL_DIR = Path(__file__).resolve().parent / "kernels"


def kernel(name: str) -> dict:
    """The counts of kernel `name` (`kernels/<name>.json`)."""
    with open(KERNEL_DIR / f"{name}.json") as f:
        return json.load(f)


def least_seconds(name: str, pairs: float, rows: int, groups: int) -> float:
    """The least time of one launch of `name` over `rows` rows in `groups`
    window groups that needs `pairs` pairs."""
    k = kernel(name)
    t_ops = pairs * k["ops_per_pair"] / PEAK_FP32
    t_bytes = (k["bytes_per_row"] * rows
               + k["bytes_per_group"] * groups) / PEAK_BYTES
    return max(t_ops, t_bytes)


def flops(name: str, pairs: float) -> float:
    """FP32 operations one launch of `name` needs on `pairs` pairs."""
    return pairs * kernel(name)["ops_per_pair"]


__all__ = ["PEAK_FP32", "PEAK_BYTES", "kernel", "least_seconds", "flops"]
