"""npz checkpoints.  Counterpart of `summersph_tpu/io/checkpoint.py`,
with the same keys, so a checkpoint written by either package loads in
the other: `p.<field>` and `s.<field>` for every particle and sink field
that is set, `t`, `dt`, `stats`, `pm_r_s` when the far field is held, and
`config_json` (the SimConfig as JSON bytes) when a config is given.

A write goes to a temporary file that is then renamed over the target,
so an interrupted run never leaves a broken checkpoint.  Loading is
forward compatible: a field missing from an older file takes its default,
a short `stats` vector is padded with zeros, and config keys this version
does not know are dropped.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from ..config import SimConfig
from ..state import STATS_FIELDS, SimState, from_numpy, to_numpy


def save_npz(path, state: SimState, cfg: Optional[SimConfig] = None) -> None:
    d = to_numpy(state)
    flat = {f"{prefix}.{name}": a
            for prefix, group in (("p", "particles"), ("s", "sinks"))
            for name, a in d[group].items()}
    for name in ("t", "dt", "stats", "pm_r_s"):
        if name in d:
            flat[name] = d[name]
    if cfg is not None:
        flat["config_json"] = np.frombuffer(
            json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8)
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_npz(path, device="cuda") -> SimState:
    return load_npz_with_config(path, device=device)[0]


def load_npz_with_config(path, device="cuda"
                         ) -> Tuple[SimState, Optional[SimConfig]]:
    """(state on `device`, the saved config or None).  The state goes to
    the card unless the caller asks for another device."""
    with np.load(path) as data:
        groups = {"particles": {}, "sinks": {}}
        for key in data.files:
            prefix, _, name = key.partition(".")
            if prefix in ("p", "s") and name:
                groups["particles" if prefix == "p" else "sinks"][name] = \
                    data[key]
        stats = (data["stats"] if "stats" in data.files
                 else np.zeros(len(STATS_FIELDS), np.int32))
        if stats.shape[0] < len(STATS_FIELDS):  # older, shorter vector
            stats = np.concatenate([stats, np.zeros(
                len(STATS_FIELDS) - stats.shape[0], np.int32)])
        d = {**groups, "t": data["t"], "dt": data["dt"], "stats": stats}
        if "pm_r_s" in data.files:
            d["pm_r_s"] = data["pm_r_s"]
        cfg = None
        if "config_json" in data.files:
            raw = json.loads(data["config_json"].tobytes().decode())
            cfg = SimConfig(**{k: v for k, v in raw.items()
                               if k in SimConfig.__dataclass_fields__})
    return from_numpy(d, device=device), cfg


__all__ = ["save_npz", "load_npz", "load_npz_with_config"]
