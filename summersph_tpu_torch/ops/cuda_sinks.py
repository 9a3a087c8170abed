"""The sink layers as CUDA kernels (`csrc/sinks.cu`): sink gravity, sink
creation, accretion and merging, each one pass over the particles (or one
block over the [S, S] pairs), with no [S, N] temporary.

`ops/gravity.py` `sink_gravity` and `ops/sinks.py` `create_sinks`,
`accrete` and `merge_sinks` dispatch by device, by the rule of
`ops/cuda_pairs.py`: a tensor on the CPU takes the plain version
(`sink_gravity_plain`, `create_sinks_plain`, `accrete_plain`,
`merge_sinks_plain`), a tensor on a CUDA card the function here of the
same name with `_cuda` at the end, which launches the kernels or raises.
There is no fallback from a kernel to its plain version.

Each function counts its kernel launches in plain integer attributes, one
per kernel (`launch_counters()`): `sink_gravity_cuda.launches` (the
particle pass) and `.reduce_launches`, `create_sinks_cuda.launches` and
`.pick_launches`, `accrete_cuda.launches` and `.reduce_launches`,
`merge_sinks_cuda.launches`.

A particle pass writes per-block partials [blocks, S, k] that a one-block
kernel sums in block order: no float atomics, so two launches agree bit
for bit; `blocks(n, tile)` depends on n alone.  On several devices
(`axis_name`, a `parallel.Mesh`) the kernels replace only the rank's
local work: the one-block kernel first writes the rank's [S, 3] gas pull
or [S, 10] accretion sums, which are summed over the ranks as the plain
versions sum them (`psum`), and a second launch of it, on those sums as
one block of partials, finishes; creation writes the rank's candidate row
(its density, or -inf; position, velocity, h), gathered over the ranks
(`all_gather_tiled`), from which a second launch picks the first densest.

The kernels take float32 or float64, a bool `alive` and at most MAX_SLOTS
sink slots, the slots they stage in shared memory.  While a profiler
records, each public sink function, on either device, adds the live slots
it saw to the tracing counter `sink_live_slots` (`count_live`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from ..config import SimConfig
from ..parallel.comm import all_gather_tiled, psum
from ..state import Particles, Sinks
from ..utils import build
from ..utils.units import G
from .cuda_pairs import _launch

SOURCE = "summersph_tpu_torch/csrc/sinks.cu"

MAX_SLOTS = 512     # sink slots a kernel stages (a one-block kernel's threads)
BLOCK = 256         # threads of a particle-pass block (csrc/sinks.cu NT)
GRAV_TILE = 4 * BLOCK   # particles a sink_gravity block takes per sweep
MAX_BLOCKS = 256    # blocks of a particle pass, and so of its partials
# creation's partials are one candidate a block: its pass takes a block
# per BLOCK particles up to N = 2^20, for the loads in flight
CREATE_MAX_BLOCKS = 4096


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("sinks")
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    tail = [i32, ptr]                                       # dbl, stream
    for name, args in (
            ("sink_gravity_pass", [ptr] * 8 + [i32, i32, i32, f64]),
            ("sink_gravity_reduce",
             [ptr, i32] + [ptr] * 4 + [i32, f64, i32]),
            ("create_sinks_pass", [ptr] * 10 + [i32, i32, i32, f64, f64]),
            ("create_sinks_pick",
             [ptr, ptr, i32, ptr, i32] + [ptr] * 19 + [i32, f64, i32]),
            ("accrete_pass", [ptr] * 14 + [i32, i32, i32]),
            ("accrete_reduce", [ptr, i32] + [ptr] * 10 + [i32, i32]),
            ("merge_sinks", [ptr] * 13 + [i32, f64, i32])):
        fn = getattr(lib, name)
        fn.argtypes = args + tail
        fn.restype = i32
    return lib


def blocks(n: int, tile: int, cap: int = MAX_BLOCKS) -> int:
    """The blocks of a particle pass over n particles that takes `tile` a
    block per sweep, at most `cap`: a function of n alone, so that the
    order of the partials' sum, and so every bit, is the same on any
    card."""
    return max(1, min(cap, -(-n // tile)))


def count_live(s: Sinks) -> None:
    """Adds the live slots of s to the tracing counter `sink_live_slots`,
    while a profiler records (a device-side add, no read)."""
    if tracing.active():
        tracing.count("sink_live_slots", torch.sum(s.alive))


def _prepare(what: str, p: Particles | None, s: Sinks, p_fields, s_fields):
    """The named fields of p and s, contiguous, after checking what the
    kernels take; returns (fields, dbl, stream)."""
    dev = s.pos.device
    dtype = s.pos.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: the sink kernels take float32 or float64, "
                        f"got {dtype}")
    if s.capacity > MAX_SLOTS:
        raise ValueError(f"{what}: {s.capacity} sink slots; the kernels "
                         f"stage at most {MAX_SLOTS}")
    if p is not None and p.capacity < 1:
        raise ValueError(f"{what}: no particle rows")
    out = {}
    for obj, names, rows in ((p, p_fields, None if p is None else p.capacity),
                             (s, s_fields, s.capacity)):
        for name in names:
            t = getattr(obj, name)
            want = torch.bool if name == "alive" else dtype
            if not t.is_cuda or t.device != dev or t.dtype != want \
                    or t.shape[0] != rows:
                raise ValueError(
                    f"{what}: {name} must be a {want} CUDA tensor of {rows} "
                    f"rows on {dev}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
            out[("s" if obj is s else "") + name] = t.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    return out, int(dtype == torch.float64), stream


def sink_gravity_cuda(p: Particles, s: Sinks, axis_name=None):
    """`gravity.sink_gravity_plain` on the card: (acc_gas [N, 3],
    acc_sink [S, 3])."""
    f, dbl, stream = _prepare("sink_gravity", p, s, ("pos", "mass", "alive"),
                              ("pos", "mass", "alive"))
    lib = _library()
    n, S = p.capacity, s.capacity
    nb = blocks(n, GRAV_TILE)
    acc = torch.empty_like(f["pos"])
    part = f["pos"].new_empty((nb, S, 3))
    sink = (f["spos"].data_ptr(), f["smass"].data_ptr(),
            f["salive"].data_ptr())
    _launch(lib.sink_gravity_pass, f["pos"].data_ptr(), f["mass"].data_ptr(),
            f["alive"].data_ptr(), *sink, acc.data_ptr(), part.data_ptr(),
            n, S, nb, G, dbl, stream)
    sink_gravity_cuda.launches += 1
    if axis_name is not None:
        sums = torch.empty_like(f["spos"])
        _launch(lib.sink_gravity_reduce, part.data_ptr(), nb, *sink,
                sums.data_ptr(), S, G, 0, dbl, stream)
        sink_gravity_cuda.reduce_launches += 1
        part, nb = psum(sums, axis_name), 1
    acc_sink = torch.empty_like(f["spos"])
    _launch(lib.sink_gravity_reduce, part.data_ptr(), nb, *sink,
            acc_sink.data_ptr(), S, G, 1, dbl, stream)
    sink_gravity_cuda.reduce_launches += 1
    return acc, acc_sink


def create_sinks_cuda(p: Particles, s: Sinks, cfg: SimConfig,
                      axis_name=None):
    """`sinks.create_sinks_plain` on the card: (sinks, slots_full)."""
    f, dbl, stream = _prepare(
        "create_sinks", p, s, ("pos", "vel", "mass", "h", "alive"),
        ("pos", "vel", "acc", "spin", "mass", "radius", "alive"))
    lib = _library()
    n, S = p.capacity, s.capacity
    nb = blocks(n, BLOCK, CREATE_MAX_BLOCKS)
    best_val = f["mass"].new_empty(nb)
    best_idx = torch.empty(nb, dtype=torch.int32, device=best_val.device)
    _launch(lib.create_sinks_pass, f["pos"].data_ptr(), f["mass"].data_ptr(),
            f["h"].data_ptr(), f["alive"].data_ptr(), f["spos"].data_ptr(),
            f["sradius"].data_ptr(), f["smass"].data_ptr(),
            f["salive"].data_ptr(), best_val.data_ptr(), best_idx.data_ptr(),
            n, S, nb, cfg.eta, cfg.sink_create_density, dbl, stream)
    create_sinks_cuda.launches += 1

    new = {k: torch.empty_like(f["s" + k])
           for k in ("alive", "pos", "vel", "acc", "spin", "mass", "radius")}
    full = torch.empty((), dtype=torch.int32, device=best_val.device)
    gas = (f["pos"].data_ptr(), f["vel"].data_ptr(), f["h"].data_ptr())
    sink = tuple(f["s" + k].data_ptr() for k in
                 ("pos", "vel", "acc", "spin", "mass", "radius", "alive"))
    outs = tuple(new[k].data_ptr() for k in
                 ("alive", "pos", "vel", "acc", "spin", "mass", "radius"))

    def pick(mode, cand=None, cand_out=None):
        _launch(lib.create_sinks_pick, best_val.data_ptr(),
                best_idx.data_ptr(), nb,
                None if cand is None else cand.data_ptr(),
                0 if cand is None else cand.numel() // 8, *gas, *sink,
                None if cand_out is None else cand_out.data_ptr(), *outs,
                full.data_ptr(), S, cfg.sink_create_mass, mode, dbl, stream)
        create_sinks_cuda.pick_launches += 1

    if axis_name is None:
        pick(0)
    else:
        row = best_val.new_empty(8)
        pick(1, cand_out=row)
        pick(2, cand=all_gather_tiled(row, axis_name))
    return s.replace(**new), full


def accrete_cuda(p: Particles, s: Sinks, axis_name=None):
    """`sinks.accrete_plain` on the card: (particles, sinks)."""
    f, dbl, stream = _prepare(
        "accrete", p, s, ("pos", "vel", "mass", "alive"),
        ("pos", "vel", "mass", "radius", "spin", "alive"))
    lib = _library()
    n, S = p.capacity, s.capacity
    nb = blocks(n, BLOCK)
    gas = {k: torch.empty_like(f[k]) for k in ("alive", "mass", "pos", "vel")}
    part = f["pos"].new_empty((nb, S, 10))
    _launch(lib.accrete_pass, f["pos"].data_ptr(), f["vel"].data_ptr(),
            f["mass"].data_ptr(), f["alive"].data_ptr(), f["spos"].data_ptr(),
            f["svel"].data_ptr(), f["smass"].data_ptr(),
            f["sradius"].data_ptr(), f["salive"].data_ptr(),
            *(gas[k].data_ptr() for k in ("alive", "mass", "pos", "vel")),
            part.data_ptr(), n, S, nb, dbl, stream)
    accrete_cuda.launches += 1

    sink = tuple(f["s" + k].data_ptr()
                 for k in ("pos", "vel", "mass", "spin", "alive"))
    new = {k: torch.empty_like(f["s" + k])
           for k in ("mass", "pos", "vel", "spin")}
    outs = tuple(new[k].data_ptr() for k in ("mass", "pos", "vel", "spin"))
    if axis_name is not None:
        sums = f["spos"].new_empty((S, 10))
        _launch(lib.accrete_reduce, part.data_ptr(), nb, *sink,
                sums.data_ptr(), *outs, S, 0, dbl, stream)
        accrete_cuda.reduce_launches += 1
        part, nb = psum(sums, axis_name), 1
    _launch(lib.accrete_reduce, part.data_ptr(), nb, *sink, None, *outs, S,
            1, dbl, stream)
    accrete_cuda.reduce_launches += 1
    return p.replace(**gas), s.replace(**new)


def merge_sinks_cuda(s: Sinks, cfg: SimConfig):
    """`sinks.merge_sinks_plain` on the card: (sinks, n_merged)."""
    f, dbl, stream = _prepare(
        "merge_sinks", None, s, (),
        ("pos", "vel", "spin", "mass", "radius", "alive"))
    S = s.capacity
    new = {k: torch.empty_like(f["s" + k])
           for k in ("alive", "mass", "pos", "vel", "spin", "radius")}
    n_merged = torch.empty((), dtype=torch.int32, device=s.pos.device)
    _launch(_library().merge_sinks,
            *(f["s" + k].data_ptr() for k in
              ("pos", "vel", "spin", "mass", "radius", "alive")),
            *(new[k].data_ptr() for k in
              ("alive", "mass", "pos", "vel", "spin", "radius")),
            n_merged.data_ptr(), S, cfg.sink_merge_factor,
            max(1, S.bit_length()), dbl, stream)
    merge_sinks_cuda.launches += 1
    return s.replace(**new), n_merged


def launch_counters():
    """(function, attribute) of every sink kernel's launch count."""
    return [(sink_gravity_cuda, "launches"),
            (sink_gravity_cuda, "reduce_launches"),
            (create_sinks_cuda, "launches"),
            (create_sinks_cuda, "pick_launches"),
            (accrete_cuda, "launches"), (accrete_cuda, "reduce_launches"),
            (merge_sinks_cuda, "launches")]


for _fn, _attr in launch_counters():
    setattr(_fn, _attr, 0)

__all__ = ["sink_gravity_cuda", "create_sinks_cuda", "accrete_cuda",
           "merge_sinks_cuda", "count_live", "blocks", "launch_counters",
           "MAX_SLOTS", "SOURCE"]
