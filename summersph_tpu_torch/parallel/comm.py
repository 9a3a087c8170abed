"""The device mesh and its collectives over `torch.distributed`: the
port's counterpart of the axis that `shard_map` binds in the JAX package
(`axis_name`) and of the `jax.lax` collectives on it.

A `Mesh` holds a process group that the caller started (`nccl` on cards,
`gloo` on the CPU), this process's rank and the group's size, and the
device its tensors live on: one process a rank, one device a process.
Wherever the JAX package takes `axis_name: str` inside `shard_map`, the
port takes a `Mesh`; None still means one device.

Every collective is a blocking call on the caller's stream, made by every
rank in the same order with tensors of the same shape.  What comes out of
one (`psum`, `pmin`, `pmax`, `all_gather_tiled`) is identical on every
rank, so a quantity that must be replicated (the sinks, dt, the PM mesh,
the box) is taken from a collective's result, never from a rank's own sum.

`gather_particles` gathers a whole `Particles` in one collective: its
fields ride one [F, n] buffer of the float type, the integer and boolean
fields (`pid`, `alive`) bit-cast into it (`.view`), never cast by value,
so ids above 2^24 survive a float32 buffer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..state import Particles

# The integer type of each float type's width, for bit-casting.
_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: the process group (None: the default group),
    this process's rank in it, its size and this rank's device."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device


def axis_index(mesh: Mesh) -> int:
    """This rank's position on the axis (`jax.lax.axis_index`)."""
    return mesh.rank


def axis_size(mesh: Mesh) -> int:
    """The number of ranks on the axis (`jax.lax.axis_size`)."""
    return mesh.size


def all_gather_tiled(t: torch.Tensor, mesh: Mesh, dim: int = 0
                     ) -> torch.Tensor:
    """Every rank's `t`, concatenated in rank order along `dim`
    (`jax.lax.all_gather(..., tiled=True)`)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=dim)


def _all_reduce(t: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's `t` (`jax.lax.psum`)."""
    return _all_reduce(t, mesh, dist.ReduceOp.SUM)


def pmin(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise minimum over the ranks (`jax.lax.pmin`)."""
    return _all_reduce(t, mesh, dist.ReduceOp.MIN)


def pmax(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum over the ranks (`jax.lax.pmax`)."""
    return _all_reduce(t, mesh, dist.ReduceOp.MAX)


def _as_rows(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A field as [k, n] rows of the float type `dtype`: floats by value,
    integers and booleans by their bits (widened by value to the float
    type's width first, which keeps every value)."""
    rows = a.reshape(a.shape[0], -1).T
    if a.is_floating_point():
        return rows.to(dtype)
    return rows.to(_INT_OF[dtype]).contiguous().view(dtype)


def _from_rows(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of `_as_rows`: [k, N] rows back to a field shaped as
    `like`, with N rows."""
    if like.is_floating_point():
        out = rows.to(like.dtype)
    else:
        out = rows.contiguous().view(_INT_OF[rows.dtype])
        out = out != 0 if like.dtype == torch.bool else out.to(like.dtype)
    return out.T.reshape((-1,) + tuple(like.shape[1:])).contiguous()


def all_gather_fields(fields: Sequence[torch.Tensor], mesh: Mesh
                      ) -> List[torch.Tensor]:
    """Each of `fields` (every one with the same number of rows, floats of
    one type or integers and booleans beside them) gathered over the
    ranks, in one collective of one [F, n] buffer."""
    dtype = next(f.dtype for f in fields if f.is_floating_point())
    rows = [_as_rows(f, dtype) for f in fields]
    out = all_gather_tiled(torch.cat(rows), mesh, dim=1)
    res, k = [], 0
    for f, r in zip(fields, rows):
        res.append(_from_rows(out[k:k + r.shape[0]], f))
        k += r.shape[0]
    return res


def gather_particles(p: Particles, mesh: Mesh) -> Particles:
    """The tiled all-gather of a `Particles`: every rank's rows in rank
    order, every field present, in one collective."""
    names = [f.name for f in dataclasses.fields(p)
             if getattr(p, f.name) is not None]
    out = all_gather_fields([getattr(p, n) for n in names], mesh)
    return p.replace(**dict(zip(names, out)))


__all__ = ["Mesh", "axis_index", "axis_size", "all_gather_tiled", "psum",
           "pmin", "pmax", "all_gather_fields", "gather_particles"]
