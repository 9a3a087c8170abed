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

The slab decomposition (`parallel/decomp.py`) adds three: `ppermute`, a
shift of a tensor along the ranks (`jax.lax.ppermute` with a chain
permutation: the edge ranks receive zeros), `all_to_all_tiled`
(`jax.lax.all_to_all(..., tiled=True)`), and `psum_scatter`
(`jax.lax.psum_scatter` tiled along dim 0, for the pencil Poisson solve).

`RESULT_BYTES` counts, per kind of collective, the bytes of every
collective's result on this rank (an all-gather's whole output, a
reduction's, a shift's received buffer, an all-to-all's received buffer),
as `cuda_pairs` counts kernel launches: `reset_result_bytes` sets them to
0.  The counts follow from the shapes alone, so they say how the traffic
scales with N and the rim; at D = 1 nothing leaves the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..state import Particles
from ..tracing import traced

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


RESULT_BYTES = {"all_gather": 0, "all_reduce": 0, "ppermute": 0,
                "all_to_all": 0, "psum_scatter": 0}


def reset_result_bytes():
    """Set every count of `RESULT_BYTES` to 0."""
    for kind in RESULT_BYTES:
        RESULT_BYTES[kind] = 0


def _count_bytes(kind: str, t: torch.Tensor):
    RESULT_BYTES[kind] += t.numel() * t.element_size()


def all_gather_tiled(t: torch.Tensor, mesh: Mesh, dim: int = 0
                     ) -> torch.Tensor:
    """Every rank's `t`, concatenated in rank order along `dim`
    (`jax.lax.all_gather(..., tiled=True)`)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    out = torch.cat(parts, dim=dim)
    _count_bytes("all_gather", out)
    return out


def _all_reduce(t: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=mesh.group)
    _count_bytes("all_reduce", out)
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


def _peer(mesh: Mesh, rank: int) -> int:
    """The global rank of the group's rank `rank` (point-to-point ops
    name global ranks)."""
    if mesh.group is None:
        return rank
    return dist.get_global_rank(mesh.group, rank)


def ppermute(t: torch.Tensor, mesh: Mesh, shift: int) -> torch.Tensor:
    """Rank d receives rank d - shift's `t`; a rank with no such source
    receives zeros (`jax.lax.ppermute` over the chain permutation
    [(s, s + shift)], the edges not wrapped).  One batch of point-to-point
    ops; a rank with neither a destination nor a source makes no call
    (every rank at D = 1)."""
    t = t.contiguous()
    out = torch.zeros_like(t)
    dst, src = mesh.rank + shift, mesh.rank - shift
    ops = []
    if 0 <= dst < mesh.size:
        ops.append(dist.P2POp(dist.isend, t, _peer(mesh, dst), mesh.group))
    if 0 <= src < mesh.size:
        ops.append(dist.P2POp(dist.irecv, out, _peer(mesh, src), mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _count_bytes("ppermute", out)
    return out


def _real(t: torch.Tensor) -> torch.Tensor:
    """A complex tensor as real (a trailing dim of 2): not every backend
    moves complex tensors."""
    return torch.view_as_real(t) if t.is_complex() else t


def _all_to_all_chunks(t: torch.Tensor, mesh: Mesh, split_dim: int,
                       kind: str) -> torch.Tensor:
    """[D, ...]: chunk j of `t` along `split_dim` sent to rank j, and
    position i of the result the chunk rank i sent here (one
    `all_to_all_single`)."""
    if t.shape[split_dim] % mesh.size:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} "
                         f"does not split over {mesh.size} ranks")
    send = torch.stack(torch.tensor_split(_real(t), mesh.size,
                                          dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    _count_bytes(kind, recv)
    return torch.view_as_complex(recv) if t.is_complex() else recv


def all_to_all_tiled(t: torch.Tensor, mesh: Mesh, split_dim: int,
                     concat_dim: int) -> torch.Tensor:
    """`jax.lax.all_to_all(t, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)`: `t` cut into D chunks along `split_dim`, chunk j to rank
    j, and the chunks received laid end to end in rank order along
    `concat_dim`.  Complex tensors ride as real pairs."""
    recv = _all_to_all_chunks(t, mesh, split_dim, "all_to_all")
    return torch.cat(recv.unbind(0), dim=concat_dim)


def psum_scatter(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`jax.lax.psum_scatter(t, scatter_dimension=0, tiled=True)`: the sum
    over the ranks of `t`, of which rank d keeps the d-th of D equal
    slices along dim 0.  One all-to-all of the slices, then their sum in
    rank order, the same on every backend."""
    return _all_to_all_chunks(t, mesh, 0, "psum_scatter").sum(dim=0)


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


def pack_fields(fields: Sequence[torch.Tensor]) -> torch.Tensor:
    """[F, n]: each of `fields` (every one with n rows, floats of one type
    or integers and booleans beside them) as rows of one buffer of the
    float type, the integers and booleans by their bits."""
    dtype = next(f.dtype for f in fields if f.is_floating_point())
    return torch.cat([_as_rows(f, dtype) for f in fields])


def unpack_fields(buf: torch.Tensor, like: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Inverse of `pack_fields` for a buffer of any number of columns: the
    fields shaped and typed as `like`."""
    res, k = [], 0
    for f in like:
        width = math.prod(f.shape[1:])
        res.append(_from_rows(buf[k:k + width], f))
        k += width
    return res


@traced("gather")
def all_gather_fields(fields: Sequence[torch.Tensor], mesh: Mesh
                      ) -> List[torch.Tensor]:
    """Each of `fields` (as `pack_fields` takes them) gathered over the
    ranks, in one collective of one [F, n] buffer."""
    return unpack_fields(all_gather_tiled(pack_fields(fields), mesh, dim=1),
                         fields)


def gather_particles(p: Particles, mesh: Mesh) -> Particles:
    """The tiled all-gather of a `Particles`: every rank's rows in rank
    order, every field present, in one collective."""
    names = [f.name for f in dataclasses.fields(p)
             if getattr(p, f.name) is not None]
    out = all_gather_fields([getattr(p, n) for n in names], mesh)
    return p.replace(**dict(zip(names, out)))


__all__ = ["Mesh", "axis_index", "axis_size", "all_gather_tiled", "psum",
           "pmin", "pmax", "ppermute", "all_to_all_tiled", "psum_scatter",
           "pack_fields", "unpack_fields", "all_gather_fields",
           "gather_particles", "RESULT_BYTES",
           "reset_result_bytes"]
