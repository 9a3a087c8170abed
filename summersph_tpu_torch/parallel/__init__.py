"""Multi-device runs (gather mode and the slab decomposition) over
`torch.distributed`.

`comm` (the mesh and its collectives) is what the ops modules import; the
run functions of `sharded` import `integrate`, which imports those ops
modules, so they load on first use.
"""

from .comm import Mesh, gather_particles

_SHARDED = ("make_mesh", "state_specs", "pad_state_to_devices", "shard_state",
            "gather_state", "make_sharded_prime", "make_sharded_step",
            "make_sharded_run_steps", "sharded_run_until")


def __getattr__(name):
    if name in _SHARDED:
        from . import sharded
        return getattr(sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Mesh", "gather_particles", *_SHARDED]
