"""Elastic mesh resolution: the relaunch environment declares the world
(port of ``repro/runtime/elastic.py``).

``REPRO_MESH=pod16x16 | pod2x16x16 | dNxM`` names the mesh a (re)start
builds over the joined process group (launch/mesh.py ``make_mesh``);
checkpoints reshard on restore (checkpoint/checkpointer.py), so the
mesh may change between runs with no checkpoint surgery.  "Devices" are
the group's ranks: a pod spec larger than the world degrades to
``d1xWORLD`` (every rank on the ``model`` axis) with a
``RuntimeWarning``, as the reference degrades on a small host; an
explicit ``dNxM`` that is not the world's size raises.
"""
from __future__ import annotations

import math
import os
import warnings

__all__ = ["mesh_from_env", "mesh_from_spec", "resolve_mesh_spec"]

_POD_SPECS = {
    "pod16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def resolve_mesh_spec(spec: str, world: int) -> tuple[tuple, tuple]:
    """(shape, axis names) of ``spec`` on a group of ``world`` ranks; warns
    where a pod spec degrades, raises ``ValueError`` on an unknown spec or
    a ``dNxM`` of another size than the world."""
    if spec in _POD_SPECS:
        dims, names = _POD_SPECS[spec]
        if math.prod(dims) > world:
            warnings.warn(
                f"REPRO_MESH={spec} wants {math.prod(dims)} devices but "
                f"the process group has {world} ranks; degrading to the "
                f"largest supported debug mesh d1x{world} (data=1, "
                f"model={world})", RuntimeWarning, stacklevel=4)
            return (1, world), ("data", "model")
        return dims, names
    if spec.startswith("d"):                        # e.g. d2x2
        try:
            dims = tuple(int(x) for x in spec[1:].split("x"))
        except ValueError:
            dims = ()
        if len(dims) in (1, 2) and all(d >= 1 for d in dims):
            if math.prod(dims) != world:
                raise ValueError(f"REPRO_MESH={spec} needs "
                                 f"{math.prod(dims)} ranks, the process "
                                 f"group has {world}")
            return dims, ("data", "model")[:len(dims)]
    raise ValueError(f"unknown REPRO_MESH={spec!r}; want pod16x16, "
                     "pod2x16x16 or dNxM")


def mesh_from_spec(spec: str):
    """The ``DeviceMesh`` ``spec`` names over the joined process group
    (``resolve_mesh_spec`` with its world size)."""
    import torch.distributed as dist

    from ..launch.mesh import make_mesh
    if not dist.is_initialized():
        raise ValueError(f"REPRO_MESH={spec}: no process group is joined "
                         "(launch/mesh.py init_distributed, under torchrun)")
    return make_mesh(*resolve_mesh_spec(spec, dist.get_world_size()))


def mesh_from_env(default: str = "pod16x16"):
    """The ``DeviceMesh`` ``REPRO_MESH`` (else ``default``) names."""
    return mesh_from_spec(os.environ.get("REPRO_MESH", default))
