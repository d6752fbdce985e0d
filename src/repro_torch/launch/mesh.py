"""Process group and mesh construction (port of ``repro/launch/mesh.py``
on ``torch.distributed``; importing it touches no device and no group).

The port serves under a mesh as SPMD, one process a device:

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh model=4

``init_distributed`` joins the group ``torchrun`` describes (NCCL on CUDA,
each rank on device ``LOCAL_RANK``; gloo when the CPU is asked for), and
``parallel_ctx_from_spec`` builds the ``("data", "model")`` mesh over it.
There is no single-process fallback: a spec whose size is not the
group's raises.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..parallel import ParallelCtx

__all__ = ["init_distributed", "make_debug_mesh", "make_parallel_ctx",
           "parallel_ctx_from_spec", "parse_mesh_spec"]


def init_distributed(device=None) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and
    return this rank's device: ``cuda:LOCAL_RANK`` over NCCL unless
    ``device`` asks for the CPU, which joins over gloo."""
    for var in ("RANK", "WORLD_SIZE"):
        if var not in os.environ:
            raise RuntimeError(f"{var} is not set: start the ranks with "
                               "torchrun (e.g. torchrun --nproc-per-node 2 "
                               "-m repro_torch.launch.serve --mesh model=2)")
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' (gloo) to "
                               "serve a mesh on the CPU")
        device = f"cuda:{local}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method="env://",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_debug_mesh(data: int = 2, model: int = 2):
    """A ``("data", "model")`` ``DeviceMesh`` over the joined group (NCCL's
    on CUDA, gloo's on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


def make_parallel_ctx(mesh) -> ParallelCtx:
    """The context of ``mesh``: its 'pod' and 'data' axes are DP, 'model'
    is TP."""
    dp_axes = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return ParallelCtx(mesh=mesh, dp_axes=dp_axes, tp_axis="model")


def parse_mesh_spec(spec: str) -> dict:
    """'model=4' or 'data=2,model=4' -> {"data": 2, "model": 4}; omitted
    axes are 1."""
    sizes = {"data": 1, "model": 1}
    for part in spec.split(","):
        axis, _, n = part.partition("=")
        if axis not in sizes or not n.isdigit() or int(n) < 1:
            raise ValueError(f"bad mesh spec {spec!r}; want e.g. 'model=4' "
                             "or 'data=2,model=4'")
        sizes[axis] = int(n)
    return sizes


def parallel_ctx_from_spec(spec: str) -> ParallelCtx:
    """CLI mesh spec -> ``ParallelCtx`` over the joined process group: a
    ('data', 'model') mesh, omitted axes 1 ('model=4' is pure tensor
    parallelism).  Needs a group of exactly data*model ranks."""
    sizes = parse_mesh_spec(spec)
    n = sizes["data"] * sizes["model"]
    if not dist.is_initialized():
        raise ValueError(f"mesh {spec!r} needs {n} ranks and no process "
                         "group is joined (launch/mesh.py init_distributed, "
                         "under torchrun)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {spec!r} needs data*model = {n} ranks, the "
                         f"process group has {world}")
    return make_parallel_ctx(make_debug_mesh(sizes["data"], sizes["model"]))
