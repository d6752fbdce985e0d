"""Parallelism context threaded through the serving and training paths
(port of ``repro/parallel.py`` on ``torch.distributed``).

The port serves and trains under a mesh as SPMD with one process a
device: every rank runs the same program on the same inputs and returns
the same tokens (or losses).  ``ParallelCtx`` carries the ``DeviceMesh``
(dims ``("data", "model")``, or ``("pod", "data", "model")`` for the
multi-pod mesh, whose ``pod`` axis is data-parallel), the axis
conventions and this rank's coordinates, and holds every collective
that serving and training under a mesh issue, in one place:

* ``all_gather``: a tensor's pieces along one dim, concatenated in mesh
  order (the reference's ``all_gather(..., tiled=True)``) over one or more
  axes; the shards of a weight (``Sharded``), the N-sharded fused MVM's
  columns, a DP-sharded batch;
* ``all_to_all``: the MoE's expert exchange over the ``model`` axis (the
  reference's ``all_to_all(..., tiled=True)``);
* ``all_reduce_mean``: the MoE aux averaged over the mesh;
* ``psum`` / ``pmax``: a sum or a max over one named axis (the
  reference's ``psum`` / ``pmax``: the train step's gradient mean over
  the DP axes, ``optim/compression.py compressed_psum_tree``), and
  ``agree``, a flag raised on any rank raised on every rank (the train
  loop's failover decision);
* ``ppermute``: each rank's tensor handed to the next rank along an axis
  (the reference's ring ``ppermute``: ``launch/pipeline.py``'s stage
  hand-off), and ``broadcast`` from one coordinate of an axis.

Each is issued whatever the axis size (a size-1 group copies), so a mesh
of one rank runs the collectives it would run on many.  On NCCL they can
be captured in a CUDA graph (the communicators are set up by one eager
collective first, ``warm_up``); a gloo group cannot be captured
(``capturable``).

``Sharded`` is one rank's piece of a parameter leaf placed by the rules of
``launch/sharding.py``: the local tensor (or prepared weight) and the
spec of the whole leaf, a tuple with an entry per dim, ``None`` or the
tuple of mesh axes that dim is split over.  ``ParallelCtx.sp`` (the
sequence-parallel residual stream) is not ported (ROADMAP A13c).

``None`` in place of a ``ParallelCtx`` everywhere means one device.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as dist

__all__ = ["ParallelCtx", "Sharded", "is_prepared"]


@dataclasses.dataclass
class Sharded:
    """One rank's piece of a placed parameter leaf: ``local`` is a tensor
    or a ``QuantizedLinearWeight``, ``spec`` the whole leaf's per-dim
    axes (a prepared weight's is that of its ``q`` planes, whose scales
    share the stack dims and N), ``shape`` the whole leaf's shape (a
    prepared weight's ``(*stack, K, N)``)."""
    local: object
    spec: tuple
    shape: tuple

    def __getitem__(self, i: int) -> "Sharded":
        """One entry of the leading (stacked-layer) dim, which is never
        split."""
        if self.spec[0] is not None:
            raise ValueError(f"a stacked dim split over {self.spec[0]} "
                             "cannot be indexed per layer")
        return Sharded(self.local[i], self.spec[1:], self.shape[1:])

    @property
    def dtype(self):
        return self.local.dtype if isinstance(self.local, torch.Tensor) \
            else None

    def to(self, dtype) -> "Sharded":
        return Sharded(self.local.to(dtype), self.spec, self.shape)


def is_prepared(w) -> bool:
    """Whether ``w`` is a prepared weight, whole or a rank's N-slice."""
    from .core.qweights import QuantizedLinearWeight
    if isinstance(w, Sharded):
        w = w.local
    return isinstance(w, QuantizedLinearWeight)


@dataclasses.dataclass(frozen=True, eq=False)
class ParallelCtx:
    """The mesh a serving run is placed on.  ``eq=False``: a context
    hashes by identity, so the operators cached per context
    (models/lm.py ``_linear_for``) are made once a mesh."""
    mesh: object                 # torch.distributed.device_mesh.DeviceMesh
    dp_axes: tuple = ("data",)
    tp_axis: str = "model"

    @functools.cached_property
    def sizes(self) -> dict:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    @functools.cached_property
    def coords(self) -> dict:
        return dict(zip(self.mesh.mesh_dim_names,
                        self.mesh.get_coordinate()))

    @property
    def rank_coords(self) -> dict:
        """{axis: (this rank's coordinate, the axis size)}."""
        return {a: (self.coords[a], self.sizes[a]) for a in self.sizes}

    @property
    def dp_size(self) -> int:
        return math.prod(self.sizes[a] for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.sizes[self.tp_axis]

    @functools.cached_property
    def backend(self) -> str:
        return str(dist.get_backend())

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives: NCCL
        only (a gloo collective syncs with the host)."""
        return self.backend == "nccl"

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def index(self, axes) -> tuple[int, int]:
        """(this rank's index, the count of pieces) of a dim split over
        ``axes``, the first axis major (a PartitionSpec's order)."""
        i, n = 0, 1
        for a in axes:
            i, n = i * self.sizes[a] + self.coords[a], n * self.sizes[a]
        return i, n

    def _gather1(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        n = self.sizes[axis]
        x = t.contiguous()
        group = self.group(axis)
        if self.backend == "nccl":
            out = x.new_empty((n, *x.shape))
            dist.all_gather_into_tensor(out, x, group=group)
        else:
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            out = torch.stack(parts)
        # (n, *piece) -> the pieces side by side along dim: a view for the
        # leading dim, one copy for another
        shape = list(x.shape)
        shape[dim] *= n
        return out.movedim(0, dim).reshape(shape)

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The whole of ``t`` along ``dim``, split over ``axes`` (a name or
        a tuple, the first major): pieces concatenated in mesh order."""
        if isinstance(axes, str):
            axes = (axes,)
        dim %= t.ndim
        for a in reversed(tuple(axes)):          # the minor axis first
            t = self._gather1(t, a, dim)
        return t

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """The reference's tiled ``all_to_all``: ``t`` is cut into
        ``size`` pieces along ``split_dim``, piece j goes to rank j of the
        ``axis`` group, and the pieces received are concatenated along
        ``concat_dim`` in rank order."""
        n = self.sizes[axis]
        shp = list(t.shape)
        x = t.movedim(split_dim, 0)
        x = x.reshape(n, x.shape[0] // n, *x.shape[1:]).contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group(axis))
        # out[j] is rank j's piece with its split_dim in front: put it
        # back in t's layout
        out = out.movedim(1, split_dim + 1)          # (n, *piece)
        shp[split_dim] //= n
        out = out.movedim(0, concat_dim)             # n next to concat_dim
        shp[concat_dim] *= n
        return out.reshape(shp).contiguous()

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over every rank of the mesh."""
        out = t.clone()
        for a in self.sizes:
            dist.all_reduce(out, group=self.group(a))
        return out / math.prod(self.sizes.values())

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axis`` (a new tensor)."""
        out = t.clone()
        dist.all_reduce(out, group=self.group(axis))
        return out

    def pmax(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks of ``axis``."""
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group(axis))
        return out

    def agree(self, flags) -> list[bool]:
        """Each of ``flags`` (bools) true on every rank where it is true
        on any: a max over every axis, so every rank takes the same
        decision (one small collective; reading it waits for the
        device)."""
        dev = "cuda" if self.backend == "nccl" else "cpu"
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                         device=dev)
        for a in self.sizes:
            t = self.pmax(t, a)
        return [bool(x) for x in t.tolist()]

    def ppermute(self, t: torch.Tensor, axis: str, shift: int = 1
                 ) -> torch.Tensor:
        """``t`` sent to the rank ``shift`` further along ``axis`` (a
        ring: the last wraps to the first); returns what the rank
        ``shift`` before sent here.  One ``all_to_all_single`` whose only
        non-empty piece goes to that rank, so a size-1 axis sends to
        itself (gloo has no send to one's own rank)."""
        n, c = self.sizes[axis], self.coords[axis]
        x = t.contiguous().reshape(1, -1)
        ins, outs = [0] * n, [0] * n
        ins[(c + shift) % n] = 1
        outs[(c - shift) % n] = 1
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, output_split_sizes=outs,
                               input_split_sizes=ins,
                               group=self.group(axis))
        return out.reshape(t.shape)

    def broadcast(self, t: torch.Tensor, axis: str, src: int
                  ) -> torch.Tensor:
        """The tensor of coordinate ``src`` along ``axis``, on every rank
        of the axis (``t`` is written in place on the others)."""
        group = self.group(axis)
        dist.broadcast(t, group=group,
                       src=dist.get_global_rank(group, src))
        return t

    def barrier(self) -> None:
        """Every rank of the mesh has reached this point (a sum of one
        element over every axis)."""
        dev = "cuda" if self.backend == "nccl" else "cpu"
        t = torch.zeros((1,), device=dev)
        for a in self.sizes:
            t = self.psum(t, a)
        t.tolist()

    def gather_spec(self, t: torch.Tensor, spec: tuple, only=None):
        """``t`` (a piece placed by ``spec``) made whole along every dim
        whose axes are all in ``only`` (default: every dim); returns
        (tensor, the spec left)."""
        left = []
        for d, axes in enumerate(spec):
            if axes and (only is None or set(axes) <= set(only)):
                t = self.all_gather(t, axes, d)
                axes = None
            left.append(axes)
        return t, tuple(left)

    def whole(self, leaf):
        """A ``Sharded`` float leaf gathered whole; anything else as it
        is (a prepared weight's N-slice stays for the sharded MVM)."""
        if isinstance(leaf, Sharded) and isinstance(leaf.local,
                                                    torch.Tensor):
            return self.gather_spec(leaf.local, leaf.spec)[0]
        return leaf

    def whole_qweight(self, w):
        """A prepared weight made whole on every rank (``Sharded`` N-slices
        gathered on N)."""
        from .core.qweights import QuantizedLinearWeight
        if not isinstance(w, Sharded):
            return w
        qw = w.local
        q, _ = self.gather_spec(qw.q, w.spec)
        sspec = (*w.spec[:-3], None, w.spec[-1])
        s, _ = self.gather_spec(qw.scale, sspec)
        return QuantizedLinearWeight(q, s, qw.k_orig, qw.group_k)

    def batch_slice(self, t: torch.Tensor, axes=None):
        """This rank's rows of ``t``'s leading dim over the DP axes, and
        the axes it was cut over (None, and ``t`` whole, when the dim does
        not divide)."""
        axes = tuple(self.dp_axes if axes is None else axes)
        i, n = self.index(axes)
        if not axes or t.shape[0] % n:
            return t, None
        b = t.shape[0] // n
        return t[i * b:(i + 1) * b], axes

    def warm_up(self, device) -> None:
        """One eager collective on every group of the mesh: NCCL sets up a
        communicator at its first collective, which a CUDA graph capture
        cannot hold."""
        for a in self.sizes:
            self.all_gather(torch.zeros((1,), device=device), a, 0)
