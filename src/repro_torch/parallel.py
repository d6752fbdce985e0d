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
  columns, a DP-sharded batch, the MoE's sequence slices and the
  recurrent scans' head and batch slices;
* ``split``: this rank's slice of a tensor every rank holds whole (the
  inverse of ``all_gather``);
* ``all_to_all``: the MoE's expert exchange over the ``model`` axis (the
  reference's ``all_to_all(..., tiled=True)``);
* ``all_reduce_mean``: the MoE aux averaged over the mesh;
* ``sum_grad``: a whole tensor read by this rank's slice of the work
  (the MoE router's weight), whose gradient is summed over an axis;
* ``psum`` / ``pmax``: a sum or a max over one named axis (the
  reference's ``psum`` / ``pmax``: the train step's gradient mean over
  the DP axes, ``optim/compression.py compressed_psum_tree``), and
  ``agree``, a flag raised on any rank raised on every rank (the train
  loop's failover decision);
* ``ppermute``: each rank's tensor handed to the next rank along an axis
  (the reference's ring ``ppermute``: ``launch/pipeline.py``'s stage
  hand-off), and ``broadcast`` from one coordinate of an axis.

Each is issued whatever the axis size (a size-1 group copies), so a mesh
of one rank runs the collectives it would run on many.

Autograd sees ``all_gather``, ``split``, ``all_to_all``,
``all_reduce_mean`` and ``sum_grad`` (the train step's expert
parallelism and head-sliced scans).  The rule of their backwards is the
train step's (launch/steps.py ``_mesh_train_step``): a tensor every rank
of the ``model`` axis holds whole holds there the whole gradient of this
rank's DP-slice loss, and the gradients are averaged over the DP axes
after the backward.  So an ``all_gather``'s consumers are replicated
over its axes and its backward is this rank's slice of the incoming
gradient (a reduce-scatter would multiply it by the axis size);
``split``'s backward gathers the slices; an ``all_to_all``'s is the
inverse exchange; ``sum_grad``'s sums the gradient over its axis; and
the mean's backward is the DP-axes sum of the incoming gradient over
the mesh's rank count (its consumers are the DP slices' losses, which
the step then averages).  On NCCL they can
be captured in a CUDA graph (the communicators are set up by one eager
collective first, ``warm_up``); a gloo group cannot be captured
(``capturable``).

``Sharded`` is one rank's piece of a parameter leaf placed by the rules of
``launch/sharding.py``: the local tensor (or prepared weight) and the
spec of the whole leaf, a tuple with an entry per dim, ``None`` or the
tuple of mesh axes that dim is split over.

``ParallelCtx.sp``: the sequence-parallel residual stream (the
reference's sharding constraint): between blocks the models hold the
residual stream as this rank's sequence slice over ``model`` and gather
it where a layer needs the whole sequence, so a rematerialized layer
keeps a 1/tp slice for its backward.  It moves placement, never
numbers (bitwise ``sp`` off); as in the reference, only the dry run and
the profile set it (launch/dryrun.py, launch/profile.py).

Every collective is issued from one of five primitives (``_gather1``,
``_all_to_all``, ``_all_reduce_``, ``ppermute``, ``broadcast``), each of
which notes its payload with ``_note`` for a cost counter that is
running (launch/cost.py ``CostMode``): the bytes this rank puts on the
interconnect (an all-gather's piece, an all-reduce's tensor), over axes
of more than one rank.  The dry run's stand-in context
(launch/dryrun.py) overrides the primitives to return tensors of the
right shapes with no process group.

``None`` in place of a ``ParallelCtx`` everywhere means one device.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

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


class _AllGather(torch.autograd.Function):
    """``ParallelCtx.all_gather`` under autograd: the backward is this
    rank's slice of the incoming gradient (consumers replicated over the
    axes)."""

    @staticmethod
    def forward(ctx, t, par, axes, dim):
        ctx.par, ctx.axes, ctx.dim = par, axes, dim
        for a in reversed(axes):                 # the minor axis first
            t = par._gather1(t, a, dim)
        return t

    @staticmethod
    def backward(ctx, g):
        return ctx.par._slice(g, ctx.axes, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    """``ParallelCtx.split``: the forward slices, the backward gathers."""

    @staticmethod
    def forward(ctx, t, par, axes, dim):
        ctx.par, ctx.axes, ctx.dim = par, axes, dim
        return par._slice(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.par, ctx.axes, ctx.dim), None, \
            None, None


class _AllToAll(torch.autograd.Function):
    """``ParallelCtx.all_to_all``: the backward is the inverse exchange
    (split and concat dims swapped)."""

    @staticmethod
    def forward(ctx, t, par, axis, split_dim, concat_dim):
        ctx.par, ctx.axis = par, axis
        ctx.dims = (split_dim, concat_dim)
        return par._all_to_all(t, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_AllToAll.apply(g, ctx.par, ctx.axis, concat_dim,
                                split_dim), None, None, None, None)


class _MeanAll(torch.autograd.Function):
    """``ParallelCtx.all_reduce_mean``: the backward is the DP-axes sum
    of the incoming gradient over the rank count (module docstring)."""

    @staticmethod
    def forward(ctx, t, par):
        ctx.par = par
        out = t.clone()
        for a in par.sizes:
            par._all_reduce_(out, a)
        return out / math.prod(par.sizes.values())

    @staticmethod
    def backward(ctx, g):
        par = ctx.par
        g = g.clone()
        for a in par.dp_axes:
            par._all_reduce_(g, a)
        return g / math.prod(par.sizes.values()), None


class _SumGrad(torch.autograd.Function):
    """``ParallelCtx.sum_grad``: the identity, whose backward sums the
    gradient over one axis."""

    @staticmethod
    def forward(ctx, t, par, axis):
        ctx.par, ctx.axis = par, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.par.psum(g, ctx.axis), None, None


@dataclasses.dataclass(frozen=True, eq=False)
class ParallelCtx:
    """The mesh a serving run is placed on.  ``eq=False``: a context
    hashes by identity, so the operators cached per context
    (models/lm.py ``_linear_for``) are made once a mesh.
    ``local_batch``: the inputs a model is given are this rank's DP
    slice already (the train step's view, ``train_view``), so no layer
    cuts the batch again."""
    mesh: object                 # torch.distributed.device_mesh.DeviceMesh
    dp_axes: tuple = ("data",)
    tp_axis: str = "model"
    local_batch: bool = False
    sp: bool = False             # sequence-parallel residual stream

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

    def _note(self, kind: str, t: torch.Tensor, axis: str) -> None:
        """Tell a running cost counter (launch/cost.py) that this rank puts
        ``t``'s bytes on the interconnect in a ``kind`` collective over
        ``axis`` (nothing over an axis of one rank)."""
        if self.sizes[axis] == 1:
            return
        for mode in _get_current_dispatch_mode_stack():
            note = getattr(mode, "note_collective", None)
            if note is not None:
                note(kind, t.numel() * t.element_size())

    def sp_on(self, seq: int) -> bool:
        """Whether the models hold a residual stream of ``seq`` positions
        as sequence slices (``sp`` and the positions divide over
        ``model``)."""
        return self.sp and seq % self.tp_size == 0

    def index(self, axes) -> tuple[int, int]:
        """(this rank's index, the count of pieces) of a dim split over
        ``axes``, the first axis major (a PartitionSpec's order); (0, 1)
        for None."""
        i, n = 0, 1
        for a in axes or ():
            i, n = i * self.sizes[a] + self.coords[a], n * self.sizes[a]
        return i, n

    def _gather1(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        n = self.sizes[axis]
        x = t.contiguous()
        self._note("all-gather", x, axis)
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
        a tuple, the first major; None or () returns ``t``): pieces
        concatenated in mesh order.  Under autograd its backward is this
        rank's slice of the gradient."""
        if not axes:
            return t
        if isinstance(axes, str):
            axes = (axes,)
        return _AllGather.apply(t, self, tuple(axes), dim % t.ndim)

    def _slice(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        i, n = self.index(axes)
        b = t.shape[dim] // n
        return t.narrow(dim, i * b, b)

    def split(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's slice of ``t`` (whole on every rank) along ``dim``
        split over ``axes`` (None or () returns ``t``); under autograd its
        backward gathers the slices' gradients."""
        if not axes:
            return t
        if isinstance(axes, str):
            axes = (axes,)
        if t.shape[dim] % self.index(axes)[1]:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {axes}")
        return _Split.apply(t, self, tuple(axes), dim % t.ndim)

    def sum_grad(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` itself, whose gradient is summed over ``axis`` in the
        backward: a whole tensor each rank of the axis reads with its own
        slice of the work."""
        return _SumGrad.apply(t, self, axis)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """The reference's tiled ``all_to_all``: ``t`` is cut into
        ``size`` pieces along ``split_dim``, piece j goes to rank j of the
        ``axis`` group, and the pieces received are concatenated along
        ``concat_dim`` in rank order.  Under autograd its backward is the
        inverse exchange."""
        return _AllToAll.apply(t, self, axis, split_dim, concat_dim)

    def _all_to_all(self, t, axis, split_dim, concat_dim):
        n = self.sizes[axis]
        shp = list(t.shape)
        x = t.movedim(split_dim, 0)
        x = x.reshape(n, x.shape[0] // n, *x.shape[1:]).contiguous()
        self._note("all-to-all", x, axis)
        out = self._exchange(x, axis)
        # out[j] is rank j's piece with its split_dim in front: put it
        # back in t's layout
        out = out.movedim(1, split_dim + 1)          # (n, *piece)
        shp[split_dim] //= n
        out = out.movedim(0, concat_dim)             # n next to concat_dim
        shp[concat_dim] *= n
        return out.reshape(shp).contiguous()

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over every rank of the mesh (its backward:
        the module docstring's rule)."""
        return _MeanAll.apply(t, self)

    def _exchange(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``all_to_all_single`` of x (n, ...) over ``axis``: piece j to
        rank j, piece i from rank i."""
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group(axis))
        return out

    def _all_reduce_(self, t: torch.Tensor, axis: str, op=None
                     ) -> torch.Tensor:
        """``t`` reduced over the ranks of ``axis`` in place (a sum, or
        ``op``); returns ``t``."""
        self._note("all-reduce", t, axis)
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                        group=self.group(axis))
        return t

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axis`` (a new tensor)."""
        return self._all_reduce_(t.clone(), axis)

    def pmax(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks of ``axis``."""
        return self._all_reduce_(t.clone(), axis, dist.ReduceOp.MAX)

    def _flags(self, flags) -> torch.Tensor:
        dev = "cuda" if self.backend == "nccl" else "cpu"
        return torch.as_tensor(np.asarray(flags, np.int32), device=dev)

    def agree(self, flags) -> np.ndarray:
        """``flags`` (bools, any shape) true on every rank where they are
        true on any: a max over every axis, so every rank takes the same
        decision (one small collective; reading it waits for the
        device).  A bool array of the flags' shape."""
        t = self._flags(flags)
        for a in self.sizes:
            t = self.pmax(t, a)
        return t.cpu().numpy().astype(bool)

    def from_first(self, flags) -> np.ndarray:
        """The flags (bools, any shape) of the mesh's first rank, on every
        rank: a host decision read from one clock (the scheduler's
        wall-clock deadlines)."""
        t = self._flags(flags)
        for a in self.sizes:
            t = self.broadcast(t, a, 0)
        return t.cpu().numpy().astype(bool)

    def ppermute(self, t: torch.Tensor, axis: str, shift: int = 1
                 ) -> torch.Tensor:
        """``t`` sent to the rank ``shift`` further along ``axis`` (a
        ring: the last wraps to the first); returns what the rank
        ``shift`` before sent here.  One ``all_to_all_single`` whose only
        non-empty piece goes to that rank, so a size-1 axis sends to
        itself (gloo has no send to one's own rank)."""
        n, c = self.sizes[axis], self.coords[axis]
        x = t.contiguous().reshape(1, -1)
        self._note("collective-permute", x, axis)
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
        self._note("broadcast", t, axis)
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

    def batch_axes(self, B: int):
        """The DP axes a batch of ``B`` rows is cut over inside a model:
        None when it does not divide, or under ``local_batch``."""
        if self.local_batch or not self.dp_axes or B % self.dp_size:
            return None
        return tuple(self.dp_axes)

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

    @functools.cached_property
    def train_view(self) -> "ParallelCtx":
        """This mesh as the train step's model sees it: the batch is this
        rank's DP slice already (``local_batch``)."""
        return self if self.local_batch else dataclasses.replace(
            self, local_batch=True)

    def warm_up(self, device) -> None:
        """One eager collective on every group of the mesh: NCCL sets up a
        communicator at its first collective, which a CUDA graph capture
        cannot hold."""
        for a in self.sizes:
            self.all_gather(torch.zeros((1,), device=device), a, 0)
