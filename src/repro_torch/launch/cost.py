"""Cost counter for one device's share of a step (the counterpart of
``repro/launch/hlo_cost.py``).

PyTorch has no HLO to parse: ``CostMode`` watches the step run instead,
as a ``TorchDispatchMode`` (every aten op that reaches a kernel, forward
and backward) with a ``TorchFunctionMode`` beside it (which layer of the
model made the op).  It runs as well on ``meta`` tensors, where nothing
is computed or allocated (launch/dryrun.py), as on a real device.  It
counts, in ``Cost`` (the reference's ``HloCost`` field names where they
mean the same):

* ``flops``: dot FLOPs, 2*M*N*K for each ``mm`` / ``addmm`` (and 2*B*M*N*K
  for each ``bmm`` / ``baddbmm``, which the attention products and the
  einsums become), forward and backward; ``dots`` counts them.  Other
  ops are left to the bytes term, as in the reference;
* ``bytes``: each op's inputs and outputs, once each (views move
  nothing and are skipped), and ``bytes_by_kind`` by aten op;
* ``coll_bytes`` / ``coll_by_kind`` / ``coll_ops``: the payload this rank
  puts on the interconnect in each collective, by kind ('all-gather',
  'all-reduce', 'all-to-all', 'collective-permute', 'broadcast'), as
  ``parallel.ParallelCtx`` issues them (``ParallelCtx._note``);
* ``flops_by_layer`` / ``bytes_by_layer``: the innermost frame of the
  port's ``layers/``, ``models/``, ``optim/`` or ``parallel.py`` that
  made the op ('attention._flash', 'mlp.mlp', 'adamw.update',
  'parallel._gather1', ...; 'step' outside them); a backward op goes to
  the layer that made its forward (the autograd node's metadata), a
  rematerialized one to the layer recomputed;
* ``peak_bytes``: the most bytes alive at once among the tensors made
  during the step (each storage counted once from its first op output
  until it is freed), and ``top_buffers``, the largest single outputs.

On ``meta`` tensors most of a step's time goes to the shape functions
(many of them Python), and a model's scans repeat the same ops on the
same shapes thousands of times: ``CostMode`` remembers the output
shapes, strides and dtypes of each functional op (no in-place write, no
view, no alias) on meta tensors by its inputs' and arguments' metadata,
and makes its outputs from that without calling it again.  Meta outputs
are a function of that metadata alone, so nothing counted changes (ops
on any other device always run).

PyTorch runs eagerly, so every loop is unrolled as it runs:
``hlo_cost.py``'s while-loop trip-count correction has nothing to
correct here.  The numbers are one rank's, as the reference's are one
device's.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import sys
import weakref
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Cost", "CostMode"]

_aten = torch.ops.aten
_PKG = str(Path(__file__).resolve().parents[1])
_LAYER_FILES = tuple(str(Path(_PKG, d)) + "/" for d in
                     ("layers", "models", "optim")) \
    + (str(Path(_PKG, "parallel.py")),)
_DOTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_ops: int = 0
    dots: int = 0
    flops_by_layer: dict = dataclasses.field(default_factory=dict)
    bytes_by_layer: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    top_buffers: list = dataclasses.field(default_factory=list)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for a in tree:
            yield from _tensors(a)
    elif isinstance(tree, dict):
        for a in tree.values():
            yield from _tensors(a)


def _dot_flops(func, args, out) -> float:
    """2 * (output elements) * (contraction length) of a dot op."""
    if func in (_aten.mm.default, _aten.bmm.default):
        a = args[0]
    else:                                   # addmm / baddbmm: (bias, a, b)
        a = args[1]
    return 2.0 * out.numel() * a.shape[-1]


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)
_TensorKey = collections.namedtuple("_TensorKey", "shape stride dtype")


def _functional(func) -> bool:
    """Whether an op writes no input and returns no alias of one."""
    schema = func._schema
    return not schema.is_mutable and all(r.alias_info is None
                                         for r in schema.returns)


def _arg_key(a, key: list) -> bool:
    """Append ``a``'s metadata to ``key``; False where it has none the
    memo can key (a tensor off meta, an unknown object)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            return False
        key.append(_TensorKey(tuple(a.shape), a.stride(), a.dtype))
    elif isinstance(a, (list, tuple)):
        key.append(len(a))
        return all(_arg_key(b, key) for b in a)
    elif isinstance(a, _PLAIN):
        key.append(a)
    else:
        return False
    return True


def _meta_key(func, args, kwargs):
    """The memo key of a call on meta tensors, or None (a tensor off meta,
    or no tensor at all: a factory op's device is its own)."""
    key = [func]
    if not all(_arg_key(a, key) for a in args):
        return None
    for k in sorted(kwargs):
        key.append(k)
        if not _arg_key(kwargs[k], key):
            return None
    if not any(isinstance(k, _TensorKey) for k in key):
        return None
    return tuple(key)


class _Layers(TorchFunctionMode):
    """Which layer of the model makes each op: the innermost frame of the
    port's layers/, models/ or optim/ at each torch call (cached by code
    object), and the forward's layer on each autograd node it makes."""

    def __init__(self):
        super().__init__()
        self.layer = None
        self._keys: dict = {}

    def _key(self):
        f = sys._getframe(2)
        while f is not None:
            code = f.f_code
            key = self._keys.get(code)
            if key is None:
                fn = code.co_filename
                key = ""
                if fn.startswith(_LAYER_FILES):
                    key = f"{Path(fn).stem}.{code.co_qualname}"
                self._keys[code] = key
            if key:
                return key
            f = f.f_back
        return None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        outer, self.layer = self.layer, self._key()
        try:
            out = func(*args, **(kwargs or {}))
        finally:
            layer, self.layer = self.layer, outer
        if torch.is_grad_enabled():
            # every node this call made (a matmul's view + mm + view
            # too) gets its layer; the walk stops at nodes made before
            todo = [t.grad_fn for t in _tensors(out)]
            while todo:
                node = todo.pop()
                if node is None or "layer" in node.metadata:
                    continue
                node.metadata["layer"] = layer or "step"
                todo.extend(n for n, _ in node.next_functions)
        return out


class CostMode(TorchDispatchMode):
    """``with CostMode() as cm: step(...)``, then ``cm.cost``: the
    ``Cost`` of what ran inside (module docstring).  Collectives are
    noted by ``parallel.ParallelCtx`` through ``note_collective``."""

    def __init__(self, top: int = 10):
        super().__init__()
        self.cost = Cost()
        self.top = top                 # the largest buffers kept
        self.memo: dict = {}
        self._functional: dict = {}  # op -> writes nothing, aliases none
        self._layers = _Layers()
        self._live = 0
        self._refs: dict = {}        # storage -> [bytes, tensors alive]
        self._top: list = []

    def __enter__(self):
        self._layers.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._layers.__exit__(*exc)

    def note_collective(self, kind: str, nbytes: int) -> None:
        c = self.cost
        c.coll_bytes += nbytes
        c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0) + nbytes
        c.coll_ops += 1

    def _layer(self) -> str:
        if self._layers.layer is not None:
            return self._layers.layer
        node = torch._C._current_autograd_node()
        if node is not None:
            return node.metadata.get("layer", "backward")
        return "step"

    def _freed(self, key) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[1] -= 1
        if ref[1] == 0:
            self._live -= ref[0]
            del self._refs[key]

    def _track(self, t: torch.Tensor, func, layer: str) -> None:
        st = t.untyped_storage()
        key = st._cdata
        ref = self._refs.get(key)
        if ref is None:
            n = st.nbytes()
            ref = self._refs[key] = [n, 0]
            self._live += n
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)
            item = (n, str(func), tuple(t.shape), str(t.dtype), layer)
            if len(self._top) < self.top:
                heapq.heappush(self._top, item)
            elif n > self._top[0][0]:
                heapq.heapreplace(self._top, item)
        ref[1] += 1
        weakref.finalize(t, self._freed, key)

    def _call(self, func, args, kwargs):
        """``func``'s result, from the memo where it has one (meta
        tensors, functional ops: the module docstring)."""
        functional = self._functional.get(func)
        if functional is None:
            functional = self._functional[func] = _functional(func)
        if not functional:
            return func(*args, **kwargs)
        key = _meta_key(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        got = self.memo.get(key)
        if got is not None:
            made = [torch.empty_strided(shape, stride, dtype=dt,
                                        device="meta")
                    for shape, stride, dt in got[0]]
            return made[0] if got[1] is None else got[1](made)
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            leaves, kind = [out], None
        elif isinstance(out, (tuple, list)) and all(
                isinstance(t, torch.Tensor) for t in out):
            leaves, kind = list(out), type(out)
        else:
            return out
        self.memo[key] = ([(tuple(t.shape), t.stride(), t.dtype)
                           for t in leaves], kind)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._call(func, args, kwargs)
        layer = self._layer()
        c = self.cost
        outs = list(_tensors(out))
        if func in _DOTS:
            f = _dot_flops(func, args, outs[0])
            c.flops += f
            c.dots += 1
            c.flops_by_layer[layer] = c.flops_by_layer.get(layer, 0) + f
        if not func.is_view:
            n = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                + sum(_nbytes(t) for t in outs)
            c.bytes += n
            kind = func.overloadpacket.__name__
            c.bytes_by_kind[kind] = c.bytes_by_kind.get(kind, 0) + n
            c.bytes_by_layer[layer] = c.bytes_by_layer.get(layer, 0) + n
        for t in outs:
            self._track(t, func, layer)
        return out

    def finish(self) -> Cost:
        """The cost, its largest buffers sorted (call after the step)."""
        self.cost.top_buffers = [
            {"bytes": n, "op": op, "shape": list(shape), "dtype": dt,
             "layer": layer}
            for n, op, shape, dt, layer in sorted(self._top, reverse=True)]
        return self.cost
