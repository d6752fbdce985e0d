"""Multi-pod dry run (port of ``repro/launch/dryrun.py``).

For every (architecture x input shape) cell and both production meshes
(launch/mesh.py ``PRODUCTION_MESHES``: data=16 x model=16, and pod=2 x
data=16 x model=16), run the port's own step on rank 0's share of the
work, on ``meta`` tensors: ``make_train_step(par=)`` with AdamW,
``make_prefill_step`` or ``make_decode_step``, under the production
placement (launch/sharding.py ``shard_params``).  Nothing is allocated
on any device and no GPU is needed.  The mesh is a stand-in
(``StandInCtx``): one process, rank 0's coordinates, and collectives
that return tensors of the right shapes and note their payloads
(``parallel.ParallelCtx``'s primitives), so the step runs its real code
path with no process group.  Each record holds:

* ``memory``: the rank's argument bytes (its ``Sharded`` pieces of the
  params and the AdamW state, the batch, the cache) and the peak of the
  bytes the step makes and holds at once (launch/cost.py), their sum
  the predicted peak;
* launch/cost.py's dot FLOPs, bytes, collective payloads by kind, bytes
  by op kind and by layer;
* ``model_flops`` (6*N_active*D train, 2*N_active*D inference, as the
  reference's) and the useful ratio;
* roofline terms against the published peaks of one NVIDIA H100 SXM
  (NVIDIA's H100 data sheet, 700 W: 989 TFLOP/s dense BF16, 3.35 TB/s
  HBM3; NVLink 4: 900 GB/s a GPU, 450 GB/s each direction).  They are
  the data sheet's, not measured.  Every collective is priced at the
  NVLink rate, though past 8 GPUs a host's links give way to the
  network: the collective term is a lower bound there.

A cell that fails is recorded with ``ok: false`` and its error, as the
reference records it.  The port keeps a serving cache whole on every
rank and gathers every placed leaf whole before use (ZeRO-3), so its
records show what that placement costs at the published shapes.

Usage (CPU; records under ``experiments/dryrun_torch/``):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod/--singlepod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCHS, get_arch
from ..models.registry import get_model
from ..optim.adamw import AdamW
from ..parallel import ParallelCtx, Sharded
from .cost import CostMode
from .mesh import PRODUCTION_MESHES
from .sharding import shard_params
from .steps import make_decode_step, make_prefill_step, make_train_step

__all__ = ["build_cell", "cells", "model_flops", "StandInCtx", "stand_in",
           "argument_bytes", "PEAK_FLOPS", "HBM_BW", "LINK_BW"]

# NVIDIA H100 SXM data sheet (700 W): dense BF16 tensor-core FLOP/s, HBM3
# bytes/s, and NVLink 4's 900 GB/s a GPU, 450 GB/s each direction
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
DEFAULT_OUT = "experiments/dryrun_torch"


class _StandInMesh:
    """A ``DeviceMesh``'s face for ``ParallelCtx`` (dim names, shape, this
    rank's coordinate) with no process group behind it: rank 0."""

    def __init__(self, shape, names):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)

    def get_coordinate(self):
        return [0] * len(self.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class StandInCtx(ParallelCtx):
    """``ParallelCtx`` on a stand-in mesh: each collective notes its
    payload, as the real ones do, and returns a tensor of the shape the
    real one returns (uninitialized: on ``meta`` tensors there are no
    values).  The step's code path and shapes are rank 0's."""

    @property
    def backend(self) -> str:
        return "stand-in"

    def _gather1(self, t, axis, dim):
        x = t.contiguous()
        self._note("all-gather", x, axis)
        shape = list(x.shape)
        shape[dim] *= self.sizes[axis]
        return x.new_empty(shape)

    def _exchange(self, x, axis):
        return torch.empty_like(x)

    def _all_reduce_(self, t, axis, op=None):
        self._note("all-reduce", t, axis)
        return t

    def ppermute(self, t, axis, shift=1):
        self._note("collective-permute", t.contiguous().reshape(1, -1), axis)
        return torch.empty_like(t)

    def broadcast(self, t, axis, src):
        self._note("broadcast", t, axis)
        return t


def stand_in(shape, axes, sp: bool = False) -> StandInCtx:
    """A stand-in context of a (shape, axes) mesh: 'pod' and 'data' DP,
    'model' TP (launch/mesh.py ``make_parallel_ctx``'s rule)."""
    dp = tuple(a for a in axes if a in ("pod", "data"))
    return StandInCtx(mesh=_StandInMesh(shape, axes), dp_axes=dp,
                      tp_axis="model", sp=sp)


def model_flops(cfg, shape, kind: str) -> float:
    """Reference useful FLOPs: 6*N_active*D train, 2*N_active*D
    inference."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * shape.batch * shape.seq
    if kind == "prefill":
        return 2.0 * n * shape.batch * shape.seq
    return 2.0 * n * shape.batch  # decode: one token per sequence


def _leaf_tensors(tree):
    if isinstance(tree, Sharded):
        tree = tree.local
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaf_tensors(v)


def argument_bytes(*trees) -> int:
    """Bytes of the tensors a rank holds in ``trees`` (a ``Sharded``
    leaf's piece, not its whole)."""
    return sum(t.numel() * t.element_size()
               for tree in trees for t in _leaf_tensors(tree))


def _decode_cache(cfg, model, B: int, T: int, par):
    """The decode step's cache on ``meta``: a recurrent family's state
    (``cache_specs``, this rank's pieces), else the dense float KV cache
    the one-call decode takes, whole on every rank as the port serves
    it."""
    if cfg.family not in ("dense", "moe"):
        return model.cache_specs(cfg, B, T, device="meta", par=par)
    from ..models.lm import DTYPES
    shape = (cfg.n_layers, B, T, cfg.n_kv, cfg.head_dim)
    dt = DTYPES[cfg.cache_dtype]
    return {"k": torch.empty(shape, dtype=dt, device="meta"),
            "v": torch.empty(shape, dtype=dt, device="meta"),
            "pos": torch.full((B,), T - 1, dtype=torch.int32,
                              device="meta")}


def run_cell(cfg, shape_name: str, par, top: int = 10):
    """Rank 0's step of ``cfg`` at ``shape_name`` under ``par`` on meta
    tensors -> (kind, argument bytes, ``CostMode``; ``top``: the largest
    buffers it keeps)."""
    model = get_model(cfg)
    kind, batch = cfg.input_specs(shape_name)
    shape = cfg.shape(shape_name)
    params = shard_params(model.init_params(cfg, 0, device="meta"), par)
    if kind == "train":
        opt = AdamW(lr=3e-4)
        opt_state = opt.init(params)
        args = (params, opt_state, batch)
        step = make_train_step(cfg, opt, "meta", par)
    elif kind == "prefill":
        args = (params, batch)
        step = make_prefill_step(cfg, par=par)
    elif kind == "decode":
        cache = _decode_cache(cfg, model, shape.batch, shape.seq, par)
        args = (params, batch, cache)
        step = make_decode_step(cfg, par=par)
    else:
        raise ValueError(kind)
    arg_bytes = argument_bytes(*args)
    with CostMode(top=top) as cm:
        out = step(*args)
    del out
    cm.finish()
    for t in _leaf_tensors(args):
        if t.device.type != "meta":
            raise AssertionError(f"a {t.device} tensor in a dry run")
    return kind, arg_bytes, cm


def build_cell(cfg, shape_name: str, multi_pod: bool,
               sp: bool | None = None, top: int = 10) -> dict:
    """Run one cell on meta tensors; returns its record (``top``: the
    largest buffers it lists)."""
    if sp is None:
        sp = os.environ.get("REPRO_SP", "0") == "1"
    mesh_shape, axes = PRODUCTION_MESHES[multi_pod]
    par = stand_in(mesh_shape, axes, sp)
    shape = cfg.shape(shape_name)
    t0 = time.time()
    kind, arg_bytes, cm = run_cell(cfg, shape_name, par, top)
    run_s = time.time() - t0
    cost = cm.cost
    chips = math.prod(mesh_shape)
    t_comp = cost.flops / PEAK_FLOPS
    t_mem = cost.bytes / HBM_BW
    t_coll = cost.coll_bytes / LINK_BW
    mf = model_flops(cfg, shape, kind)
    return {
        "arch": cfg.name, "shape": shape_name, "kind": kind,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16", "chips": chips,
        "sp": sp, "ok": True, "run_s": run_s,
        "memory": {"argument_bytes": arg_bytes,
                   "peak_live_bytes": cost.peak_bytes,
                   "total_per_device": arg_bytes + cost.peak_bytes},
        "flops_per_device": cost.flops,
        "bytes_per_device": cost.bytes,
        "collective_bytes_per_device": dict(cost.coll_by_kind,
                                            total=cost.coll_bytes),
        "collective_ops": cost.coll_ops,
        "dot_ops": cost.dots,
        "bytes_by_kind_top": dict(sorted(cost.bytes_by_kind.items(),
                                         key=lambda kv: -kv[1])[:8]),
        "flops_by_layer": cost.flops_by_layer,
        "bytes_by_layer": cost.bytes_by_layer,
        "top_buffers": cost.top_buffers,
        "roofline": {
            "t_compute_s": t_comp, "t_memory_s": t_mem,
            "t_collective_s": t_coll,
            "dominant": max([("compute", t_comp), ("memory", t_mem),
                             ("collective", t_coll)],
                            key=lambda kv: kv[1])[0],
            "peaks": "NVIDIA H100 SXM data sheet (700 W): 989e12 FLOP/s "
                     "BF16 dense, 3.35e12 B/s HBM3, 450e9 B/s NVLink a "
                     "direction; not measured"},
        "model_flops_global": mf,
        "model_flops_per_device": mf / chips,
        "useful_flops_ratio": (mf / chips) / cost.flops if cost.flops
        else 0.0,
    }


def cells(arch_filter=None, shape_filter=None):
    for name, cfg in ARCHS.items():
        if arch_filter and name != arch_filter:
            continue
        for s in cfg.shapes:
            if shape_filter and s.name != shape_filter:
                continue
            yield cfg, s


def _failure(cfg, shape_name, mp, e) -> dict:
    return {"arch": cfg.name, "shape": shape_name,
            "mesh": "pod2x16x16" if mp else "pod16x16", "ok": False,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true", default=None,
                    help="only the 2x16x16 mesh")
    ap.add_argument("--singlepod", action="store_true", default=None,
                    help="only the 16x16 mesh")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if not (args.all or args.arch):
        ap.error("pass --arch (and --shape), or --all")
    if args.arch:
        get_arch(args.arch)
    os.makedirs(args.out, exist_ok=True)
    meshes = [False, True]
    if args.multipod and not args.singlepod:
        meshes = [True]
    if args.singlepod and not args.multipod:
        meshes = [False]

    n_ok = n_skip = n_fail = 0
    t_all = time.time()
    for cfg, shape in cells(args.arch, args.shape):
        for mp in meshes:
            tag = f"{cfg.name}_{shape.name}_{'mp' if mp else 'sp'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                n_skip += 1
                continue
            if not cfg.runnable(shape.name):
                rec = {"arch": cfg.name, "shape": shape.name,
                       "mesh": "pod2x16x16" if mp else "pod16x16",
                       "ok": False, "skipped": True,
                       "reason": "full-attention arch; long-context decode "
                                 "requires a sub-quadratic family"}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                n_skip += 1
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            t0 = time.time()
            try:
                rec = build_cell(cfg, shape.name, mp)
                n_ok += 1
            except Exception as e:  # noqa: BLE001 - record the failure
                rec = _failure(cfg, shape.name, mp, e)
                n_fail += 1
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            status = "ok" if rec.get("ok") else "FAIL " + rec["error"][:200]
            print(f"[dryrun] {tag}: {status} ({time.time() - t0:.1f}s)",
                  flush=True)
            if rec.get("ok"):
                r = rec["roofline"]
                print(f"    mem/dev="
                      f"{rec['memory']['total_per_device'] / 2**30:.2f}GiB "
                      f"comp={r['t_compute_s']:.2e}s "
                      f"mem={r['t_memory_s']:.2e}s "
                      f"coll={r['t_collective_s']:.2e}s "
                      f"dom={r['dominant']}", flush=True)
    print(f"[dryrun] done: ok={n_ok} skip={n_skip} fail={n_fail} in "
          f"{time.time() - t_all:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
