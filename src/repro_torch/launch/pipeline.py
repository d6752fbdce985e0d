"""Pipeline parallelism over the ``pod`` axis, the GPipe schedule (port of
``repro/launch/pipeline.py``).

The default multi-pod deployment is pod-DP; this module is the
alternative where the cross-pod gradient all-reduce would dominate: each
rank of the ``pod`` axis owns a contiguous stage of layers, microbatches
stream through hand-offs to the next stage, and the bubble fraction is
(P - 1) / (P - 1 + M).  ``pp_dryrun`` runs a 2-stage pipeline of GELU
MLP layers on the joined group's ``pod`` axis: torch has no compile-only
lowering, so where the reference compiles it and reports the compiled
temporaries and collective permutes, this runs it and reports the peak
device memory and the hand-offs sent.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel import Sharded

__all__ = ["pipeline_forward", "pp_dryrun"]


def _stage(leaf, rank: int, axis: str):
    """This rank's stage of a leaf stacked over the stages on dim 0."""
    if isinstance(leaf, Sharded):
        if leaf.spec[0] != (axis,):
            raise ValueError(f"a placed stage leaf must split dim 0 over "
                             f"{axis!r}, not {leaf.spec[0]}")
        return leaf.local[0]
    return leaf[rank]


def pipeline_forward(stage_params, x_mb, *, stage_fn, par,
                     axis: str = "pod", counter: dict | None = None):
    """GPipe forward over ``axis`` of the mesh ``par``.

    ``stage_params``: a tree (nested dicts, tuples or lists) of leaves
    stacked over the stages on dim 0, whole (each rank takes its stage's
    slice) or placed over ``axis`` (``Sharded`` pieces of one stage).
    ``x_mb``: (M, mb, S, D) microbatches, the same on every rank.
    ``stage_fn(params_of_one_stage, x) -> x``.

    The schedule runs M + P - 1 clocks on every rank: stage 0 takes
    microbatch t at clock t, every other stage the activation the stage
    before it handed on at the previous clock, every stage hands its
    output to the next (``ParallelCtx.ppermute``, a ring whose wrap to
    stage 0 is ignored), and the last stage keeps microbatch t - (P - 1).
    Returns the last stage's outputs (M, mb, S, D), broadcast from it to
    every rank of ``axis`` (the reference's result is valid on the last
    pod only).  ``counter``: a dict whose 'sends' is incremented by each
    hand-off this rank sends."""
    n_stage, rank = par.sizes[axis], par.coords[axis]

    def stage_of(t):
        if isinstance(t, dict):
            return {k: stage_of(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(stage_of(v) for v in t)
        return _stage(t, rank, axis)

    params = stage_of(stage_params)
    M = x_mb.shape[0]
    out = torch.zeros_like(x_mb)
    buf = torch.zeros_like(x_mb[0])
    for t in range(M + n_stage - 1):
        x_in = x_mb[min(max(t - rank, 0), M - 1)] if rank == 0 else buf
        y = stage_fn(params, x_in)
        buf = par.ppermute(y, axis)
        if counter is not None:
            counter["sends"] = counter.get("sends", 0) + 1
        done = t - (n_stage - 1)
        if rank == n_stage - 1 and done >= 0:
            out[done] = y
    return par.broadcast(out, axis, n_stage - 1)


def gelu_mlp_stage(params, x):
    """The dry run's stage: ``h = gelu(h @ w1) @ w2`` for each layer of
    (w1 (L, D, F), w2 (L, F, D)), GELU in its tanh form (``jax.nn.gelu``'s
    default)."""
    w1, w2 = params
    for a, b in zip(w1, w2):
        x = F.gelu(x @ a, approximate="tanh") @ b
    return x


def pp_dryrun(d_model: int = 1024, d_ff: int = 4096,
              layers_per_stage: int = 4, microbatches: int = 8,
              mb_size: int = 2, seq: int = 512, *, par, device=None,
              seed: int = 0, dtype=torch.bfloat16):
    """Run the 2-stage pipeline of ``gelu_mlp_stage`` on the ``pod`` axis
    of ``par`` (a mesh with pod = 2), on weights and microbatches drawn
    from ``seed`` on ``device`` (CUDA unless the caller asks for another;
    each rank draws every stage and keeps its own).  Returns the
    reference's record keys (``ok``, ``stages``, ``microbatches``,
    ``bubble_fraction``) with
    ``peak_memory_bytes`` (the device's peak during the run, None on the
    CPU) and ``sends`` (hand-offs this rank sent) in place of the
    compiled ``temp_bytes`` and ``collective_permutes``, and under
    ``out`` the result and under ``inputs`` (w1, w2, x) for a check."""
    if par.sizes.get("pod") != 2:
        raise ValueError(f"pp_dryrun runs 2 stages on a pod=2 mesh, not "
                         f"{par.sizes}")
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    L, D, Fd = layers_per_stage, d_model, d_ff
    w1 = (torch.randn((2, L, D, Fd), generator=g, device=dev)
          * D ** -0.5).to(dtype)
    w2 = (torch.randn((2, L, Fd, D), generator=g, device=dev)
          * Fd ** -0.5).to(dtype)
    x = torch.randn((microbatches, mb_size, seq, D), generator=g,
                    device=dev).to(dtype)
    counter = {"sends": 0}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        out = pipeline_forward((w1, w2), x, stage_fn=gelu_mlp_stage,
                               par=par, counter=counter)
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    return {"ok": bool(torch.isfinite(out).all()), "stages": 2,
            "microbatches": microbatches,
            "bubble_fraction": (2 - 1) / (2 - 1 + microbatches),
            "peak_memory_bytes": peak, "sends": counter["sends"],
            "out": out, "inputs": (w1, w2, x)}

