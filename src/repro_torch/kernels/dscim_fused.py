"""Fused DS-CIM MVM: float activations + prepared int8 weights -> f32
output in one kernel launch (port of ``repro/kernels/dscim_fused.py``).

    out[m,n] = Σ_u s_x[m,u] * s_w[u,n] * psum_u[m,n]
    psum_u   = scale*C_u - 128*Σx_u - 128*Σ(w_u+128)  (+ center-trunc terms)

``dscim_fused_mvm_prepared`` quantizes the activations per (row, window)
in torch, as the reference does, and then

* on a CUDA tensor launches ``csrc/dscim_fused.cu`` (the hand-written
  Hopper kernel; see its header for the design and what bounds it);
* on a CPU tensor runs ``dscim_fused_mvm_plain``, the plain PyTorch
  version of the same estimator.

There is no fallback between the two: any other device raises.

The counts are exact integers on both routes.  The kernel reads them as
popcounts of (G, S) bit-mask tables built here from the blocked point
tables; the plain version as the reference's {0,1} bit-expansion matmul,
window by window and in N chunks (a one-shot expansion at the head's
shape, K=1024, N=152064, pmax=18, would need about 11 GB).  Float outputs
agree with the reference to f32 summation-order rounding.

``dscim_windowed_vmap_mvm`` is the staged per-window path the fused kernel
replaced, kept as its A/B baseline: one ``dscim_counts_blocked`` launch
per window, the psum staged in memory, corrections and dequant in
separate passes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.macro import DSCIMConfig
from ..core.qweights import QuantizedLinearWeight, prepare_linear_weight
from ..core.quant import QuantizedTensor, quantize_int8
from . import build
from .dscim_mvm import count_mask_tables
from .dscim_mvm_blocked import block_point_tables, dscim_counts_blocked

__all__ = ["dscim_fused_mvm", "dscim_fused_mvm_prepared",
           "dscim_fused_mvm_plain", "quantize_activations_windowed",
           "mask_tables", "dscim_windowed_vmap_mvm", "LAUNCHES"]

LAUNCHES = build.LaunchCounter("dscim_fused_mvm")
_N_CHUNK = 16384          # plain version: output columns per bit expansion


def quantize_activations_windowed(x: torch.Tensor, nw: int, g: int
                                  ) -> QuantizedTensor:
    """Float x (..., K) -> per-window int8 activations: pad K with float
    zeros to nw*g *before* quantizing, one scale per (row, window).
    Returns q (..., nw, g) int8 and scale (..., nw, 1) f32."""
    K = x.shape[-1]
    pad = nw * g - K
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return quantize_int8(x.reshape(*x.shape[:-1], nw, g), axis=-1)


def _estimator_constants(cfg: DSCIMConfig, g: int):
    """(scale, c1, wconst): count scale, center-truncation coefficient of
    Σa+Σb, and the once-per-window center-truncation constant g·δ²."""
    if cfg.trunc == "center":
        delta = (2 ** cfg.k - 1) / 2.0
        return cfg.scale, (2 ** cfg.k) * delta, g * delta * delta
    return cfg.scale, 0.0, 0.0


@functools.lru_cache(maxsize=32)
def mask_tables(cfg: DSCIMConfig):
    """(G, S) uint32 bit masks over each block's points:
    ta[g, a] = {p : lu[g,p] < a}, tb[g, b] = {p : lv[g,p] < b}; so the
    count of one row is popcount(ta[g, a] & tb[g, b]).  The one-word case
    of ``dscim_mvm.count_mask_tables``, returned as int32 arrays (same
    bits) for torch."""
    tu, tv, pmax = block_point_tables(cfg)
    if pmax > 32:
        raise ValueError(f"{cfg.name}: {pmax} points per block exceed the "
                         "kernel's 32-bit masks")
    ta, tb = count_mask_tables(tu, tv, cfg.sbits)
    return ta[..., 0], tb[..., 0]


@functools.lru_cache(maxsize=32)
def _device_mask_tables(cfg: DSCIMConfig, device: torch.device):
    """``mask_tables`` copied to ``device`` once (not per launch)."""
    return tuple(torch.as_tensor(t, device=device) for t in mask_tables(cfg))


def dscim_fused_mvm_plain(xq: torch.Tensor, sx: torch.Tensor,
                          wq: torch.Tensor, sw: torch.Tensor,
                          cfg: DSCIMConfig) -> torch.Tensor:
    """Plain PyTorch fused estimator: xq (M, nw, g) int8, sx (M, nw) f32,
    wq (nw, g, N) int8, sw (nw, N) f32 -> (M, N) f32.

    Counts are the {0,1} bit-expansion product of the reference kernel, in
    f32 (exact: every partial sum is an integer < 2^24).  On CUDA that
    needs full-precision f32 matmuls, so TF32 must be off."""
    if xq.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("dscim_fused_mvm_plain needs exact f32 matmuls; "
                           "set torch.backends.cuda.matmul.allow_tf32=False")
    M, nw, g = xq.shape
    N = wq.shape[-1]
    dev = xq.device
    k = cfg.k
    tu_np, tv_np, pmax = block_point_tables(cfg)
    blk = torch.arange(g, device=dev) % cfg.group
    lu = torch.as_tensor(tu_np, device=dev)[blk]          # (g, pmax)
    lv = torch.as_tensor(tv_np, device=dev)[blk]
    scale, c1, wconst = _estimator_constants(cfg, g)
    out = torch.zeros((M, N), dtype=torch.float32, device=dev)
    for u in range(nw):
        x = xq[:, u].to(torch.int32)                      # (M, g)
        a = (x + 128) >> k
        abit = (lu[None] < a[:, :, None]).to(torch.float32).reshape(M, -1)
        xsum = x.sum(-1, keepdim=True).to(torch.float32)
        asum = a.sum(-1, keepdim=True)
        for n0 in range(0, N, _N_CHUNK):
            w = wq[u, :, n0:n0 + _N_CHUNK].to(torch.int32)  # (g, nc)
            b = (w + 128) >> k
            wbit = (lv[:, :, None] < b[:, None, :]).to(torch.float32)
            counts = abit @ wbit.reshape(g * pmax, -1)
            psum = scale * counts
            psum = psum - 128.0 * xsum
            psum = psum - 128.0 * (w + 128).sum(0, keepdim=True).to(
                torch.float32)
            if c1:
                psum = psum + c1 * (asum + b.sum(0, keepdim=True)).to(
                    torch.float32)
            psum = psum + wconst
            out[:, n0:n0 + _N_CHUNK] += psum * sx[:, u, None] \
                * sw[u, None, n0:n0 + _N_CHUNK]
    return out


def _launch_kernel(xq, sx, wq, sw, cfg: DSCIMConfig) -> torch.Tensor:
    M, nw, g = xq.shape
    N = wq.shape[-1]
    for t, dt in ((xq, torch.int8), (sx, torch.float32), (wq, torch.int8),
                  (sw, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != xq.device:
            raise ValueError("dscim_fused kernel takes contiguous int8 xq/wq "
                             "and f32 sx/sw on one CUDA device")
    if cfg.group * cfg.sbits > 2048:
        raise ValueError(f"k={cfg.k}: count tables larger than the kernel's")
    ta, tb = _device_mask_tables(cfg, xq.device)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    scale, c1, wconst = _estimator_constants(cfg, g)
    lib = build.load("dscim_fused")
    fn = lib.dscim_fused_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
        + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = fn(xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
            ta.data_ptr(), tb.data_ptr(), out.data_ptr(), M, N, nw, g,
            cfg.k, cfg.group, cfg.sbits, scale, c1, wconst, stream)
    if rc != 0:
        raise RuntimeError(f"dscim_fused kernel launch failed: error {rc}")
    LAUNCHES.count += 1
    return out


def dscim_fused_mvm_prepared(x: torch.Tensor, qw: QuantizedLinearWeight,
                             cfg: DSCIMConfig) -> torch.Tensor:
    """Fused DS-CIM linear: x (..., K) float + prepared weight ->
    (..., N) f32.  Leading dims fold into the kernel's M rows (one launch
    per call).  Only the activations are quantized per call."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    if K != qw.k_orig:
        raise ValueError(f"x K={K} vs prepared weight K={qw.k_orig}")
    if qw.q.ndim != 3:
        raise ValueError("pass one layer's prepared weight, not a stack")
    nw, g, N = qw.nw, qw.g, qw.n
    xq = quantize_activations_windowed(x.reshape(-1, K), nw, g)
    q = xq.q.contiguous()                                 # (M, nw, g)
    sx = xq.scale.reshape(q.shape[0], nw).contiguous()
    if x.device.type == "cpu":
        out = dscim_fused_mvm_plain(q, sx, qw.q, qw.scale, cfg)
    elif x.device.type == "cuda":
        out = _launch_kernel(q, sx, qw.q, qw.scale, cfg)
    else:
        raise ValueError(f"no dscim_fused route for device {x.device}")
    return out.reshape(*lead, N)


def dscim_fused_mvm(x: torch.Tensor, w: torch.Tensor, cfg: DSCIMConfig, *,
                    group_k: int | None = 128) -> torch.Tensor:
    """Fused DS-CIM linear from float weights: ``prepare_linear_weight``
    + the prepared entry."""
    return dscim_fused_mvm_prepared(x, prepare_linear_weight(w, group_k), cfg)


def dscim_windowed_vmap_mvm(x: torch.Tensor, w: torch.Tensor,
                            cfg: DSCIMConfig, *,
                            group_k: int | None = 128) -> torch.Tensor:
    """The staged path (the reference's per-window ``vmap``), kept as the
    fused path's A/B baseline: x (..., K), w (K, N) float -> (..., N) f32.

    One ``dscim_counts_blocked`` launch per quantization window; the psum
    (M, nw, N) is staged in memory, and the corrections and the dequant
    are separate passes.  The window's float-zero pad rows are real
    estimator rows (x = 0 fires), as in the reference."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w.shape[-1]
    qw = prepare_linear_weight(w, group_k)
    nw, g = qw.nw, qw.g
    xq = quantize_activations_windowed(x.reshape(-1, K), nw, g)
    M = xq.q.shape[0]
    scale, c1, wconst = _estimator_constants(cfg, g)
    psum = torch.empty((M, nw, N), dtype=torch.float32, device=x.device)
    for u in range(nw):
        xg = xq.q[:, u].contiguous()                      # (M, g) int8
        wg = qw.q[u]                                      # (g, N) int8
        counts = dscim_counts_blocked(xg, wg, cfg)
        x32 = xg.to(torch.int32)
        w32 = wg.to(torch.int32)
        p = scale * counts \
            - 128.0 * x32.sum(-1, keepdim=True).to(torch.float32) \
            - 128.0 * (w32 + 128).sum(0, keepdim=True).to(torch.float32)
        if c1:
            a = (x32 + 128) >> cfg.k
            b = (w32 + 128) >> cfg.k
            p = p + c1 * (a.sum(-1, keepdim=True)
                          + b.sum(0, keepdim=True)).to(torch.float32) \
                + wconst
        psum[:, u] = p
    out = (psum * xq.scale.reshape(M, nw, 1) * qw.scale[None]).sum(1)
    return out.reshape(*lead, N)
