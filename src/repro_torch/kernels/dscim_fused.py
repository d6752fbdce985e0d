"""Fused DS-CIM MVM: float activations + prepared int8 weights -> f32
output from one C call (port of ``repro/kernels/dscim_fused.py``).

    out[m,n] = Σ_u s_x[m,u] * s_w[u,n] * psum_u[m,n]
    psum_u   = scale*C_u - 128*Σx_u - 128*Σ(w_u+128)  (+ center-trunc terms)

``dscim_fused_mvm_prepared``

* on a CUDA tensor calls ``csrc/dscim_fused.cu`` once: the hand-written
  Hopper MVM (see the source's header for the design and what bounds it),
  whose quantize kernel quantizes the activations per (row, window)
  bitwise as ``quantize_activations_windowed`` before the MVM kernel reads
  them (two device launches);
* on a CPU tensor quantizes with ``quantize_activations_windowed``, as
  the reference does, and runs ``dscim_fused_mvm_plain``, the plain
  PyTorch version of the same estimator.

There is no fallback between the two: any other device raises.

The counts are exact integers on both routes.  The kernel reads them as
popcounts of (G, S) bit-mask tables built here from the blocked point
tables, one 32-bit mask per (row, K-row) on each side of a binary
tensor-core product (``tests/test_torch_bitmma.py`` spells that layout
out in plain PyTorch); the plain version as the reference's {0,1} bit-expansion matmul,
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
from ..core.quant import RECIP_127, QuantizedTensor, quantize_int8
from . import build
from .dscim_mvm import count_mask_tables
from .dscim_mvm_blocked import block_point_tables, dscim_counts_blocked

__all__ = ["dscim_fused_mvm", "dscim_fused_mvm_prepared",
           "dscim_fused_mvm_plain", "quantize_activations_windowed",
           "mask_tables", "dscim_windowed_vmap_mvm", "prepare_capture",
           "LAUNCHES", "launches_for"]

LAUNCHES = build.LaunchCounter("dscim_fused_mvm")
_BY_CFG: dict = {}


def launches_for(cfg: DSCIMConfig) -> build.LaunchCounter:
    """The launches of the kernel with ``cfg``'s estimator (a share of
    ``LAUNCHES``: a speculative window runs two estimators)."""
    c = _BY_CFG.get(cfg)
    if c is None:
        c = _BY_CFG[cfg] = build.LaunchCounter(f"dscim_fused_mvm {cfg.name}")
    return c
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


_DEVICE_TABLES: dict = {}


def _device_mask_tables(cfg: DSCIMConfig, device: torch.device):
    """``mask_tables`` copied to ``device`` once (not per launch).  The
    copy is from pageable host memory, which a CUDA graph capture
    forbids: ``prepare_capture`` makes it first, and a first copy during
    capture raises."""
    key = (cfg, device)
    tabs = _DEVICE_TABLES.get(key)
    if tabs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{cfg.name}: count tables copied to {device} "
                               "during a CUDA graph capture; call "
                               "prepare_capture first")
        tabs = tuple(torch.as_tensor(t, device=device)
                     for t in mask_tables(cfg))
        _DEVICE_TABLES[key] = tabs
    return tabs


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


# dscim_fused_launch(x, x_dtype, wq, sw, ta, tb, out, scratch, counters, M,
#                    N, K, nw, g, k, G, S, vec, scale, c1, wconst, eps, recip,
#                    stream)
ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 9 + [ctypes.c_float] * 5 + [ctypes.c_void_p])
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# quantize_int8's eps as ``clamp_min`` sees it in each dtype (0 in f16)
_CLAMP_EPS = {dt: float(torch.tensor(1e-8).to(dt)) for dt in X_DTYPES}


@functools.lru_cache(maxsize=256)
def _launch_sizes(M: int, N: int, nw: int, g: int) -> tuple[int, int]:
    """(scratch bytes, tile counters) the C call needs for this shape: the
    quantized activations and, where it splits the windows over blocks,
    the staged partials and a counter per output tile."""
    n = build.bind("dscim_fused", "dscim_fused_scratch_bytes",
                   [ctypes.c_int] * 4)(M, N, nw, g)
    if n < 0:
        raise ValueError(f"dscim_fused kernel: shape M={M} N={N} nw={nw} "
                         f"g={g} too large for its scratch")
    tiles = build.bind("dscim_fused", "dscim_fused_counters",
                       [ctypes.c_int] * 3)(M, N, nw)
    return n, tiles


def _copy_width(wq: torch.Tensor) -> int:
    """The widest copy (16, 4 or 1 bytes) that wq's base and row pitch
    allow the kernel's cp.async ring."""
    N, ptr = wq.shape[-1], wq.data_ptr()
    for v in (16, 4):
        if N % v == 0 and ptr % v == 0:
            return v
    return 1


def _launch_kernel(x: torch.Tensor, qw: QuantizedLinearWeight,
                   cfg: DSCIMConfig):
    """``csrc/dscim_fused.cu`` from one C call: x (M, K) f32/bf16/f16 on
    the card + prepared weight -> (out (M, N) f32, xq (M, nw, g) int8,
    sx (M, nw) f32).  Its quantize kernel quantizes the activations per
    (row, window) bitwise as ``quantize_activations_windowed`` into xq and
    sx, which the MVM kernel then reads."""
    M, K = x.shape
    nw, g, N = qw.nw, qw.g, qw.n
    if x.dtype not in X_DTYPES or not x.is_contiguous():
        raise ValueError("dscim_fused kernel takes contiguous f32/bf16/f16 x")
    for t, dt in ((qw.q, torch.int8), (qw.scale, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != x.device:
            raise ValueError("dscim_fused kernel takes a contiguous prepared "
                             "weight on x's CUDA device")
    if K != qw.k_orig:
        raise ValueError(f"x K={K} vs prepared weight K={qw.k_orig}")
    if cfg.group * cfg.sbits > 2048:
        raise ValueError(f"k={cfg.k}: count tables larger than the kernel's")
    ta, tb = _device_mask_tables(cfg, x.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    nbytes, tiles = _launch_sizes(M, N, nw, g)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    scale, c1, wconst = _estimator_constants(cfg, g)
    fn = build.bind("dscim_fused", "dscim_fused_launch", ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = build.tile_counters(x.device, stream, tiles)
    rc = fn(x.data_ptr(), X_DTYPES[x.dtype], qw.q.data_ptr(),
            qw.scale.data_ptr(), ta.data_ptr(), tb.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), counters.data_ptr(), M, N, K, nw, g, cfg.k,
            cfg.group, cfg.sbits, _copy_width(qw.q), scale, c1, wconst,
            _CLAMP_EPS[x.dtype], RECIP_127[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"dscim_fused kernel launch failed: error {rc}")
    LAUNCHES.count += 1
    launches_for(cfg).count += 1
    # the C side's scratch layout: xq, padded to 16 bytes, then sx
    xq_bytes = -(-M * nw * g // 16) * 16
    xq = scratch[:M * nw * g].view(torch.int8).reshape(M, nw, g)
    sx = scratch[xq_bytes:xq_bytes + 4 * M * nw].view(torch.float32)
    return out, xq, sx.reshape(M, nw)


def prepare_capture(weights, M: int, cfg: DSCIMConfig, stream) -> None:
    """Everything the wrapper makes at first use, made before a CUDA graph
    capture on ``stream`` that calls it with M rows on each prepared
    weight in ``weights`` (one layer's weight per shape suffices): the
    library built and bound, the count tables on the device, the
    stream's tile counters sized for the largest call, and one launch per
    weight shape on zero activations (the kernels' first-launch path:
    module load, shared-memory attributes, the SM count)."""
    build.load("dscim_fused")
    seen = set()
    tiles = 0
    for qw in weights:
        tiles = max(tiles, _launch_sizes(M, qw.n, qw.nw, qw.g)[1])
    dev = weights[0].q.device
    _device_mask_tables(cfg, dev)
    build.tile_counters(dev, stream.cuda_stream, tiles)
    with torch.cuda.stream(stream):
        for qw in weights:
            shape = (qw.k_orig, qw.n, qw.nw, qw.g)
            if shape in seen:
                continue
            seen.add(shape)
            for dt in (torch.float32, torch.bfloat16):
                _launch_kernel(torch.zeros((M, qw.k_orig), dtype=dt,
                                           device=dev), qw, cfg)


def dscim_fused_mvm_prepared(x: torch.Tensor, qw: QuantizedLinearWeight,
                             cfg: DSCIMConfig) -> torch.Tensor:
    """Fused DS-CIM linear: x (..., K) float + prepared weight ->
    (..., N) f32.  Leading dims fold into the kernel's M rows.  Only the
    activations are quantized per call: on the card by the kernel's own
    quantize kernel (two device launches from one C call), on the
    CPU by ``quantize_activations_windowed`` before the plain version."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    if K != qw.k_orig:
        raise ValueError(f"x K={K} vs prepared weight K={qw.k_orig}")
    if qw.q.ndim != 3:
        raise ValueError("pass one layer's prepared weight, not a stack")
    nw, g, N = qw.nw, qw.g, qw.n
    x2 = x.reshape(-1, K)
    if x.device.type == "cpu":
        xq = quantize_activations_windowed(x2, nw, g)
        q = xq.q.contiguous()                             # (M, nw, g)
        sx = xq.scale.reshape(q.shape[0], nw).contiguous()
        out = dscim_fused_mvm_plain(q, sx, qw.q, qw.scale, cfg)
    elif x.device.type == "cuda":
        out = _launch_kernel(x2.contiguous(), qw, cfg)[0]
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
