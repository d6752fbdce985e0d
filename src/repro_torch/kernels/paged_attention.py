"""Int8 paged-attention decode (port of ``repro/kernels/paged_attention.py``).

One query token per slot attends over its int8 KV pages, found through the
page table, with the per-(page, kv head) dequant, the bf16 tail overlay at
logical page ``pos // ps``, the ragged mask past ``pos`` and an f32 online
softmax fused into one page walk.

``paged_attention_decode`` launches ``csrc/paged_attention.cu`` (the
hand-written Hopper kernel, split-KV in runs of whole pages, 32 or 64
tokens by the slot's own context, whose partial softmax states its last
block combines in run order; its header gives the
design and what bounds it) on CUDA tensors, and runs ``paged_read_plain`` on CPU tensors.  The
plain version is the port of the reference's jnp read path
(``repro/layers/attention.py _paged_read_jnp``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["paged_attention_decode", "paged_read_plain", "prepare_capture",
           "LAUNCHES", "NEG_INF"]

NEG_INF = -1e30
LAUNCHES = build.LaunchCounter("paged_attention_decode")


def paged_read_plain(q, k_pages, v_pages, k_scale, v_scale, k_tail, v_tail,
                     page_table, pos) -> torch.Tensor:
    """Plain PyTorch page walk: online softmax over logical pages, gathering
    each physical int8 page and dequantizing it inside the loop (the full-
    precision cache is never materialized).  Arguments as
    ``paged_attention_decode``; returns (B, KV, n_rep, HD) f32."""
    B, KV, R, HD = q.shape
    ps = k_pages.shape[1]
    MP = page_table.shape[1]
    scale_qk = HD ** -0.5
    tail_page = pos // ps
    dev = q.device
    m = torch.full((B, KV, R), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, R), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, R, HD), dtype=torch.float32, device=dev)
    kt = k_tail.to(torch.float32)
    vt = v_tail.to(torch.float32)
    offs = torch.arange(ps, dtype=torch.int32, device=dev)
    for j in range(MP):
        phys = page_table[:, j].long()
        kj = k_pages[phys].to(torch.float32) * k_scale[phys][:, None, :, None]
        vj = v_pages[phys].to(torch.float32) * v_scale[phys][:, None, :, None]
        is_tail = (tail_page == j)[:, None, None, None]
        kj = torch.where(is_tail, kt, kj)
        vj = torch.where(is_tail, vt, vj)
        valid = (j * ps + offs)[None, :] <= pos[:, None]          # (B, ps)
        s = torch.einsum("bgrd,bpgd->bgrp", q, kj) * scale_qk
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrp,bpgd->bgrd", p, vj)
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]


# paged_attention_launch(q, k_pages, v_pages, k_scale, v_scale, k_tail,
#                        v_tail, page_table, pos, out, part, counters, B, KV,
#                        R, HD, ps, MP, vec16, scale, stream)
ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])
def _launch_kernel(q, k_pages, v_pages, k_scale, v_scale, k_tail, v_tail,
                   page_table, pos) -> torch.Tensor:
    B, KV, R, HD = q.shape
    P, ps = k_pages.shape[:2]
    MP = page_table.shape[1]
    want = ((q, torch.float32, (B, KV, R, HD)),
            (k_pages, torch.int8, (P, ps, KV, HD)),
            (v_pages, torch.int8, (P, ps, KV, HD)),
            (k_scale, torch.float32, (P, KV)),
            (v_scale, torch.float32, (P, KV)),
            (k_tail, torch.bfloat16, (B, ps, KV, HD)),
            (v_tail, torch.bfloat16, (B, ps, KV, HD)),
            (page_table, torch.int32, (B, MP)),
            (pos, torch.int32, (B,)))
    for t, dt, shape in want:
        if (t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"paged attention kernel: got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}, wants contiguous {dt} {shape} on {q.device}")
    fn = build.bind("paged_attention", "paged_attention_launch", ARGTYPES)
    runs = build.bind("paged_attention", "paged_attention_max_runs",
                      [ctypes.c_int] * 2)(ps, MP)
    out = torch.empty((B, KV, R, HD), dtype=torch.float32, device=q.device)
    part = torch.empty((B * KV * runs * R * (HD + 2),) if runs > 1 else (1,),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = build.tile_counters(q.device, stream, B * KV)
    vec16 = int(HD % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (
        k_pages, v_pages, k_tail, v_tail)))
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), k_tail.data_ptr(),
            v_tail.data_ptr(), page_table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, KV, R,
            HD, ps, MP, vec16, HD ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: error {rc}")
    LAUNCHES.count += 1
    return out


def prepare_capture(B: int, KV: int, R: int, HD: int, ps: int, MP: int,
                    device, stream) -> None:
    """Everything the wrapper makes at first use, made before a CUDA graph
    capture on ``stream`` of calls at these shapes: the library built and
    bound, the stream's tile counters, and one launch on a zero pool of
    the same layout (module load, the shared-memory attribute)."""
    build.tile_counters(device, stream.cuda_stream, B * KV)
    with torch.cuda.stream(stream):
        z = dict(dtype=torch.float32, device=device)
        pages = torch.zeros((B * MP, ps, KV, HD), dtype=torch.int8,
                            device=device)
        scale = torch.ones((B * MP, KV), **z)
        tail = torch.zeros((B, ps, KV, HD), dtype=torch.bfloat16,
                           device=device)
        table = torch.arange(B * MP, dtype=torch.int32,
                             device=device).reshape(B, MP)
        pos = torch.zeros((B,), dtype=torch.int32, device=device)
        _launch_kernel(torch.zeros((B, KV, R, HD), **z), pages, pages,
                       scale, scale, tail, tail, table, pos)


def paged_attention_decode(q, k_pages, v_pages, k_scale, v_scale,
                           k_tail, v_tail, page_table, pos) -> torch.Tensor:
    """Single-launch paged decode attention.

    q (B, KV, n_rep, HD) f32, the post-RoPE query in kv-major head layout;
    k/v_pages (P, ps, KV, HD) int8; k/v_scale (P, KV) f32; k/v_tail
    (B, ps, KV, HD) bf16, already holding this step's token; page_table
    (B, MP) int32 of physical page ids; pos (B,) int32.  Returns the
    attended (B, KV, n_rep, HD) f32."""
    args = (q, k_pages, v_pages, k_scale, v_scale, k_tail, v_tail,
            page_table, pos)
    if q.device.type == "cpu":
        return paged_read_plain(*args)
    if q.device.type == "cuda":
        return _launch_kernel(*args)
    raise ValueError(f"no paged attention route for device {q.device}")
