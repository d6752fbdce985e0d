"""Causal flash attention (port of ``repro/kernels/flash_attention.py``).

``flash_attention(q, k, v)`` on (BH, S, d) launches
``csrc/flash_attention.cu`` (a hand-written FlashAttention-2 kernel on the
tensor cores: bf16/f16 through ``mma.sync`` with f32 softmax state, f32
through 3xTF32; its header gives the design and what bounds it) on CUDA
tensors, and runs
``flash_attention_plain`` (``ref.py flash_attention_ref``: the full f32
softmax with a -1e30 causal mask) on CPU tensors.  The output has q's
dtype.  Unlike the reference, any S is taken: the kernel masks the ragged
edge itself.

Not wired into the port's prefill, as the reference's prefill does not
use it either: that runs the chunked bf16 ``_flash`` of
``layers/attention.py``, whose numbers differ from this f32 kernel's.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["flash_attention", "flash_attention_plain", "LAUNCHES",
           "NEG_INF"]

NEG_INF = -1e30
LAUNCHES = build.LaunchCounter("flash_attention")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# flash_attention_launch(q, k, v, o, BH, S, d, dtype, scale, stream)
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_plain(q, k, v) -> torch.Tensor:
    """Plain causal softmax attention in f32; q/k/v (BH, S, d)."""
    S, d = q.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * d ** -0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p,
                        v.to(torch.float32)).to(q.dtype)


def _launch_kernel(q, k, v) -> torch.Tensor:
    BH, S, d = q.shape
    for t in (k, v):
        if (t.dtype != q.dtype or t.shape != q.shape
                or t.device != q.device):
            raise ValueError("flash attention kernel: q, k, v must share "
                             "shape, dtype and device")
    if q.dtype not in DTYPE_CODES or not 0 < d <= 256 or BH > 65535:
        raise ValueError(f"flash attention kernel takes f32/bf16/f16 with "
                         f"d <= 256 and BH <= 65535, got {q.dtype} "
                         f"{tuple(q.shape)}")
    out = torch.empty_like(q)
    fn = build.bind("flash_attention", "flash_attention_launch", ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S,
            d, DTYPE_CODES[q.dtype], d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: error {rc}")
    LAUNCHES.count += 1
    return out


def flash_attention(q, k, v) -> torch.Tensor:
    """Causal attention, q/k/v (BH, S, d) (batch and heads folded; GQA
    callers repeat kv per q head first) -> (BH, S, d) in q's dtype."""
    if q.ndim != 3:
        raise ValueError(f"flash_attention takes (BH, S, d), got "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type == "cuda":
        return _launch_kernel(q.contiguous(), k.contiguous(), v.contiguous())
    raise ValueError(f"no flash attention route for device {q.device}")
