"""Int8 block-paged KV cache (port of the one-shot serving half of
``repro/core/kvcache.py``).

Layout (a plain dict of tensors):

  k_pages / v_pages  int8  (L, P, ps, KV, HD)   page pool, P physical pages
  k_scale / v_scale  f32   (L, P, KV)           per-page per-kv-head scales
  k_tail  / v_tail   bf16  (L, B, ps, KV, HD)   the partially-filled page
                                                 per slot, kept unquantized
  page_table         int32 (B, MP)              logical block -> physical page
  pos                int32 (B,)                  per-slot token counts

Each decoded token lands in its slot's tail page at ``pos % ps``; when the
tail fills it is quantized once and flushed to the physical page the table
gives (layers/attention.py).  Unlike the reference's functional updates,
the decode path writes these tensors in place.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_page", "n_pages_for",
           "default_page_table", "init_paged_cache", "paged_from_dense",
           "TAIL_DTYPE"]

TAIL_DTYPE = torch.bfloat16


def quantize_page(x: torch.Tensor):
    """Symmetric int8 page quantization with per-kv-head scales.

    x (..., ps, KV, HD) float -> (q int8 same shape, scale (..., KV) f32);
    absmax over the page's (token, head_dim) axes.  The scale is
    ``amax * (1/127)``: the reference divides by 127.0, but it runs inside
    ``jit``, where XLA turns that division into this multiply, and the port
    matches the jitted result bit for bit."""
    x = x.to(torch.float32)
    amax = torch.abs(x).amax(dim=(-3, -1))
    scale = torch.clamp_min(amax, 1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale[..., None, :, None]), -127, 127)
    return q.to(torch.int8), scale


def n_pages_for(capacity: int, page_size: int) -> int:
    """Logical pages needed for one sequence of ``capacity`` tokens."""
    return -(-capacity // page_size)


def default_page_table(batch: int, max_pages: int, device=None):
    """Slot-major contiguous assignment: slot b owns pages
    [b*MP, (b+1)*MP)."""
    return torch.arange(batch * max_pages, dtype=torch.int32,
                        device=device).reshape(batch, max_pages)


def init_paged_cache(n_layers: int, batch: int, n_pages: int, page_size: int,
                     max_pages: int, n_kv: int, head_dim: int, device=None):
    """Empty pool + idle slots (pos 0, slot-major default page table
    clamped into the pool)."""
    table = torch.clamp_max(default_page_table(batch, max_pages, device),
                            n_pages - 1)
    pool = (n_layers, n_pages, page_size, n_kv, head_dim)
    tail = (n_layers, batch, page_size, n_kv, head_dim)
    return {
        "k_pages": torch.zeros(pool, dtype=torch.int8, device=device),
        "v_pages": torch.zeros(pool, dtype=torch.int8, device=device),
        "k_scale": torch.ones((n_layers, n_pages, n_kv), dtype=torch.float32,
                              device=device),
        "v_scale": torch.ones((n_layers, n_pages, n_kv), dtype=torch.float32,
                              device=device),
        "k_tail": torch.zeros(tail, dtype=TAIL_DTYPE, device=device),
        "v_tail": torch.zeros(tail, dtype=TAIL_DTYPE, device=device),
        "page_table": table,
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def paged_from_dense(ks: torch.Tensor, vs: torch.Tensor, page_size: int,
                     n_pages: int | None = None,
                     max_pages: int | None = None):
    """Convert a dense prefill cache (L, B, S, KV, HD) into a paged one:
    full pages are quantized, the S % ps remainder stays in the bf16 tail.
    Callers that decode past ``max_pages * page_size`` tokens must size
    ``max_pages`` for prompt + generation."""
    L, B, S, KV, HD = ks.shape
    ps = page_size
    nf, rem = divmod(S, ps)
    if max_pages is None:
        max_pages = nf + 1
    if n_pages is None:
        n_pages = B * max_pages
    if n_pages < B * max_pages:
        raise ValueError(f"pool of {n_pages} pages < {B} slots x "
                         f"{max_pages} pages")
    cache = init_paged_cache(L, B, n_pages, ps, max_pages, KV, HD,
                             device=ks.device)
    cache["pos"].fill_(S)
    if nf:
        phys = cache["page_table"][:, :nf].long()               # (B, nf)
        for src, pages, scales in ((ks, "k_pages", "k_scale"),
                                   (vs, "v_pages", "v_scale")):
            full = src[:, :, :nf * ps].reshape(L, B, nf, ps, KV, HD)
            q, s = quantize_page(full)
            cache[pages][:, phys] = q
            cache[scales][:, phys] = s
    if rem:
        cache["k_tail"][:, :, :rem] = ks[:, :, nf * ps:].to(TAIL_DTYPE)
        cache["v_tail"][:, :, :rem] = vs[:, :, nf * ps:].to(TAIL_DTYPE)
    return cache
