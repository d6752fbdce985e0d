"""The integrity layer's digests as one launch a sweep (``csrc/digest.cu``;
no Pallas kernel of the reference: it computes them in jnp under
``jax.jit``, ``repro/runtime/integrity.py _sweeps``).

Two entries, each with its plain version (``core/digest.py``'s int64
arithmetic, the CPU's path and the card's yardstick):

* ``planes_digest(xs, mults)``: the digest of each tensor, ``(n,)`` int64
  in [0, 2**32), every tensor in one launch.  The weight sweep and
  ``plane_digest``.  The launch reads a device table of the tensors'
  pointers, kept per tensor set (a new one when an address changes);
* ``page_digests``, ``page_refresh`` and ``page_flags``: per-(layer,
  page) digests of the int8 KV pool (k and v slabs, multipliers 1 and 3;
  the f32 scales, 5 and 7), read in place.  Write mode digests every page
  into a new (L, P) tensor, or the listed pages ``phys`` or a refresh
  window's hit pages (worked out in the kernel from the page table and
  the slots' positions) into ``sums``; compare mode flags every page
  whose digest is not its ``sums`` entry.  None reads the host or
  allocates what a CUDA graph could not replay.

A CPU tensor takes the plain version (so does a ``meta`` tensor, whose
result is only a shape); a CUDA tensor launches the kernel or raises (a
dtype the sweeps never meet, a strided tensor, a failed build).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.digest import GOLD, M32, fold, fold_sum
from . import build

__all__ = ["planes_digest", "planes_digest_plain", "page_digests",
           "page_digests_plain", "page_refresh", "page_refresh_plain",
           "page_flags", "page_flags_plain", "LAUNCHES", "KINDS"]

LAUNCHES = build.LaunchCounter("digest")
CHUNK_BYTES = 1 << 16              # csrc/digest.cu kChunkBytes
# u32's widening of each dtype (csrc/digest.cu Kind)
KINDS = {torch.int8: 0, torch.uint8: 1, torch.bool: 1, torch.int16: 2,
         torch.float16: 3, torch.bfloat16: 3, torch.int32: 4,
         torch.float32: 4}
PAGE_MULTS = (1, 3, 5, 7)          # k, v, k scale, v scale
# digest_planes_launch(rows, n_rows, n_blocks, acc_done, n_slots, out,
#                      stream)
PLANES_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
# digest_pages_launch(k, v, ks, vs, L, P, E, KV, phys, n, table, pos0,
#                     upper, mp, J, ps, sums, flags, stream)
PAGES_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
    ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
_TABLES: dict = {}                 # (device, rows) -> (table, blocks)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _route(x) -> bool:
    """True for the kernel (CUDA), False for the plain version: the CPU's
    path, and on ``meta`` tensors (specs, the dry run) the result's
    shape and dtype."""
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no digest route for device {x.device}")
    return x.device.type == "cuda"


# --- entry (a): many tensors, one launch -----------------------------------

def planes_digest_plain(xs, mults=None) -> torch.Tensor:
    """``planes_digest``'s plain version: each tensor folded in int64
    chunks (``core/digest.py fold``)."""
    mults = mults or (1,) * len(xs)
    if not xs:
        return torch.zeros((0,), dtype=torch.int64)
    return torch.stack([fold(x, 0, m) for x, m in zip(xs, mults)])


def _table(xs, mults, device):
    """The launch's device table (csrc/digest.cu Row, 8 int64 a tensor)
    and its block count, made once per set of (address, size, dtype,
    multiplier)."""
    rows, first = [], 0
    for slot, (x, m) in enumerate(zip(xs, mults)):
        kind = KINDS.get(x.dtype)
        if kind is None or x.device != device or not x.is_contiguous():
            raise ValueError(
                f"digest kernel: tensor {slot} is {x.dtype} on {x.device}"
                f"{'' if x.is_contiguous() else ', strided'}; the sweeps "
                f"take contiguous {sorted(map(str, KINDS))} tensors on "
                f"{device}")
        blocks = max(1, -(-x.numel() * x.element_size() // CHUNK_BYTES))
        rows.append((x.data_ptr(), x.numel(), kind, (GOLD * m) & M32, slot,
                     first, blocks, 0))
        first += blocks
    key = (device, tuple(rows))
    hit = _TABLES.get(key)
    if hit is None:
        if len(_TABLES) >= 32:
            _TABLES.clear()
        hit = (torch.tensor(rows, dtype=torch.int64).to(device), first)
        _TABLES[key] = hit
    return hit


def planes_digest(xs, mults=None) -> torch.Tensor:
    """The digest of each tensor of ``xs`` (multiplier ``mults[i]``,
    default 1) over all its elements: ``(n,)`` int64 in [0, 2**32) on
    their device, in one launch on CUDA."""
    xs = list(xs)
    mults = tuple(mults or (1,) * len(xs))
    if not xs or not _route(xs[0]):
        return planes_digest_plain(xs, mults)
    device = xs[0].device
    table, blocks = _table(xs, mults, device)
    n = len(xs)
    out = torch.empty((n,), dtype=torch.int64, device=device)
    stream = _stream(device)
    acc = build.tile_counters(device, stream, 2 * n)
    fn = build.bind("digest", "digest_planes_launch", PLANES_ARGTYPES)
    rc = fn(table.data_ptr(), n, blocks, acc.data_ptr(), n, out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"digest kernel (planes) launch failed: error "
                           f"{rc}")
    LAUNCHES.count += 1
    return out


# --- entry (b): the page pool, one launch ---------------------------------

def page_digests_plain(k, v, ks, vs, sums=None, phys=None):
    """``page_digests``'s plain version: the four planes folded past their
    (layer, page) axes and added; listed pages through gathered copies."""
    if phys is None:
        d = sum(fold_sum(t, 2, m)
                for t, m in zip((k, v, ks, vs), PAGE_MULTS)) & M32
        if sums is None:
            return d
        sums.copy_(d)
        return sums
    idx = phys.reshape(-1).long()
    sums[:, idx] = page_digests_plain(k[:, idx], v[:, idx], ks[:, idx],
                                      vs[:, idx])
    return sums


def _window(table, pos0, upper, max_span: int, ps: int):
    """A refresh window's candidates: (physical pages (B, J) int64, hit
    (B, J) bool), ``J = max_span // ps + 2`` logical pages a slot from
    ``pos0 // ps``."""
    mp = table.shape[1]
    J = max_span // ps + 2
    js = (pos0 // ps)[:, None].long() + torch.arange(
        J, dtype=torch.long, device=table.device)[None, :]
    last_tok = js * ps + (ps - 1)                             # (B, J)
    hit = (last_tok >= pos0[:, None]) & (last_tok < upper[:, None]) \
        & (js < mp)
    return torch.gather(table, 1, torch.clamp_max(js, mp - 1)).long(), hit


def page_refresh_plain(k, v, ks, vs, sums, table, pos0, upper,
                       max_span: int):
    """``page_refresh``'s plain version: the candidates gathered and
    digested, the unhit ones written to a scratch column that is
    dropped."""
    phys, hit = _window(table, pos0, upper, max_span, k.shape[2])
    phys = phys.reshape(-1)
    d = page_digests_plain(k[:, phys], v[:, phys], ks[:, phys], vs[:, phys])
    P = sums.shape[1]
    buf = torch.cat([sums, sums[:, :1]], 1)
    buf[:, torch.where(hit.reshape(-1), phys, P)] = d
    sums.copy_(buf[:, :P])
    return sums


def page_flags_plain(k, v, ks, vs, sums) -> torch.Tensor:
    """``page_flags``'s plain version."""
    return page_digests_plain(k, v, ks, vs) != sums


def _launch_pages(k, v, ks, vs, sums, n, *, phys=None, window=None,
                  flags=None):
    """One launch over ``n`` candidates (every page, ``phys`` or the
    refresh ``window`` (table, pos0, upper, J)); checks every tensor the
    kernel reads or writes first."""
    L, P = k.shape[:2]
    KV = ks.shape[2] if ks.ndim == 3 else -1
    want = [(k, torch.int8, tuple(k.shape)), (v, torch.int8, tuple(k.shape)),
            (ks, torch.float32, (L, P, KV)), (vs, torch.float32, (L, P, KV)),
            (sums, torch.int64, (L, P))]
    if phys is not None:
        want.append((phys, torch.int64, (n,)))
    mp = J = 0
    if window is not None:
        table, pos0, upper, J = window
        B, mp = table.shape
        want += [(table, torch.int32, (B, mp)), (pos0, torch.int32, (B,)),
                 (upper, torch.int32, (B,))]
    for t, dtype, shape in want:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != k.device or not t.is_contiguous()):
            raise ValueError(
                f"digest kernel (pages): got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}, want contiguous {dtype} {shape} on {k.device}")
    if k.ndim < 3 or L > 65535:
        raise ValueError(f"digest kernel (pages): pool {tuple(k.shape)}")
    if L == 0 or n == 0:
        return
    ptr = (lambda t: None if t is None else t.data_ptr())
    win = window or (None, None, None, 0)
    fn = build.bind("digest", "digest_pages_launch", PAGES_ARGTYPES)
    rc = fn(k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(), L, P,
            math.prod(k.shape[2:]), KV, ptr(phys), n, *map(ptr, win[:3]),
            mp, J, k.shape[2], sums.data_ptr(), ptr(flags),
            _stream(k.device))
    if rc != 0:
        raise RuntimeError(f"digest kernel (pages) launch failed: error "
                           f"{rc}")
    LAUNCHES.count += 1


def page_digests(k, v, ks, vs, sums=None, phys=None):
    """Write mode.  ``k``/``v`` int8 (L, P, ps, KV, HD), ``ks``/``vs`` f32
    (L, P, KV).  With ``phys`` None: every page's digest, into ``sums``
    (L, P) int64 or a new tensor, returned.  Else the pages ``phys``
    ((n,) int64) names re-digested into ``sums`` in place (a page named
    twice gets one digest: both come from its bits); returns ``sums``."""
    if not _route(k):
        return page_digests_plain(k, v, ks, vs, sums, phys)
    if sums is None:
        if phys is not None:
            raise ValueError("page_digests: listed pages need sums")
        sums = torch.empty(k.shape[:2], dtype=torch.int64, device=k.device)
    _launch_pages(k, v, ks, vs, sums,
                  k.shape[1] if phys is None else phys.numel(), phys=phys)
    return sums


def page_refresh(k, v, ks, vs, sums, table, pos0, upper, max_span: int):
    """Write mode over a refresh window (``core/kvcache.py
    refresh_page_checksums``): for each slot b the logical pages from
    ``pos0[b] // ps`` (``max_span // ps + 2`` of them) whose last token
    lies in ``[pos0[b], upper[b])`` and inside the int32 ``table`` (B, MP)
    are re-digested at the physical page the table names, into ``sums``
    in place; returns ``sums``.  On CUDA one launch, the window worked
    out in the kernel."""
    if not _route(k):
        return page_refresh_plain(k, v, ks, vs, sums, table, pos0, upper,
                                  max_span)
    J = max_span // k.shape[2] + 2
    _launch_pages(k, v, ks, vs, sums, table.shape[0] * J,
                  window=(table, pos0, upper, J))
    return sums


def page_flags(k, v, ks, vs, sums) -> torch.Tensor:
    """Compare mode: (L, P) bool, true where a page's digest is not its
    ``sums`` entry (the reference's ``_page_bad`` before its live mask)."""
    if not _route(k):
        return page_flags_plain(k, v, ks, vs, sums)
    flags = torch.empty(k.shape[:2], dtype=torch.bool, device=k.device)
    _launch_pages(k, v, ks, vs, sums, k.shape[1], flags=flags)
    return flags
