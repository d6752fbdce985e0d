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
the decode path and the admissions write these tensors in place, so a
captured decode step keeps its addresses.

Page allocation is host-side (``PageAllocator``): the continuous-batching
scheduler (runtime/serving.py) grants a request its pages at admission and
returns them at completion, so the decode step never allocates.

Prefix cache (``PrefixCache``, ``prefix_chunk_keys``, ``cow_fork``): a
rolling hash over page-aligned token chunks keys full flushed pages, and
an admission whose prompt shares a page-aligned prefix with a live or
retained entry maps its leading page-table entries at the same physical
pages (``PageAllocator.share``) and prefills from the first divergent
page.  Sharing covers only full flushed pages strictly below a slot's
write frontier (``pos // ps``): decode flushes land at logical index
>= pos // ps and the chunked prefill feeds from the first divergent page,
so the write paths never touch a shared page.  ``cow_fork`` is the
enforcement point a host-side write into a grant goes through.
``extract_slot_pages`` / ``insert_slot_pages`` (priority eviction) copy
bytes by physical id and always restore onto freshly granted private
pages, so an eviction round trip never re-enters the shared set.  The
allocator's and the index's snapshots carry refcounts, the retained LRU
and the hash index, so a failover restore replays bit for bit.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..kernels.digest import page_digests, page_refresh

__all__ = ["quantize_page", "n_pages_for", "admission_pages",
           "default_page_table", "init_paged_cache", "paged_from_dense",
           "admit_request", "admit_dense", "spec_rollback", "PageAllocator",
           "prefix_chunk_keys", "PrefixCache", "cow_fork",
           "extract_slot_pages", "insert_slot_pages", "TAIL_DTYPE",
           "CHECKSUM_KEY", "page_checksums", "refresh_page_checksums",
           "dequantize_page", "paged_cache_specs", "kv_cache_bytes",
           "dense_cache_bytes"]

TAIL_DTYPE = torch.bfloat16
CHECKSUM_KEY = "page_sum"


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


def dequantize_page(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_page``: q (..., ps, KV, HD) int8 and scale
    (..., KV) -> f32 (..., ps, KV, HD)."""
    return q.to(torch.float32) * scale[..., None, :, None]


def page_checksums(k_pages, v_pages, k_scale, v_scale) -> torch.Tensor:
    """Per-(layer, page) uint32 digest of the quantized pool, as int64: k/v
    int8 planes (L, P, ps, KV, HD) and bitcast f32 scales (L, P, KV) ->
    (L, P), each plane folded with its own odd multiplier (1, 3, 5, 7) and
    the four added mod 2**32, as the reference adds its uint32 sums.  One
    digest launch on CUDA (``kernels/digest.py``)."""
    return page_digests(k_pages, v_pages, k_scale, v_scale)


def _update_page_sums(cache, phys) -> None:
    """Re-digest the physical pages ``phys`` (any shape) from the pool's
    current bits, in place; no-op without the ``page_sum`` plane."""
    if CHECKSUM_KEY not in cache:
        return
    idx = torch.as_tensor(phys, device=cache["pos"].device).reshape(-1) \
        .long()
    page_digests(*(cache[name] for name in _PAGE_PLANES),
                 sums=cache[CHECKSUM_KEY], phys=idx)


def refresh_page_checksums(cache, pos0, upper, max_span: int) -> None:
    """Re-digest every physical page a decode segment or an extend chunk
    may have flushed, in place, with no host read: a logical page whose
    last token index lies in ``[pos0, upper)`` (B,) was filled during the
    step, so its digest is recomputed from the live pool bits.
    ``max_span`` bounds ``upper - pos0`` (sizes the candidate window);
    empty ranges refresh nothing, and two candidates naming one page carry
    the same digest (both come from its bits).  One digest launch on CUDA
    (``kernels/digest.py page_refresh``).  No-op without the ``page_sum``
    plane."""
    if CHECKSUM_KEY not in cache:
        return
    page_refresh(*(cache[name] for name in _PAGE_PLANES),
                 cache[CHECKSUM_KEY], cache["page_table"], pos0, upper,
                 max_span)


def n_pages_for(capacity: int, page_size: int) -> int:
    """Logical pages needed for one sequence of ``capacity`` tokens."""
    return -(-capacity // page_size)


def admission_pages(prompt_len: int, budget: int, page_size: int,
                    headroom: int = 0) -> int:
    """Physical pages one admission must be granted: prompt + generation
    budget + in-flight headroom.  Non-positive ``page_size``/``budget``
    and negative ``prompt_len``/``headroom`` raise: each is a caller bug
    that would otherwise surface as a nonsense page count."""
    if page_size <= 0:
        raise ValueError(f"admission_pages: page_size must be positive, "
                         f"got {page_size}")
    if budget <= 0:
        raise ValueError(f"admission_pages: generation budget must be "
                         f"positive, got {budget}")
    if prompt_len < 0 or headroom < 0:
        raise ValueError(f"admission_pages: prompt_len/headroom must be "
                         f">= 0, got {prompt_len}/{headroom}")
    return n_pages_for(prompt_len + budget + headroom, page_size)


def default_page_table(batch: int, max_pages: int, device=None):
    """Slot-major contiguous assignment: slot b owns pages
    [b*MP, (b+1)*MP)."""
    return torch.arange(batch * max_pages, dtype=torch.int32,
                        device=device).reshape(batch, max_pages)


def init_paged_cache(n_layers: int, batch: int, n_pages: int, page_size: int,
                     max_pages: int, n_kv: int, head_dim: int, device=None,
                     integrity: bool = False):
    """Empty pool + idle slots (pos 0, slot-major default page table
    clamped into the pool).  ``integrity=True`` adds the ``page_sum``
    plane, consistent with the empty pool."""
    table = torch.clamp_max(default_page_table(batch, max_pages, device),
                            n_pages - 1)
    pool = (n_layers, n_pages, page_size, n_kv, head_dim)
    tail = (n_layers, batch, page_size, n_kv, head_dim)
    cache = {
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
    if integrity:
        cache[CHECKSUM_KEY] = page_checksums(
            *(cache[name] for name in _PAGE_PLANES))
    return cache


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
        _scatter_pages(cache,
                       ks[:, :, :nf * ps].reshape(L, B, nf, ps, KV, HD),
                       vs[:, :, :nf * ps].reshape(L, B, nf, ps, KV, HD),
                       cache["page_table"][:, :nf].long())
    if rem:
        cache["k_tail"][:, :, :rem] = ks[:, :, nf * ps:].to(TAIL_DTYPE)
        cache["v_tail"][:, :, :rem] = vs[:, :, nf * ps:].to(TAIL_DTYPE)
    return cache


def paged_cache_specs(cfg, batch: int, capacity: int, page_size: int,
                      n_pages: int | None = None, integrity: bool = False):
    """``init_paged_cache``'s planes for ``cfg`` as ``meta`` tensors (shape
    and dtype, no storage): ``batch`` slots of ``capacity`` tokens, a pool
    of ``n_pages`` (default one full sequence a slot), the digest plane
    with ``integrity`` (int64 here, where the reference's is uint32)."""
    mp = n_pages_for(capacity, page_size)
    if n_pages is None:
        n_pages = batch * mp
    return init_paged_cache(cfg.n_layers, batch, n_pages, page_size, mp,
                            cfg.n_kv, cfg.head_dim, device="meta",
                            integrity=integrity)


def kv_cache_bytes(cache_or_specs) -> int:
    """Resident decode-cache bytes of a cache or its specs (pages, scales,
    tails, page table; the per-slot positions and the digest plane are
    bookkeeping, left out as the reference leaves them out, so the count
    is the same with integrity on or off)."""
    skip = {"pos", CHECKSUM_KEY}
    return sum(t.numel() * t.element_size()
               for k, t in cache_or_specs.items() if k not in skip)


def dense_cache_bytes(cfg, batch: int, capacity: int) -> int:
    """k + v bytes of the dense fixed-capacity cache at cfg.cache_dtype."""
    itemsize = torch.empty((), dtype=getattr(torch, cfg.cache_dtype)
                           ).element_size()
    return 2 * cfg.n_layers * batch * capacity * cfg.n_kv * cfg.head_dim \
        * itemsize


def _scatter_pages(cache, ks, vs, phys):
    """Quantize full pages ks/vs (L, ..., nf, ps, KV, HD) and write them
    into the pool at physical indices ``phys`` (..., nf), in place, and
    re-digest them."""
    for src, pages, scales in ((ks, "k_pages", "k_scale"),
                               (vs, "v_pages", "v_scale")):
        q, s = quantize_page(src)
        cache[pages][:, phys] = q
        cache[scales][:, phys] = s
    _update_page_sums(cache, phys)


def admit_request(cache, ks1, vs1, slot: int, page_ids):
    """Write one request's prefill KV (dense, (L, 1, S, KV, HD)) into slot
    ``slot`` of a live paged cache, in place, onto host-granted physical
    pages ``page_ids`` ((MP,) ints; entries past the request's need are
    unused): the slot's table row and pos, its full pages quantized into
    the pool, the S % ps remainder into its (otherwise zeroed) tail."""
    L, _, S, KV, HD = ks1.shape
    ps = cache["k_tail"].shape[2]
    nf, rem = divmod(S, ps)
    ids = torch.as_tensor(page_ids, dtype=torch.int32,
                          device=cache["page_table"].device)
    cache["page_table"][slot] = ids
    cache["pos"][slot] = S
    if nf:
        _scatter_pages(cache, ks1[:, 0, :nf * ps].reshape(L, nf, ps, KV, HD),
                       vs1[:, 0, :nf * ps].reshape(L, nf, ps, KV, HD),
                       ids[:nf].long())
    for name, src in (("k_tail", ks1), ("v_tail", vs1)):
        tail = cache[name][:, slot]
        tail.zero_()
        if rem:
            tail[:, :rem] = src[:, 0, nf * ps:].to(tail.dtype)
    return cache


def admit_dense(cache, ks1, vs1, slot: int):
    """Dense-cache counterpart of ``admit_request``: overwrite batch row
    ``slot`` of a (L, B, T, KV, HD) cache with a B=1 prefill padded to T,
    in place."""
    S = ks1.shape[2]
    for name, src in (("k", ks1), ("v", vs1)):
        row = cache[name][:, slot]
        row.zero_()
        row[:, :S] = src[:, 0].to(row.dtype)
    cache["pos"][slot] = S
    return cache


def spec_rollback(cache, pos0, new_pos, tails0=None, win_kv=None):
    """Truncate a speculative draft/verify window back to its committed
    length (launch/steps.py), in place: the write-then-rollback
    discipline of the reference's ``spec_rollback``.

    ``pos0`` (B,) is the position the window started from, ``new_pos``
    (B,) the committed position after accept/reject (pos0 <= new_pos <=
    pos0 + T).  Both layouts are append-only with read masks on ``pos``,
    so rejected positions never need erasing:

    * dense: truncating ``pos`` is the whole rollback;
    * paged: the same, except that a window which crossed a page boundary
      flushed the committed tail page's low offsets out of the tail.  The
      tail is rebuilt here by a gather from the window's K/V (``win_kv``
      (L, B, T, KV, HD), the verifier's writes in the tail dtype:
      positions >= pos0) and the pre-window tails (``tails0`` (L, B, ps,
      KV, HD): positions < pos0).  Pages are never allocated or freed:
      every slot's grant has headroom for the window's k draft
      positions.

    Entries past ``new_pos % ps`` are don't-care (rewritten before they
    are read); they are filled from the same gather.  Returns ``cache``
    (its tensors updated in place)."""
    if "k_pages" in cache:
        k_tail0, v_tail0 = tails0
        win_k, win_v = win_kv
        L, B, T = win_k.shape[:3]
        ps = cache["k_tail"].shape[2]
        o = torch.arange(ps, dtype=new_pos.dtype, device=new_pos.device)
        i = (new_pos // ps * ps)[:, None] + o[None, :]          # (B, ps)
        t = torch.clamp(i - pos0[:, None], 0, T - 1).long()
        use_w = (i >= pos0[:, None])[None, :, :, None, None]
        idx = t[None, :, :, None, None].expand(L, B, ps, *win_k.shape[3:])
        for name, win, tail0 in (("k_tail", win_k, k_tail0),
                                 ("v_tail", win_v, v_tail0)):
            cache[name].copy_(torch.where(use_w, torch.gather(win, 2, idx),
                                          tail0))
    cache["pos"].copy_(new_pos)
    return cache


class PageAllocator:
    """Host-side refcounted free-list over the physical page pool.  The
    continuous scheduler allocates a request's pages at admission and
    frees them at completion: capacity is the pool size, not
    slots x max_len.

    Lifecycle of a physical page:

    * ``alloc``: free -> live at refcount 1.
    * ``share``: +1 reference on a live page, or revive a *retained* page
      back to live at refcount 1.
    * ``free``: -1 reference; a page leaves the live set only at
      refcount 0, and then returns to the free list unless it is marked
      retainable (``set_retainable``), in which case it parks in a
      recently-freed LRU set with its bytes intact.
    * retained pages are reclaimed oldest-first, notifying the
      ``on_reclaim`` hooks, only when an ``alloc`` would otherwise refuse.

    ``free`` validates its ids: a double free or an out-of-range id would
    put one physical page on the free list twice, and two live slots
    would later write one page."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))
        self._live: set = set()
        self._refs: dict = {}               # live pid -> refcount >= 1
        self._retained: OrderedDict = OrderedDict()   # ref-0 parked, LRU
        self._retainable: set = set()
        self._drop_hooks: list = []
        self._high_water = 0
        self._refusals = 0
        self._shares = 0
        self._reclaimed = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Pages an ``alloc`` could hand out: free + reclaimable retained."""
        return len(self._free) + len(self._retained)

    def refcount(self, pid: int) -> int:
        """Current reference count of a page (0 for free/retained)."""
        return self._refs.get(int(pid), 0)

    def _reclaim_one(self) -> None:
        pid, _ = self._retained.popitem(last=False)     # oldest first
        self._retainable.discard(pid)
        for hook in self._drop_hooks:
            hook(pid)
        self._free.append(pid)
        self._reclaimed += 1

    def alloc(self, n: int):
        """n private physical page ids (refcount 1 each), or None if the
        pool cannot cover them.  ``n <= 0`` raises: a grant that owns no
        pages would let the slot's first flush write an unowned page."""
        if n <= 0:
            raise ValueError(
                f"PageAllocator.alloc: page count must be positive, got {n}")
        if n > len(self._free) + len(self._retained):
            self._refusals += 1
            return None
        while n > len(self._free):
            self._reclaim_one()
        ids = [self._free.pop() for _ in range(n)]
        self._live.update(ids)
        for i in ids:
            self._refs[i] = 1
        self._high_water = max(self._high_water, len(self._live))
        return ids

    def share(self, ids) -> None:
        """One more reference on each page in ``ids``: +1 on a live page,
        or revive a retained page to live at refcount 1.  A page that is
        neither (its bytes may be reallocated) raises."""
        ids = [int(i) for i in ids]
        for i in ids:
            if not (i in self._live or i in self._retained):
                raise ValueError(
                    f"PageAllocator.share: page {i} is neither live nor "
                    "retained; a stale index would alias a reallocated page")
        for i in ids:
            if i in self._retained:
                del self._retained[i]
                self._live.add(i)
                self._refs[i] = 1
            else:
                self._refs[i] += 1
            self._shares += 1
        self._high_water = max(self._high_water, len(self._live))

    def set_retainable(self, pid: int, flag: bool = True) -> None:
        """Mark/unmark a page for retention at refcount 0.  Unmarking a
        retained page releases it to the free list at once."""
        pid = int(pid)
        if flag:
            self._retainable.add(pid)
        else:
            self._retainable.discard(pid)
            if pid in self._retained:
                del self._retained[pid]
                self._free.append(pid)

    def on_reclaim(self, hook) -> None:
        """Register ``hook(pid)``, called when a retained page is
        reclaimed for reallocation."""
        self._drop_hooks.append(hook)

    def stats(self) -> dict:
        """Occupancy counters: live pages now, the high-water mark (peak
        concurrent grant), refused ``alloc`` calls (admission
        backpressure), pages referenced more than once, retained pages,
        ``share`` references taken and retained pages reclaimed."""
        return {"n_pages": self.n_pages,
                "live_pages": len(self._live),
                "high_water": self._high_water,
                "refusals": self._refusals,
                "shared_pages": sum(1 for r in self._refs.values() if r > 1),
                "retained_pages": len(self._retained),
                "shares": self._shares,
                "reclaimed": self._reclaimed}

    def free(self, ids) -> None:
        ids = [int(i) for i in ids]
        seen: set = set()
        for i in ids:
            if not 0 <= i < self.n_pages:
                raise ValueError(
                    f"PageAllocator.free: page id {i} out of range for a "
                    f"{self.n_pages}-page pool")
            if i in seen or i not in self._live:
                raise ValueError(
                    f"PageAllocator.free: double free of page {i} (not "
                    "currently allocated): two live slots would share a "
                    "physical page")
            seen.add(i)
        # validate, then commit: a raise above leaves the pool unchanged
        for i in ids:
            self._refs[i] -= 1
            if self._refs[i] > 0:
                continue                     # another sharer still holds it
            del self._refs[i]
            self._live.discard(i)
            if i in self._retainable:
                self._retained[i] = None     # park, newest at the LRU back
            else:
                self._free.append(i)

    def snapshot(self) -> dict:
        """Plain-data copy of the allocator state: the free list and the
        retained LRU in order (reuse order is visible in a replay), live
        pages with refcounts, the retainable marks and the counters.
        Hooks are process state and are not kept."""
        return {"n_pages": self.n_pages, "free": list(self._free),
                "live": sorted(self._live),
                "refs": {int(k): int(v) for k, v in self._refs.items()},
                "retained": list(self._retained),
                "retainable": sorted(self._retainable),
                "high_water": self._high_water,
                "refusals": self._refusals,
                "shares": self._shares,
                "reclaimed": self._reclaimed}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "PageAllocator":
        a = cls.__new__(cls)
        a.n_pages = int(snap["n_pages"])
        a._free = [int(i) for i in snap["free"]]
        a._live = {int(i) for i in snap["live"]}
        # a snapshot without refcounts had every live page singly owned
        a._refs = {int(k): int(v)
                   for k, v in snap.get("refs", {}).items()} \
            or {i: 1 for i in a._live}
        a._retained = OrderedDict(
            (int(i), None) for i in snap.get("retained", ()))
        a._retainable = {int(i) for i in snap.get("retainable", ())}
        a._drop_hooks = []
        a._high_water = int(snap.get("high_water", len(a._live)))
        a._refusals = int(snap.get("refusals", 0))
        a._shares = int(snap.get("shares", 0))
        a._reclaimed = int(snap.get("reclaimed", 0))
        return a


_PREFIX_MULT = 1099511628211          # FNV-1a prime, odd -> invertible
_PREFIX_SEED = 14695981039346656037   # FNV-1a offset basis
_U64 = (1 << 64) - 1


def prefix_chunk_keys(tokens, page_size: int) -> list:
    """Rolling hash over page-aligned chunks of a token sequence: one
    uint64 key (a Python int) per *full* page, key j digesting the whole
    prefix ``tokens[:(j+1) * page_size]`` (the hash rolls, it does not
    reset per page), so equal keys at chunk j mean equal prefixes up to
    that page boundary.  ``tok + 1`` keeps a zero token from being
    absorbed (h * m + 0 == h * m would make [0] and [] collide)."""
    h = _PREFIX_SEED
    keys = []
    toks = np.asarray(tokens).reshape(-1)
    for j in range(len(toks) // page_size):
        for t in toks[j * page_size:(j + 1) * page_size]:
            h = (h * _PREFIX_MULT + int(t) + 1) & _U64
        keys.append(h)
    return keys


class PrefixCache:
    """Prefix-hash index over full flushed physical pages: rolling
    prefix-chunk keys (``prefix_chunk_keys``) -> physical page ids, so an
    admission sharing a page-aligned prompt prefix with a live or
    retained request reuses those pages instead of prefilling and
    quantizing them again.

    * ``acquire(tokens, max_chunks)``: the longest indexed prefix of the
      prompt, at most ``max_chunks`` pages; takes a reference on each
      matched page (``PageAllocator.share``) and returns
      ``(n_shared_tokens, page_ids)``.
    * ``register(tokens, page_ids)``: index a served request's full
      flushed prefix pages and mark them retainable.  First writer wins:
      a key already indexed keeps its page.
    * reclaim: the index registers an ``on_reclaim`` hook, so a retained
      page the allocator recycles leaves the index before its bytes can
      be rewritten, and ``share`` never aliases a reallocated page."""

    def __init__(self, alloc: PageAllocator, page_size: int):
        self.alloc = alloc
        self.page_size = int(page_size)
        self._index: dict = {}       # chunk key -> physical page id
        self._by_pid: dict = {}      # physical page id -> chunk key
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.pages_deduped = 0
        alloc.on_reclaim(self._on_reclaim)

    def __len__(self) -> int:
        return len(self._index)

    def _on_reclaim(self, pid: int) -> None:
        key = self._by_pid.pop(int(pid), None)
        if key is not None:
            self._index.pop(key, None)

    def acquire(self, tokens, max_chunks: int):
        """Match the longest indexed page-aligned prefix of ``tokens`` (at
        most ``max_chunks`` pages), take a reference on each matched page
        and return ``(n_shared_tokens, page_ids)``; a miss is ``(0, [])``.
        Callers cap ``max_chunks`` at ``(len(tokens) - 1) // page_size``
        so at least one prompt token is left to feed: the first sampled
        token needs the last prompt position's logits."""
        self.lookups += 1
        keys = prefix_chunk_keys(tokens, self.page_size)[:max(max_chunks, 0)]
        pids = []
        for key in keys:
            pid = self._index.get(key)
            if pid is None:
                break
            pids.append(pid)
        if not pids:
            return 0, []
        self.alloc.share(pids)
        self.hits += 1
        self.hit_tokens += len(pids) * self.page_size
        self.pages_deduped += len(pids)
        return len(pids) * self.page_size, list(pids)

    def register(self, tokens, page_ids) -> int:
        """Index a request's full flushed prefix pages: chunk j's key ->
        ``page_ids[j]`` for each of its ``len(tokens) // page_size`` full
        pages (clipped to the grant), each marked retainable so its bytes
        outlive the request.  Returns the number of new index entries."""
        n_flushed = min(len(np.asarray(tokens).reshape(-1))
                        // self.page_size, len(page_ids))
        keys = prefix_chunk_keys(tokens, self.page_size)[:n_flushed]
        added = 0
        for key, pid in zip(keys, page_ids):
            pid = int(pid)
            if key in self._index or pid in self._by_pid:
                continue                     # first writer wins
            self._index[key] = pid
            self._by_pid[pid] = key
            self.alloc.set_retainable(pid, True)
            added += 1
        return added

    def stats(self) -> dict:
        return {"entries": len(self._index),
                "lookups": self.lookups,
                "hits": self.hits,
                "hit_tokens": self.hit_tokens,
                "pages_deduped": self.pages_deduped}

    def snapshot(self) -> dict:
        """Plain-data copy of the index and its counters (a failover
        restore must find the index it had)."""
        return {"page_size": self.page_size,
                "index": [[int(k), int(p)] for k, p in self._index.items()],
                "lookups": self.lookups, "hits": self.hits,
                "hit_tokens": self.hit_tokens,
                "pages_deduped": self.pages_deduped}

    @classmethod
    def from_snapshot(cls, snap: dict, alloc: PageAllocator) -> "PrefixCache":
        pc = cls(alloc, int(snap["page_size"]))
        for k, p in snap["index"]:
            pc._index[int(k)] = int(p)
            pc._by_pid[int(p)] = int(k)
        pc.lookups = int(snap.get("lookups", 0))
        pc.hits = int(snap.get("hits", 0))
        pc.hit_tokens = int(snap.get("hit_tokens", 0))
        pc.pages_deduped = int(snap.get("pages_deduped", 0))
        return pc


_PAGE_PLANES = ("k_pages", "v_pages", "k_scale", "v_scale")


def cow_fork(cache, alloc: PageAllocator, page_ids, start_idx: int = 0):
    """Copy-on-write fork: make every page of a slot's grant from logical
    index ``start_idx`` on private before a write can land there.  A
    page in that range with refcount > 1 is copied (int8 planes, f32
    scales, its digest) onto a fresh page of the pool, in place; the slot
    drops its reference on the original (the other sharers keep it).  In the
    aligned admission flow this is a checked no-op: sharing stops
    strictly below the write frontier.  Returns ``(cache, new_page_ids,
    n_forked)``; raises RuntimeError if the pool has no page to fork
    onto."""
    ids = [int(i) for i in page_ids]
    forked = 0
    for j in range(max(start_idx, 0), len(ids)):
        old = ids[j]
        if alloc.refcount(old) <= 1:
            continue
        got = alloc.alloc(1)
        if got is None:
            raise RuntimeError(
                "cow_fork: page pool exhausted while forking a shared "
                f"page (id {old}): the grant was undersized")
        new = got[0]
        for name in _PAGE_PLANES + ((CHECKSUM_KEY,) if CHECKSUM_KEY in cache
                                    else ()):
            cache[name][:, new].copy_(cache[name][:, old])
        alloc.free([old])
        ids[j] = new
        forked += 1
    return cache, ids, forked


def extract_slot_pages(cache, slot: int, page_ids) -> dict:
    """Bit-exact host copy of one slot's share of a paged cache: its
    granted physical pages (int8 planes, f32 scales), its tail and its
    position, as CPU tensors (the eviction path parks it so the request
    is never prefilled again: requantizing, or another float reduction
    order, would change its bits)."""
    ids = torch.as_tensor([int(i) for i in page_ids], dtype=torch.long,
                          device=cache["pos"].device)
    blob = {"page_count": len(page_ids), "pos": int(cache["pos"][slot])}
    for name in _PAGE_PLANES:
        blob[name] = cache[name][:, ids].cpu()
    for name in ("k_tail", "v_tail"):
        blob[name] = cache[name][:, slot].to("cpu", copy=True)
    return blob


def insert_slot_pages(cache, slot: int, page_ids, blob: dict):
    """Inverse of ``extract_slot_pages`` onto freshly granted physical
    pages, in place: the parked planes and scales go to ``page_ids``, the
    slot's tail and position are restored and its page-table row
    rewritten (padded to MP with the last id, as admission pads it).
    Only the physical ids differ from the slot that was extracted, and
    reads go through the page table, so the slot decodes the same bits."""
    ids = [int(i) for i in page_ids]
    if len(ids) != blob["page_count"]:
        raise ValueError(f"insert_slot_pages: {blob['page_count']} pages "
                         f"parked but {len(ids)} granted")
    dev = cache["pos"].device
    mp = cache["page_table"].shape[1]
    idx = torch.as_tensor(ids, dtype=torch.long, device=dev)
    for name in _PAGE_PLANES:
        cache[name][:, idx] = blob[name].to(dev)
    for name in ("k_tail", "v_tail"):
        cache[name][:, slot].copy_(blob[name])
    cache["page_table"][slot] = torch.as_tensor(
        ids + [ids[-1]] * (mp - len(ids)), dtype=torch.int32, device=dev)
    cache["pos"][slot] = blob["pos"]
    _update_page_sums(cache, idx)
    return cache
