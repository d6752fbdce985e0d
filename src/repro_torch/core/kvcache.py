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
"""
from __future__ import annotations

from collections import OrderedDict

import torch

__all__ = ["quantize_page", "n_pages_for", "admission_pages",
           "default_page_table", "init_paged_cache", "paged_from_dense",
           "admit_request", "admit_dense", "spec_rollback", "PageAllocator",
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
        _scatter_pages(cache,
                       ks[:, :, :nf * ps].reshape(L, B, nf, ps, KV, HD),
                       vs[:, :, :nf * ps].reshape(L, B, nf, ps, KV, HD),
                       cache["page_table"][:, :nf].long())
    if rem:
        cache["k_tail"][:, :, :rem] = ks[:, :, nf * ps:].to(TAIL_DTYPE)
        cache["v_tail"][:, :, :rem] = vs[:, :, nf * ps:].to(TAIL_DTYPE)
    return cache


def _scatter_pages(cache, ks, vs, phys):
    """Quantize full pages ks/vs (L, ..., nf, ps, KV, HD) and write them
    into the pool at physical indices ``phys`` (..., nf), in place."""
    for src, pages, scales in ((ks, "k_pages", "k_scale"),
                               (vs, "v_pages", "v_scale")):
        q, s = quantize_page(src)
        cache[pages][:, phys] = q
        cache[scales][:, phys] = s


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
