"""Asyncio serving router: the request-granular frontend above the
continuous-batching scheduler (port of ``repro/runtime/router.py``).

``serve_continuous`` serves a closed queue of fixed-length prompts; a
service faces streaming requests of any prompt length, arriving at any
time, each wanting its tokens as they are produced and a definite answer
when they are not.  ``Router`` drives the scheduler's halves
(launch/steps.py ``make_admit_fn`` / ``make_segment_fn`` /
``make_extend_fn`` / ``make_probe_fn``) request by request over one
persistent serve state; launch/server.py wraps it in an HTTP shim.
Greedy serving is schedule-independent per request, so a bucket-length
request served here gets bitwise the tokens ``serve_continuous`` gives
it.

Admission paths:

* **bucketed one-shot**: a prompt whose length is one of ``buckets``
  prefills in one eager ``admit`` call;
* **chunked**: any other length feeds ``chunk_len`` prompt tokens a
  round through one captured extend graph, the last chunk padded and
  rolled back; decode segments of the live slots run between chunks.
  Teacher-forced decode equivalent, so any chunk size gives the same
  tokens (not bitwise the batched prefill);
* **prefix-cached** (``prefix_cache=True``, int8 KV): every admission is
  chunked at ``chunk_len == page_size``; a prompt sharing a page-aligned
  prefix with an earlier one maps its leading page-table rows to the
  donor's pages (``PrefixCache.acquire``) and feeds from the first
  divergent page, bitwise the same prompt served cold.

Robustness: typed refusals (``Refused``: 'too_large' a 413, 'queue' a
429 with a throughput-derived ``retry_after``, 'draining' a 503);
``deadline_s`` anchored at submission (queue time counts) and
``deadline_steps`` at admission; ``cancel()`` frees the slot at the next
round; snapshots every ``snapshot_every`` rounds with failover replay
(``FailureInjector`` device loss, ``StepHang``, ``IntegrityReplay``)
that never re-streams a token (the ``sent`` cursors live outside the
snapshot); a quarantined request (``monitor``) is served again down the
degradation ladder at once, its stream sees ``('restart', None)`` and
ends ``degraded``; ``close('drain')`` finishes live requests and
refuses the queued, ``close('snapshot')`` parks them in a blob a new
``Router(resume=blob)`` completes.  Either way the pool drains to zero
live pages.  Every request ends in one of ``ok | deadline | refused |
cancelled | degraded``.

What the port does differently:

* the serve state is written in place and never rebuilt (``done``,
  ``pos``, the page-table row), and snapshots are host copies restored
  into the state's own tensors (runtime/failover.py ``to_host`` /
  ``restore_into``), so the captured segment, extend and probe graphs
  stay bound for the router's life (``stats()['bindings']``);
* the segment and extend steps are built once per macro-fault spec in
  force, each its own graph;
* the host reads back ``done`` and the segment's outputs once a round;
  nothing inside a segment or chunk syncs;
* ``device``: CUDA unless 'cpu' is asked for; the reference's
  ``paged_attn`` and ``prepare`` are gone (the card always takes the
  paged-attention kernel, the CPU its plain version; prepared params pass
  ``prepare_params`` unchanged);
* ``par`` (a ``ParallelCtx``): the reference's mesh serving, SPMD: every
  rank runs its own router on the same submissions, which must reach
  every rank at the same rounds (e.g. all submitted before ``start()``),
  and streams the same tokens.  Wall-clock deadlines are read from the
  first rank's clock (``ParallelCtx.from_first``); integrity checks
  digest each rank's pieces and agree the findings
  (runtime/integrity.py); a weight flip hits the rank whose piece holds
  its element (runtime/failover.py).
"""
from __future__ import annotations

import asyncio
import copy
import dataclasses
import time

import numpy as np
import torch

from ..core.kvcache import (PageAllocator, PrefixCache, admission_pages,
                            cow_fork, n_pages_for)
from ..device import resolve_device
from ..launch.serve import prepare_params
from ..launch.steps import (_check_kv, _parse_spec, init_serve_state,
                            make_admit_fn, make_extend_fn, make_probe_fn,
                            make_segment_fn, pin_paged_attn)
from .failover import (IntegrityReplay, SimulatedHardwareFailure,
                       restore_into, to_host)
from .integrity import IntegrityEngine, parse_integrity
from .serving import _escalate, exact_probe_spec
from .watchdog import StepHang

__all__ = ["Router", "RequestHandle", "RouterResult", "Refused",
           "STATUS_OK", "STATUS_DEADLINE", "STATUS_REFUSED",
           "STATUS_CANCELLED", "STATUS_DEGRADED", "TERMINAL_STATUSES"]

STATUS_OK = "ok"
STATUS_DEADLINE = "deadline"
STATUS_REFUSED = "refused"
STATUS_CANCELLED = "cancelled"
STATUS_DEGRADED = "degraded"
TERMINAL_STATUSES = (STATUS_OK, STATUS_DEADLINE, STATUS_REFUSED,
                     STATUS_CANCELLED, STATUS_DEGRADED)

_RECOVERABLE = (SimulatedHardwareFailure, StepHang, IntegrityReplay)


class Refused(Exception):
    """Typed admission refusal (the 429/413/503 surface).

    ``reason``: 'queue' (transient overload: retry after ``retry_after``
    seconds), 'too_large' (permanent: the request cannot fit this
    router's capacity or page pool), 'draining' (shutdown in progress:
    retry against another replica)."""

    def __init__(self, reason: str, retry_after: float | None = None,
                 detail: str = ""):
        self.reason = reason
        self.retry_after = retry_after
        super().__init__(f"admission refused ({reason})"
                         + (f": {detail}" if detail else ""))


@dataclasses.dataclass
class RouterResult:
    status: str
    tokens: list


class _Request:
    """Host-side request record: the client-visible half (the stream
    queue and its ``sent`` cursor), which stays out of failover snapshots
    so a replay never re-streams.  Tokens, status and admission anchors
    live in the engine's host books."""

    __slots__ = ("rid", "prompt", "max_new", "deadline_s", "deadline_steps",
                 "priority", "submit_t", "queue", "sent", "cancelled",
                 "restart_sent", "ended")

    def __init__(self, rid, prompt, max_new, deadline_s, deadline_steps,
                 priority, submit_t):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.deadline_s = deadline_s
        self.deadline_steps = deadline_steps
        self.priority = int(priority)
        self.submit_t = submit_t
        self.queue: asyncio.Queue = asyncio.Queue()
        self.sent = 0
        self.cancelled = False
        self.restart_sent = False
        self.ended = False

    def descriptor(self) -> dict:
        """Plain-data re-submission record for ``close('snapshot')``."""
        return {"rid": self.rid, "prompt": self.prompt.tolist(),
                "max_new": self.max_new, "deadline_s": self.deadline_s,
                "deadline_steps": self.deadline_steps,
                "priority": self.priority}


class RequestHandle:
    """Client handle: an event stream plus cancellation.

    ``events()`` yields ``('token', id)`` per streamed token,
    ``('restart', None)`` when a quarantined request is served again down
    the degradation ladder (the tokens streamed before are void), and a
    final ``('end', status)``.  ``result()`` folds that stream into a
    ``RouterResult``.  Consume one of the two: they share the queue."""

    def __init__(self, req: _Request):
        self._req = req

    @property
    def rid(self) -> int:
        return self._req.rid

    def cancel(self) -> None:
        """Client disconnect: the engine frees the slot and recycles its
        pages at the next round boundary (status ``cancelled``)."""
        self._req.cancelled = True

    async def events(self):
        while True:
            ev = await self._req.queue.get()
            yield ev
            if ev[0] == "end":
                return

    async def result(self) -> RouterResult:
        tokens: list = []
        async for kind, val in self.events():
            if kind == "token":
                tokens.append(int(val))
            elif kind == "restart":
                tokens.clear()
            else:
                return RouterResult(status=val, tokens=tokens)
        raise AssertionError("event stream ended without a terminal status")


class Router:
    """Asyncio serving frontend over the continuous-batching scheduler.

    ``params`` are prepared once here (launch/serve.py
    ``prepare_params``, a no-op for prepared params, so the reference's
    ``prepare`` keyword is gone).  ``buckets`` lists the one-shot
    prefill lengths; any other prompt length <= ``max_prompt`` is
    chunked.
    ``max_new_cap`` bounds a request's budget (page grants are sized from
    it).  ``monitor`` / ``injector`` / ``snapshot_every`` /
    ``max_replays`` / ``integrity`` are the scheduler's knobs with the
    same meaning; ``spec`` turns decode segments into self-speculative
    windows; ``prefix_cache`` shares int8 pages across page-aligned
    prefixes (every admission chunked at ``chunk_len == page_size``).
    ``device``: CUDA unless 'cpu' is asked for.  Call ``await start()``
    before ``submit`` streams anything (requests submitted before are
    taken in submission order at the first round)."""

    def __init__(self, cfg, params, *, slots: int = 4, seg_len: int = 4,
                 kv: str = "int8", page_size: int = 8,
                 n_pages: int | None = None,
                 buckets: tuple = (8, 16, 32), chunk_len: int = 16,
                 max_prompt: int = 256, max_new_cap: int = 64,
                 max_queue: int = 64, eos_id: int | None = -1,
                 sample: str = "greedy", spec: str | None = None,
                 rng_seed: int = 0, monitor=None,
                 injector=None, snapshot_every: int = 0,
                 max_replays: int = 3, integrity: str = "off",
                 prefix_cache: bool = False, resume: dict | None = None,
                 device=None, log=print, par=None,
                 paged_attn: str = "auto"):
        cfg = pin_paged_attn(cfg, paged_attn)    # serve_batch's option
        _check_kv(cfg, kv)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.par = par
        self.params = prepare_params(cfg, params, self.device, par)
        self.slots = slots
        self.seg_len = seg_len
        self.kv = kv
        self.page_size = page_size
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.chunk_len = int(chunk_len)
        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache:
            if kv != "int8":
                raise ValueError("prefix caching shares int8 physical "
                                 "pages; pass kv='int8'")
            # hits and misses run the one extend graph at chunk_len ==
            # page_size from the first divergent page: the bitwise
            # hit-vs-cold contract
            self.chunk_len = self.page_size
        self.max_prompt = int(max_prompt)
        self.max_new_cap = int(max_new_cap)
        self.max_queue = int(max_queue)
        self.eos_id = eos_id
        self.eos = -1 if eos_id is None else eos_id
        self.sample = sample
        self.spec = spec
        self.rng_seed = rng_seed
        self.monitor = monitor
        self.injector = injector
        self.snapshot_every = snapshot_every
        self.max_replays = max_replays
        self.log = log

        sp = _parse_spec(spec)
        k_spec = sp[1] if sp else 0
        # in-flight writes past the committed position: a spec window's k
        # drafts, a padded last chunk's chunk_len - 1 pad positions
        self.headroom_bucket = k_spec
        self.headroom_chunked = max(k_spec, self.chunk_len - 1)
        self.capacity = self.max_prompt + self.max_new_cap \
            + max(self.headroom_bucket, self.headroom_chunked)
        self.mp = n_pages_for(self.capacity, page_size)
        period = parse_integrity(integrity)
        if period > 0 and kv != "int8":
            raise ValueError("integrity checksums cover the int8 paged "
                             "cache; use kv='int8' or integrity='off'")
        self._integrity = None
        if period > 0:
            from ..core.qweights import golden_weight_copy
            # repairs restore the planes in place: self.params keeps its
            # binding
            self._integrity = IntegrityEngine(
                golden_weight_copy(self.params), period=period, par=par)
        self._state = init_serve_state(cfg, slots, self.capacity, kv=kv,
                                       page_size=page_size, n_pages=n_pages,
                                       seed=rng_seed, integrity=period > 0,
                                       device=self.device)
        self._alloc = PageAllocator(self._state["cache"]["k_pages"].shape[1]) \
            if kv == "int8" else None
        self.n_pages = self._alloc.n_pages if self._alloc is not None else None
        self._no_pages = torch.zeros((self.mp,), dtype=torch.int32,
                                     device=self.device)
        self._prefix = PrefixCache(self._alloc, page_size) \
            if self.prefix_cache else None

        # the step functions of each macro-fault spec in force, made once:
        # their graphs stay bound to this router's state
        self._fns: dict = {}
        self._steps_for("")
        self._probe = None
        if monitor is not None and monitor.rel_threshold is not None:
            if cfg.dscim in ("off", "float"):
                raise ValueError("drift probes need a dscim serving spec "
                                 "(see runtime/serving.py)")
            self._probe = make_probe_fn(dataclasses.replace(
                cfg, dscim=exact_probe_spec(cfg.dscim), dscim_fault=""),
                par=par)
        self._k_spec = k_spec

        # host bookkeeping: everything the failover snapshot must carry
        self._host = {
            "slot_rid": [-1] * slots,        # rid per slot (-1 free)
            "slot_pages": [None] * slots,
            "slot_phase": ["idle"] * slots,  # idle | prefill | decode
            "slot_fed": [0] * slots,         # chunked-prefill cursor
            "waiting": [],                   # admission queue (rids)
            "out": {},                       # rid -> [token, ...]
            "status": {},                    # rid -> None | terminal
            "restarted": {},                 # rid -> bool (ladder re-serve)
            "admit_t": {},                   # rid -> wall admission anchor
            "admit_step": {},                # rid -> global_step at admission
            "segments": 0, "global_step": 0,
            "live_steps": 0, "total_steps": 0,
            "prefill_computed": 0, "prefill_total": 0,
            "counters": {"deadline_cancelled": 0, "cancelled": 0,
                         "quarantined": 0, "degraded": 0, "refused_queue": 0,
                         "refused_too_large": 0, "refused_draining": 0},
        }
        self._requests: dict = {}            # rid -> _Request (NOT snapshot)
        # rids a page flip hit (port; NOT snapshot): their clients may
        # have been streamed tokens decoded from the flipped page, which
        # a restore from before the flip cannot take back
        self._corrupted: list = []
        self._inbox: list = []               # submitted, not yet ingested
        self._next_rid = 0
        self._replays = 0
        self._snap = None
        self._vsnap = None       # last integrity-verified snapshot
        self._draining = False
        self._drain_mode = "drain"
        self._engine_task = None
        self._wake: asyncio.Event | None = None
        self._tok_s_ema = 0.0
        self._t_start = time.perf_counter()
        self._resume_handles: dict = {}
        self._snapshot_blob = None
        # port-only measurements, outside the snapshot: admission
        # latencies (path -> seconds), the chunked admissions in flight,
        # snapshot copies, the ladder's serve_batch calls
        self._lat = {"bucket": [], "chunked_miss": [], "chunked_hit": []}
        self._chunk_t0: dict = {}
        self._snaps = {"count": 0, "snapshot_s": 0.0, "restores": 0,
                       "restore_s": 0.0}
        self._ladder = {"s": 0.0, "captures": 0, "records": []}
        if resume is not None:
            self._restore_blob(resume)

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------

    async def start(self) -> None:
        """Spawn the engine task on the running loop."""
        if self._engine_task is not None:
            return
        self._wake = asyncio.Event()
        self._engine_task = asyncio.create_task(self._engine())

    def _need_pages(self, prompt_len: int, max_new: int,
                    chunked: bool) -> int:
        head = self.headroom_chunked if chunked else self.headroom_bucket
        return admission_pages(prompt_len, max_new, self.page_size, head)

    def _queue_depth(self) -> int:
        return len(self._inbox) + len(self._host["waiting"])

    def _retry_after(self) -> float:
        """Throughput-derived backoff hint: the queued and live token debt
        over the recent useful tok/s (floored, so a cold router still
        hints something finite)."""
        debt = 0
        for rid in self._host["waiting"] + self._inbox:
            rq = self._requests[rid]
            debt += len(rq.prompt) + rq.max_new
        for rid in self._host["slot_rid"]:
            if rid >= 0:
                debt += self._requests[rid].max_new
        return debt / max(self._tok_s_ema, 1.0)

    def submit(self, prompt, max_new: int, *, deadline_s: float | None = None,
               deadline_steps: int | None = None,
               priority: int = 0) -> RequestHandle:
        """Admit one streaming request, or raise ``Refused``.

        ``prompt``: 1-D token ids (any length <= ``max_prompt``).
        ``max_new``: the generation budget (<= ``max_new_cap``), the first
        prefill-sampled token included.  ``deadline_s`` anchors at this
        call (queue time counts); ``deadline_steps`` at admission.
        ``priority`` orders admission only (higher first, FIFO within a
        class): the router never preempts a live slot."""
        if self._draining:
            self._host["counters"]["refused_draining"] += 1
            raise Refused("draining")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        S = len(prompt)
        if S < 1 or S > self.max_prompt or max_new < 1 \
                or max_new > self.max_new_cap:
            self._host["counters"]["refused_too_large"] += 1
            raise Refused("too_large", detail=(
                f"prompt {S} tokens / budget {max_new} vs max_prompt "
                f"{self.max_prompt} / max_new_cap {self.max_new_cap}"))
        chunked = self.prefix_cache or S not in self.buckets
        need = self._need_pages(S, max_new, chunked)
        if self.n_pages is not None and need > self.n_pages:
            self._host["counters"]["refused_too_large"] += 1
            raise Refused("too_large", detail=(
                f"{need} pages needed, pool holds {self.n_pages}"))
        if self._queue_depth() >= self.max_queue:
            self._host["counters"]["refused_queue"] += 1
            raise Refused("queue", retry_after=self._retry_after(),
                          detail=f"admission queue at {self.max_queue}")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, prompt, max_new, deadline_s, deadline_steps,
                       priority, time.perf_counter())
        self._requests[rid] = req
        self._inbox.append(rid)
        if self._wake is not None:
            self._wake.set()
        return RequestHandle(req)

    async def close(self, mode: str = "drain") -> dict | None:
        """Graceful shutdown.  'drain': stop admission, serve live requests
        to completion, end still-queued streams ``refused`` (retryable
        elsewhere).  'snapshot': stop admission, park live and queued
        requests in a resumable blob (returned; feed it to
        ``Router(..., resume=blob)``) and end their streams
        ``cancelled``.  Either way every granted page is freed."""
        if mode not in ("drain", "snapshot"):
            raise ValueError(f"close mode must be 'drain' or 'snapshot', "
                             f"got {mode!r}")
        self._draining = True
        self._drain_mode = mode
        if self._wake is not None:
            self._wake.set()
        if self._engine_task is not None:
            await self._engine_task
            self._engine_task = None
        return self._snapshot_blob

    def resume_handles(self) -> dict:
        """rid -> RequestHandle for requests revived from a resume blob
        (their streams start over from token 0: the clients of the
        snapshot are gone)."""
        return dict(self._resume_handles)

    def stats(self) -> dict:
        """The reference's keys, then the port's: ``bindings`` (runners
        made for a new state, params or fault binding, each a capture on
        the card: {"segment", "extend", "probe"}), ``capture_s`` (their
        captures' seconds), ``admit_lat`` (admission to first
        token, seconds: 'bucket', 'chunked_miss', 'chunked_hit' (a
        prefix hit); a chunked admission's spans the segments between
        its chunks), ``corrupted_requests`` (the rids whose slot an
        injected page flip hit, silent corruption the flips' effect
        decides; kept through a replay that restores from before the
        flip, since tokens streamed meanwhile stay streamed),
        ``snapshots`` (host copies and restores, counts and seconds) and
        ``ladder`` (the re-serves' wall seconds, the decode graphs
        their ``serve_batch`` captured and each rung's record) and
        ``eager_reason`` (why the segments stepped eagerly where graphs
        were asked for: a gloo mesh on CUDA; else None)."""
        h = self._host
        dt = time.perf_counter() - self._t_start
        useful = sum(len(o) for o in h["out"].values())
        done = [s for s in h["status"].values() if s is not None]
        segs = [f[0] for f in self._fns.values()]
        exts = [f[1] for f in self._fns.values()]

        def captured(fn):
            run = fn.runs.get("run")
            return run.step.capture_s if run is not None else 0.0

        return {
            "submitted": self._next_rid,
            "completed": len(done),
            "statuses": {s: done.count(s) for s in TERMINAL_STATUSES
                         if done.count(s)},
            "refusals": {k[8:]: v for k, v in h["counters"].items()
                         if k.startswith("refused_")},
            "counters": dict(h["counters"]),
            "segments": h["segments"],
            "replays": self._replays,
            "useful_tokens": useful,
            "tok_s": useful / max(dt, 1e-9),
            "occupancy": h["live_steps"] / max(h["total_steps"], 1),
            "pages": self._alloc.stats() if self._alloc is not None else None,
            "prefix": (dict(self._prefix.stats(),
                            prefill_positions_computed=h["prefill_computed"],
                            prefill_positions_total=h["prefill_total"])
                       if self._prefix is not None else None),
            "queue_depth": self._queue_depth(),
            "integrity": (dict(self._integrity.stats(),
                               detections=self._integrity.detections)
                          if self._integrity is not None else None),
            "bindings": {"segment": sum(f.runs["bindings"] for f in segs),
                         "extend": sum(f.runs["bindings"] for f in exts),
                         "probe": self._probe.runs["bindings"]
                         if self._probe is not None else 0},
            "capture_s": {"segment": sum(captured(f) for f in segs),
                          "extend": sum(captured(f) for f in exts)},
            "admit_lat": {k: list(v) for k, v in self._lat.items()},
            "corrupted_requests": sorted(self._corrupted),
            "snapshots": dict(self._snaps),
            "ladder": dict(self._ladder,
                           records=list(self._ladder["records"])),
            "eager_reason": next((f.eager_reason for f in segs
                                  if f.eager_reason), None),
        }

    # ------------------------------------------------------------------
    # failover snapshot/restore
    # ------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _take_snapshot(self) -> dict:
        t = time.perf_counter()
        snap = {"state": to_host(self._state),
                "host": copy.deepcopy(self._host),
                "alloc": self._alloc.snapshot()
                if self._alloc is not None else None,
                "prefix": self._prefix.snapshot()
                if self._prefix is not None else None}
        self._snaps["count"] += 1
        self._snaps["snapshot_s"] += time.perf_counter() - t
        return snap

    def _restore_blob(self, blob: dict) -> None:
        t = time.perf_counter()
        restore_into(self._state, blob["state"])
        self._sync()
        self._snaps["restores"] += 1
        self._snaps["restore_s"] += time.perf_counter() - t
        self._host = copy.deepcopy(blob["host"])
        if blob["alloc"] is not None:
            self._alloc = PageAllocator.from_snapshot(blob["alloc"])
        if blob.get("prefix") is not None:
            self._prefix = PrefixCache.from_snapshot(blob["prefix"],
                                                     self._alloc)
        elif self._prefix is not None:
            # a prefix router resumed from a blob without an index: start
            # a fresh one on the restored allocator
            self._prefix = PrefixCache(self._alloc, self.page_size)
        # arrivals ingested after the snapshot vanish from the restored
        # books: ingest again anything they do not know
        for rid in sorted(self._requests):
            if rid not in self._host["status"] and rid not in self._inbox:
                self._inbox.append(rid)
        # blobs of close('snapshot') carry request descriptors
        for d in blob.get("requests", ()):
            rid = int(d["rid"])
            if rid in self._requests:
                continue
            req = _Request(rid, d["prompt"], d["max_new"], d["deadline_s"],
                           d["deadline_steps"], d["priority"],
                           time.perf_counter())
            self._requests[rid] = req
            self._resume_handles[rid] = RequestHandle(req)
            self._next_rid = max(self._next_rid, rid + 1)

    # ------------------------------------------------------------------
    # the engine
    # ------------------------------------------------------------------

    def _steps_for(self, fault: str):
        """(segment, extend) of the macro-fault spec ``fault`` ('' =
        healthy), made at its first use."""
        if fault not in self._fns:
            c = dataclasses.replace(self.cfg, dscim_fault=fault) \
                if fault else self.cfg
            self._fns[fault] = (
                make_segment_fn(c, self.seg_len, eos_id=self.eos_id,
                                sample=self.sample, spec=self.spec,
                                par=self.par),
                make_extend_fn(c, self.chunk_len, eos_id=self.eos_id,
                               sample=self.sample, par=self.par))
        return self._fns[fault]

    @property
    def _fault_now(self) -> str:
        """The macro fault in force this segment: a persistent injected
        fault serves through the faulted config, as the scheduler does."""
        return self.injector.serving_fault(self._host["segments"]) \
            if self.injector is not None else ""

    def _finish(self, rid: int, status: str) -> None:
        if self._host["status"].get(rid) is None:
            self._host["status"][rid] = status

    def _free_slot(self, b: int) -> None:
        h = self._host
        self._chunk_t0.pop(h["slot_rid"][b], None)
        if self._alloc is not None and h["slot_pages"][b] is not None:
            self._alloc.free(h["slot_pages"][b])
            h["slot_pages"][b] = None
        h["slot_rid"][b] = -1
        h["slot_phase"][b] = "idle"
        h["slot_fed"][b] = 0

    def _release(self, rid: int, status: str) -> None:
        """Terminal-status a request wherever it lives now."""
        h = self._host
        self._finish(rid, status)
        if rid in h["waiting"]:
            h["waiting"].remove(rid)
        for b in range(self.slots):
            if h["slot_rid"][b] == rid:
                self._free_slot(b)
                self._state["done"][b] = True

    def _expired(self, rid: int, now: float) -> bool:
        h = self._host
        if h["status"].get(rid) is not None:
            return False
        req = self._requests[rid]
        if req.deadline_steps is not None and rid in h["admit_step"] \
                and h["global_step"] - h["admit_step"][rid] \
                >= int(req.deadline_steps):
            return True
        # an end-to-end budget: anchored at submission, queue time counts
        return req.deadline_s is not None and req.deadline_s > 0 \
            and now - req.submit_t >= float(req.deadline_s)

    def _ingest(self) -> None:
        """Move submitted requests into the admission queue, priority
        first (submission order within a class)."""
        h = self._host
        if not self._inbox:
            return
        for rid in self._inbox:
            h["status"].setdefault(rid, None)
            h["out"].setdefault(rid, [])
            h["waiting"].append(rid)
        self._inbox.clear()
        h["waiting"].sort(key=lambda r: (-self._requests[r].priority, r))

    def _admit_waiting(self) -> None:
        """Fill free slots head-of-line from the admission queue (no
        skip-ahead: a big request at the head holds its place, admission
        order is the priority contract)."""
        h = self._host
        cache = self._state["cache"]
        for b in range(self.slots):
            if h["slot_rid"][b] >= 0 or not h["waiting"]:
                continue
            rid = h["waiting"][0]
            req = self._requests[rid]
            S = len(req.prompt)
            chunked = self.prefix_cache or S not in self.buckets
            pages = self._no_pages
            d_shared = 0
            if self._alloc is not None:
                need = self._need_pages(S, req.max_new, chunked)
                shared: list = []
                if self._prefix is not None:
                    _n, shared = self._prefix.acquire(
                        req.prompt, (S - 1) // self.page_size)
                d_shared = len(shared)
                fresh = self._alloc.alloc(need - d_shared)
                if fresh is None:
                    if shared:             # return the borrowed refs
                        self._alloc.free(shared)
                    return                     # pool exhausted: wait
                ids = shared + fresh
                h["slot_pages"][b] = ids
                pages = ids + [ids[-1]] * (self.mp - need)
            h["waiting"].pop(0)
            h["slot_rid"][b] = rid
            t_adm = time.perf_counter()
            h["admit_t"][rid] = t_adm
            h["admit_step"][rid] = h["global_step"]
            if chunked:
                # begin-admit, in place: point the slot's page-table row
                # at its grant and its position past any shared prefix;
                # the slot stays done-masked until the last chunk emits
                if self._prefix is not None and h["slot_pages"][b]:
                    # the copy-on-write enforcement point (a checked
                    # no-op: sharing stops below the write frontier)
                    _, ids, _ = cow_fork(cache, self._alloc,
                                         h["slot_pages"][b],
                                         start_idx=d_shared)
                    h["slot_pages"][b] = ids
                    pages = ids + [ids[-1]] * (self.mp - len(ids))
                fed0 = d_shared * self.page_size
                cache["pos"][b] = fed0
                if "page_table" in cache:
                    cache["page_table"][b].copy_(torch.as_tensor(
                        pages, dtype=torch.int32, device=self.device))
                self._state["done"][b] = True
                h["slot_phase"][b] = "prefill"
                h["slot_fed"][b] = fed0
                h["prefill_computed"] += S - fed0
                h["prefill_total"] += S
                self._chunk_t0[rid] = (t_adm, d_shared > 0)
            else:
                fault = self._fault_now
                admit = make_admit_fn(
                    dataclasses.replace(self.cfg, dscim_fault=fault)
                    if fault else self.cfg,
                    eos_id=self.eos_id, sample=self.sample, par=self.par)
                prompt = torch.as_tensor(req.prompt[None], dtype=torch.long,
                                         device=self.device)
                _, tok0 = admit(self.params, self._state, prompt, b, pages,
                                req.max_new)
                h["out"][rid].append(int(tok0))    # sync: the latency is real
                self._lat["bucket"].append(time.perf_counter() - t_adm)
                h["slot_phase"][b] = "decode"

    def _feed_chunks(self) -> None:
        """One prompt chunk per prefilling slot a round: long admissions
        interleave with decode segments instead of stalling them."""
        h = self._host
        C = self.chunk_len
        extend = self._steps_for(self._fault_now)[1]
        for b in range(self.slots):
            if h["slot_phase"][b] != "prefill":
                continue
            rid = h["slot_rid"][b]
            req = self._requests[rid]
            fed = h["slot_fed"][b]
            part = req.prompt[fed:fed + C]
            n_real = len(part)
            if n_real < C:
                part = np.pad(part, (0, C - n_real))
            emit = fed + n_real >= len(req.prompt)
            _, tok0 = extend(self.params, self._state, part[None], b,
                             n_real, emit, req.max_new)
            h["slot_fed"][b] = fed + n_real
            if emit:
                h["out"][rid].append(int(tok0))
                h["slot_phase"][b] = "decode"
                t0, hit = self._chunk_t0.pop(rid, (None, False))
                if t0 is not None:
                    self._lat["chunked_hit" if hit else "chunked_miss"] \
                        .append(time.perf_counter() - t0)
                if self._prefix is not None and h["slot_pages"][b]:
                    # every fully flushed prompt page is now immutable:
                    # index it for reuse
                    self._prefix.register(
                        req.prompt,
                        h["slot_pages"][b][:len(req.prompt)
                                           // self.page_size])

    def _ladder_reserve(self, rid: int, reason: str) -> None:
        """A quarantined request: serve it again from its prompt down the
        degradation ladder (runtime/serving.py ``_escalate`` for one
        request, through ``serve_batch`` on the prepared params), each
        intermediate level checked against its exact twin.  Terminal
        status ``degraded``: the client sees a restart event and a
        definite, verified output."""
        t_lad = time.perf_counter()
        h = self._host
        req = self._requests[rid]
        one = {"quarantine": [{"request": 0, "reason": reason}],
               "status": {0: None}, "out": {}}
        records: list = []
        self._ladder["captures"] += _escalate(
            self.cfg, self.params, req.prompt[None], req.max_new, one,
            [req.max_new], eos_id=self.eos, sample=self.sample, kv=self.kv,
            page_size=self.page_size, rng_seed=self.rng_seed,
            monitor=self.monitor, records=records, device=self.device,
            log=self.log, par=self.par)
        self._ladder["records"] += [dict(r, request=rid) for r in records]
        h["out"][rid] = one["out"][0]
        h["status"][rid] = STATUS_DEGRADED
        h["counters"]["degraded"] += 1
        self._ladder["s"] += time.perf_counter() - t_lad

    def _check_integrity(self) -> None:
        """The due boundary's sweeps: weight planes against their golden
        digests (a mismatch is restored in place) and the granted, fully
        flushed pages against their digests.  Any finding restores the
        last verified snapshot and replays (``IntegrityReplay``): repaired
        weights persist, transient flips fire once, so the replay runs
        clean.  Otherwise this boundary becomes the verified snapshot."""
        h = self._host
        cache = self._state["cache"] if self._alloc is not None else None
        # both sweeps and the slots' positions in one host read
        sweep = self._integrity.sweep(
            self.params, cache, None if cache is None else cache["pos"])
        bad_w = self._integrity.check_weights(self.params, sweep)
        if bad_w:
            self._integrity.repair_weights(self.params, bad_w)
            self.log(f"[router] integrity: weight plane(s) {bad_w} "
                     "restored from golden copy")
        coords = []
        if cache is not None:
            live_pages = np.zeros((self._alloc.n_pages,), bool)
            for b in range(self.slots):
                ids = h["slot_pages"][b]
                if ids is not None:
                    for p in ids[:int(sweep.pos[b]) // self.page_size]:
                        live_pages[int(p)] = True
            coords = self._integrity.check_pages(cache, live_pages, sweep)
            if coords:
                self.log(f"[router] integrity: corrupted page(s) at "
                         f"(layer, page) {coords}")
        if bad_w or coords:
            self._integrity.note_replay()
            self._snap = self._vsnap
            raise IntegrityReplay(
                f"weights {bad_w or 'clean'}, pages {coords or 'clean'}")
        self._vsnap = self._take_snapshot()

    def _round(self) -> bool:
        """One engine round: ingest, cancellations, harvest, deadlines,
        admissions, one chunk per prefilling slot, one decode segment if
        anything is live.  Returns True while a request can still make
        progress."""
        h = self._host
        seg = h["segments"]
        if self._snap is not None and self.snapshot_every > 0 \
                and seg % self.snapshot_every == 0:
            self._snap = self._take_snapshot()
        if self.injector is not None:
            self.injector.maybe_fail(seg)

        self._ingest()
        now = time.perf_counter()
        for rid, req in self._requests.items():        # cancellations
            if req.cancelled and h["status"].get(rid) is None:
                self._release(rid, STATUS_CANCELLED)
                h["counters"]["cancelled"] += 1
        done_h = self._state["done"].cpu().numpy()
        for b in range(self.slots):                    # harvest finished
            rid = h["slot_rid"][b]
            if rid >= 0 and h["slot_phase"][b] == "decode" and done_h[b]:
                self._free_slot(b)
                self._finish(rid, STATUS_OK)
        rids = list(h["status"])
        expired = [self._expired(rid, now) for rid in rids]
        if self.par is not None and any(
                self._requests[rid].deadline_s for rid in rids):
            # wall budgets by the first rank's clock: every rank cancels
            # the same requests at the same round
            expired = self.par.from_first(expired)
        for rid, gone in zip(rids, expired):           # deadline sweep
            if gone:
                self._release(rid, STATUS_DEADLINE)
                h["counters"]["deadline_cancelled"] += 1
        if self._draining:
            if self._drain_mode == "snapshot":
                return self._drain_snapshot()
            for rid in list(h["waiting"]):   # drain: shed the queue,
                self._release(rid, STATUS_REFUSED)     # retryable elsewhere
                h["counters"]["refused_draining"] += 1
        else:
            self._admit_waiting()
        self._feed_chunks()

        live_b = [b for b in range(self.slots)
                  if h["slot_rid"][b] >= 0 and h["slot_phase"][b] == "decode"]
        live0 = np.zeros((self.slots,), bool)
        if live_b:
            done_h = self._state["done"].cpu().numpy()
            for b in live_b:
                live0[b] = not done_h[b]
        if not live0.any():
            prefilling = any(p == "prefill" for p in h["slot_phase"])
            return bool(h["waiting"]) or bool(self._inbox) or prefilling \
                or any(r >= 0 for r in h["slot_rid"])

        lg_exact = None
        if self._probe is not None and self.monitor.should_probe(seg):
            lg_exact = self._probe(self.params, self._state).cpu().numpy()
        if self.injector is not None and self._alloc is not None:
            # flips XOR into the live tensors: the graphs read them
            _, hit = self.injector.corrupt_cache(seg, self._state["cache"],
                                                 h["slot_pages"])
            for b in hit:
                rid = h["slot_rid"][b]
                if rid >= 0 and rid not in self._corrupted:
                    self._corrupted.append(rid)
        if self.injector is not None and self.injector.weight_flips:
            self.injector.corrupt_weights(seg, self.params, self.par)
        if self._integrity is not None and self._integrity.due(seg):
            self._check_integrity()
        segment = self._steps_for(self._fault_now)[0]
        _, toks, lives, aux = segment(self.params, self._state)
        toks_h, lives_h = toks.cpu().numpy(), lives.cpu().numpy()
        for s in range(toks_h.shape[0]):               # harvest tokens
            for b in range(self.slots):
                if lives_h[s, b] and h["slot_rid"][b] >= 0:
                    h["out"][h["slot_rid"][b]].append(int(toks_h[s, b]))
        if self.monitor is not None:
            nan = aux["bad"].cpu().numpy().any(axis=0)
            trip = nan.copy()
            if lg_exact is not None:
                t2, _ = self.monitor.check(aux["logits0"].cpu().numpy(),
                                           lg_exact, live0)
                trip |= t2
            for b in np.nonzero(trip)[0].tolist():
                rid = h["slot_rid"][b]
                if rid < 0:
                    continue
                self._free_slot(b)
                self._state["done"][b] = True
                h["out"][rid] = []          # discard poisoned tokens
                h["restarted"][rid] = True
                h["counters"]["quarantined"] += 1
                self._ladder_reserve(rid, "nan" if nan[b] else "drift")
        h["live_steps"] += int(lives_h.sum())
        h["total_steps"] += toks_h.shape[0] * self.slots
        h["segments"] += 1
        h["global_step"] += self.seg_len * (self._k_spec + 1)
        return True

    def _drain_snapshot(self) -> bool:
        """snapshot-mode close: park every live or prefilling request's
        descriptor with the whole serve state, free every page, end the
        streams ``cancelled``."""
        h = self._host
        parked = [rid for rid in h["status"] if h["status"][rid] is None]
        blob = self._take_snapshot()
        blob["requests"] = [self._requests[rid].descriptor()
                            for rid in parked]
        self._snapshot_blob = blob
        for rid in parked:
            self._release(rid, STATUS_CANCELLED)
        return False

    def _flush_streams(self) -> None:
        """Push newly harvested tokens and terminal statuses to the client
        queues.  A failover replay regrows ``out`` under the ``sent``
        cursors bit for bit, so nothing re-streams; a ladder re-serve
        flips ``restarted`` and streams again from zero behind a restart
        event."""
        h = self._host
        for rid, req in self._requests.items():
            if req.ended:
                continue
            out = h["out"].get(rid)
            if out is None:
                continue
            if h["restarted"].get(rid) and not req.restart_sent:
                req.queue.put_nowait(("restart", None))
                req.restart_sent = True
                req.sent = 0
            while req.sent < len(out):
                req.queue.put_nowait(("token", out[req.sent]))
                req.sent += 1
            status = h["status"].get(rid)
            if status is not None and req.sent >= len(out):
                req.queue.put_nowait(("end", status))
                req.ended = True

    async def _engine(self) -> None:
        if self.injector is not None or self.snapshot_every > 0 \
                or self._integrity is not None:
            # the initial state is integrity-verified by construction
            self._snap = self._take_snapshot()
            self._vsnap = self._snap
        emitted_before = 0
        t_last = time.perf_counter()
        while True:
            try:
                busy = self._round()
            except _RECOVERABLE as e:
                self._replays += 1
                self.log(f"[router] {type(e).__name__}: {e}; replay "
                         f"{self._replays}/{self.max_replays}")
                if self._snap is None or self._replays > self.max_replays:
                    # unrecoverable: every request still gets a definite
                    # status
                    self._ingest()
                    for rid in list(self._host["status"]):
                        if self._host["status"][rid] is None:
                            self._release(rid, STATUS_CANCELLED)
                    self._flush_streams()
                    return
                self._restore_blob(self._snap)
                continue
            self._flush_streams()
            # throughput EMA for the retry-after hints
            emitted = sum(len(o) for o in self._host["out"].values())
            now = time.perf_counter()
            if now - t_last > 1e-3:
                inst = (emitted - emitted_before) / (now - t_last)
                self._tok_s_ema = inst if self._tok_s_ema == 0.0 \
                    else 0.8 * self._tok_s_ema + 0.2 * inst
                emitted_before, t_last = emitted, now
            if self._draining and not busy and not self._inbox:
                self._flush_streams()
                return
            if busy or self._inbox:
                await asyncio.sleep(0)
            else:
                # idle: wait for a submission, cancel or close, waking
                # now and then so wall deadlines on queued work expire
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=0.05)
                except asyncio.TimeoutError:
                    pass
