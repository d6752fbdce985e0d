"""Continuous-batching scheduler with its fault handling and the prefix
cache (port of ``serve_continuous_ft`` and ``prefix_drill`` from
``repro/runtime/serving.py``).

Between segments (``launch/steps.py make_segment_fn``: ``seg_len``
replays of the captured done-masked decode step over the persistent
serve state) the host harvests finished slots, returns their pages to
the ``PageAllocator``, and admits waiting requests into the freed slots,
granting each its pages or leaving it queued while the pool is full
(backpressure).  An admission is one eager prefill (``make_admit_fn``),
or under ``prefix_cache`` page-aligned chunks of one captured extend
graph (``make_extend_fn``) that start at the first page the prefix index
does not hold.  Under ``spec`` each segment step is a self-speculative
draft/verify window, so a segment emits up to ``seg_len * (k+1)`` tokens
per slot, and every slot's capacity and page grant carry k positions of
headroom for the draft's in-flight writes.

The fault handling acts only between segments, on the host:

* **Deadlines** (``deadline_steps``: decode steps on the global step
  ledger, deterministic and replay-safe; ``deadline_s``: wall seconds
  from the request's admission, so a queued request never expires): an
  expired request is cancelled with status ``'deadline'`` and keeps its
  partial tokens; its slot and pages recycle at once.
* **Priority eviction** (``priority``, int8 KV only): when the pool
  cannot cover an admission, the youngest live slot of the lowest
  *strictly* lower priority is evicted; its pages, tail, position and
  sampler stream are parked on the host bit for bit
  (``core/kvcache.py extract_slot_pages``) and written back onto fresh
  pages once the pool has room (``insert_slot_pages``), so it resumes as
  if it had never left.
* **Snapshots and failover** (``snapshot_every``, ``injector``): every N
  boundaries the serve state is copied to the host with the scheduler's
  books, the allocator and the prefix index; ``runtime/failover.py
  run_with_failover`` restores the latest snapshot after a recoverable
  failure (``FailureInjector.fail_at``) and replays from it.  A restore
  copies back into the state's own tensors, so the captured segment and
  extend graphs stay bound.

Greedy and sampled decoding replay bit for bit through eviction and
failover: draws are keyed by (seed, the request's stream, its emitted
count), all of which survive both.  The accuracy watchdog and the
integrity checks (``monitor``, ``watchdog``, ``integrity`` and the
injector's flips and macro fault) are ROADMAP A11's second half and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import copy
import time
from time import perf_counter as _clock   # port-only timings

import numpy as np
import torch

__all__ = ["STATUS_OK", "STATUS_DEADLINE", "serve_continuous_ft",
           "prefix_drill"]

STATUS_OK = "ok"
STATUS_DEADLINE = "deadline"


def _req_array(x, R, dtype, name):
    if x is None:
        return None
    arr = np.asarray(x, dtype)
    if arr.shape != (R,):
        raise ValueError(f"{name} must be shape ({R},), got {arr.shape}")
    return arr


def _not_ported(**knobs):
    """Raise for the first knob of ROADMAP A11's second half that is set."""
    for name, value in knobs.items():
        if value not in (None, 0, False, "", "off"):
            raise NotImplementedError(
                f"serve_continuous: {name}={value!r} is not ported yet "
                "(ROADMAP A11: the accuracy watchdog and integrity checks)")


def _to_host(tree: dict) -> dict:
    """A host copy of a serve state: every tensor cloned to the CPU,
    nested dicts copied, plain values as they are."""
    return {k: _to_host(v) if isinstance(v, dict)
            else v.to("cpu", copy=True) if isinstance(v, torch.Tensor)
            else v for k, v in tree.items()}


def _restore(dst: dict, src: dict) -> None:
    """Copy a host snapshot back into the live state's own tensors (the
    captured graphs bound their addresses), plain values by assignment."""
    for k, v in src.items():
        if isinstance(v, dict):
            _restore(dst[k], v)
        elif isinstance(v, torch.Tensor):
            dst[k].copy_(v)
        else:
            dst[k] = v


def serve_continuous_ft(cfg, params, prompts, n_tokens: int, *,
                        slots: int = 4, seg_len: int = 4, max_new=None,
                        eos_id: int | None = None, sample: str = "greedy",
                        kv: str = "float", page_size: int = 8,
                        n_pages: int | None = None, rng_seed: int = 0,
                        deadline_steps=None, deadline_s=None, priority=None,
                        monitor=None, injector=None, snapshot_every: int = 0,
                        max_replays: int = 3, watchdog=None,
                        spec: str | None = None, integrity: str = "off",
                        prefix_cache=False, device=None, log=print):
    """Continuous batching over already-prepared ``params`` on
    ``device`` (launch/serve.py ``serve_continuous`` is the user-facing
    wrapper and documents the arguments).  Returns (outputs, stats):
    ``outputs[r]`` is request r's int32 tokens; ``stats`` has the
    reference's keys (``wall_s``, ``tok_s``, ``occupancy``,
    ``live_slot_steps``, ``slot_steps``, ``segments``, ``requests``,
    ``useful_tokens``, ``status``, ``replays``, ``evictions``,
    ``readmissions``, ``evicted_requests``, ``deadline_cancelled``, the
    allocator's ``pages`` and the prefix cache's ``prefix``, None where
    off) and the port's: ``capture_s`` and ``extend_capture_s`` (seconds
    of the last segment and extend capture, inside ``wall_s``; 0 without
    a graph), ``bindings`` (runners made for a new state or params
    binding, each a capture on the card: {"segment", "extend"}),
    ``extend_launches`` (kernel launches of the extend calls, by counter)
    and ``snapshots`` ({"count", "snapshot_s", "restores",
    "restore_s"}: host copies of the state and copies back)."""
    from ..core.kvcache import (PageAllocator, PrefixCache, admission_pages,
                                cow_fork, extract_slot_pages,
                                insert_slot_pages, n_pages_for)
    from ..launch.steps import (_parse_spec, init_serve_state,
                                make_admit_fn, make_extend_fn,
                                make_segment_fn)
    from .failover import (IntegrityReplay, SimulatedHardwareFailure,
                           run_with_failover)

    _not_ported(monitor=monitor, watchdog=watchdog, integrity=integrity)
    prompts = np.asarray(prompts)
    R, S = prompts.shape
    budgets = np.full((R,), n_tokens, np.int32) if max_new is None \
        else _req_array(max_new, R, np.int32, "max_new")
    if not (budgets >= 1).all():
        raise ValueError(f"budgets must be >= 1, got {budgets.tolist()}")
    dl_steps = _req_array(deadline_steps, R, np.int64, "deadline_steps")
    dl_secs = _req_array(deadline_s, R, np.float64, "deadline_s")
    prio = _req_array(priority, R, np.int64, "priority")
    if prio is not None and kv != "int8":
        raise ValueError("priority eviction preempts physical pages; it "
                         "needs the paged cache (kv='int8')")
    if prefix_cache is True:
        prefix_cache = "on"
    if prefix_cache not in (False, None, "", "off", "on", "cold"):
        raise ValueError(f"prefix_cache must be one of False/'on'/'cold', "
                         f"got {prefix_cache!r}")
    use_prefix = prefix_cache in ("on", "cold")
    if use_prefix and kv != "int8":
        raise ValueError("prefix caching shares int8 physical pages; "
                         "pass kv='int8'")
    # +headroom past prompt + budget: a speculative window may write k
    # draft positions past the committed pos before its rollback, and a
    # chunked prefill up to page_size - 1 pad positions past the prompt
    sp = _parse_spec(spec)
    k_spec = sp[1] if sp else 0
    headroom = max(k_spec, page_size - 1) if use_prefix else k_spec
    capacity = S + int(budgets.max()) + headroom
    mp = n_pages_for(capacity, page_size)
    state = init_serve_state(cfg, slots, capacity, kv=kv,
                             page_size=page_size, n_pages=n_pages,
                             seed=rng_seed, device=device)
    dev = state["tok"].device
    alloc0 = PageAllocator(state["cache"]["k_pages"].shape[1]) \
        if kv == "int8" else None
    pfx0 = PrefixCache(alloc0, page_size) if use_prefix else None
    host0 = {
        "slot_req": [-1] * slots, "slot_pages": [None] * slots,
        "slot_seq": [0] * slots,
        "out": [[] for _ in range(R)], "status": [None] * R,
        "admit_t": [None] * R,
        "next_req": 0, "seq": 0,
        "readmit": [], "evicted": {}, "evicted_ever": [],
        "counters": {"evictions": 0, "readmissions": 0,
                     "deadline_cancelled": 0},
        "segments": 0, "global_step": 0,
        "live_steps": 0, "total_steps": 0,
        "prefill_computed": 0, "prefill_total": 0, "admit_lat": [],
    }
    # made once: their graphs stay bound to the state across restores
    admit = make_admit_fn(cfg, eos_id=eos_id, sample=sample)
    extend = make_extend_fn(cfg, page_size, eos_id=eos_id, sample=sample) \
        if use_prefix else None
    segment = make_segment_fn(cfg, seg_len, eos_id=eos_id, sample=sample,
                              spec=spec)
    snaps = {"count": 0, "snapshot_s": 0.0, "restores": 0, "restore_s": 0.0}
    holder = None
    t0 = time.perf_counter()

    def _expired(host, r, now):
        if host["status"][r] is not None:
            return False
        if dl_steps is not None and dl_steps[r] >= 0 \
                and host["global_step"] >= int(dl_steps[r]):
            return True
        # wall budgets anchor at the request's admission: a late
        # admission gets its full budget, a queued request never expires
        return dl_secs is not None and dl_secs[r] > 0 \
            and host["admit_t"][r] is not None \
            and now - host["admit_t"][r] >= float(dl_secs[r])

    def _snap(host, alloc, pfx):
        t = _clock()
        snap = {"state": _to_host(state), "host": copy.deepcopy(host),
                "alloc": alloc.snapshot() if alloc is not None else None,
                "prefix": pfx.snapshot() if pfx is not None else None}
        snaps["count"] += 1
        snaps["snapshot_s"] += _clock() - t
        return snap

    def _loop(snap):
        if snap is None:
            host, alloc, pfx = host0, alloc0, pfx0
        else:
            t = _clock()
            _restore(state, snap["state"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            snaps["restores"] += 1
            snaps["restore_s"] += _clock() - t
            host = copy.deepcopy(snap["host"])
            alloc = None if snap["alloc"] is None \
                else PageAllocator.from_snapshot(snap["alloc"])
            pfx = None if snap["prefix"] is None \
                else PrefixCache.from_snapshot(snap["prefix"], alloc)

        def free_slot(b):
            if alloc is not None and host["slot_pages"][b] is not None:
                alloc.free(host["slot_pages"][b])
                host["slot_pages"][b] = None
            host["slot_req"][b] = -1

        def evict(b):
            r = host["slot_req"][b]
            blob = extract_slot_pages(state["cache"], b,
                                      host["slot_pages"][b])
            for name in ("tok", "n_out", "stream"):
                blob[name] = int(state[name][b])
            blob["seq"] = host["slot_seq"][b]
            host["evicted"][r] = blob
            host["readmit"].append(r)
            if r not in host["evicted_ever"]:
                host["evicted_ever"].append(r)
            free_slot(b)
            state["done"][b] = True
            host["counters"]["evictions"] += 1

        def grant(need, want_prio):
            """Page grant for an admission, evicting strictly-lower-
            priority live slots (lowest priority, youngest on ties) while
            the pool cannot cover it and priorities are in force."""
            ids = alloc.alloc(need)
            while ids is None and want_prio is not None:
                cands = [(int(prio[host["slot_req"][b]]),
                          -host["slot_seq"][b], b)
                         for b in range(slots) if host["slot_req"][b] >= 0
                         and int(prio[host["slot_req"][b]]) < want_prio]
                if not cands:
                    return None
                evict(min(cands)[2])
                ids = alloc.alloc(need)
            return ids

        def try_readmit(b):
            for r in list(host["readmit"]):
                blob = host["evicted"][r]
                ids = grant(blob["page_count"],
                            int(prio[r]) if prio is not None else None)
                if ids is None:
                    continue
                host["readmit"].remove(r)
                del host["evicted"][r]
                host["slot_pages"][b] = ids
                host["slot_req"][b] = r
                host["slot_seq"][b] = blob["seq"]   # keeps its seniority
                insert_slot_pages(state["cache"], b, ids, blob)
                for name in ("tok", "n_out", "stream"):
                    state[name][b] = blob[name]
                state["done"][b] = False
                state["max_new"][b] = int(budgets[r])
                host["counters"]["readmissions"] += 1
                return True
            return False

        def admit_prefix(b, rq, ids, d_shared):
            """Page-aligned chunked prefill from the first divergent page,
            through one extend graph for hits and misses alike: shared
            pages hold exactly the bytes the donor's identical chunks
            wrote, so a hit serves the bits a cold admission serves."""
            t_adm = time.perf_counter()
            fed = d_shared * page_size
            cache = state["cache"]
            # the copy-on-write enforcement point: a checked no-op here,
            # sharing stops strictly below the write frontier
            _, ids, _ = cow_fork(cache, alloc, ids, start_idx=d_shared)
            host["slot_pages"][b] = ids
            cache["page_table"][b] = torch.as_tensor(
                ids + [ids[-1]] * (mp - len(ids)), dtype=torch.int32,
                device=dev)
            cache["pos"][b] = fed
            state["done"][b] = True
            while fed < S:
                part = prompts[rq, fed:fed + page_size]
                n_real = len(part)
                if n_real < page_size:
                    part = np.pad(part, (0, page_size - n_real))
                _, tok0 = extend(params, state, part[None], b, n_real,
                                 fed + n_real >= S, int(budgets[rq]))
                fed += n_real
            tok0 = int(tok0)                   # sync: the latency is real
            if prefix_cache == "on":
                pfx.register(prompts[rq], ids[:S // page_size])
            host["prefill_computed"] += S - d_shared * page_size
            host["prefill_total"] += S
            host["admit_lat"].append(
                (d_shared > 0, time.perf_counter() - t_adm))
            return tok0

        while True:
            seg = host["segments"]
            if holder is not None and snapshot_every > 0 \
                    and seg % snapshot_every == 0:
                holder["snap"] = _snap(host, alloc, pfx)
            if injector is not None:
                injector.maybe_fail(seg)
            now = time.perf_counter()
            done_h = state["done"].cpu().numpy()
            for b in range(slots):                 # harvest finished slots
                r = host["slot_req"][b]
                if r >= 0 and done_h[b]:
                    free_slot(b)
                    host["status"][r] = STATUS_OK
            if dl_steps is not None or dl_secs is not None:
                for r in range(R):                 # deadline sweep
                    if not _expired(host, r, now):
                        continue
                    host["status"][r] = STATUS_DEADLINE
                    host["counters"]["deadline_cancelled"] += 1
                    if r in host["evicted"]:
                        del host["evicted"][r]
                        host["readmit"].remove(r)
                    for b in range(slots):
                        if host["slot_req"][b] == r:
                            free_slot(b)
                            state["done"][b] = True
            for b in range(slots):                 # admissions
                if host["slot_req"][b] >= 0:
                    continue
                if host["readmit"] and try_readmit(b):
                    continue
                while host["next_req"] < R \
                        and host["status"][host["next_req"]] is not None:
                    host["next_req"] += 1          # skip cancelled waiters
                if host["next_req"] >= R:
                    continue
                rq = host["next_req"]
                pages = [0] * mp
                ids = None
                d_shared = 0
                if alloc is not None:
                    need = admission_pages(S, int(budgets[rq]), page_size,
                                           headroom)
                    shared = []
                    if pfx is not None and prefix_cache == "on":
                        _, shared = pfx.acquire(prompts[rq],
                                                (S - 1) // page_size)
                    d_shared = len(shared)
                    fresh = grant(need - d_shared,
                                  int(prio[rq]) if prio is not None else None)
                    if fresh is None:              # pool exhausted: wait
                        if shared:
                            alloc.free(shared)     # release the refs taken
                        continue
                    ids = shared + fresh
                    host["slot_pages"][b] = ids
                    # pad to mp with a self-owned id (never read unmasked,
                    # never flushed: pos stays under the granted pages)
                    pages = ids + [ids[-1]] * (mp - need)
                host["next_req"] = rq + 1
                if host["admit_t"][rq] is None:
                    host["admit_t"][rq] = time.perf_counter()
                if pfx is not None:
                    tok0 = admit_prefix(b, rq, ids, d_shared)
                else:
                    prompt = torch.as_tensor(prompts[rq:rq + 1],
                                             dtype=torch.long, device=dev)
                    _, tok0 = admit(params, state, prompt, b, pages,
                                    int(budgets[rq]))
                host["out"][rq].append(int(tok0))
                host["slot_req"][b] = rq
                host["seq"] += 1
                host["slot_seq"][b] = host["seq"]
            if all(r < 0 for r in host["slot_req"]):
                waiting = any(host["status"][r] is None
                              for r in range(host["next_req"], R))
                if not waiting and not host["readmit"]:
                    return host, alloc, pfx
                nr = host["next_req"]
                if nr < R:
                    need = admission_pages(S, int(budgets[nr]), page_size,
                                           headroom)
                    what = f"request {nr} ({need} pages needed"
                else:
                    ev = host["readmit"][0]
                    what = (f"evicted request {ev} "
                            f"({host['evicted'][ev]['page_count']} pages "
                            "needed")
                raise RuntimeError(f"page pool too small for {what}, "
                                   f"{alloc.free_pages} free)")
            if bool(state["done"].all()):
                continue      # all finished at admission: harvest, no step
            _, toks, lives, _ = segment(params, state)
            toks_h, lives_h = toks.cpu().numpy(), lives.cpu().numpy()
            # under spec a segment has seg_len * (k + 1) rows
            for s in range(toks_h.shape[0]):       # harvest tokens
                for b in range(slots):
                    if lives_h[s, b] and host["slot_req"][b] >= 0:
                        host["out"][host["slot_req"][b]].append(
                            int(toks_h[s, b]))
            host["live_steps"] += int(lives_h.sum())
            host["total_steps"] += toks_h.shape[0] * slots
            host["segments"] += 1
            # a spec segment attempts seg_len * (k + 1) positions a slot,
            # whatever it accepts: all count toward the deadline ledger
            host["global_step"] += seg_len * (k_spec + 1)

    if injector is not None or snapshot_every > 0:
        holder = {"snap": _snap(host0, alloc0, pfx0)}
        # the first attempt starts from host0 as it stands; only a replay
        # restores the latest snapshot
        starts = iter([None])
        (host, alloc, pfx), replays = run_with_failover(
            _loop, restore_fn=lambda: next(starts, holder["snap"]),
            max_restarts=max_replays,
            recoverable=(SimulatedHardwareFailure, IntegrityReplay), log=log)
    else:
        host, alloc, pfx = _loop(None)
        replays = 0
    for r in range(R):
        if host["status"][r] is None:
            host["status"][r] = STATUS_OK

    dt = time.perf_counter() - t0
    seg_run, ext_run = segment.runs.get("run"), \
        extend.runs.get("run") if extend is not None else None
    useful = sum(len(o) for o in host["out"])
    stats = {
        "wall_s": dt,
        "tok_s": useful / dt,
        "occupancy": host["live_steps"] / max(host["total_steps"], 1),
        "live_slot_steps": host["live_steps"],
        "slot_steps": host["total_steps"],
        "segments": host["segments"],
        "requests": R,
        "useful_tokens": useful,
        "status": list(host["status"]),
        "replays": replays,
        "evictions": host["counters"]["evictions"],
        "readmissions": host["counters"]["readmissions"],
        "evicted_requests": list(host["evicted_ever"]),
        "deadline_cancelled": host["counters"]["deadline_cancelled"],
        "pages": alloc.stats() if alloc is not None else None,
        "prefix": (dict(
            pfx.stats(),
            prefill_positions_computed=host["prefill_computed"],
            prefill_positions_total=host["prefill_total"],
            admit_lat_hit=[t for hit, t in host["admit_lat"] if hit],
            admit_lat_miss=[t for hit, t in host["admit_lat"] if not hit])
            if pfx is not None else None),
        "capture_s": seg_run.step.capture_s if seg_run is not None else 0.0,
        "extend_capture_s": ext_run.step.capture_s
        if ext_run is not None else 0.0,
        "bindings": {"segment": segment.runs["bindings"],
                     "extend": extend.runs["bindings"]
                     if extend is not None else 0},
        "extend_launches": dict(extend.launches)
        if extend is not None else {},
        "snapshots": snaps,
    }
    return [np.asarray(o, np.int32) for o in host["out"]], stats


def prefix_drill(arch: str = "qwen3-0.6b", *, seed: int = 0, device=None,
                 log=print) -> dict:
    """The reference's prefix-cache drill on the port: staggered
    admissions sharing a page-aligned system prompt, served warm
    (``prefix_cache='on'``) and cold (``'cold'``: the same chunked
    admission path with lookup and registration off), must agree bitwise
    per request while the warm leg visibly dedupes pages and skips
    prefill: requests 1-4 hit 3 shared pages each, over 40 % of the
    prefill positions are skipped, and the drained pool holds no live
    page but keeps the shared prefix retained.  Deterministic: greedy,
    no EOS.  Returns a report dict."""
    import dataclasses

    from ..configs import get_arch
    from ..launch.serve import serve_continuous
    from ..models import lm

    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              dscim="kernel:dscim2:64")
    params = lm.init_params(cfg, seed, device=device)
    rng = np.random.default_rng(seed)
    R, S, n, ps = 6, 16, 6, 4
    prompts = rng.integers(0, cfg.vocab, (R, S), dtype=np.int32)
    # requests 0..4 share a 12-token (3-page) system prompt; request 5
    # is fully distinct (a guaranteed miss among hits)
    prompts[1:5, :12] = prompts[0, :12]
    budgets = np.asarray([6, 5, 6, 4, 6, 5], np.int32)
    knobs = dict(slots=2, seg_len=2, max_new=budgets, eos_id=-1,
                 kv="int8", page_size=ps, device=device, log=log)

    outs_cold, st_cold = serve_continuous(cfg, params, prompts, n, **knobs,
                                          prefix_cache="cold")
    outs_warm, st_warm = serve_continuous(cfg, params, prompts, n, **knobs,
                                          prefix_cache="on")
    for r in range(R):
        if not np.array_equal(outs_warm[r], outs_cold[r]):
            raise AssertionError(f"request {r}: prefix-hit serving "
                                 f"diverged from cold: {outs_warm[r]} vs "
                                 f"{outs_cold[r]}")
    pw, pc = st_warm["prefix"], st_cold["prefix"]
    removed = 1.0 - pw["prefill_positions_computed"] \
        / max(pw["prefill_positions_total"], 1)
    checks = {
        "cold leg shares nothing": pc["hits"] == 0
        and pc["pages_deduped"] == 0,
        "requests 1..4 hit": pw["hits"] == 4,
        "each hit shares 3 full pages": pw["pages_deduped"] == 4 * 3,
        "12 tokens per hit": pw["hit_tokens"] == 4 * 12,
        "over 40% of prefill positions skipped": removed > 0.4,
        "drained pools hold no live page":
        st_warm["pages"]["live_pages"] == 0
        and st_cold["pages"]["live_pages"] == 0,
        "the index retains the shared prefix":
        st_warm["pages"]["retained_pages"] > 0,
        "every dedup is a share reference":
        st_warm["pages"]["shares"] == pw["pages_deduped"],
        "warm statuses ok": all(s == STATUS_OK for s in st_warm["status"]),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"prefix drill: {failed}: warm {pw}, cold "
                             f"{pc}, pages {st_warm['pages']}")
    report = {
        "seed": seed, "requests": R,
        "hits": pw["hits"], "pages_deduped": pw["pages_deduped"],
        "hit_tokens": pw["hit_tokens"],
        "prefill_removed_frac": removed,
        "retained_pages": st_warm["pages"]["retained_pages"],
        "statuses": st_warm["status"],
    }
    log(f"[prefix] drill ok: {report}")
    return report
