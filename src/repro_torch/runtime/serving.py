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

* **Accuracy watchdog and degradation ladder** (``monitor``): every
  ``probe_every`` segments one extra *exact-mode* decode of the state's
  (token, cache) (launch/steps.py ``make_probe_fn``, on a scratch copy
  of what a decode writes) is compared with the segment's first-step
  serving logits (``aux['logits0']``).  A slot whose relative logit RMSE
  passes the ``AccuracyWatchdog`` threshold (from the macro's
  ``ErrorModel`` moments), or whose logits go NaN/Inf (``aux['bad']``,
  every segment), is quarantined: its tokens are discarded, its slot and
  pages recycle, and after the loop the request is served again from its
  prompt down the ladder dscim2 -> dscim1 -> exact (``_escalate``, through
  ``serve_batch``), each intermediate level checked against its exact
  twin.  A stuck-at macro fault (``FailureInjector.macro_fault_at``)
  serves through a second segment runner built on the faulted config.
* **Integrity** (``integrity`` 'verify' | 'scrub:<n>', int8 KV only):
  every n-th boundary the page pool is re-digested against its
  ``page_sum`` plane and the prepared weight planes against their golden
  digests (runtime/integrity.py).  A corrupted weight plane gets its
  golden bytes back in place (and a replay from the last verified
  snapshot if decodes already ran against it: ``IntegrityReplay``); a
  corrupted page rewinds only its owner slot to the verified snapshot, or
  serves the request again from its prompt if it was admitted later.

Greedy and sampled decoding replay bit for bit through eviction and
failover: draws are keyed by (seed, the request's stream, its emitted
count), all of which survive both.

Under a mesh (``par``) every rank runs this scheduler on the same queue
and takes every host decision the same way: the ``deadline_s`` expiries
are read from the first rank's clock and broadcast
(``ParallelCtx.from_first``), a hang on any rank raises ``StepHang`` on
every rank (``Watchdog.step(par)``), the integrity sweeps agree their
findings over the mesh and name them as one device does
(runtime/integrity.py), and an injector's weight flip hits the rank that
holds its element (runtime/failover.py); the page flips, the snapshots
and the monitor's probes are every rank's own, on state every rank holds
whole.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from time import perf_counter as _clock   # port-only timings

import numpy as np
import torch

from .watchdog import AccuracyWatchdog

__all__ = ["STATUS_OK", "STATUS_DEADLINE", "serve_continuous_ft",
           "next_ladder_spec", "exact_probe_spec", "watchdog_for_spec",
           "chaos_drill", "integrity_drill", "integrity_scenario",
           "prefix_drill"]

STATUS_OK = "ok"
STATUS_DEADLINE = "deadline"


# ---------------------------------------------------------------------------
# the degradation ladder's spec algebra
# ---------------------------------------------------------------------------

def exact_probe_spec(spec: str) -> str:
    """The exact-mode twin of a dscim serving spec: same variant, L,
    calibration and '+attn' scope (so the same prepared planes apply),
    exact int8 MVMs.  'off'/'float' map to themselves."""
    if spec in ("off", "float"):
        return spec
    head, _, rest = spec.partition(":")
    _, plus, attn = head.partition("+")
    return "exact" + plus + attn + (":" + rest if rest else "")


def next_ladder_spec(spec: str) -> str | None:
    """One step down the ladder, or None at the bottom: dscim2 (L=64) ->
    dscim1:256 (mode, '+attn' and calibration kept) -> the exact twin;
    exact and float specs are terminal."""
    if spec in ("off", "float"):
        return None
    head, _, rest = spec.partition(":")
    if head.partition("+")[0] == "exact":
        return None
    parts = rest.split(":") if rest else []
    if parts and parts[0] == "dscim2":
        parts[0] = "dscim1"
        if len(parts) > 1:
            parts[1] = "256"
        return head + ":" + ":".join(parts)
    return exact_probe_spec(spec)


def watchdog_for_spec(spec: str, *, margin: float = 3.0,
                      probe_every: int = 8) -> AccuracyWatchdog:
    """An ``AccuracyWatchdog`` whose drift threshold is ``margin`` times
    the serving spec's relative moment bound (core/error_model.py).  The
    reference pinned margin 3 on the reduced config: healthy dscim2:64
    drift near 2x the bound, a stuck-at macro fault near 16x."""
    from ..core.error_model import ErrorModel
    from ..core.macro import DSCIMMacro
    from ..core.seed_search import calibrated_config
    from ..models.lm import _parse_dscim
    _, _, variant, length, calib = _parse_dscim(spec)
    em = ErrorModel.from_macro(DSCIMMacro(calibrated_config(variant, length,
                                                            calib)))
    return AccuracyWatchdog.from_error_model(em, margin=margin,
                                             probe_every=probe_every)


def _req_array(x, R, dtype, name):
    if x is None:
        return None
    arr = np.asarray(x, dtype)
    if arr.shape != (R,):
        raise ValueError(f"{name} must be shape ({R},), got {arr.shape}")
    return arr


def serve_continuous_ft(cfg, params, prompts, n_tokens: int, *,
                        slots: int = 4, seg_len: int = 4, max_new=None,
                        eos_id: int | None = None, sample: str = "greedy",
                        kv: str = "float", page_size: int = 8,
                        n_pages: int | None = None, rng_seed: int = 0,
                        deadline_steps=None, deadline_s=None, priority=None,
                        monitor=None, injector=None, snapshot_every: int = 0,
                        max_replays: int = 3, watchdog=None,
                        spec: str | None = None, integrity: str = "off",
                        prefix_cache=False, device=None, log=print,
                        par=None):
    """Continuous batching over already-prepared ``params`` on
    ``device`` (launch/serve.py ``serve_continuous`` is the user-facing
    wrapper and documents the arguments).  Returns (outputs, stats):
    ``outputs[r]`` is request r's int32 tokens; ``stats`` has the
    reference's keys (``wall_s``, ``tok_s``, ``occupancy``,
    ``live_slot_steps``, ``slot_steps``, ``segments``, ``requests``,
    ``useful_tokens``, ``status``, ``replays``, ``evictions``,
    ``readmissions``, ``evicted_requests``, ``deadline_cancelled``,
    ``quarantined``, ``escalations``, ``corrupted_requests``, ``probes``,
    ``probe_trips``, ``stragglers``, the allocator's ``pages``, the
    integrity engine's ``integrity`` and the prefix cache's ``prefix``,
    None where off) and the port's: ``capture_s`` and
    ``extend_capture_s`` (seconds of this run's segment and extend
    captures, inside ``wall_s``; 0 without a graph, and 0 where the run
    replayed the graphs an earlier run at these options captured:
    launch/steps.py ``continuous_runners``), ``captures`` (the graphs
    this run captured: {"segment", "extend", "probe"}), ``bindings``
    (the bindings of a state, params and fault spec the run's segment and
    extend steps ran under, each a capture on the card unless an earlier
    run made it: 1 each while the params keep their addresses, restores
    included: {"segment", "extend"}), ``probe_bindings`` (the watchdog
    probe's), ``extend_launches`` (kernel launches of the extend calls, by
    counter), ``snapshots`` ({"count", "snapshot_s",
    "restores", "restore_s"}: host copies of the state and copies back),
    ``probe_s`` (wall seconds of the watchdog's probes, synchronized by
    their read), ``escalation_s`` (wall seconds of the ladder),
    ``escalation_captures`` (decode graphs the ladder's ``serve_batch``
    runs captured), ``quarantine_log`` (the reference's quarantine records: request,
    slot, segment, reason, rel) and ``eager_reason`` (why the segments
    stepped eagerly where graphs were asked for: a gloo mesh on CUDA;
    else None)."""
    from ..core.kvcache import (PageAllocator, PrefixCache, admission_pages,
                                cow_fork, extract_slot_pages,
                                insert_slot_pages, n_pages_for)
    from ..core.qweights import golden_weight_copy
    from ..launch.steps import _parse_spec, continuous_runners
    from .failover import (IntegrityReplay, SimulatedHardwareFailure,
                           restore_into, run_with_failover, to_host)
    from .integrity import IntegrityEngine, parse_integrity
    from .watchdog import StepHang

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
    if monitor is not None and monitor.rel_threshold is not None \
            and cfg.dscim in ("off", "float"):
        raise ValueError("drift probes compare against the serving spec's "
                         "exact-mode twin; float serving has no estimator "
                         "to probe (pass rel_threshold=None for NaN-only "
                         "monitoring)")
    integrity_period = parse_integrity(integrity)
    if integrity_period > 0 and kv != "int8":
        raise ValueError("integrity checksums cover the int8 paged cache; "
                         "pass kv='int8' (the float dense cache is the "
                         "watchdog's statistical territory)")
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
    # the serve state and the step functions of these options, kept
    # across runs with their graphs; the state is reset in place
    runners = continuous_runners(
        cfg, slots, capacity, kv=kv, page_size=page_size, n_pages=n_pages,
        seg_len=seg_len, spec=spec, eos_id=eos_id, sample=sample,
        integrity=integrity_period > 0, device=device, par=par)
    state = runners.start(rng_seed)
    dev = state["tok"].device
    alloc0 = PageAllocator(state["cache"]["k_pages"].shape[1]) \
        if kv == "int8" else None
    pfx0 = PrefixCache(alloc0, page_size) if use_prefix else None
    # repairs restore the planes in place, so the engine outlives restarts
    engine = IntegrityEngine(golden_weight_copy(params),
                             period=integrity_period, par=par) \
        if integrity_period > 0 else None
    host0 = {
        "slot_req": [-1] * slots, "slot_pages": [None] * slots,
        "slot_seq": [0] * slots,
        "out": [[] for _ in range(R)], "status": [None] * R,
        "admit_t": [None] * R,
        "next_req": 0, "seq": 0,
        "readmit": [], "evicted": {}, "quarantine": [], "corrupted": [],
        "evicted_ever": [], "reserve": [],
        "counters": {"evictions": 0, "readmissions": 0,
                     "deadline_cancelled": 0},
        "segments": 0, "global_step": 0,
        "live_steps": 0, "total_steps": 0,
        "prefill_computed": 0, "prefill_total": 0, "admit_lat": [],
    }
    probe = None
    if monitor is not None and monitor.rel_threshold is not None:
        probe = runners.probe(dataclasses.replace(
            cfg, dscim=exact_probe_spec(cfg.dscim), dscim_fault=""))
    # the step functions of each fault spec in force this run: their
    # graphs stay bound to the state across restores
    fns: dict = {}

    def steps_for(fault: str):
        if fault not in fns:
            fns[fault] = runners.steps(fault, use_prefix)
        return fns[fault]

    steps_for("")
    snaps = {"count": 0, "snapshot_s": 0.0, "restores": 0, "restore_s": 0.0}
    timers = {"probe_s": 0.0}
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
        snap = {"state": to_host(state), "host": copy.deepcopy(host),
                "alloc": alloc.snapshot() if alloc is not None else None,
                "prefix": pfx.snapshot() if pfx is not None else None}
        snaps["count"] += 1
        snaps["snapshot_s"] += _clock() - t
        return snap

    def _probe():
        t = _clock()
        lg = probe(params, state).cpu().numpy()
        timers["probe_s"] += _clock() - t
        return lg

    def _loop(snap):
        if snap is None:
            host, alloc, pfx = host0, alloc0, pfx0
        else:
            t = _clock()
            restore_into(state, snap["state"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            snaps["restores"] += 1
            snaps["restore_s"] += _clock() - t
            host = copy.deepcopy(snap["host"])
            alloc = None if snap["alloc"] is None \
                else PageAllocator.from_snapshot(snap["alloc"])
            pfx = None if snap["prefix"] is None \
                else PrefixCache.from_snapshot(snap["prefix"], alloc)
        if watchdog is not None:
            watchdog.reset()
        # segments run since the last weight sweep: a corrupted plane
        # found with this at 0 was caught before any decode read it
        # (repair only); otherwise poisoned tokens exist and the repair is
        # followed by a replay from the last verified snapshot
        segs_since_wcheck = 0

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

        def repair_pages(coords):
            """Slot-scoped KV repair: rewind each slot owning a corrupted
            page to the last *verified* snapshot (its pages digested clean
            there) through the eviction blob, or, if its request was not
            live there, serve it again from its prompt
            (``host['reserve']``).  Every other slot is untouched."""
            vstate, vhost = holder["verified"]["state"], \
                holder["verified"]["host"]
            owner = {int(p): b for b in range(slots)
                     for p in (host["slot_pages"][b] or ())}
            for b in sorted({owner[p] for _, p in coords if p in owner}):
                r = host["slot_req"][b]
                b0 = vhost["slot_req"].index(r) \
                    if r in vhost["slot_req"] else -1
                if b0 >= 0:
                    blob = extract_slot_pages(vstate["cache"], b0,
                                              vhost["slot_pages"][b0])
                    insert_slot_pages(state["cache"], b,
                                      host["slot_pages"][b], blob)
                    for name in ("tok", "done", "n_out", "max_new",
                                 "stream"):
                        state[name][b] = vstate[name][b0]
                    host["out"][r] = list(vhost["out"][r])
                    log(f"[integrity] slot {b} (request {r}) rewound to "
                        f"the verified snapshot (pos {blob['pos']})")
                    engine.note_page_repair("rewinds")
                else:
                    # admitted after the verified snapshot: serve it again
                    # from its prompt (greedy: the same tokens)
                    free_slot(b)
                    state["done"][b] = True
                    host["out"][r] = []
                    host["reserve"].append(r)
                    log(f"[integrity] request {r} served again from its "
                        "prompt (corrupted page, admitted after the "
                        "verified snapshot)")
                    engine.note_page_repair("reserves")

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

        def admit_prefix(extend, b, rq, ids, d_shared):
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
            admit, extend, segment = steps_for(
                injector.serving_fault(seg) if injector is not None else "")
            now = time.perf_counter()
            done_h = state["done"].cpu().numpy()
            for b in range(slots):                 # harvest finished slots
                r = host["slot_req"][b]
                if r >= 0 and done_h[b]:
                    free_slot(b)
                    host["status"][r] = STATUS_OK
            if dl_steps is not None or dl_secs is not None:
                expired = [_expired(host, r, now) for r in range(R)]
                if par is not None and dl_secs is not None:
                    # wall budgets by the first rank's clock: every rank
                    # cancels the same requests at the same boundary
                    expired = par.from_first(expired)
                for r in range(R):                 # deadline sweep
                    if not expired[r]:
                        continue
                    host["status"][r] = STATUS_DEADLINE
                    host["counters"]["deadline_cancelled"] += 1
                    if r in host["evicted"]:
                        del host["evicted"][r]
                        host["readmit"].remove(r)
                    if r in host["reserve"]:
                        host["reserve"].remove(r)
                    for b in range(slots):
                        if host["slot_req"][b] == r:
                            free_slot(b)
                            state["done"][b] = True
            for b in range(slots):                 # admissions
                if host["slot_req"][b] >= 0:
                    continue
                if host["readmit"] and try_readmit(b):
                    continue
                # integrity re-serves go first: they were admitted once
                reserve = bool(host["reserve"])
                if reserve:
                    rq = host["reserve"][0]
                else:
                    while host["next_req"] < R \
                            and host["status"][host["next_req"]] is not None:
                        host["next_req"] += 1      # skip cancelled waiters
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
                if reserve:
                    host["reserve"].pop(0)
                else:
                    host["next_req"] = rq + 1
                if host["admit_t"][rq] is None:    # re-serves keep theirs
                    host["admit_t"][rq] = time.perf_counter()
                if pfx is not None:
                    tok0 = admit_prefix(extend, b, rq, ids, d_shared)
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
                if not waiting and not host["readmit"] \
                        and not host["reserve"]:
                    return host, alloc, pfx
                nr = host["next_req"]
                if host["reserve"] or nr >= R:
                    r = (host["reserve"] or host["readmit"])[0]
                    need = host["evicted"][r]["page_count"] \
                        if r in host["evicted"] else admission_pages(
                            S, int(budgets[r]), page_size, headroom)
                    what = f"request {r} ({need} pages needed"
                else:
                    need = admission_pages(S, int(budgets[nr]), page_size,
                                           headroom)
                    what = f"request {nr} ({need} pages needed"
                raise RuntimeError(f"page pool too small for {what}, "
                                   f"{alloc.free_pages} free)")
            done_h = state["done"].cpu().numpy()
            if done_h.all():
                continue      # all finished at admission: harvest, no step
            live0 = np.asarray([r >= 0 for r in host["slot_req"]]) & ~done_h
            lg_exact = None
            if probe is not None and monitor.should_probe(seg) \
                    and live0.any():
                lg_exact = _probe()
            if injector is not None and alloc is not None:
                _, hit = injector.corrupt_cache(seg, state["cache"],
                                                host["slot_pages"])
                for b in hit:
                    r = host["slot_req"][b]
                    if r >= 0 and r not in host["corrupted"]:
                        host["corrupted"].append(r)
            if injector is not None and injector.weight_flips:
                injector.corrupt_weights(seg, params, par)
            if engine is not None and engine.due(seg):
                # faults injected at this boundary land before the check,
                # so a flip due the segment a check runs is caught before
                # any decode reads it
                reprobe = False
                # both sweeps and the slots' positions in one host read
                sweep = engine.sweep(params, state["cache"],
                                     state["cache"]["pos"])
                bad_w = engine.check_weights(params, sweep)
                if bad_w:
                    engine.repair_weights(params, bad_w)
                    log(f"[integrity] weight plane(s) {bad_w} restored "
                        "from the golden copy")
                    if segs_since_wcheck > 0:
                        # decodes ran against the corrupted plane: every
                        # slot's tokens since the last verified snapshot
                        # are suspect; replay them on the repaired planes
                        engine.note_replay()
                        holder["snap"] = holder["verified"]
                        raise IntegrityReplay(
                            f"weight plane(s) {bad_w} repaired after "
                            f"{segs_since_wcheck} unverified segment(s)")
                    reprobe = True
                segs_since_wcheck = 0
                # digests are under warranty only for granted, fully
                # flushed pages
                live_pages = np.zeros((alloc.n_pages,), bool)
                for b in range(slots):
                    ids = host["slot_pages"][b]
                    if ids is not None:
                        for p in ids[:int(sweep.pos[b]) // page_size]:
                            live_pages[int(p)] = True
                coords = engine.check_pages(state["cache"], live_pages,
                                            sweep)
                if coords:
                    log(f"[integrity] corrupted page(s) at (layer, page) "
                        f"{coords}")
                    repair_pages(coords)
                    reprobe = True
                # everything digests clean now: the repair restore point
                holder["verified"] = _snap(host, alloc, pfx)
                if reprobe and lg_exact is not None:
                    # a repair must never read as drift: probe again
                    lg_exact = _probe()
            ctx = watchdog.step(par) if watchdog is not None \
                else contextlib.nullcontext()
            with ctx:
                _, toks, lives, aux = segment(params, state)
                toks_h, lives_h = toks.cpu().numpy(), lives.cpu().numpy()
            # under spec a segment has seg_len * (k + 1) rows
            for s in range(toks_h.shape[0]):       # harvest tokens
                for b in range(slots):
                    if lives_h[s, b] and host["slot_req"][b] >= 0:
                        host["out"][host["slot_req"][b]].append(
                            int(toks_h[s, b]))
            if monitor is not None:
                bad = aux["bad"].cpu().numpy().any(axis=0)
                trip = bad.copy()
                rels = np.zeros((slots,))
                if lg_exact is not None:
                    t2, rels = monitor.check(aux["logits0"].cpu().numpy(),
                                             lg_exact, live0)
                    trip |= t2
                for b in np.nonzero(trip)[0].tolist():
                    r = host["slot_req"][b]
                    if r < 0:
                        continue
                    free_slot(b)
                    state["done"][b] = True
                    host["out"][r] = []            # discard poisoned tokens
                    host["quarantine"].append({
                        "request": r, "slot": b, "segment": seg,
                        "reason": "nonfinite" if bad[b] else "drift",
                        "rel": float(rels[b]) if np.isfinite(rels[b])
                        else float("inf")})
            host["live_steps"] += int(lives_h.sum())
            host["total_steps"] += toks_h.shape[0] * slots
            host["segments"] += 1
            segs_since_wcheck += 1
            # a spec segment attempts seg_len * (k + 1) positions a slot,
            # whatever it accepts: all count toward the deadline ledger
            host["global_step"] += seg_len * (k_spec + 1)

    if injector is not None or snapshot_every > 0 or watchdog is not None \
            or engine is not None:
        snap0 = _snap(host0, alloc0, pfx0)
        # the initial state is verified clean by construction
        holder = {"snap": snap0, "verified": snap0}
        # the first attempt starts from host0 as it stands; only a replay
        # restores the latest snapshot
        starts = iter([None])
        (host, alloc, pfx), replays = run_with_failover(
            _loop, restore_fn=lambda: next(starts, holder["snap"]),
            max_restarts=max_replays,
            recoverable=(SimulatedHardwareFailure, StepHang,
                         IntegrityReplay), log=log)
    else:
        host, alloc, pfx = _loop(None)
        replays = 0

    esc_records: list = []
    esc_captures = 0
    t_esc = time.perf_counter()
    if any(host["status"][q["request"]] is None
           for q in host["quarantine"]):
        esc_captures = _escalate(cfg, params, prompts, n_tokens, host, budgets,
                  eos_id=eos_id, sample=sample, kv=kv, page_size=page_size,
                  rng_seed=rng_seed, monitor=monitor, records=esc_records,
                  device=dev, log=log, par=par)
    t_esc = time.perf_counter() - t_esc
    for r in range(R):
        if host["status"][r] is None:
            host["status"][r] = STATUS_OK

    dt = time.perf_counter() - t0
    segs = [f[2] for f in fns.values()]
    exts = [f[1] for f in fns.values() if f[1] is not None]

    ext_launches: dict = {}
    for e in exts:
        for name, n in e.launches.items():
            ext_launches[name] = ext_launches.get(name, 0) + n
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
        "quarantined": sorted({q["request"] for q in host["quarantine"]}),
        "quarantine_log": list(host["quarantine"]),
        "escalations": esc_records,
        "corrupted_requests": sorted(host["corrupted"]),
        "probes": monitor.n_probes if monitor is not None else 0,
        "probe_trips": monitor.n_trips if monitor is not None else 0,
        "stragglers": watchdog.n_stragglers if watchdog is not None else 0,
        "pages": alloc.stats() if alloc is not None else None,
        "integrity": (dict(engine.stats(), detections=engine.detections)
                      if engine is not None else None),
        "prefix": (dict(
            pfx.stats(),
            prefill_positions_computed=host["prefill_computed"],
            prefill_positions_total=host["prefill_total"],
            admit_lat_hit=[t for hit, t in host["admit_lat"] if hit],
            admit_lat_miss=[t for hit, t in host["admit_lat"] if not hit])
            if pfx is not None else None),
        "capture_s": sum(f.runs["capture_s"] for f in segs),
        "extend_capture_s": sum(f.runs["capture_s"] for f in exts),
        "captures": {"segment": sum(f.runs["captures"] for f in segs),
                     "extend": sum(f.runs["captures"] for f in exts),
                     "probe": probe.runs["captures"] if probe else 0},
        "bindings": {"segment": sum(f.runs["used"] for f in segs),
                     "extend": sum(f.runs["used"] for f in exts)},
        "probe_bindings": probe.runs["used"] if probe else 0,
        "extend_launches": ext_launches,
        "snapshots": snaps,
        "probe_s": timers["probe_s"],
        "escalation_s": t_esc,
        "escalation_captures": esc_captures,
        # why the segments stepped eagerly where graphs were asked for (a
        # gloo mesh on CUDA), else None
        "eager_reason": next((f.eager_reason for f in segs
                              if f.eager_reason), None),
    }
    return [np.asarray(o, np.int32) for o in host["out"]], stats


def _escalate(cfg, params, prompts, n_tokens, host, budgets, *, eos_id,
              sample, kv, page_size, rng_seed, monitor, records, device,
              log, par=None):
    """Serve quarantined requests again from their prompts down the
    ladder.  A segment runs one estimator for the whole slot batch, so a
    request restarts through ``serve_batch`` on a clean config
    (``dscim_fault=''``) at the next level, grouped by level.  Each
    intermediate level is checked against its exact twin (prefill logit
    relative RMSE under the monitor's threshold); rows still drifting go
    further down.  The bottom level (exact / float) is accepted as it is:
    it is the reference.  Returns how many decode graphs the ladder's
    ``serve_batch`` runs captured."""
    from ..launch.serve import serve_batch
    thresh = monitor.rel_threshold \
        if monitor is not None and monitor.rel_threshold is not None \
        else float("inf")
    eos = -1 if eos_id is None else eos_id
    level, reason = {}, {}
    for q in host["quarantine"]:
        r = q["request"]
        if host["status"][r] is not None:      # e.g. a deadline meanwhile
            continue
        level.setdefault(r, cfg.dscim)
        reason.setdefault(r, q["reason"])
    pending = sorted(level)
    captures = 0
    while pending:
        groups: dict = {}
        for r in pending:
            nxt = next_ladder_spec(level[r]) or level[r]   # off: restart
            groups.setdefault(nxt, []).append(r)
        pending = []
        for spec, rows in sorted(groups.items()):
            kw = dict(eos_id=eos, max_new=[int(budgets[r]) for r in rows],
                      sample=sample, kv=kv, page_size=page_size,
                      rng_seed=rng_seed, device=device, par=par)
            t: dict = {}
            toks, lgs = serve_batch(
                dataclasses.replace(cfg, dscim=spec, dscim_fault=""),
                params, prompts[rows], n_tokens, timings=t, **kw)
            captures += "capture_s" in t
            ok = np.ones(len(rows), bool)
            rel = np.zeros(len(rows))
            if next_ladder_spec(spec) is not None and np.isfinite(thresh):
                t = {}
                _, lgs_ex = serve_batch(
                    dataclasses.replace(cfg, dscim=exact_probe_spec(spec),
                                        dscim_fault=""),
                    params, prompts[rows], n_tokens, timings=t, **kw)
                captures += "capture_s" in t
                s = np.asarray(lgs[0], np.float64).reshape(len(rows), -1)
                e = np.asarray(lgs_ex[0], np.float64).reshape(len(rows), -1)
                rms = np.sqrt(np.mean(e * e, axis=-1))
                rel = np.sqrt(np.mean((s - e) ** 2, axis=-1)) \
                    / np.maximum(rms, 1e-9)
                ok = np.isfinite(rel) & (rel <= thresh)
            for i, r in enumerate(rows):
                records.append({"request": r, "frm": level[r], "to": spec,
                                "reason": reason[r],
                                "accepted": bool(ok[i]),
                                "rel": float(rel[i])})
                log(f"[ladder] request {r}: {level[r]} -> {spec} "
                    f"({reason[r]}; rel {rel[i]:.2e}; "
                    f"{'accepted' if ok[i] else 'still drifting'})")
                if ok[i]:
                    row = np.asarray(toks[i])
                    n_use = int(budgets[r])
                    hits = np.nonzero(row[:n_use] == eos)[0]
                    if len(hits):
                        n_use = int(hits[0]) + 1
                    host["out"][r] = row[:n_use].tolist()
                    host["status"][r] = STATUS_OK
                else:
                    level[r] = spec
                    reason[r] = "drift"
                    pending.append(r)
    return captures


def chaos_drill(arch: str = "qwen3-0.6b", *, seed: int = 0, params=None,
                device=None, log=print) -> dict:
    """The reference's chaos drill on the port (reduced config,
    ``kernel:dscim2:64``): under one injected device loss, two page-pool
    bit flips (an f32 scale and an int8 page: silent corruption on this
    RMSNorm'd model, tracked in ``corrupted_requests``), a persistent
    stuck-at macro fault from segment 6 and a step deadline,
    ``serve_continuous`` ends every request with a definite status;
    requests no fault touched are bitwise the fault-free run; the
    watchdog trips on the macro fault and escalates dscim2 -> dscim1; one
    replay absorbs the device loss.  Greedy, no EOS, snapshots every
    segment.  ``params``: the f32 weights (default ``lm.init_params(cfg,
    seed)``).  Returns a report dict."""
    from ..configs import get_arch
    from ..launch.steps import _check_continuous
    from ..launch.serve import serve_continuous
    from ..models import lm
    from .failover import FailureInjector

    spec = "kernel:dscim2:64"
    cfg = dataclasses.replace(get_arch(arch).reduced(), dscim=spec)
    _check_continuous(cfg)
    if params is None:
        params = lm.init_params(cfg, seed, device=device)
    rng = np.random.default_rng(seed)
    R, S, n = 6, 8, 8
    prompts = rng.integers(0, cfg.vocab, (R, S), dtype=np.int32)
    budgets = np.asarray([8, 6, 8, 5, 8, 6], np.int32)
    # request 3 gets a 4-step budget: admitted in the first wave, cancelled
    # at the boundary after segment 2 with partial tokens
    deadlines = np.asarray([-1, -1, -1, 4, -1, -1], np.int64)
    knobs = dict(slots=3, seg_len=2, max_new=budgets, eos_id=-1,
                 kv="int8", page_size=4, device=device, log=log)

    outs_ref, _ = serve_continuous(cfg, params, prompts, n, **knobs)
    monitor = watchdog_for_spec(spec, probe_every=1)
    injector = FailureInjector(
        fail_at=(3,),
        page_flips={1: ((0, "v_scale", (0, 0, 0), 0x7f000000),),
                    2: ((1, "k_pages", (0, 0, 0, 0, 0), 0x41),)},
        macro_fault_at=6, macro_fault="stuck:3:40.0")
    outs, stats = serve_continuous(
        cfg, params, prompts, n, **knobs, deadline_steps=deadlines,
        monitor=monitor, injector=injector, snapshot_every=1,
        max_replays=2)

    if not all(s in (STATUS_OK, STATUS_DEADLINE) for s in stats["status"]):
        raise AssertionError(f"indefinite request status: {stats['status']}")
    if stats["replays"] != 1:
        raise AssertionError(f"the device loss must cost 1 replay: {stats}")
    if stats["status"][3] != STATUS_DEADLINE or len(outs[3]) >= budgets[3]:
        raise AssertionError(f"deadline request not cancelled: "
                             f"{stats['status']}")
    escalated = {e["request"] for e in stats["escalations"]}
    hops = {(e["frm"], e["to"]) for e in stats["escalations"]}
    if not any("dscim2" in frm and "dscim1" in to for frm, to in hops):
        raise AssertionError(f"no dscim2 -> dscim1 escalation: {hops}")
    if stats["probe_trips"] < 1:
        raise AssertionError("the watchdog never tripped")
    affected = (set(stats["corrupted_requests"]) | escalated
                | set(stats["quarantined"])
                | {r for r in range(R)
                   if stats["status"][r] == STATUS_DEADLINE})
    clean = sorted(set(range(R)) - affected)
    if not clean:
        raise AssertionError("the scenario left no unaffected request")
    for r in clean:
        if not np.array_equal(outs[r], outs_ref[r]):
            raise AssertionError(f"unaffected request {r} diverged from "
                                 f"the fault-free run: {outs[r]} vs "
                                 f"{outs_ref[r]}")
    report = {
        "seed": seed, "requests": R, "clean": clean,
        "affected": sorted(affected), "replays": stats["replays"],
        "probes": stats["probes"], "probe_trips": stats["probe_trips"],
        "quarantined": stats["quarantined"],
        "escalations": len(stats["escalations"]),
        "deadline_cancelled": stats["deadline_cancelled"],
        "corrupted_requests": stats["corrupted_requests"],
        "statuses": stats["status"],
        "rel_threshold": monitor.rel_threshold,
    }
    log(f"[chaos] drill ok: {report}")
    return report


def integrity_scenario(cfg, params, prompts, budgets, *, slots: int,
                       seg_len: int, page_size: int, rewind_slot: int,
                       reserve_slot: int, layer: int, monitor=None,
                       outs_ref=None, device=None, log=print) -> dict:
    """The integrity drill's two legs on any queue, each asserting its
    contract (raises AssertionError otherwise), greedy, no EOS, int8 KV,
    ``integrity='scrub:2'``, a snapshot every segment:

    * leg 1 (with ``monitor`` if given): a q-plane flip of the first
      prepared ``w_up`` at segment 0 (caught by the boundary-0 sweep
      before any decode read it: a golden-copy repair, no replay), an f32
      scale flip on ``rewind_slot``'s first page at segment 1 (its owner
      rewound to the verified snapshot) and an int8 page flip at layer
      ``layer`` on ``reserve_slot``'s first page at segment 3 (a request
      admitted after that snapshot: served again from its prompt).  Zero
      replays, no quarantine or escalation, each detection at the exact
      (layer, physical page) and (path, plane) the flips hit;
    * leg 2: a scale-plane flip at segment 3, an unchecked boundary:
      segment 3 decodes against it, the boundary-4 sweep repairs it and
      replays from the last verified snapshot (one ``IntegrityReplay``).

    Every request of both legs must be bitwise ``outs_ref`` (default: a
    fault-free run of the same queue).  Returns a report with the
    statuses, counters, coordinates and the corrupted requests."""
    from ..core.qweights import weight_plane_index
    from ..launch.serve import prepare_params, serve_continuous
    from .failover import FailureInjector

    served = prepare_params(cfg, params, device)
    widx = weight_plane_index(served)
    if not widx:
        raise AssertionError("the integrity drill needs prepared planes")
    wpath = next((p for p, w in widx if "w_up" in p and w == "q"),
                 widx[0][0])
    R = len(budgets)
    n = int(np.max(budgets))
    knobs = dict(slots=slots, seg_len=seg_len, max_new=budgets, eos_id=-1,
                 kv="int8", page_size=page_size, device=device, log=log)
    if outs_ref is None:
        outs_ref, _ = serve_continuous(cfg, served, prompts, n, **knobs)

    inj1 = FailureInjector(
        page_flips={
            1: ((rewind_slot, "v_scale", (0, 0, 0), 0x7f000000),),
            3: ((reserve_slot, "k_pages", (layer, 0, 0, 0, 0), 0x41),)},
        weight_flips={0: ((wpath, "q", 2026, 0x10),)})
    outs1, st1 = serve_continuous(
        cfg, served, prompts, n, **knobs, monitor=monitor, injector=inj1,
        snapshot_every=1, max_replays=2, integrity="scrub:2")
    ig1 = st1["integrity"]
    want_pages = [[(full[0], full[1])] for _, _, full in inj1.hits]
    pdet = [d["coords"] for d in ig1["detections"] if d["kind"] == "page"]
    wdet = [d["coords"] for d in ig1["detections"] if d["kind"] == "weight"]
    checks1 = {
        "scrub period 2": ig1["period"] == 2,
        "all ok": all(s == STATUS_OK for s in st1["status"]),
        "no replay": st1["replays"] == 0 and ig1["replays"] == 0,
        "no quarantine or escalation": not st1["quarantined"]
        and not st1["escalations"],
        "two page flips applied": len(inj1.hits) == 2,
        "page flips found and repaired": ig1["page_mismatches"] == 2
        and ig1["page_repairs"] == 2,
        "one owner rewound, one request served again": ig1["rewinds"] == 1
        and ig1["reserves"] == 1,
        "weight flip found and repaired": ig1["weight_mismatches"] == 1
        and ig1["weight_repairs"] == 1,
        "pages at the flipped (layer, page)": pdet == want_pages,
        "weight at the flipped plane": wdet == [[(wpath, "q")]],
        "bitwise the fault-free run": all(
            np.array_equal(outs1[r], outs_ref[r]) for r in range(R)),
    }
    inj2 = FailureInjector(weight_flips={3: ((wpath, "scale", 7, 1 << 23),)})
    outs2, st2 = serve_continuous(
        cfg, served, prompts, n, **knobs, injector=inj2,
        snapshot_every=1, max_replays=2, integrity="scrub:2")
    ig2 = st2["integrity"]
    checks2 = {
        "one replay": st2["replays"] == 1 and ig2["replays"] == 1,
        "weight flip found and repaired": ig2["weight_mismatches"] == 1
        and ig2["weight_repairs"] == 1,
        "all ok": all(s == STATUS_OK for s in st2["status"]),
        "bitwise the fault-free run": all(
            np.array_equal(outs2[r], outs_ref[r]) for r in range(R)),
    }
    failed = [f"leg 1: {k}" for k, ok in checks1.items() if not ok] \
        + [f"leg 2: {k}" for k, ok in checks2.items() if not ok]
    if failed:
        raise AssertionError(f"integrity drill: {failed}: leg 1 {st1}, "
                             f"leg 2 {st2}")
    return {
        "weight_plane": wpath, "scrub_period": 2,
        "leg1": {"page_repairs": ig1["page_repairs"],
                 "weight_repairs": ig1["weight_repairs"],
                 "replays": st1["replays"], "checks": ig1["checks"],
                 "pages_verified": ig1["pages_verified"],
                 "scrub_time_s": ig1["scrub_time_s"],
                 "page_coords": pdet, "weight_coords": wdet,
                 "corrupted_requests": st1["corrupted_requests"],
                 "bindings": st1["bindings"], "wall_s": st1["wall_s"]},
        "leg2": {"weight_repairs": ig2["weight_repairs"],
                 "replays": st2["replays"], "checks": ig2["checks"],
                 "scrub_time_s": ig2["scrub_time_s"],
                 "bindings": st2["bindings"], "wall_s": st2["wall_s"],
                 "snapshots": st2["snapshots"]},
        "statuses": st1["status"],
    }


def integrity_drill(arch: str = "qwen3-0.6b", *, seed: int = 0, params=None,
                    device=None, log=print) -> dict:
    """The reference's integrity drill on the port (reduced config,
    ``kernel:dscim2:64``, 6 requests through 3 slots, segments of 2, page
    4): ``integrity_scenario`` with the watchdog armed in leg 1, the
    rewound request 0 (slot 0) and the re-served request 3 (slot 1).
    ``params``: the f32 weights (default ``lm.init_params(cfg, seed)``).
    Returns the scenario's report."""
    from ..configs import get_arch
    from ..launch.steps import _check_continuous
    from ..models import lm

    spec = "kernel:dscim2:64"
    cfg = dataclasses.replace(get_arch(arch).reduced(), dscim=spec)
    _check_continuous(cfg)
    if params is None:
        params = lm.init_params(cfg, seed, device=device)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (6, 8), dtype=np.int32)
    budgets = np.asarray([8, 6, 8, 5, 8, 6], np.int32)
    report = integrity_scenario(
        cfg, params, prompts, budgets, slots=3, seg_len=2, page_size=4,
        rewind_slot=0, reserve_slot=1, layer=1 if cfg.n_layers > 1 else 0,
        monitor=watchdog_for_spec(spec, probe_every=1), device=device,
        log=log)
    if report["leg1"]["corrupted_requests"] != [0, 3]:
        raise AssertionError(f"unexpected corruption footprint: "
                             f"{report['leg1']['corrupted_requests']}")
    report.update(seed=seed, requests=len(budgets))
    log(f"[integrity] drill ok: {report}")
    return report


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
    from ..launch.steps import _check_continuous
    from ..launch.serve import serve_continuous
    from ..models import lm

    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              dscim="kernel:dscim2:64")
    _check_continuous(cfg)
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
