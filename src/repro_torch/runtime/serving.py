"""Continuous-batching scheduler, the plain path (port of
``serve_continuous_ft`` from ``repro/runtime/serving.py`` with every
fault-tolerance knob at its default).

Between segments (``launch/steps.py make_segment_fn``: ``seg_len``
replays of the captured done-masked decode step over the persistent
serve state) the host harvests finished slots, returns their pages to
the ``PageAllocator``, and admits waiting requests into the freed slots
(``make_admit_fn``: one eager prefill each), granting each its pages or
leaving it queued while the pool is full (backpressure).  Under ``spec``
each segment step is a self-speculative draft/verify window, so a segment
emits up to ``seg_len * (k+1)`` tokens per slot, and every slot's
capacity and page grant carry k positions of headroom for the draft's
in-flight writes.  The knobs of later ROADMAP items (deadlines, priority
eviction, snapshots, the watchdog, integrity checks, the prefix cache)
raise ``NotImplementedError`` until they are ported.
"""
from __future__ import annotations

import time

import numpy as np

__all__ = ["STATUS_OK", "serve_continuous_ft"]

STATUS_OK = "ok"


def _req_array(x, R, dtype, name):
    if x is None:
        return None
    arr = np.asarray(x, dtype)
    if arr.shape != (R,):
        raise ValueError(f"{name} must be shape ({R},), got {arr.shape}")
    return arr


def _not_ported(**knobs):
    """Raise for the first knob of a later ROADMAP item that is set."""
    items = {"deadline_steps": "A11", "deadline_s": "A11",
             "priority": "A11", "monitor": "A11", "injector": "A11",
             "snapshot_every": "A11", "watchdog": "A11",
             "integrity": "A11", "prefix_cache": "A10"}
    for name, value in knobs.items():
        if value not in (None, 0, False, "", "off"):
            raise NotImplementedError(
                f"serve_continuous: {name}={value!r} is not ported yet "
                f"(ROADMAP {items[name]})")


def serve_continuous_ft(cfg, params, prompts, n_tokens: int, *,
                        slots: int = 4, seg_len: int = 4, max_new=None,
                        eos_id: int | None = None, sample: str = "greedy",
                        kv: str = "float", page_size: int = 8,
                        n_pages: int | None = None, rng_seed: int = 0,
                        deadline_steps=None, deadline_s=None, priority=None,
                        monitor=None, injector=None, snapshot_every: int = 0,
                        watchdog=None, spec: str | None = None,
                        integrity: str = "off", prefix_cache=False,
                        device=None):
    """Continuous batching over already-prepared ``params`` on
    ``device`` (launch/serve.py ``serve_continuous`` is the user-facing
    wrapper and documents the arguments).  Returns (outputs, stats):
    ``outputs[r]`` is request r's int32 tokens; ``stats`` has ``wall_s``,
    ``tok_s`` (useful tokens over wall time), ``occupancy`` (live
    slot-steps / slot-steps), ``live_slot_steps``, ``slot_steps``,
    ``segments``, ``requests``, ``useful_tokens``, ``status``,
    ``capture_s`` (seconds spent capturing the segment step, inside
    ``wall_s``; 0 without a graph) and the allocator's ``pages`` stats
    (None for the float cache)."""
    import torch

    from ..core.kvcache import PageAllocator, admission_pages, n_pages_for
    from ..launch.steps import (_parse_spec, init_serve_state,
                                make_admit_fn, make_segment_fn)

    _not_ported(deadline_steps=deadline_steps, deadline_s=deadline_s,
                priority=priority, monitor=monitor, injector=injector,
                snapshot_every=snapshot_every, watchdog=watchdog,
                integrity=integrity, prefix_cache=prefix_cache)
    prompts = np.asarray(prompts)
    R, S = prompts.shape
    budgets = np.full((R,), n_tokens, np.int32) if max_new is None \
        else _req_array(max_new, R, np.int32, "max_new")
    if not (budgets >= 1).all():
        raise ValueError(f"budgets must be >= 1, got {budgets.tolist()}")
    # +k headroom past prompt + budget: a speculative window may write k
    # draft positions past the committed pos before its rollback
    sp = _parse_spec(spec)
    headroom = sp[1] if sp else 0
    capacity = S + int(budgets.max()) + headroom
    mp = n_pages_for(capacity, page_size)
    state = init_serve_state(cfg, slots, capacity, kv=kv,
                             page_size=page_size, n_pages=n_pages,
                             seed=rng_seed, device=device)
    dev = state["tok"].device
    alloc = PageAllocator(state["cache"]["k_pages"].shape[1]) \
        if kv == "int8" else None
    admit = make_admit_fn(cfg, eos_id=eos_id, sample=sample)
    segment = make_segment_fn(cfg, seg_len, eos_id=eos_id, sample=sample,
                              spec=spec)
    slot_req = [-1] * slots
    slot_pages = [None] * slots
    out = [[] for _ in range(R)]
    status = [None] * R
    next_req = segments = live_steps = total_steps = 0
    t0 = time.perf_counter()

    def free_slot(b):
        if alloc is not None and slot_pages[b] is not None:
            alloc.free(slot_pages[b])
            slot_pages[b] = None
        slot_req[b] = -1

    while True:
        done_h = state["done"].cpu().numpy()
        for b in range(slots):                     # harvest finished slots
            r = slot_req[b]
            if r >= 0 and done_h[b]:
                free_slot(b)
                status[r] = STATUS_OK
        for b in range(slots):                     # admissions
            if slot_req[b] >= 0 or next_req >= R:
                continue
            rq = next_req
            pages = [0] * mp
            if alloc is not None:
                need = admission_pages(S, int(budgets[rq]), page_size,
                                       headroom)
                ids = alloc.alloc(need)
                if ids is None:                    # pool exhausted: wait
                    continue
                slot_pages[b] = ids
                # pad to mp with a self-owned id (never read unmasked,
                # never flushed: pos stays under the granted pages)
                pages = ids + [ids[-1]] * (mp - need)
            next_req = rq + 1
            prompt = torch.as_tensor(prompts[rq:rq + 1], dtype=torch.long,
                                     device=dev)
            state, tok0 = admit(params, state, prompt, b, pages,
                                int(budgets[rq]))
            out[rq].append(int(tok0))
            slot_req[b] = rq
        if all(r < 0 for r in slot_req):
            if next_req >= R:
                break
            need = admission_pages(S, int(budgets[next_req]), page_size,
                                   headroom)
            raise RuntimeError(
                f"page pool too small for request {next_req} ({need} pages "
                f"needed, {alloc.free_pages} free)")
        if bool(state["done"].all()):
            continue          # all finished at admission: harvest, no step
        state, toks, lives, _ = segment(params, state)
        toks_h, lives_h = toks.cpu().numpy(), lives.cpu().numpy()
        for s in range(toks_h.shape[0]):           # harvest tokens
            for b in range(slots):
                if lives_h[s, b] and slot_req[b] >= 0:
                    out[slot_req[b]].append(int(toks_h[s, b]))
        live_steps += int(lives_h.sum())
        total_steps += toks_h.shape[0] * slots
        segments += 1

    dt = time.perf_counter() - t0
    run = segment.runs.get("run")
    capture_s = run.step.capture_s if run is not None else 0.0
    for r in range(R):
        if status[r] is None:
            status[r] = STATUS_OK
    useful = sum(len(o) for o in out)
    stats = {
        "wall_s": dt,
        "tok_s": useful / dt,
        "occupancy": live_steps / max(total_steps, 1),
        "live_slot_steps": live_steps,
        "slot_steps": total_steps,
        "segments": segments,
        "requests": R,
        "useful_tokens": useful,
        "status": status,
        "capture_s": capture_s,
        "pages": alloc.stats() if alloc is not None else None,
    }
    return [np.asarray(o, np.int32) for o in out], stats
