"""Router load test: heavy-tailed synthetic traffic against the asyncio
serving router (runtime/router.py), with and without injected faults
(port of the reference's ``benchmarks/loadtest.py``).

    python -m repro_torch.launch.loadtest --smoke

serves ``--arch`` (any registered token-input config, default
qwen3-0.6b) at its published width on the GPU (``--reduced`` cuts it to
the smoke-test size, ``--device cpu`` runs the plain PyTorch versions on
the CPU).

The trace (``make_trace``, the reference's for every seed): mixed prompt
lengths (bucketed one-shot lengths plus an odd-length tail that takes
chunked prefill), geometric generation budgets, bursty arrivals,
a few deadlines and mid-stream client disconnects.  Every request must
end in a terminal status and the page pool must drain to zero live pages,
with the fault schedule armed (``FailureInjector.sampled(chaos_seed)``:
device losses and page-pool bit flips, replayed through snapshot and
restore) as without.  Requests ``ok`` in both legs must have bitwise the
same tokens (greedy serving is schedule- and replay-independent), but for
those a page flip hit, whose tokens the flip decides (``chaos_injector``
says why; the reference's check, which holds them too, fails on them at
some seeds); the full run also
replays the plain leg's bucket-length ``ok`` requests
through ``serve_continuous`` and holds them bitwise.  ``--prefix-cache``
adds a shared-system-prompt trace served by an all-chunked cold router
and a ``prefix_cache=True`` one, ``ok``-vs-``ok`` bitwise.

It prints its rows (``serve/router_plain``, ``serve/router_chaos``,
``serve/prefix_router``: p50/p99 latency, useful tok/s, refusal rate,
occupancy, page counters) and returns them; it writes no file.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import time
from collections.abc import Callable

import numpy as np

from ..configs import CONTINUOUS_ARCHS
from ..runtime.failover import FailureInjector, SimulatedHardwareFailure


def make_trace(seed: int, n: int, *, buckets=(4, 8), max_prompt: int = 12,
               max_new_cap: int = 8, mean_gap_s: float = 0.002,
               shared_prefix=None, shared_frac: float = 0.0):
    """``n`` request descriptors with arrival offsets.  About 80 % of
    prompts take a one-shot bucket length, the rest odd lengths (chunked
    prefill); budgets are geometric (heavy tail, clipped to the cap);
    arrivals are bursty: geometric burst sizes at exponential gaps.  A
    few requests carry deadlines; a few disconnect mid-stream.
    ``shared_prefix`` / ``shared_frac``: overwrite the leading tokens of
    that fraction of prompts with a common system prompt (the prefix
    legs' hit source).  The draws are the reference's, in its order, so
    a seed gives the reference's trace."""
    rng = np.random.default_rng(seed)
    buckets = tuple(buckets)
    odd = [s for s in range(2, max_prompt + 1) if s not in buckets]
    trace = []
    t = 0.0
    i = 0
    while i < n:
        burst = min(1 + rng.geometric(0.45), n - i)
        t += rng.exponential(mean_gap_s) * burst
        for _ in range(burst):
            if rng.random() < 0.8 or not odd:
                S = int(rng.choice(buckets))
            else:
                S = int(rng.choice(odd))
            budget = int(np.clip(rng.geometric(0.35), 1, max_new_cap))
            prompt = rng.integers(1, 1000, S, dtype=np.int32)
            if shared_prefix is not None and rng.random() < shared_frac:
                m = min(len(shared_prefix), S)
                prompt[:m] = shared_prefix[:m]
            req = {"t": t, "prompt": prompt,
                   "max_new": budget, "priority": int(rng.random() < 0.1),
                   "deadline_s": None, "deadline_steps": None,
                   "disconnect_after": None}
            u = rng.random()
            if u < 0.05:
                req["deadline_steps"] = int(rng.integers(1, 6))
            elif u < 0.07:
                req["deadline_s"] = float(rng.uniform(0.2, 2.0))
            if rng.random() < 0.02 and budget > 2:
                req["disconnect_after"] = int(rng.integers(1, budget))
            trace.append(req)
            i += 1
    return trace


async def _client(router, spec, t0, rec):
    from ..runtime.router import Refused
    await asyncio.sleep(max(0.0, t0 + spec["t"] - time.perf_counter()))
    rec["t_submit"] = time.perf_counter()
    try:
        handle = router.submit(spec["prompt"], spec["max_new"],
                               deadline_s=spec["deadline_s"],
                               deadline_steps=spec["deadline_steps"],
                               priority=spec["priority"])
    except Refused as e:
        rec["status"] = "refused"
        rec["refused_reason"] = e.reason
        rec["t_end"] = time.perf_counter()
        return
    rec["rid"] = handle.rid
    tokens: list = []
    cut = spec["disconnect_after"]
    async for kind, val in handle.events():
        if kind == "token":
            tokens.append(int(val))
            if cut is not None and len(tokens) >= cut:
                handle.cancel()
        elif kind == "restart":
            tokens.clear()
        else:
            rec["status"] = val
    rec["tokens"] = tokens
    rec["t_end"] = time.perf_counter()


async def _run_leg(cfg, params, trace, *, injector=None, monitor=None,
                   snapshot_every=0, slots=4, seg_len=4, page_size=4,
                   n_pages=None, buckets=(4, 8), chunk_len=4,
                   max_prompt=12, max_new_cap=8, max_queue=64,
                   prefix_cache=False, device=None):
    """One router serving ``trace`` at its arrival times, drained at the
    end: (per-request records, the router's stats, wall s)."""
    from ..runtime.router import Router
    router = Router(cfg, params, slots=slots, seg_len=seg_len, kv="int8",
                    page_size=page_size, n_pages=n_pages, buckets=buckets,
                    chunk_len=chunk_len, max_prompt=max_prompt,
                    max_new_cap=max_new_cap, max_queue=max_queue,
                    injector=injector, monitor=monitor,
                    snapshot_every=snapshot_every, prefix_cache=prefix_cache,
                    device=device, log=lambda *a: None)
    recs = [{"status": None, "tokens": []} for _ in trace]
    if isinstance(injector, LegFailures):
        injector.out_of_work = lambda: _out_of_work(router, recs)
    await router.start()
    t0 = time.perf_counter()
    await asyncio.gather(*[_client(router, s, t0, r)
                           for s, r in zip(trace, recs)])
    await router.close("drain")
    wall = time.perf_counter() - t0
    return recs, router.stats(), wall


def _metrics(recs, stats, wall):
    from ..runtime.router import TERMINAL_STATUSES
    lat = sorted(r["t_end"] - r["t_submit"] for r in recs
                 if r["status"] not in (None, "refused"))
    counts = {s: sum(1 for r in recs if r["status"] == s)
              for s in TERMINAL_STATUSES}
    n = len(recs)
    useful = sum(len(r["tokens"]) for r in recs)
    pct = (lambda q: lat[min(len(lat) - 1, int(q * (len(lat) - 1)))]) \
        if lat else (lambda q: 0.0)
    return {
        "requests": n,
        "statuses": counts,
        "latencies": len(lat),      # p99 is the int(0.99 * (n - 1))-th
        "p50_ms": pct(0.50) * 1e3,
        "p99_ms": pct(0.99) * 1e3,
        "tok_s": useful / wall,
        "useful_tokens": useful,
        "refusal_rate": counts["refused"] / max(n, 1),
        "occupancy": stats["occupancy"],
        "replays": stats["replays"],
        "quarantined": stats["counters"]["quarantined"],
        "pages": stats["pages"],
        "wall_s": wall,
    }


def _row(kind, tag, m):
    pg = m["pages"]
    st = m["statuses"]
    return {
        "name": f"serve/router_{kind}/{tag}",
        "us": m["wall_s"] * 1e6,
        "derived": (f"p50_ms={m['p50_ms']:.2f};p99_ms={m['p99_ms']:.2f};"
                    f"tok_s={m['tok_s']:.2f};"
                    f"refusal_rate={m['refusal_rate']:.4f};"
                    f"occupancy={m['occupancy']:.3f};"
                    f"requests={m['requests']};"
                    f"ok={st['ok']};deadline={st['deadline']};"
                    f"refused={st['refused']};cancelled={st['cancelled']};"
                    f"degraded={st['degraded']};"
                    f"replays={m['replays']};"
                    f"quarantined={m['quarantined']};"
                    f"pages_live={pg['live_pages']};"
                    f"pages_high_water={pg['high_water']};"
                    f"pages_refusals={pg['refusals']}"),
    }


def _assert_terminal(recs, stats, leg):
    bad = [i for i, r in enumerate(recs) if r["status"] is None]
    assert not bad, f"{leg}: requests without terminal status: {bad[:10]}"
    assert stats["pages"]["live_pages"] == 0, \
        f"{leg}: page leak at drain: {stats['pages']}"


def _check_bitwise(trace, plain, chaos, skip=()):
    """Requests ok in both legs must agree bitwise (greedy serving is
    schedule- and replay-independent), but for the trace indices in
    ``skip``.  Returns how many were held."""
    both = [i for i in range(len(trace)) if i not in skip
            and plain[i]["status"] == chaos[i]["status"] == "ok"]
    for i in both:
        assert plain[i]["tokens"] == chaos[i]["tokens"], (
            f"request {i}: plain {plain[i]['tokens']} != "
            f"chaos {chaos[i]['tokens']}")
    return len(both)


def _check_vs_continuous(cfg, params, trace, plain, *, buckets, seg_len,
                         page_size, device=None):
    """The plain leg's bucket-length ok requests served again straight
    through serve_continuous must match bitwise.  Returns how many were
    held."""
    from .serve import serve_continuous
    checked = 0
    for S in buckets:
        rows = [i for i, s in enumerate(trace)
                if len(s["prompt"]) == S and plain[i]["status"] == "ok"]
        if not rows:
            continue
        rows = rows[:16]        # a sample per bucket keeps this cheap
        prompts = np.stack([trace[i]["prompt"] for i in rows])
        budgets = [trace[i]["max_new"] for i in rows]
        outs, _ = serve_continuous(
            cfg, params, prompts, max(budgets), slots=2, seg_len=seg_len,
            kv="int8", page_size=page_size, max_new=budgets, eos_id=-1,
            device=device, log=lambda *a: None)
        for j, i in enumerate(rows):
            assert plain[i]["tokens"] == outs[j].tolist(), (
                f"request {i} (S={S}): router {plain[i]['tokens']} != "
                f"serve_continuous {outs[j].tolist()}")
            checked += 1
    return checked


@dataclasses.dataclass(frozen=True)
class LoadShape:
    """The trace and router shapes of one load test and its fault
    schedule.  ``smoke()`` and the defaults are the reference's two (its
    reduced trace: buckets (4, 8), prompts up to 12, budgets up to 8,
    page 4, chunk 4).  The pool is under-provisioned by the reference's
    rule, so admission control works: about half the slots' worth of
    full-size grants.  The chaos leg's sampled schedule spans
    ``max(min_fault_segments, fault_span * the plain leg's segments)``
    segments; ``prefix_requests`` sizes the prefix legs' trace (None:
    ``requests``); ``direct`` replays the plain leg's bucket-length ok
    requests through ``serve_continuous``."""
    requests: int = 1000
    slots: int = 4
    seg_len: int = 4
    page_size: int = 4
    buckets: tuple = (4, 8)
    chunk_len: int = 4
    max_prompt: int = 12
    max_new_cap: int = 8
    mean_gap_s: float = 0.002
    device_losses: int = 3
    flips: int = 6
    min_fault_segments: int = 16
    fault_span: float = 1.0
    prefix_requests: int | None = None
    direct: bool = True

    @classmethod
    def smoke(cls) -> "LoadShape":
        return cls(requests=24, slots=2, seg_len=2, mean_gap_s=0.001,
                   device_losses=1, flips=2, direct=False)

    def router_kw(self) -> dict:
        return dict(slots=self.slots, seg_len=self.seg_len,
                    page_size=self.page_size, buckets=self.buckets,
                    chunk_len=self.chunk_len, max_prompt=self.max_prompt,
                    max_new_cap=self.max_new_cap,
                    max_queue=max(16, self.requests // 4),
                    n_pages=self.slots * ((self.max_prompt + self.max_new_cap
                                           + self.chunk_len)
                                          // self.page_size + 1))


@dataclasses.dataclass
class LegFailures(FailureInjector):
    """A ``FailureInjector`` whose device losses cannot outlive the leg
    that runs them.  A loss fires at its drawn segment, as the base
    class's does; but where ``out_of_work()`` says, at a round's start,
    that no decode segment can follow that round, the earliest loss still
    drawn for a later segment fires there instead.  ``_run_leg`` binds
    ``out_of_work`` to the router serving the leg (``_out_of_work``);
    unbound, this is the base class."""
    out_of_work: Callable[[], bool] | None = None

    def maybe_fail(self, step: int):
        super().maybe_fail(step)
        late = sorted(s for s in self.fail_at
                      if s > step and s not in self.fired)
        if late and self.out_of_work is not None and self.out_of_work():
            self.fired.add(late[0])
            raise SimulatedHardwareFailure(
                f"injected fault drawn for segment {late[0]}, fired at "
                f"segment {step}: the leg runs no segment after it")


def _out_of_work(router, recs) -> bool:
    """Whether the router's round about to start is the last that can
    hold live work: every request of the trace has reached the router,
    some request is still open (a loss then still has live work to
    replay from the last snapshot), and no open request can run a decode
    segment after this round: each sits in a decode slot that is done,
    or its client has cancelled it, or it carries a deadline, which this
    round may end.  A deadline that does not end it makes the loss fire
    a round early, never too late."""
    if any("t_submit" not in r for r in recs):
        return False                      # arrivals still to come
    h = router._host
    open_ = list(router._inbox) + [r for r, st in h["status"].items()
                                   if st is None]
    if not open_:
        return False
    done = router._state["done"].cpu().numpy()
    for rid in open_:
        req = router._requests[rid]
        if req.cancelled or req.deadline_s is not None \
                or req.deadline_steps is not None:
            continue
        b = h["slot_rid"].index(rid) if rid in h["slot_rid"] else -1
        if b < 0 or h["slot_phase"][b] != "decode" or not done[b]:
            return False
    return True


def chaos_injector(shape: LoadShape, cfg, plain_segments: int,
                   chaos_seed: int) -> LegFailures:
    """The chaos leg's fault schedule: ``FailureInjector.sampled`` over
    ``max(min_fault_segments, fault_span * plain_segments)`` segments,
    with the reference's arguments, so equal inputs give the reference's
    device losses and flips (segment, slot, plane, element, bit), drawn
    in its order (the ``--chaos-seed`` contract).  Which request a flip
    hits, and whether it hits a committed page (the flip persists and
    may change that request's tokens) or one a later flush rewrites,
    depends on where the router's arrivals, timed on the wall clock, have
    put each request at that segment, and so does the plain leg's segment
    count: the same seed lands its flips on other requests from run to
    run, in either package.

    The device losses are re-armed against the reference's schedule
    (``benchmarks/loadtest.py:285`` fires a loss only at its drawn
    segment).  The chaos leg's own segment count also depends on the
    host: where its rounds run slowly, the wall-clock arrivals overrun
    the admission queue, more requests are refused, and the leg runs
    fewer segments than the plain leg that set the span (14 against
    16-20 at the smoke shape), so a loss drawn past its end never fired
    and the leg made no replay.  ``LegFailures`` fires such a loss in the
    round that harvests the leg's last live segment (``_out_of_work``),
    so every drawn loss fires, and replays live work, whatever the
    host's speed.  A loss the leg reaches fires at its drawn segment, as
    the reference's does."""
    segs = max(shape.min_fault_segments,
               int(plain_segments * shape.fault_span))
    inj = FailureInjector.sampled(
        chaos_seed, segments=segs, slots=shape.slots, n_layers=cfg.n_layers,
        page_size=shape.page_size, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
        device_losses=shape.device_losses, flips=shape.flips)
    return LegFailures(**{f.name: getattr(inj, f.name)
                          for f in dataclasses.fields(inj)})


def run_loadtest(smoke: bool = True, *, requests: int | None = None,
                 seed: int = 0, chaos_seed: int = 0, arch: str = "qwen3-0.6b",
                 prefix: bool = False, reduced: bool = False,
                 device=None, log=print, cfg=None, params=None,
                 shape: LoadShape | None = None, around_leg=None,
                 legs: dict | None = None):
    """The warm-up, both legs and their invariants; returns (rows, plain
    metrics, chaos metrics).  ``smoke``: the mini trace (24 requests, 2
    slots); otherwise 1000 requests through 4 slots and the
    serve_continuous replay (``shape`` replaces either, ``requests`` its
    count).  ``prefix``: add the shared-system-prompt legs, cold
    (all-chunked, sharing off) and ``prefix_cache=True``, ok-vs-ok
    bitwise with hits > 0, and a ``serve/prefix_router`` row.  The chaos
    leg's ok requests are held bitwise against the plain leg's, but for
    those an injected page flip hit (silent corruption: the flip decides
    whether their tokens change, as in the chaos drill; see
    ``chaos_injector``); how many of those still matched is logged.

    Weights are random from seed 0 at ``arch`` (``reduced``: the
    smoke-test width, not the published one) with ``dscim='off'``, as the
    reference's are, unless ``cfg`` and prepared ``params`` are given.
    ``device``: CUDA unless 'cpu' is asked for.  ``around_leg(name)``,
    if given, returns a context manager entered around each leg's serving
    ('warmup', 'plain', 'chaos', 'prefix_cold', 'prefix_warm').  ``legs``,
    if given, receives each leg's trace, records, router stats, wall s and
    metrics under its name, and the checks' counts under 'checks'."""
    from ..configs import get_arch
    from ..device import resolve_device
    from ..models import lm
    from ..runtime.watchdog import AccuracyWatchdog
    from .serve import prepare_params
    from .steps import _check_continuous

    dev = resolve_device(device)
    if cfg is None:
        cfg = get_arch(arch)
        if reduced:
            cfg = cfg.reduced()
        _check_continuous(cfg)
        params = prepare_params(cfg, lm.init_params(cfg, 0, device=dev), dev)
    if shape is None:
        shape = LoadShape.smoke() if smoke else LoadShape()
    if requests is not None:
        shape = dataclasses.replace(shape, requests=requests)
    legs = {} if legs is None else legs
    around = around_leg or (lambda name: contextlib.nullcontext())
    n = shape.requests
    kn = dict(shape.router_kw(), device=dev)
    tk = dict(buckets=shape.buckets, max_prompt=shape.max_prompt,
              max_new_cap=shape.max_new_cap, mean_gap_s=shape.mean_gap_s)
    trace = make_trace(seed, n, **tk)
    tag = f"R{n}s{shape.slots}x{shape.max_prompt}+{shape.max_new_cap}"

    def leg(name, trace, check_terminal=True, **kw):
        with around(name):
            recs, st, wall = asyncio.run(_run_leg(cfg, params, trace,
                                                  **{**kn, **kw}))
        if check_terminal:
            _assert_terminal(recs, st, name)
        legs[name] = {"trace": trace, "records": recs, "stats": st,
                      "wall_s": wall, "metrics": _metrics(recs, st, wall)}
        return recs, st, legs[name]["metrics"]

    # warm up (an admission per bucket, a chunked one, the segment) so
    # the timed legs measure serving, not first calls
    log("[loadtest] warmup")
    rng = np.random.default_rng(seed + 1)
    warm = [{"t": 0.0, "prompt": rng.integers(1, 1000, S, dtype=np.int32),
             "max_new": 2, "priority": 0, "deadline_s": None,
             "deadline_steps": None, "disconnect_after": None}
            for S in tuple(shape.buckets) + (shape.max_prompt - 1,)]
    leg("warmup", warm, check_terminal=False)

    log(f"[loadtest] plain leg: {n} requests")
    plain, st_p, m_plain = leg("plain", trace)

    log(f"[loadtest] chaos leg: fault schedule seed={chaos_seed}")
    inj = chaos_injector(shape, cfg, st_p["segments"], chaos_seed)
    chaos, st_c, m_chaos = leg("chaos", trace, injector=inj,
                               monitor=AccuracyWatchdog(None),
                               snapshot_every=4)
    legs["chaos"]["injector"] = inj
    hit_rids = set(st_c["corrupted_requests"])
    hit = {i for i, r in enumerate(chaos) if r.get("rid") in hit_rids}
    n_both = _check_bitwise(trace, plain, chaos, skip=hit)
    hit_ok = [i for i in sorted(hit)
              if plain[i]["status"] == chaos[i]["status"] == "ok"]
    hit_equal = sum(plain[i]["tokens"] == chaos[i]["tokens"]
                    for i in hit_ok)
    checks = legs.setdefault("checks", {})
    checks.update(chaos_bitwise=n_both, corrupted=sorted(hit),
                  corrupted_ok=len(hit_ok), corrupted_ok_equal=hit_equal)
    log(f"[loadtest] bitwise ok-vs-ok agreement: {n_both} requests; "
        f"a flip hit {sorted(hit)}, {hit_equal} of their {len(hit_ok)} ok "
        "in both legs still equal")
    if shape.direct:
        checks["direct"] = _check_vs_continuous(
            cfg, params, trace, plain, buckets=shape.buckets,
            seg_len=shape.seg_len, page_size=shape.page_size, device=dev)
        log(f"[loadtest] bitwise vs serve_continuous: {checks['direct']} "
            "requests")
    rows = [_row("plain", tag, m_plain), _row("chaos", tag, m_chaos)]
    if prefix:
        n_p = shape.prefix_requests or n
        sysp = np.random.default_rng(seed + 3).integers(1, 1000, 8,
                                                        dtype=np.int32)
        ptrace = make_trace(seed + 2, n_p, **tk, shared_prefix=sysp,
                            shared_frac=0.75)
        # the cold leg: the same all-chunked page-aligned admissions with
        # sharing off, the bitwise-comparable one
        cold = dict(buckets=(), chunk_len=shape.page_size)
        log(f"[loadtest] prefix cold leg: {n_p} requests (all-chunked)")
        pcold, _, _ = leg("prefix_cold", ptrace, **cold)
        log("[loadtest] prefix warm leg: prefix_cache=True")
        pwarm, st_pw, m_pfx = leg("prefix_warm", ptrace, prefix_cache=True,
                                  **cold)
        n_hit = _check_bitwise(ptrace, pcold, pwarm)
        checks["prefix_bitwise"] = n_hit
        px = st_pw["prefix"]
        assert px["hits"] > 0, f"shared trace produced no hits: {px}"
        removed = 1.0 - px["prefill_positions_computed"] \
            / max(px["prefill_positions_total"], 1)
        log(f"[loadtest] prefix: bitwise ok-vs-ok {n_hit} requests, "
            f"{px['hits']}/{px['lookups']} hits, "
            f"{removed:.2f} prefill removed")
        row = _row("plain", tag, m_pfx)     # base fields, then the ledger
        rows.append({
            "name": f"serve/prefix_router/{tag}",
            "us": row["us"],
            "derived": (f"{row['derived']};hits={px['hits']};"
                        f"lookups={px['lookups']};"
                        f"hit_tokens={px['hit_tokens']};"
                        f"pages_deduped={px['pages_deduped']};"
                        f"prefill_removed_frac={removed:.3f};"
                        f"pages_retained="
                        f"{st_pw['pages']['retained_pages']};"
                        f"bitwise_ok={n_hit}")})
    for kind, m in (("plain", m_plain), ("chaos", m_chaos)):
        log(f"[loadtest] {kind}: p50 {m['p50_ms']:.1f}ms "
            f"p99 {m['p99_ms']:.1f}ms (of {m['latencies']}) "
            f"{m['tok_s']:.1f} tok/s refusal {m['refusal_rate']:.3f} "
            f"occupancy {m['occupancy']:.2f} statuses {m['statuses']}")
    return rows, m_plain, m_chaos


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="mini trace: 24 requests through 2 slots")
    ap.add_argument("--requests", type=int, default=None,
                    help="trace size (default: 24 smoke / 1000 full)")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace seed (arrivals, lengths, budgets)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="FailureInjector.sampled seed: reproduces a fault "
                         "schedule exactly")
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=CONTINUOUS_ARCHS)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="add the shared-system-prompt prefix legs: "
                         "bitwise hit-vs-cold under the trace's traffic and "
                         "a serve/prefix_router row")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced smoke-test width instead of "
                         "the published one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    rows, _, _ = run_loadtest(args.smoke, requests=args.requests,
                              seed=args.seed, chaos_seed=args.chaos_seed,
                              arch=args.arch, prefix=args.prefix_cache,
                              reduced=args.reduced, device=args.device)
    for r in rows:
        print(f"{r['name']},{r['us']:.0f},{r['derived']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
