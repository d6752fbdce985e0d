"""CI bench-regression gate on the port (port of the reference's
``tools/bench_regression.py``): six legs on the reduced qwen3-0.6b, each
held to bounds from ``ci_thresholds.json`` beside this file (a copy of the
reference's ``tools/ci_thresholds.json``, held equal to it by the tests).

    python -m repro_torch.launch.bench_regression --smoke            # CUDA
    python -m repro_torch.launch.bench_regression --smoke --device cpu

Exit 0 on pass, 1 on drift; each crossed bound prints a ``BENCH
REGRESSION:`` line on stderr naming its leg.  The legs, in the
reference's order and at its shapes (``--smoke`` shortens legs 1, 4 and 5
as the reference's does):

1. ``paged_kernel_vs_gather``: the float model, int8 paged KV at page 4,
   4 prompts of 16, served with ``paged_attn='kernel'`` (the
   paged-attention kernel) and ``'jnp'`` (the plain read): matched-prefix
   logit RMSE (``logit_drift_rmse``) and token agreement between the two.
2. ``chaos_monitor_overhead``: ``kernel:dscim1:256``, a queue of 4 prompts
   of 8 through 2 slots in segments of 4, served plain and with the
   accuracy watchdog (``watchdog_for_spec(spec, probe_every=8)``) and a
   snapshot every 8 boundaries: median of 3 warmed runs each, the ratio.
   The queue does not shrink under ``--smoke``.
3. ``integrity_overhead``: the same queue with ``integrity='off'`` and
   ``'scrub:2'``, interleaved, min of 5 after one warm run each: the
   ratio.
4. ``spec_acceptance``: ``spec='dscim2:4'`` tokens bitwise the plain
   driver's, and the greedy acceptance rate Σ(emitted - 1) / Σ windows / k.
5. ``prefix_cache``: a 90 %-shared queue of 6 prompts of 16, page 4,
   ``prefix_cache='cold'`` against ``'on'``, the second run of each after
   a warm pair: outputs bitwise, the fraction of prefill positions
   removed, the mean hit over cold admission latency.  The reference
   passes ``prepare=False``; the port's ``serve_continuous`` always
   prepares the weights, and none of the three contracts depends on it.
6. ``router_loadtest``: the load test's smoke (``run_loadtest(smoke=True,
   reduced=True)``: the reference's always serves the reduced config, the
   port's only when asked), which asserts its own liveness contract: the
   worst leg's p99/p50 latency ratio and refusal rate.

Weights are random from seed 0 (``lm.init_params``; each leg but the last
may be handed other params, as the CPU tests hand it the reference's).
The clock is the host's around a call whose result is on the host; on
CUDA the device is synchronized before the clock stops.  A value exactly
at its bound passes, as in the reference; a NaN fails.

``measure`` runs the legs and returns their values (``chip_smoke.py``'s
``bench_regression`` phase calls it with ``around``, a context per leg in
which it counts the kernels' launches); ``check`` and ``report`` hold them
to the thresholds; ``main`` does all three.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

__all__ = ["THRESHOLDS", "LEGS", "CHECKS", "load_thresholds", "timed",
           "measure", "check", "report", "main"]

THRESHOLDS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "ci_thresholds.json")
ARCH = "qwen3-0.6b"
SPEC = "kernel:dscim1:256"

LEGS = ("paged_kernel_vs_gather", "chaos_monitor_overhead",
        "integrity_overhead", "spec_acceptance", "prefix_cache",
        "router_loadtest")

# (leg, value, threshold key, kind, message): 'max' fails unless value <=
# bound, 'min' unless value >= bound, 'true' unless the value is true
CHECKS = (
    ("paged_kernel_vs_gather", "rmse", "paged_kernel_vs_gather_logit_rmse",
     "max", "paged-attention kernel drifted from the jnp gather reference"),
    ("paged_kernel_vs_gather", "agreement",
     "paged_kernel_vs_gather_token_agreement", "min",
     "paged-attention kernel drifted from the jnp gather reference"),
    ("chaos_monitor_overhead", "ratio", "chaos_monitor_overhead_ratio",
     "max", "fault-free monitoring overhead of the serving runtime "
     "exceeded its bound"),
    ("integrity_overhead", "ratio", "integrity_scrub_overhead_ratio", "max",
     "fault-free integrity scrubbing overhead exceeded its bound"),
    ("spec_acceptance", "match", None, "true",
     "greedy self-speculative output drifted from the plain driver "
     "(bitwise-parity contract)"),
    ("spec_acceptance", "rate", "spec_greedy_acceptance_rate_min", "min",
     "greedy self-spec acceptance rate collapsed below its bound"),
    ("prefix_cache", "match", None, "true",
     "prefix-cached serving drifted from the cold chunked reference "
     "(bitwise-parity contract)"),
    ("prefix_cache", "removed", "prefix_flops_removed_min", "min",
     "prefix caching stopped removing prefill work — shared pages are "
     "being re-fed"),
    ("prefix_cache", "admit_ratio", "prefix_hit_admission_latency_ratio_max",
     "max", "prefix-hit admission latency no longer beats a cold admission "
     "— dedup is not skipping chunks"),
    ("router_loadtest", "p99_p50", "router_p99_p50_ratio_max", "max",
     "router tail latency collapsed — p99/p50 exceeded its bound "
     "(head-of-line blocking?)"),
    ("router_loadtest", "refusal", "router_refusal_rate_max", "max",
     "router refusal rate exceeded its bound — admission control is "
     "shedding most of a modest trace"),
)


def load_thresholds() -> dict:
    with open(THRESHOLDS) as f:
        return json.load(f)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, *args, n: int = 3, warmup: int = 1, device=None,
          walls: list | None = None) -> float:
    """Median wall time (us) of ``fn(*args)`` after ``warmup`` calls; on
    CUDA the device is synchronized before each clock stops.  ``walls``,
    if given, receives each timed call's seconds."""
    for _ in range(warmup):
        fn(*args)
        _sync(device or "cpu")
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device or "cpu")
        ts.append(time.perf_counter() - t0)
    if walls is not None:
        walls.extend(ts)
    ts.sort()
    return ts[len(ts) // 2] * 1e6


def _model(dev, dscim=None, params=None):
    """The reduced config (with ``dscim`` where given) and its params:
    ``params`` if given, else random from seed 0 on ``dev``."""
    from ..configs import get_arch
    from ..models.registry import get_model
    cfg = get_arch(ARCH).reduced()
    if dscim is not None:
        cfg = dataclasses.replace(cfg, dscim=dscim)
    if params is None:
        params = get_model(cfg).init_params(cfg, 0, device=dev)
    return cfg, params


def _serve_both_paths(smoke: bool, device=None, params=None, around=None):
    """{path: (tokens, logit trace)} for the kernel and the plain paged
    read on the serve bench's paged-KV smoke shape (float model: the read
    path is the only thing under test).  ``around(name)``, if given, is a
    context entered around each path's request."""
    from ..device import resolve_device
    from .serve import serve_batch
    dev = resolve_device(device)
    cfg, params = _model(dev, params=params)
    B, prompt_len = 4, 16
    n_tokens = 16 if smoke else 48
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (B, prompt_len), dtype=np.int32)
    around = around or (lambda name: contextlib.nullcontext())
    out = {}
    for path in ("kernel", "jnp"):
        with around(f"paged_kernel_vs_gather/{path}"):
            out[path] = serve_batch(cfg, params, prompts, n_tokens,
                                    trace_logits=True, prepare=False,
                                    kv="int8", page_size=4, paged_attn=path,
                                    device=dev)
    return out


def _paged_drift(smoke: bool, device=None, params=None, around=None):
    """(matched-prefix logit RMSE, token agreement) of the plain read
    against the kernel's (leg 1)."""
    from .serve import _agreement, logit_drift_rmse
    out = _serve_both_paths(smoke, device, params, around)
    tk, lk = out["kernel"]
    tj, lj = out["jnp"]
    return (logit_drift_rmse(tj, tk, lj, lk),
            _agreement(np.asarray(tk), np.asarray(tj), None))


def _queue(dev, params):
    """Legs 2 and 3's continuous queue: the ``SPEC`` model, 4 prompts of
    8, budgets 2..8, 2 slots, segments of 4, int8 KV at page 4."""
    cfg, params = _model(dev, SPEC, params)
    R, prompt_len, n_tokens = 4, 8, 8
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (R, prompt_len), dtype=np.int32)
    budgets = np.linspace(2, n_tokens, R).round().astype(np.int32)
    knobs = dict(slots=2, seg_len=4, max_new=budgets, eos_id=-1,
                 kv="int8", page_size=4, device=dev)
    return cfg, params, prompts, n_tokens, knobs


def _chaos_monitor_overhead(smoke: bool, device=None, params=None,
                            runs: dict | None = None) -> float:
    """Fault-free wall-time ratio monitored / plain of ``serve_continuous``
    on a small queue: median of 3 warmed runs a path even under
    ``--smoke``, and the queue does not shrink (below about 8 decode
    segments the one probe and one snapshot are a fixed cost with nothing
    to amortize over).  ``runs``, if given, receives each path's timed
    seconds under 'plain' and 'monitored'."""
    from ..device import resolve_device
    from ..runtime.serving import watchdog_for_spec
    from .serve import serve_continuous
    dev = resolve_device(device)
    cfg, params, prompts, n_tokens, knobs = _queue(dev, params)
    monitor = watchdog_for_spec(SPEC, probe_every=8)

    def plain():
        return serve_continuous(cfg, params, prompts, n_tokens, **knobs)[0]

    def monitored():
        return serve_continuous(cfg, params, prompts, n_tokens, **knobs,
                                monitor=monitor, snapshot_every=8)[0]

    runs = {} if runs is None else runs
    us_plain = timed(plain, n=3, device=dev,
                     walls=runs.setdefault("plain", []))
    us_mon = timed(monitored, n=3, device=dev,
                   walls=runs.setdefault("monitored", []))
    return us_mon / us_plain


def _integrity_overhead(smoke: bool, device=None, params=None,
                        runs: dict | None = None) -> float:
    """Fault-free wall-time ratio scrub:2 / off of ``serve_continuous`` on
    leg 2's queue: min of 5 over interleaved off / scrub runs after one
    warm run each (interleaved minima track the noise floor both share,
    which is what the bound is about).  ``runs``, if given, receives each
    path's timed seconds under 'off' and 'scrub'."""
    from ..device import resolve_device
    from .serve import serve_continuous
    dev = resolve_device(device)
    cfg, params, prompts, n_tokens, knobs = _queue(dev, params)

    def off():
        return serve_continuous(cfg, params, prompts, n_tokens, **knobs)[0]

    def scrubbed():
        return serve_continuous(cfg, params, prompts, n_tokens, **knobs,
                                integrity="scrub:2")[0]

    off(), scrubbed()          # the first runs of each
    runs = {} if runs is None else runs
    for name in ("off", "scrub"):
        runs.setdefault(name, [])
    for _ in range(5):
        for name, fn in (("off", off), ("scrub", scrubbed)):
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            runs[name].append(time.perf_counter() - t0)
    return min(runs["scrub"]) / min(runs["off"])


def _spec_acceptance(smoke: bool, device=None, params=None):
    """(bitwise match, acceptance rate) of greedy self-speculative serving
    (``dscim2:4`` drafts, the ``SPEC`` verifier, int8 KV at page 4)."""
    from ..device import resolve_device
    from .serve import serve_batch
    dev = resolve_device(device)
    cfg, params = _model(dev, SPEC, params)
    B, prompt_len, k = 4, 8, 4
    n_tokens = 8 if smoke else 16
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (B, prompt_len), dtype=np.int32)
    kw = dict(kv="int8", page_size=4, device=dev)
    t_ref, _ = serve_batch(cfg, params, prompts, n_tokens, **kw)
    t_spec, _, ss = serve_batch(cfg, params, prompts, n_tokens,
                                spec=f"dscim2:{k}", spec_stats=True, **kw)
    match = bool(np.array_equal(t_spec, t_ref))
    accepted = int((ss["emitted"] - 1).sum())
    rate = accepted / max(int(ss["windows"].sum()), 1) / k
    return match, rate


def _prefix_leg(smoke: bool, device=None, params=None):
    """(bitwise match, prefill removed fraction, hit / cold admission
    latency ratio) on the 90 %-shared queue: 6 prompts of 16 whose first
    five share 12 tokens, 2 slots, segments of 2, page 4.  Each leg runs
    twice and the second run's stats are used (the first pair makes the
    runners the second measures)."""
    from ..device import resolve_device
    from .serve import serve_continuous
    dev = resolve_device(device)
    cfg, params = _model(dev, SPEC, params)
    ps, S, R = 4, 16, 6
    n_tokens = 4 if smoke else 8
    rng = np.random.default_rng(0)
    budgets = np.clip(np.linspace(2, n_tokens, R).round(), 2,
                      n_tokens).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (R, S), dtype=np.int32)
    prompts[:round(0.9 * R), :12] = rng.integers(0, cfg.vocab, 12,
                                                 dtype=np.int32)
    knobs = dict(slots=2, seg_len=2, max_new=budgets, eos_id=-1,
                 kv="int8", page_size=ps, device=dev, log=lambda *a: None)

    def leg(mode):
        return serve_continuous(cfg, params, prompts, n_tokens,
                                prefix_cache=mode, **knobs)

    leg("cold"), leg("on")
    out_c, st_c = leg("cold")
    out_w, st_w = leg("on")
    match = len(out_c) == len(out_w) and all(
        np.array_equal(a, b) for a, b in zip(out_c, out_w))
    pw = st_w["prefix"]
    removed = 1.0 - pw["prefill_positions_computed"] \
        / max(pw["prefill_positions_total"], 1)
    lat_cold = float(np.mean(st_c["prefix"]["admit_lat_miss"]))
    lat_hit = float(np.mean(pw["admit_lat_hit"])) if pw["admit_lat_hit"] \
        else float("inf")
    return match, removed, lat_hit / max(lat_cold, 1e-12)


def _router_loadtest(smoke: bool, device=None):
    """(worst-leg p99/p50, worst-leg refusal rate, each leg's numbers)
    from the load test's smoke at the reduced width.  ``run_loadtest``
    asserts the liveness contract itself (every request terminal, no live
    page at drain, ok-vs-ok bitwise between the legs)."""
    from .loadtest import run_loadtest
    _, m_plain, m_chaos = run_loadtest(True, reduced=True, device=device,
                                       log=lambda *a: None)
    per_leg = {name: {"p50_ms": m["p50_ms"], "p99_ms": m["p99_ms"],
                      "refusal_rate": m["refusal_rate"],
                      "refused": m["statuses"]["refused"],
                      "requests": m["requests"], "replays": m["replays"]}
               for name, m in (("plain", m_plain), ("chaos", m_chaos))}
    ratio = max(m["p99_ms"] / max(m["p50_ms"], 1e-9)
                for m in (m_plain, m_chaos))
    refusal = max(m["refusal_rate"] for m in (m_plain, m_chaos))
    return ratio, refusal, per_leg


def measure(smoke: bool = True, device=None, around=None) -> dict:
    """Run the six legs in order; {leg: {value: ..., "wall_s": s}}, legs 2
    and 3 with each timed run's seconds (``runs_s``), leg 6 with each
    load-test leg's numbers (``legs``).  ``around(name)``, if given,
    returns a context entered around each leg (around each path of leg 1,
    named ``paged_kernel_vs_gather/kernel`` and ``/jnp``)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    ctx = around or (lambda name: contextlib.nullcontext())
    monitor_runs, scrub_runs = {}, {}
    legs = (
        ("paged_kernel_vs_gather", ("rmse", "agreement"),
         lambda: _paged_drift(smoke, dev, around=around), False),
        ("chaos_monitor_overhead", ("ratio", "runs_s"),
         lambda: (_chaos_monitor_overhead(smoke, dev, runs=monitor_runs),
                  monitor_runs), True),
        ("integrity_overhead", ("ratio", "runs_s"),
         lambda: (_integrity_overhead(smoke, dev, runs=scrub_runs),
                  scrub_runs), True),
        ("spec_acceptance", ("match", "rate"),
         lambda: _spec_acceptance(smoke, dev), True),
        ("prefix_cache", ("match", "removed", "admit_ratio"),
         lambda: _prefix_leg(smoke, dev), True),
        ("router_loadtest", ("p99_p50", "refusal", "legs"),
         lambda: _router_loadtest(smoke, dev), True))
    out = {}
    for name, keys, run, wrap in legs:
        t0 = time.perf_counter()
        with ctx(name) if wrap else contextlib.nullcontext():
            vals = run()
        out[name] = dict(zip(keys, vals), wall_s=time.perf_counter() - t0)
    return out


def check(values: dict, th: dict) -> list:
    """The crossed bounds, as (leg, threshold key or, for a bitwise flag,
    the value's key, message) in ``CHECKS`` order."""
    bad = []
    for leg, key, bound_key, kind, msg in CHECKS:
        v = values[leg][key]
        bound = th.get(bound_key)
        if kind == "true":
            crossed, what = not v, f"{key} {v}"
        elif kind == "max":
            crossed, what = not v <= bound, f"{bound_key} {v:.6g} > {bound}"
        else:
            crossed, what = not v >= bound, f"{bound_key} {v:.6g} < {bound}"
        if crossed:
            bad.append((leg, bound_key or key,
                        f"BENCH REGRESSION: {msg} [{leg}: {what}]"))
    return bad


def report(values: dict, th: dict, out=None, err=None) -> bool:
    """Print the reference's lines (``out``, default stdout) and one
    ``BENCH REGRESSION:`` line a crossed bound (``err``, default stderr);
    True if no bound was crossed."""
    out, err = out or sys.stdout, err or sys.stderr
    p, c, i, s, x, r = (values[leg] for leg in LEGS)
    print(f"paged kernel vs jnp gather: matched-prefix logit RMSE "
          f"{p['rmse']:.3e} (threshold "
          f"{th['paged_kernel_vs_gather_logit_rmse']:.0e}), token agreement "
          f"{p['agreement']:.4f} (threshold "
          f"{th['paged_kernel_vs_gather_token_agreement']})", file=out)
    print(f"fault-tolerant serving monitoring overhead: "
          f"{c['ratio']:.3f}x plain (threshold "
          f"{th['chaos_monitor_overhead_ratio']}x)", file=out)
    print(f"integrity scrubbing overhead: {i['ratio']:.3f}x off "
          f"(threshold {th['integrity_scrub_overhead_ratio']}x)", file=out)
    print(f"self-speculative greedy serving: bitwise match {s['match']}, "
          f"acceptance rate {s['rate']:.3f} (threshold "
          f"{th['spec_greedy_acceptance_rate_min']})", file=out)
    print(f"prefix cache (90% shared trace): bitwise match {x['match']}, "
          f"prefill removed {x['removed']:.3f} (threshold >= "
          f"{th['prefix_flops_removed_min']}), hit/cold admission latency "
          f"ratio {x['admit_ratio']:.3f} (threshold <= "
          f"{th['prefix_hit_admission_latency_ratio_max']})", file=out)
    print(f"router load test: p99/p50 ratio {r['p99_p50']:.2f} (threshold "
          f"{th['router_p99_p50_ratio_max']}), refusal rate "
          f"{r['refusal']:.3f} (threshold {th['router_refusal_rate_max']})",
          file=out)
    bad = check(values, th)
    for _, _, msg in bad:
        print(msg, file=err)
    return not bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="short trace (the CI leg)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    th = load_thresholds()
    return 0 if report(measure(args.smoke, dev), th) else 1


if __name__ == "__main__":
    sys.exit(main())
