"""Batched serving with the DS-CIM approximate-MVM path as a serving
option (port of ``serve_batch``, ``serve_continuous``, ``logit_drift_rmse``
and the CLI of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --dscim kernel:dscim1:256 --kv int8

serves qwen3-0.6b at its published width on the GPU (``--reduced`` cuts
it to the smoke-test size, ``--device cpu`` runs the plain PyTorch
versions on the CPU) and prints tok/s for the float path and the DS-CIM
path, their token agreement and the prefill logit RMSE between them.

Generation replays one captured decode step as a CUDA graph (launch/
steps.py, launch/graph.py): one host call per token instead of one per
kernel.  ``--host-loop`` runs the eager loop instead (the A/B baseline).
``--temp``/``--top-k``/``--top-p`` sample instead of taking the argmax.
``--continuous`` serves ``--requests`` prompts through ``--batch``
persistent slots, admitting between segments of ``--segment-len`` steps
(runtime/serving.py).  ``--spec dscim2:<k>`` turns on self-speculative
decoding: each window drafts k tokens through the cheaper estimator on
the same prepared weights and verifies them with one batched forward
through ``--dscim`` (greedy output bitwise the plain output).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_arch
from ..device import resolve_device
from ..models import lm
from .steps import clear_graphs, make_generate_fn, prepare_serving_params

__all__ = ["serve_batch", "serve_continuous", "prepare_params",
           "clear_graphs", "logit_drift_rmse", "main"]


def _to(params, device):
    from ..core.qweights import map_params
    return map_params(lambda _, a: a.to(device)
                      if isinstance(a, torch.Tensor) else a, params)


def prepare_params(cfg, params, device=None):
    """``params`` as the serving entry points use them: on ``device`` (CUDA
    unless 'cpu' is asked for), DS-CIM-eligible weights quantized once
    into int8 planes (no-op when cfg.dscim is 'off') and the layers cast
    to the compute dtype.  Prepared params pass through unchanged, the
    same tensors: a caller that serves many requests prepares once and
    hands these to ``serve_batch``, whose captured decode graph then stays
    bound to them (other tensors capture it again)."""
    dev = resolve_device(device)
    out = prepare_serving_params(cfg, _to(params, dev))
    return lm.cast_layers(out, lm.DTYPES[cfg.compute_dtype])


def serve_batch(cfg, params, prompts, n_tokens: int, *,
                trace_logits: bool = False, eos_id: int | None = None,
                kv: str = "float", page_size: int = 8, max_new=None,
                scan: bool = True, sample: str = "greedy", rng_seed: int = 0,
                device=None, timings: dict | None = None,
                return_cache: bool = False, spec: str | None = None,
                spec_stats: bool = False):
    """prompts (B, S) int -> generated (B, n_tokens) int32 numpy, logits
    list (the per-step trace under ``trace_logits``, else [prefill
    logits]), as numpy f32.

    ``params`` go through ``prepare_params`` (a no-op for prepared
    params; pass prepared params to keep the captured decode graph across
    requests).  ``kv``: 'float' dense cache or 'int8' paged cache with ``page_size``
    tokens per page.  ``eos_id`` / ``max_new``: early exit with per-slot
    budgets.  ``scan``: replay the captured decode step (the default; a
    CUDA graph on the card, the same step eagerly on the CPU) or, False,
    run the eager host loop; the two agree bitwise.  ``sample``: 'greedy'
    | 'temp:<t>' | 'topk:<k>[:<t>]' | 'topp:<p>[:<t>]', drawn from a
    generator seeded with ``rng_seed``.  ``device``: CUDA unless 'cpu' is
    asked for; params are moved there if they are elsewhere.
    ``timings``: a dict filled with 'prepare_s', 'generate_s'
    (synchronized wall times) and, where this call captured the decode
    graph, 'capture_s' (inside 'generate_s').  ``spec``: '<variant>:<k>'
    self-speculative decoding (launch/steps.py ``make_generate_fn``):
    each replay drafts k tokens with the cheaper estimator and verifies
    the window in one batched forward; greedy output is bitwise the plain
    output.  ``spec_stats=True`` adds an element ``{"windows": (B,),
    "emitted": (B,)}`` np.int32 (None without spec): per-row verify
    windows and emitted tokens, whose ratio is accepted tokens per
    verify.  ``return_cache``: also return a copy of the final KV cache
    (tensors on device), last."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    params = prepare_params(cfg, params, dev)
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                             device=dev)
    budgets = None
    if max_new is not None:
        if eos_id is None:
            raise ValueError("max_new budgets need the early-exit variant; "
                             "pass eos_id (any id, e.g. -1, works)")
        budgets = torch.as_tensor(np.asarray(max_new), dtype=torch.int32,
                                  device=dev)
    sync()
    t1 = time.perf_counter()
    generate = make_generate_fn(cfg, n_tokens, trace_logits=trace_logits,
                                eos_id=eos_id, kv=kv, page_size=page_size,
                                sample=sample, scan=scan, spec=spec)
    out, logits, cache = generate(params, tokens, budgets, rng_seed)
    sync()
    t2 = time.perf_counter()
    if timings is not None:
        timings.update(prepare_s=t1 - t0, generate_s=t2 - t1)
        if generate.last_capture_s is not None:
            timings["capture_s"] = generate.last_capture_s
    logits = logits.cpu().numpy()
    trace = list(logits) if trace_logits else [logits]
    result = (out.cpu().numpy(), trace)
    if spec_stats:
        stats = generate.last_spec_stats
        result += (None if stats is None else
                   {k: v.cpu().numpy() for k, v in stats.items()},)
    if return_cache:
        return result + ({k: v.clone() for k, v in cache.items()},)
    return result


def serve_continuous(cfg, params, prompts, n_tokens: int, *,
                     slots: int = 4, seg_len: int = 4, max_new=None,
                     eos_id: int | None = None, sample: str = "greedy",
                     kv: str = "float", page_size: int = 8,
                     n_pages: int | None = None, rng_seed: int = 0, spec: str | None = None,
                     deadline_steps=None, deadline_s=None, priority=None,
                     monitor=None, injector=None, snapshot_every: int = 0,
                     watchdog=None, integrity: str = "off",
                     prefix_cache=False, device=None):
    """Continuous-batching scheduler: serve a queue of R requests through
    ``slots`` persistent decode slots.

    prompts (R, S) int: the request queue (one prompt length per
    scheduler).  Between segments of ``seg_len`` done-masked decode steps
    (launch/steps.py ``make_segment_fn``: replays of the captured step on
    the card) the host admits waiting requests into freed slots with one
    prefill each (``make_admit_fn``); the KV cache, per-slot positions,
    done mask and generator persist across segments.  A request completes
    on EOS (``eos_id``) or its budget (``max_new`` (R,), default
    ``n_tokens``, counted including the prefill token), releasing its slot
    and, for ``kv='int8'``, its physical pages (``n_pages`` sizes the pool
    independently of slots x max_len; an admission waits while the pool
    is full, and a pool too small for any one request raises).

    Returns (outputs, stats) as ``runtime/serving.py serve_continuous_ft``
    documents: ``outputs[r]`` is request r's np.int32 tokens (<= its
    budget, ending at EOS if hit); ``stats`` has wall time, tok/s over
    useful tokens, occupancy = live slot-steps / slot-steps, segments,
    statuses, the segment step's capture time (``capture_s``, inside
    ``wall_s``) and the allocator's page stats.

    ``params`` go through ``prepare_params``.  ``device``: CUDA unless 'cpu' is asked for.  The
    fault-tolerance knobs (``deadline_steps``, ``deadline_s``,
    ``priority``, ``monitor``, ``injector``, ``snapshot_every``,
    ``watchdog``, ``integrity``) and ``prefix_cache`` raise
    ``NotImplementedError`` when set: their ROADMAP items (A10, A11) are
    not ported yet.  ``spec`` ('<variant>:<k>'): each segment step is a
    draft/verify window (launch/steps.py ``make_segment_fn``), and every
    slot's capacity and page grant gain k positions of headroom; each
    request's tokens are bitwise those without spec under greedy
    decoding."""
    from ..runtime.serving import serve_continuous_ft
    dev = resolve_device(device)
    params = prepare_params(cfg, params, dev)
    return serve_continuous_ft(
        cfg, params, prompts, n_tokens, slots=slots, seg_len=seg_len,
        max_new=max_new, eos_id=eos_id, sample=sample, kv=kv,
        page_size=page_size, n_pages=n_pages, rng_seed=rng_seed,
        deadline_steps=deadline_steps, deadline_s=deadline_s,
        priority=priority, monitor=monitor, injector=injector,
        snapshot_every=snapshot_every, watchdog=watchdog, spec=spec,
        integrity=integrity, prefix_cache=prefix_cache, device=dev)


def _sample_spec(args) -> str:
    # `is not None` so --temp 0 reaches the sampler's t > 0 validation
    # instead of silently degrading to greedy / t=1
    if args.top_k is not None and args.top_p is not None:
        raise SystemExit("--top-k and --top-p are mutually exclusive")
    if args.top_k is not None:
        return f"topk:{args.top_k}:" \
               f"{args.temp if args.temp is not None else 1.0}"
    if args.top_p is not None:
        return f"topp:{args.top_p}:" \
               f"{args.temp if args.temp is not None else 1.0}"
    if args.temp is not None:
        return f"temp:{args.temp}"
    return "greedy"


def logit_drift_rmse(tokens_ref, tokens_alt, logits_ref, logits_alt) -> float:
    """RMSE between two runs' per-step logit traces on the teacher-
    matched prefix: per row, steps up to and including the first token
    divergence (past it the two runs feed different tokens back)."""
    lf, lq = np.stack(logits_ref), np.stack(logits_alt)
    tokens_ref, tokens_alt = np.asarray(tokens_ref), np.asarray(tokens_alt)
    n = tokens_ref.shape[1]
    errs = []
    for b in range(tokens_ref.shape[0]):
        mism = np.nonzero(tokens_ref[b] != tokens_alt[b])[0]
        end = mism[0] + 1 if len(mism) else n
        errs.append(((lf[:end, b] - lq[:end, b]) ** 2).ravel())
    return float(np.sqrt(np.mean(np.concatenate(errs))))


def _useful_lengths(tokens: np.ndarray, eos_id: int | None) -> np.ndarray:
    """Per-row token count up to and including the first EOS."""
    n = tokens.shape[1]
    if eos_id is None:
        return np.full((tokens.shape[0],), n)
    out = []
    for row in tokens:
        hits = np.nonzero(row == eos_id)[0]
        out.append(int(hits[0]) + 1 if len(hits) else n)
    return np.asarray(out)


def _useful_tokens(tokens: np.ndarray, eos_id: int | None) -> int:
    """Tokens up to and including each row's first EOS: the early-exit
    report must not credit the pad tokens past it."""
    return int(_useful_lengths(tokens, eos_id).sum())


def _agreement(a: np.ndarray, b: np.ndarray, eos_id: int | None) -> float:
    """Token agreement over the reference rows' useful prefixes."""
    lens = _useful_lengths(b, eos_id)
    hits = sum(int((a[i, :l] == b[i, :l]).sum()) for i, l in enumerate(lens))
    return hits / max(int(lens.sum()), 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced smoke-test width instead of "
                         "the published one")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--dscim", default="off",
                    help="off | <mode>[+attn]:<variant>:<L>[:calib], e.g. "
                         "kernel:dscim1:256 (fused kernel hot path) or "
                         "lut:dscim1:256 (oracle, small shapes only)")
    ap.add_argument("--kv", choices=("float", "int8"), default="float",
                    help="KV cache layout: dense float or block-paged int8")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page for --kv int8")
    ap.add_argument("--eos", type=int, default=None, metavar="ID",
                    help="EOS token id: stop once every row has finished")
    ap.add_argument("--host-loop", action="store_true",
                    help="eager host loop (one decode step of kernel "
                         "launches per token) instead of replaying the "
                         "captured decode step (A/B)")
    ap.add_argument("--temp", type=float, default=None,
                    help="temperature sampling (default greedy argmax)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="top-k sampling (combines with --temp)")
    ap.add_argument("--top-p", type=float, default=None,
                    help="top-p (nucleus) sampling: keep the smallest "
                         "probability mass >= p (combines with --temp; "
                         "exclusive with --top-k)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: serve --requests prompts "
                         "through --batch persistent slots, admitting "
                         "between segments of --segment-len steps")
    ap.add_argument("--requests", type=int, default=8,
                    help="queue length for --continuous")
    ap.add_argument("--segment-len", type=int, default=4,
                    help="decode steps per segment for --continuous")
    ap.add_argument("--spec", default=None, metavar="VARIANT:K",
                    help="self-speculative decoding, e.g. 'dscim2:4': "
                         "draft K tokens a window with the cheaper "
                         "estimator on the same prepared weights, verify "
                         "with one batched forward through --dscim; "
                         "greedy output is bitwise the plain output")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    sample = _sample_spec(args)
    params = lm.init_params(cfg, args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    runs = [("off", cfg)]
    if args.dscim != "off":
        runs.append((args.dscim, dataclasses.replace(cfg, dscim=args.dscim)))
    name = f"{cfg.name}{' (reduced)' if args.reduced else ''} on {dev}"

    if args.continuous:
        prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len),
                               dtype=np.int64)
        # skewed per-request budgets exercise slot recycling
        budgets = rng.integers(max(2, args.tokens // 4), args.tokens + 1,
                               (args.requests,), dtype=np.int32)
        for tag, c in runs:
            _, stats = serve_continuous(
                c, params, prompts, args.tokens, slots=args.batch,
                seg_len=args.segment_len, max_new=budgets,
                eos_id=args.eos if args.eos is not None else -1,
                sample=sample, kv=args.kv, page_size=args.page_size,
                device=dev, spec=args.spec if tag != "off" else None)
            pages = stats["pages"]
            print(f"[serve-cb] dscim={tag} kv={args.kv} {name}: "
                  f"{stats['tok_s']:.1f} tok/s over "
                  f"{stats['useful_tokens']} useful tokens, occupancy "
                  f"{stats['occupancy']:.2f} "
                  f"({stats['live_slot_steps']}/{stats['slot_steps']} "
                  f"slot-steps live, {stats['segments']} segments of "
                  f"{args.segment_len})"
                  + (f", pages high water {pages['high_water']}/"
                     f"{pages['n_pages']}" if pages else ""))
        return 0

    mode = "host loop" if args.host_loop else (
        "graph" if dev.type == "cuda" else "step loop")
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int64)
    results = {}
    for tag, c in runs:
        t = {}
        spec = args.spec if tag != "off" else None
        toks, logits, sstats = serve_batch(
            c, params, prompts, args.tokens, eos_id=args.eos, kv=args.kv,
            page_size=args.page_size, scan=not args.host_loop,
            sample=sample, device=dev, timings=t, spec=spec,
            spec_stats=True)
        useful = _useful_tokens(toks, args.eos)
        results[tag] = (toks, logits)
        line = (f"[serve] dscim={tag} kv={args.kv} {name} ({mode}): "
                f"{useful / t['generate_s']:.1f} tok/s ({useful} tokens, "
                f"batch={args.batch}, prepare {t['prepare_s']:.2f} s"
                + (f", capture {t['capture_s']:.2f} s" if "capture_s" in t
                   else "") + ")")
        if tag != "off":
            base_toks, base_logits = results["off"]
            rmse = float(np.sqrt(np.mean((logits[0] - base_logits[0]) ** 2)))
            line += (f", token agreement "
                     f"{_agreement(toks, base_toks, args.eos):.3f}, "
                     f"prefill logit RMSE {rmse:.4f}")
        if sstats is not None:
            tpv = (sstats["emitted"] - 1).sum() / max(
                int(sstats["windows"].sum()), 1)
            line += f", {tpv:.2f} accepted tok/verify (--spec {spec})"
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
