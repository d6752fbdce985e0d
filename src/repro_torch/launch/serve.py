"""Batched serving with the DS-CIM approximate-MVM path as a serving
option (port of ``serve_batch``, ``serve_continuous``, ``logit_drift_rmse``
and the CLI of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --dscim kernel:dscim1:256 --kv int8

serves ``--arch`` (any registered token-input config, default
qwen3-0.6b) at its published width on the GPU (``--reduced`` cuts it to
the smoke-test size, ``--device cpu`` runs the plain PyTorch versions on
the CPU) and prints tok/s for the float path and the DS-CIM path, their
token agreement and the prefill logit RMSE between them.  The RWKV6 and
Zamba2 configs (rwkv6-7b, zamba2-7b) serve with ``--dscim off|float --kv
float`` and without ``--continuous`` or ``--spec``, as the reference
serves them.

Generation replays one captured decode step as a CUDA graph (launch/
steps.py, launch/graph.py): one host call per token instead of one per
kernel.  ``--host-loop`` runs the eager loop instead (the A/B baseline).
``--temp``/``--top-k``/``--top-p`` sample instead of taking the argmax.
``--no-prepare`` quantizes the DS-CIM weights at every call instead of
once before serving (the A/B of the quantize-once weights).
``--continuous`` serves ``--requests`` prompts through ``--batch``
persistent slots, admitting between segments of ``--segment-len`` steps
(runtime/serving.py).  ``--spec dscim2:<k>`` turns on self-speculative
decoding: each window drafts k tokens through the cheaper estimator on
the same prepared weights and verifies them with one batched forward
through ``--dscim`` (greedy output bitwise the plain output).
``--prefix-cache`` admits the ``--continuous`` queue through the prefix
cache (a shared system prompt over 3/4 of it); ``--prefix-drill`` runs
the prefix cache's self-verifying drill (runtime/serving.py).
``--integrity verify|scrub:<n>`` checks the ``--continuous`` run's int8
pages and weight planes; ``--sampled-chaos`` arms a fault schedule drawn
from ``--chaos-seed`` on it; ``--chaos`` and ``--integrity-drill`` run
the watchdog's and the integrity layer's self-verifying drills.

``--mesh SPEC`` ('model=N' or 'data=D,model=M') serves under a mesh, one
process a device, every rank the same program:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh model=2

(launch/mesh.py ``init_distributed``: NCCL on CUDA, device ``LOCAL_RANK``;
gloo with ``--device cpu``).  Prepared weights split N over ``model``, the
fused MVM and the paged read run placed on the mesh, the MoE experts with
expert parallelism, the RWKV6 and Mamba2 scans on this rank's heads and
batch slice; the tokens are those of one device.  ``--continuous`` takes
``--integrity`` and ``--sampled-chaos`` under a mesh; the three drills
(``--chaos``, ``--integrity-drill``, ``--prefix-drill``) run on one
device, as the reference runs them.  Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import TOKEN_ARCHS, get_arch
from ..core.qweights import map_params
from ..device import resolve_device
from ..models import lm
from ..models.registry import get_model
from .steps import (_check_kv, clear_graphs, make_generate_fn,
                    prepare_serving_params)

__all__ = ["serve_batch", "serve_continuous", "prepare_params",
           "clear_graphs", "logit_drift_rmse", "main"]


def _to(params, device):
    from ..parallel import Sharded

    def move(_, a):
        if isinstance(a, Sharded) and isinstance(a.local, torch.Tensor):
            return a if a.local.device == device else \
                Sharded(a.local.to(device), a.spec, a.shape)
        return a.to(device) if isinstance(a, torch.Tensor) else a
    return map_params(move, params)


def prepare_params(cfg, params, device=None, par=None, *,
                   prepare: bool = True):
    """``params`` as the serving entry points use them: on ``device`` (CUDA
    unless 'cpu' is asked for), DS-CIM-eligible weights quantized once
    into int8 planes (no-op when cfg.dscim is 'off') and the layers cast
    to the compute dtype; with ``par`` placed on that mesh (the
    reference's ``_place``: launch/sharding.py's rules, each rank keeps
    its pieces).  Prepared params pass through unchanged, the same
    tensors: a caller that serves many requests prepares once and hands
    these to ``serve_batch``, whose captured decode graph then stays
    bound to them (other tensors capture it again).  ``prepare=False``
    keeps the float weights (placed and cast all the same): every DS-CIM
    matmul then quantizes its weight at each call, the reference's
    ``--no-prepare`` A/B, bitwise the prepared path under f32 compute."""
    dev = resolve_device(device)
    params = _to(params, dev)
    if prepare:
        out = prepare_serving_params(cfg, params, par)
    elif par is not None:
        from .sharding import shard_params
        out = shard_params(params, par)
    else:
        out = params
    return get_model(cfg).cast_layers(out, lm.DTYPES[cfg.compute_dtype])


_place = prepare_params


def serve_batch(cfg, params, prompts, n_tokens: int, *,
                trace_logits: bool = False, eos_id: int | None = None,
                kv: str = "float", page_size: int = 8, max_new=None,
                scan: bool = True, sample: str = "greedy", rng_seed: int = 0,
                device=None, timings: dict | None = None,
                return_cache: bool = False, spec: str | None = None,
                spec_stats: bool = False, par=None, prepare: bool = True):
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
    (tensors on device), last.  ``timings`` also gets 'graph' (whether
    the decode step replayed a captured graph) and, where a graph was
    asked for on CUDA and the step ran eagerly, 'eager_reason'.

    ``par``: serve under that mesh (launch/mesh.py); ``params`` are placed
    by ``prepare_params(..., par)`` and every rank returns the tokens and
    logits one device would, the same on every rank.  ``prepare=False``:
    the weights stay float and are quantized at every call
    (``prepare_params``), bitwise the prepared path under f32 compute."""
    _check_kv(cfg, kv)
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    params = prepare_params(cfg, params, dev, par, prepare=prepare)
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
                                sample=sample, scan=scan, spec=spec, par=par)
    out, logits, cache = generate(params, tokens, budgets, rng_seed)
    sync()
    t2 = time.perf_counter()
    if timings is not None:
        timings.update(prepare_s=t1 - t0, generate_s=t2 - t1,
                       graph=generate.last_graph)
        if generate.eager_reason is not None:
            timings["eager_reason"] = generate.eager_reason
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
        return result + (map_params(lambda _, t: t.clone(), cache),)
    return result


def serve_continuous(cfg, params, prompts, n_tokens: int, *,
                     slots: int = 4, seg_len: int = 4, max_new=None,
                     eos_id: int | None = None, sample: str = "greedy",
                     kv: str = "float", page_size: int = 8,
                     n_pages: int | None = None, rng_seed: int = 0,
                     spec: str | None = None, deadline_steps=None,
                     deadline_s=None, priority=None, monitor=None,
                     injector=None, snapshot_every: int = 0,
                     max_replays: int = 3, watchdog=None,
                     integrity: str = "off", prefix_cache=False,
                     device=None, log=print, par=None):
    """Continuous-batching scheduler: serve a queue of R requests through
    ``slots`` persistent decode slots.

    prompts (R, S) int: the request queue (one prompt length per
    scheduler).  Between segments of ``seg_len`` done-masked decode steps
    (launch/steps.py ``make_segment_fn``: replays of the captured step on
    the card) the host admits waiting requests into freed slots with one
    prefill each (``make_admit_fn``); the KV cache, per-slot positions,
    done mask and sampler keys persist across segments.  A request
    completes on EOS (``eos_id``) or its budget (``max_new`` (R,), default
    ``n_tokens``, counted including the prefill token), releasing its slot
    and, for ``kv='int8'``, its physical pages (``n_pages`` sizes the pool
    independently of slots x max_len; an admission waits while the pool
    is full, and a pool too small for any one request raises).

    Returns (outputs, stats) as ``runtime/serving.py serve_continuous_ft``
    documents: ``outputs[r]`` is request r's np.int32 tokens (<= its
    budget, ending at EOS if hit); ``stats`` has wall time, tok/s over
    useful tokens, occupancy = live slot-steps / slot-steps, segments,
    statuses, the fault and prefix counters below, the captures' times
    and the allocator's page stats.

    Failure semantics (checked between segments only, so a request can
    overrun by at most one segment):

    * **Statuses.**  ``stats['status'][r]`` is ``'ok'`` (ran to EOS or
      its budget, possibly through a failover replay or an eviction round
      trip) or ``'deadline'`` (cancelled at a segment boundary;
      ``outputs[r]`` holds its partial tokens, a valid prefix, possibly
      none if it never left the queue).
    * **Deadlines.**  ``deadline_steps`` (R,): a budget of decode steps on
      the global ledger (a segment counts ``seg_len * (k+1)``; negative =
      none).  ``deadline_s`` (R,): wall seconds from the request's
      admission (<= 0 = none).
    * **Eviction** (``priority`` (R,), int8 KV only): when the pool
      blocks an admission, live requests of *strictly* lower priority are
      preempted, lowest first and youngest on ties; their pages are
      parked on the host bit for bit and the request resumes mid-stream
      once pages free, its tokens unchanged
      (``stats['evictions'/'readmissions'/'evicted_requests']``).
    * **Snapshots and failover** (``snapshot_every`` > 0, ``injector``
      a runtime/failover.py ``FailureInjector(fail_at=...)``): the serve
      state, the scheduler's books, the allocator and the prefix index
      are copied to the host every N boundaries; an injected device loss
      restores the latest copy and replays from it, bitwise, up to
      ``max_replays`` times (``stats['replays']``; ``log`` gets one line
      a restart).
    * **Prefix caching** (``prefix_cache``, int8 KV only): True/'on'
      admits every request as page-aligned chunks of one captured extend
      graph (launch/steps.py ``make_extend_fn``, ``chunk_len =
      page_size``) and shares physical pages across page-aligned prompt
      prefixes (core/kvcache.py ``PrefixCache``): a hit maps its leading
      page-table entries at the donor's pages and prefills from the
      first divergent page, and its tokens are bitwise those of a cold
      admission.  'cold' runs the same chunked admissions with sharing
      off.  ``stats['prefix']`` has the index's hits, hit tokens, pages
      deduped, prefill positions computed and in total, and the hit and
      miss admission latencies.
    * **Accuracy watchdog** (``monitor``, a runtime/watchdog.py
      ``AccuracyWatchdog``, usually runtime/serving.py
      ``watchdog_for_spec(cfg.dscim)``): every ``probe_every`` segments an
      exact-mode decode of the same (token, cache) is compared with the
      segment's first serving logits; a slot that drifts past the
      threshold or goes NaN/Inf is quarantined, its tokens discarded, and
      its request served again down the ladder dscim2 -> dscim1 -> exact
      (``stats['quarantined'/'escalations'/'probes'/'probe_trips']``).
      ``watchdog`` (a ``Watchdog``) counts stragglers and turns a hang
      into a replay.  The injector's ``macro_fault_at`` arms a stuck-at
      macro fault (a second, faulted segment runner) and its
      ``page_flips`` / ``weight_flips`` flip bits in place
      (``stats['corrupted_requests']``).
    * **Integrity** (``integrity`` 'verify' | 'scrub:<n>', int8 KV only):
      checksummed pages and digested weight planes checked every n-th
      boundary; a corrupted plane is restored from its golden copy in
      place (with a replay if decodes read it), a corrupted page rewinds
      its owner slot alone (``stats['integrity']``).  Weight flips stay in
      prepared params passed in when nothing repairs them.

    ``spec`` ('<variant>:<k>'): each segment step is a
    draft/verify window, and every slot's capacity and page grant gain k
    positions of headroom; each request's tokens are bitwise those
    without spec under greedy decoding.  ``params`` go through
    ``prepare_params``; ``device``: CUDA unless 'cpu' is asked for.

    ``par``: serve under that mesh, every rank running the same scheduler
    on the same queue and returning the same outputs.  The host decisions
    a rank could take alone are taken together: ``deadline_s`` expiries
    by the first rank's clock, a ``watchdog``'s hang on any rank agreed
    over the mesh; ``integrity`` digests each rank's pieces and pages and
    agrees the findings, named as one device names them; an injector's
    weight flip hits the rank whose piece holds its element."""
    from ..runtime.serving import serve_continuous_ft
    _check_kv(cfg, kv)
    dev = resolve_device(device)
    params = prepare_params(cfg, params, dev, par)
    return serve_continuous_ft(
        cfg, params, prompts, n_tokens, slots=slots, seg_len=seg_len,
        max_new=max_new, eos_id=eos_id, sample=sample, kv=kv,
        page_size=page_size, n_pages=n_pages, rng_seed=rng_seed,
        deadline_steps=deadline_steps, deadline_s=deadline_s,
        priority=priority, monitor=monitor, injector=injector,
        snapshot_every=snapshot_every, max_replays=max_replays,
        watchdog=watchdog, spec=spec, integrity=integrity,
        prefix_cache=prefix_cache, device=dev, log=log, par=par)


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
    ap.add_argument("--arch", default="qwen3-0.6b", choices=TOKEN_ARCHS)
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
    ap.add_argument("--no-prepare", action="store_true",
                    help="quantize the DS-CIM weights at every call instead "
                         "of once before serving (A/B; one-shot batches)")
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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share int8 KV pages across page-aligned prompt "
                         "prefixes on the --continuous run (refcounted "
                         "pages + prefix-hash index, core/kvcache.py): "
                         "hits skip prefill for the shared pages, "
                         "bitwise; requires --kv int8")
    ap.add_argument("--prefix-drill", action="store_true",
                    help="run the self-verifying prefix-cache drill "
                         "(runtime/serving.py prefix_drill): staggered "
                         "admissions with a shared system prompt, warm "
                         "vs cold legs; asserts bitwise parity, page "
                         "dedup, >40%% prefill positions skipped and a "
                         "drained pool")
    ap.add_argument("--chaos", action="store_true",
                    help="run the self-verifying chaos drill "
                         "(runtime/serving.py chaos_drill): a device loss, "
                         "page-pool bit flips, a stuck-at macro fault and a "
                         "deadline over the fault-tolerant scheduler")
    ap.add_argument("--integrity", default="off", metavar="MODE",
                    help="integrity checks of the --continuous run "
                         "(runtime/integrity.py): 'off', 'verify' (every "
                         "segment boundary) or 'scrub:<n>' (every n-th): "
                         "checksummed int8 KV pages and prepared-weight "
                         "digests with targeted repair; requires --kv int8")
    ap.add_argument("--integrity-drill", action="store_true",
                    help="run the self-verifying integrity drill "
                         "(runtime/serving.py integrity_drill): page and "
                         "weight-plane bit flips under scrub:2, found at "
                         "their coordinates and repaired, outputs bitwise "
                         "the fault-free run")
    ap.add_argument("--sampled-chaos", action="store_true",
                    help="arm a FailureInjector.sampled schedule (seeded by "
                         "--chaos-seed) on the --continuous run: a device "
                         "loss and page/weight bit flips; pairs with "
                         "--integrity")
    ap.add_argument("--chaos-seed", type=int, default=0, metavar="SEED",
                    help="seed of the drills' weights and prompts and of "
                         "--sampled-chaos' schedule, so a failure "
                         "reproduces from the logged seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="serve under a mesh, e.g. 'model=2' or "
                         "'data=2,model=2': one process a device under "
                         "torchrun --nproc-per-node data*model (NCCL; "
                         "gloo with --device cpu); only rank 0 prints")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    args = ap.parse_args(argv)
    if not args.mesh:
        return _run(args, resolve_device(args.device), None)
    from .mesh import init_distributed, parallel_ctx_from_spec, \
        parse_mesh_spec
    parse_mesh_spec(args.mesh)
    drills = [f"--{f.replace('_', '-')}" for f in
              ("chaos", "integrity_drill", "prefix_drill") if getattr(args, f)]
    if drills:
        raise ValueError(f"{', '.join(drills)} run on one device, as the "
                         "reference runs its drills: drop --mesh (it serves "
                         "--continuous, with --integrity and "
                         "--sampled-chaos, and one-shot batches)")
    import os
    import sys

    import torch.distributed as dist
    dev = init_distributed(args.device)
    try:
        par = parallel_ctx_from_spec(args.mesh)
        if dist.get_rank() != 0:           # every rank serves, rank 0 prints
            sys.stdout = open(os.devnull, "w")
        rc = _run(args, dev, par)
        # every rank done with its last collective before any tears its
        # connections down (a gloo peer cut off mid-transfer aborts)
        dist.barrier()
        return rc
    finally:
        dist.destroy_process_group()


def _run(args, dev, par) -> int:
    """``main`` after the device (and under ``--mesh`` the mesh) is set."""
    if args.chaos or args.integrity_drill:
        from ..runtime import serving
        drill = serving.chaos_drill if args.chaos \
            else serving.integrity_drill
        drill(args.arch, seed=args.chaos_seed, device=dev)
        return 0
    if args.prefix_drill:
        from ..runtime.serving import prefix_drill
        prefix_drill(args.arch, seed=args.seed, device=dev)
        return 0
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    sample = _sample_spec(args)
    params = get_model(cfg).init_params(cfg, args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    runs = [("off", cfg)]
    if args.dscim != "off":
        runs.append((args.dscim, dataclasses.replace(cfg, dscim=args.dscim)))
    name = f"{cfg.name}{' (reduced)' if args.reduced else ''} on {dev}" \
        + (f" under mesh {args.mesh}" if par is not None else "")

    if args.continuous:
        if args.no_prepare:
            raise ValueError("--no-prepare serves one-shot batches; the "
                             "continuous scheduler prepares once")
        prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len),
                               dtype=np.int64)
        if args.prefix_cache:
            # a shared page-aligned "system prompt" over 3/4 of the queue,
            # so the prefix index has something to hit
            shared = max(args.prompt_len // 2, args.page_size)
            prompts[:args.requests * 3 // 4, :shared] = prompts[0, :shared]
        # skewed per-request budgets exercise slot recycling
        budgets = rng.integers(max(2, args.tokens // 4), args.tokens + 1,
                               (args.requests,), dtype=np.int32)
        for tag, c in runs:
            injector = None
            if args.sampled_chaos:
                from ..runtime.failover import FailureInjector
                # a fresh injector a run: its fired-once set is stateful
                injector = FailureInjector.sampled(
                    args.chaos_seed, segments=8, slots=args.batch,
                    n_layers=c.n_layers, page_size=args.page_size,
                    device_losses=1, flips=2,
                    weight_paths=("layers/mlp/w_up",) if tag != "off"
                    else (), weight_flip_count=1 if tag != "off" else 0)
            _, stats = serve_continuous(
                c, params, prompts, args.tokens, slots=args.batch,
                seg_len=args.segment_len, max_new=budgets,
                eos_id=args.eos if args.eos is not None else -1,
                sample=sample, kv=args.kv, page_size=args.page_size,
                device=dev, spec=args.spec if tag != "off" else None,
                prefix_cache=args.prefix_cache, injector=injector,
                snapshot_every=1 if injector is not None else 0,
                integrity=args.integrity, par=par)
            pages = stats["pages"]
            pf = stats["prefix"]
            ig = stats["integrity"]
            print(f"[serve-cb] dscim={tag} kv={args.kv} {name}: "
                  f"{stats['tok_s']:.1f} tok/s over "
                  f"{stats['useful_tokens']} useful tokens, occupancy "
                  f"{stats['occupancy']:.2f} "
                  f"({stats['live_slot_steps']}/{stats['slot_steps']} "
                  f"slot-steps live, {stats['segments']} segments of "
                  f"{args.segment_len})"
                  + (f", pages high water {pages['high_water']}/"
                     f"{pages['n_pages']}" if pages else "")
                  + (f", prefix: {pf['hits']}/{pf['lookups']} hits, "
                     f"{pf['pages_deduped']} pages deduped, "
                     f"{pf['prefill_positions_computed']}/"
                     f"{pf['prefill_positions_total']} prefill positions "
                     "computed" if pf else "")
                  + (f", integrity: {ig['checks']} checks, "
                     f"{ig['page_mismatches']}p/{ig['weight_mismatches']}w "
                     f"mismatches, {ig['page_repairs'] + ig['weight_repairs']}"
                     f" repairs" if ig else "")
                  + (f", {stats['replays']} replays ("
                     f"{ig['replays'] if ig else 0} for integrity), "
                     f"corrupted {stats['corrupted_requests']}"
                     if injector else ""))
        return 0

    mode = "host loop" if args.host_loop else (
        "graph" if dev.type == "cuda" and (par is None or par.capturable)
        else "step loop")
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
            spec_stats=True, par=par, prepare=not args.no_prepare)
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
