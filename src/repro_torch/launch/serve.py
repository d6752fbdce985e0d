"""Batched serving with the DS-CIM approximate-MVM path as a serving
option (port of ``serve_batch``, ``logit_drift_rmse`` and the one-shot CLI
of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --dscim kernel:dscim1:256 --kv int8

serves qwen3-0.6b at its published width on the GPU (``--reduced`` cuts
it to the smoke-test size, ``--device cpu`` runs the plain PyTorch
versions on the CPU) and prints tok/s for the float path and the DS-CIM
path, their token agreement and the prefill logit RMSE between them.
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
from .steps import make_generate_fn, prepare_serving_params

__all__ = ["serve_batch", "logit_drift_rmse", "main"]


def _to(params, device):
    from ..core.qweights import map_params
    return map_params(lambda _, a: a.to(device)
                      if isinstance(a, torch.Tensor) else a, params)


def serve_batch(cfg, params, prompts, n_tokens: int, *,
                trace_logits: bool = False, eos_id: int | None = None,
                kv: str = "float", page_size: int = 8, max_new=None,
                device=None, timings: dict | None = None,
                return_cache: bool = False):
    """prompts (B, S) int -> generated (B, n_tokens) int32 numpy, logits
    list (the per-step trace under ``trace_logits``, else [prefill
    logits]), as numpy f32.

    DS-CIM-eligible weights are quantized once first (no-op when
    cfg.dscim is 'off').  ``kv``: 'float' dense cache or 'int8' paged cache
    with ``page_size`` tokens per page.  ``eos_id`` / ``max_new``: early
    exit with per-slot budgets.  ``device``: CUDA unless 'cpu' is asked
    for; params are moved there if they are elsewhere.  ``timings``: a dict
    filled with 'prepare_s' and 'generate_s' (synchronized wall times).
    ``return_cache``: also return the final KV cache (tensors on device).
    """
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    params = prepare_serving_params(cfg, _to(params, dev))
    params = lm.cast_layers(params, lm.DTYPES[cfg.compute_dtype])
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
                                eos_id=eos_id, kv=kv, page_size=page_size)
    out, logits, cache = generate(params, tokens, budgets)
    sync()
    t2 = time.perf_counter()
    if timings is not None:
        timings.update(prepare_s=t1 - t0, generate_s=t2 - t1)
    logits = logits.cpu().numpy()
    trace = list(logits) if trace_logits else [logits]
    result = (out.cpu().numpy(), trace)
    return result + (cache,) if return_cache else result


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
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_params(cfg, args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int64)
    runs = [("off", cfg)]
    if args.dscim != "off":
        runs.append((args.dscim, dataclasses.replace(cfg, dscim=args.dscim)))
    results = {}
    for tag, c in runs:
        t = {}
        toks, logits = serve_batch(c, params, prompts, args.tokens,
                                   eos_id=args.eos, kv=args.kv,
                                   page_size=args.page_size, device=dev,
                                   timings=t)
        useful = int(_useful_lengths(toks, args.eos).sum())
        results[tag] = (toks, logits)
        line = (f"[serve] dscim={tag} kv={args.kv} {cfg.name}"
                f"{' (reduced)' if args.reduced else ''} on {dev}: "
                f"{useful / t['generate_s']:.1f} tok/s ({useful} tokens, "
                f"batch={args.batch}, prepare {t['prepare_s']:.2f} s)")
        if tag != "off":
            base_toks, base_logits = results["off"]
            rmse = float(np.sqrt(np.mean((logits[0] - base_logits[0]) ** 2)))
            line += (f", token agreement "
                     f"{_agreement(toks, base_toks, args.eos):.3f}, "
                     f"prefill logit RMSE {rmse:.4f}")
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
