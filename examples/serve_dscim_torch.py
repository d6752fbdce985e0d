"""Batched serving with the DS-CIM compute path on the PyTorch port (the
paper's Table II workflow, as ``examples/serve_dscim.py`` runs it):

1. build the reduced LM with random weights (seed 0),
2. serve a request batch on the float path,
3. serve it again with DS-CIM1 (precise) and DS-CIM2 (efficient) macro
   emulation, the bit-exact LUT estimator and the fused DS-CIM kernel,
4. report throughput, greedy-token agreement and prefill logit RMSE.

  PYTHONPATH=src python examples/serve_dscim_torch.py --tokens 16        # CUDA
  PYTHONPATH=src python examples/serve_dscim_torch.py --device cpu --kv int8

Generation replays one captured decode step as a CUDA graph (launch/
steps.py ``make_generate_fn``); ``--host-loop`` runs the eager loop, one
step and one host look a token (on the CPU both run the step eagerly).

Weights are prepared once by default: every DS-CIM-eligible matrix
becomes a resident window-packed int8 ``QuantizedLinearWeight`` before
serving (the CIM array stores static int8), bitwise the per-call path
under f32 compute (the reduced configs).  ``--no-prepare`` quantizes
them at every call instead.

  --eos ID        EOS early exit, finished rows done-masked
  --temp/--top-k/--top-p  sampling instead of the argmax
  --kv int8       the block-paged int8 KV cache, read by the
                  paged-attention kernel (core/kvcache.py)

Under a mesh, one process a device (launch/mesh.py; NCCL on CUDA, gloo
with ``--device cpu``), prepared planes split N over 'model'; only rank
0 prints:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      examples/serve_dscim_torch.py --mesh model=2 --device cpu
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch.distributed as dist

from repro_torch.configs import TOKEN_ARCHS, get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.serve import _sample_spec, serve_batch
from repro_torch.models.registry import get_model

# (tag, dscim spec): the reference example's five runs, in its order
SPECS = (("float", "off"),
         ("dscim1/L256", "paper_inject:dscim1:256"),
         ("dscim2/L64", "paper_inject:dscim2:64"),
         ("dscim1/L256/exact-lut", "lut:dscim1:256"),
         ("dscim1/L256/fused-kernel", "kernel:dscim1:256"))


def serve_specs(cfg, params, prompts, tokens: int, *, device, par=None,
                prepare: bool = True, scan: bool = True, eos_id=None,
                sample: str = "greedy", kv: str = "float") -> dict:
    """{tag: (tokens (B, tokens), prefill logits, tok/s)} of ``SPECS`` on
    the same params and prompts."""
    results = {}
    for tag, spec in SPECS:
        c = dataclasses.replace(cfg, dscim=spec)
        t0 = time.perf_counter()
        toks, logits = serve_batch(c, params, prompts, tokens, par=par,
                                   prepare=prepare, scan=scan, eos_id=eos_id,
                                   sample=sample, kv=kv, device=device)
        dt = time.perf_counter() - t0
        results[tag] = (toks, logits[0], prompts.shape[0] * tokens / dt)
    return results


def report(results: dict, loop: str, mesh: str = "") -> list:
    """The reference example's lines: the float path's tok/s, then each
    DS-CIM run's tok/s, token agreement and prefill logit RMSE."""
    base_toks, base_lg, base_tps = results["float"]
    lines = [f"float ({loop}{mesh}): {base_tps:.1f} tok/s"]
    for tag in list(results)[1:]:
        toks, lg, tps = results[tag]
        agree = float((toks == base_toks).mean())
        rmse = float(np.sqrt(np.mean((lg - base_lg) ** 2)))
        lines.append(f"{tag}: {tps:.1f} tok/s, token agreement {agree:.2f}, "
                     f"logit RMSE {rmse:.3f}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=TOKEN_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--no-prepare", action="store_true",
                    help="quantize the weights at every call instead of "
                         "the default prepare-once int8 weights")
    ap.add_argument("--host-loop", action="store_true",
                    help="the eager loop, one host look a token, instead "
                         "of replaying the captured decode step")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="serve under a mesh, e.g. 'model=2', one process "
                         "a device under torchrun")
    ap.add_argument("--eos", type=int, default=None, metavar="ID",
                    help="EOS early exit with done-masked rows")
    ap.add_argument("--temp", type=float, default=None,
                    help="temperature sampling")
    ap.add_argument("--top-k", type=int, default=None,
                    help="top-k sampling")
    ap.add_argument("--top-p", type=float, default=None,
                    help="top-p (nucleus) sampling (exclusive with "
                         "--top-k)")
    ap.add_argument("--kv", choices=("float", "int8"), default="float",
                    help="dense float KV cache or the block-paged int8 one")
    ap.add_argument("--device", default=None,
                    help="cpu to serve on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    sample = _sample_spec(args)

    par = None
    if args.mesh:
        from repro_torch.launch.mesh import (init_distributed,
                                             parallel_ctx_from_spec)
        dev = init_distributed(args.device)
    else:
        dev = resolve_device(args.device)
    try:
        if args.mesh:
            par = parallel_ctx_from_spec(args.mesh)
            if dist.get_rank() != 0:       # every rank serves, rank 0 prints
                sys.stdout = open(os.devnull, "w")
        cfg = get_arch(args.arch).reduced()
        params = get_model(cfg).init_params(cfg, 0, device=dev)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int32)
        results = serve_specs(cfg, params, prompts, args.tokens, device=dev,
                              par=par, prepare=not args.no_prepare,
                              scan=not args.host_loop, eos_id=args.eos,
                              sample=sample, kv=args.kv)
        loop = "host-loop" if args.host_loop else "scanned"
        for line in report(results, loop,
                           f", mesh {args.mesh}" if args.mesh else ""):
            print(line)
        if par is not None:
            # every rank done with its last collective before any tears
            # its connections down (a gloo peer cut off mid-transfer aborts)
            dist.barrier()
    finally:
        if args.mesh:
            dist.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
