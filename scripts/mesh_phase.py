#!/usr/bin/env python3
"""``chip_smoke.py``'s ``mesh`` phase alone, for iterating on the serving
path under a mesh without the whole smoke run.

    python3 scripts/mesh_phase.py

Needs one NVIDIA GPU with ``nvcc``.  Builds the fused-MVM and
paged-attention kernels, serves the main path once on one device
(qwen3-0.6b at its published width, random weights from seed 0,
``chip_smoke.DSCIM``, int8 paged KV) for the tokens leg (a) is held to,
then runs the phase's four legs in order, each reported with its wall
time and its result as one JSON line: (a) the main path under
``model=1`` over NCCL, captured; (b) kernel 1 per shard; (c) kernel 2
per shard; (d) two gloo ranks on the one card.  A leg that fails prints
its traceback and the script exits 1.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.serve import prepare_params, serve_batch
    from repro_torch.models import lm

    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    build.build(("dscim_fused", "paged_attention"))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = get_arch("qwen3-0.6b")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                (cs.BATCH, cs.PROMPT))
    cfg_ds = dataclasses.replace(cfg, dscim=cs.DSCIM)
    served = prepare_params(cfg_ds, lm.init_params(cfg, 0))
    toks, _ = serve_batch(cfg_ds, served, prompts, cs.TOKENS, kv="int8",
                          page_size=cs.PAGE)
    failed = []
    for name, fn, args in (
            ("a", cs._mesh_world1, (torch, cfg, served, prompts, toks)),
            ("b", cs._mesh_fused_shards, (torch, cfg, served)),
            ("c", cs._mesh_paged_shards, (torch, cfg)),
            ("d", cs._mesh_gloo, (torch,))):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:                    # report, run the other legs
            traceback.print_exc()
            failed.append(name)
            continue
        print(json.dumps({"leg": name, "s": time.perf_counter() - t0,
                          "result": out}, default=str), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
