#!/usr/bin/env python3
"""Where the accuracy watchdog's threshold sits against the drift it
sees: healthy and stuck-at-faulted runs of ``chip_smoke.py``'s continuous
queue (8 requests of prompt 64, budgets 16, 5, 12, 3, 16, 8, 10, 2, seed
1; 4 slots, segments of 4, page 8, int8 KV, random weights from seed 0
drawn on the serving device), each probed every segment.

    PYTHONPATH=src python3 scripts/watchdog_margin.py [--reduced]
        [--layers N] [--init-cpu] [--device cpu] [--legs healthy faulted]
        [--dscim kernel:dscim2:64 ...]

For each DS-CIM spec it prints the margin-3 threshold
(``watchdog_for_spec``), the moment bound it scales, the healthy run's
highest live relative logit RMSE and trips, and the faulted run's
(``stuck:3:40.0`` from segment 1) lowest live rel after the fault, each
also as a multiple of the bound, and a digest of each run's tokens.  The queue is model independent, so the
reduced config and the published one, at any depth (``--layers``), serve
the same schedule; ``--init-cpu`` draws the weights on the CPU, so a CPU
run and a card run serve the same model.  Prints one JSON object per
spec.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

BUDGETS = (16, 5, 12, 3, 16, 8, 10, 2)
FAULT, FAULT_AT = "stuck:3:40.0", 1


def measure(cfg, params, spec: str, device,
            legs=("healthy", "faulted")) -> dict:
    import numpy as np

    from repro_torch.launch.serve import prepare_params, serve_continuous
    from repro_torch.runtime.failover import FailureInjector
    from repro_torch.runtime.serving import watchdog_for_spec

    cfg_s = dataclasses.replace(cfg, dscim=spec)
    served = prepare_params(cfg_s, params, device)
    budgets = np.asarray(BUDGETS, np.int32)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab,
                                                (len(budgets), 64))
    kw = dict(slots=4, seg_len=4, max_new=budgets, kv="int8", page_size=8,
              eos_id=-1, device=device, log=lambda *_: None)
    out = {"spec": spec}
    for leg in legs:
        inj = None if leg == "healthy" else FailureInjector(
            macro_fault_at=FAULT_AT, macro_fault=FAULT)
        wd = watchdog_for_spec(spec, probe_every=1)
        outs, st = serve_continuous(cfg_s, served, prompts,
                                    int(budgets.max()), monitor=wd,
                                    injector=inj, **kw)
        rels = wd.live_rels(FAULT_AT if inj else 0)
        out["threshold"] = wd.rel_threshold
        out["bound"] = wd.rel_threshold / 3.0
        key = "max" if inj is None else "min"
        val = float(rels.max() if inj is None else rels.min())
        out[f"{leg}_{key}_rel"] = val
        out[f"{leg}_{key}_over_bound"] = val / out["bound"]
        out[f"{leg}_trips"] = st["probe_trips"]
        # the served tokens' digest: equal runs served the same tokens
        out[f"{leg}_tokens_sha1"] = hashlib.sha1(
            np.concatenate(outs).astype(np.int32).tobytes()).hexdigest()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced smoke-test width instead of the "
                         "published one")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers, widths kept "
                         "(depth apart from width and device)")
    ap.add_argument("--init-cpu", action="store_true",
                    help="draw the random weights on the CPU and move them, "
                         "so runs on the CPU and on the card serve the same "
                         "weights (a CUDA generator draws others)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--legs", nargs="+", choices=("healthy", "faulted"),
                    default=["healthy", "faulted"])
    ap.add_argument("--dscim", nargs="+",
                    default=["kernel:dscim2:64", "kernel:dscim1:256"])
    args = ap.parse_args(argv)
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import lm

    dev = resolve_device(args.device)
    cfg = get_arch("qwen3-0.6b")
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = lm.init_params(cfg, 0, device="cpu" if args.init_cpu else dev)
    where = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    for spec in args.dscim:
        print(json.dumps(dict(measure(cfg, params, spec, dev, args.legs),
                              config=cfg.name, reduced=args.reduced,
                              layers=cfg.n_layers, d_model=cfg.d_model,
                              init_cpu=args.init_cpu,
                              device=where)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
