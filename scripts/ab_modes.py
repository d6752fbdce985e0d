#!/usr/bin/env python3
"""Time the DS-CIM linear's serving modes of one tree of the repository on
one card, as that tree's ``chip_smoke.py`` runs them: its ``profile``
phase (the main path's kernel count, graph and eager), its ``modes``
phase at the main path's ``TOKENS`` (each mode's generate and capture
seconds, and the checks the phase makes), and with ``--eager`` the
device kernels of one profiled eager request in each mode (about three
minutes more: the eager count modes issue 550,000-820,000 kernels).

    python3 scripts/ab_modes.py [--tree DIR] [--label NAME] [--eager]

``DIR`` (default: this checkout) is a checkout of the repository, for
instance an earlier commit unpacked with
``git archive <commit> | tar -x -C DIR``; its kernels are built into its
own ``src/repro_torch/kernels/_build/``.  To compare two trees, run the
script once a tree, in one call on the card, in the order old, new, new,
old.  Prints one JSON object as its last line.  Needs one NVIDIA GPU with
``nvcc``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

EAGER_MODES = ("exact", "lut", "bitmatmul", "statistical", "paper_inject")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--eager", action="store_true")
    a = ap.parse_args(argv)
    tree = Path(a.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_modes: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.serve import prepare_params, serve_batch
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build(("dscim_fused", "paged_attention", "dscim_counts"))
    print(f"[{a.label}] built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = get_arch("qwen3-0.6b")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                (cs.BATCH, cs.PROMPT))
    served = prepare_params(dataclasses.replace(cfg, dscim=cs.DSCIM),
                            lm.init_params(cfg, 0))
    prof = cs.profile_main_path(torch, cfg, served, prompts)
    # the modes phase at the main path's depth in every tree, as trees
    # before MODES_TOKENS ran it
    cs.MODES_TOKENS = cs.TOKENS
    t0 = time.perf_counter()
    modes = cs.modes_phase(torch, cfg, served, prompts)
    modes_s = time.perf_counter() - t0
    eager = {}
    for mode in EAGER_MODES if a.eager else ():
        c = dataclasses.replace(cfg, dscim=f"{mode}:dscim1:256")
        p = cs._profile_request(torch, lambda c=c: serve_batch(
            c, served, prompts, cs.TOKENS, kv="int8", page_size=cs.PAGE,
            scan=False))
        eager[mode] = {"kernels": p["kernel_launches"],
                       "device_busy_ms": p["device_busy_ms"],
                       "wall_ms_profiled": p["wall_ms_profiled"]}
        print(f"[{a.label}] eager {mode}: {p['kernel_launches']} kernels, "
              f"busy {p['device_busy_ms']:.1f} ms, wall "
              f"{p['wall_ms_profiled']:.1f} ms", flush=True)
    out = {"label": a.label, "tree": str(tree), "modes_phase_s": modes_s,
           "profile_kernels": {k: v["kernel_launches"]
                               for k, v in prof.items()},
           "modes": {m: {"generate_s": e["generate_s"],
                         "capture_s": e["capture_s"]}
                     for m, e in modes["modes"].items()},
           "eager": eager}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
