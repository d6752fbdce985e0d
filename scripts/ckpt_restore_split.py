#!/usr/bin/env python3
"""Where a checkpoint restore onto the GPU spends its time.

    python3 scripts/ckpt_restore_split.py [--gb 15.4] [--leaf-mb 512]

Saves a tree of f32 leaves (``--gb`` in all, ``--leaf-mb`` a leaf; the
size of ``chip_smoke.py``'s olmo-1b train state) with the port's
``Checkpointer`` into a temporary directory, then restores it onto the
card four times in turns: the restore as it was, split into its two
steps (``np.load`` of every leaf, then a pageable ``torch.from_numpy(arr)
.to(device)``), and ``Checkpointer.restore`` as it is (the files read
into two pinned buffers, each chunk's copy overlapping the next read).
Each restore is held bitwise against the saved tensors.  The files were
just written, so every read is from a warm page cache.  Prints one JSON
line a restore and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gb", type=float, default=15.4)
    ap.add_argument("--leaf-mb", type=int, default=512)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.tree import leaves

    if not torch.cuda.is_available():
        print("ckpt_restore_split: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    leaf = args.leaf_mb * 2**20 // 4
    n = max(1, round(args.gb * 1e9 / (leaf * 4)))
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {f"leaf_{i:03d}": torch.randn(leaf, generator=gen, device=dev)
            for i in range(n)}
    nbytes = n * leaf * 4
    tmp = tempfile.mkdtemp(prefix="ckpt_split_")
    try:
        ck = Checkpointer(tmp)
        t0 = time.perf_counter()
        ck.save(0, tree, blocking=True)
        save_s = time.perf_counter() - t0
        want = leaves(tree)
        print(json.dumps({"leaves": n, "bytes": nbytes, "save_s": save_s}),
              flush=True)

        def old():
            load_s = copy_s = 0.0
            out = []
            for i in range(n):
                t0 = time.perf_counter()
                arr = np.load(f"{tmp}/step_{0:09d}/arr_{i:05d}.npy")
                t1 = time.perf_counter()
                out.append(torch.from_numpy(arr).to(dev))
                torch.cuda.synchronize()
                load_s += t1 - t0
                copy_s += time.perf_counter() - t1
            return out, {"np_load_s": load_s, "pageable_copy_s": copy_s}

        def new():
            t0 = time.perf_counter()
            got, _ = ck.restore(0, tree)
            torch.cuda.synchronize()
            return leaves(got), {"restore_s": time.perf_counter() - t0}

        for name, fn in (("as it was", old), ("staged", new),
                         ("staged", new), ("as it was", old)):
            t0 = time.perf_counter()
            got, parts = fn()
            total = time.perf_counter() - t0
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            del got
            torch.cuda.empty_cache()
            print(json.dumps({"restore": name, "total_s": total,
                              "gb_per_s": nbytes / total / 1e9,
                              "bitwise": same, **parts}), flush=True)
            if not same:
                return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
