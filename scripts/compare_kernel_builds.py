#!/usr/bin/env python3
"""Time builds of the port's flash-attention and int8 GEMM kernels side by
side on one card, in turns, and check each against its plain version.

    python3 scripts/compare_kernel_builds.py --old DIR

``DIR`` holds other versions of ``flash_attention.cu`` and
``int8_matmul.cu`` with the same C interface, for instance an earlier
commit's, unpacked with

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C DIR \\
        --strip-components=4

The old sources are built with ``build.NVCC_FLAGS`` into
``src/repro_torch/kernels/_build/compare/`` and bound with the wrappers'
own argument types; the current ones are the wrappers' own libraries
(``build.bind``).  At each of ``chip_smoke.py``'s flash and int8 shapes
the two are timed in the order old, current, current, old with
``chip_smoke._cuda_ms`` (device time; the host queues every call before
the device starts), and each one's error against the plain version is
taken at those shapes and at the flash shapes of
``tests/test_torch_cuda.py``.  Prints one line per shape and build, and a
JSON object as the last line.  Needs one NVIDIA GPU with ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

NAMES = ("flash_attention", "int8_matmul")
# the flash shapes of tests/test_torch_cuda.py (errors only)
TEST_FLASH = [(4, 64, 32), (2, 128, 64), (1, 96, 16), (3, 77, 100),
              (2, 130, 256)] + [(2, s, d) for s in (1, 63, 65, 1024)
                                for d in (16, 24, 100, 256)]


def old_build(csrc: Path, out: Path) -> dict:
    """Compile both old sources, one ``nvcc`` each, in parallel; their
    launch functions, bound as the wrappers bind the current ones."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        so = out / f"old-{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(so), str(csrc / f"{name}.cu")]
        r = subprocess.run(cmd, capture_output=True, text=True)
        (out / f"old-{name}.log").write_text(r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for old {name}:\n{r.stderr}")
        return so

    with ThreadPoolExecutor(len(NAMES)) as ex:
        sos = dict(zip(NAMES, ex.map(one, NAMES)))
    fns = {}
    for key, name, argtypes in (("flash", "flash_attention", fa.ARGTYPES),
                                ("int8", "int8_matmul", im.ARGTYPES)):
        fn = getattr(ctypes.CDLL(str(sos[name])), f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fns[key] = fn
    return fns


def call_flash(torch, fn, q, k, v):
    from repro_torch.kernels.flash_attention import DTYPE_CODES
    out = torch.empty_like(q)
    BH, S, d = q.shape
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S,
            d, DTYPE_CODES[q.dtype], d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash launch failed: {rc}")
    return out


def call_int8(torch, fn, x, w):
    M, K = x.shape
    out = torch.empty((M, w.shape[1]), dtype=torch.int32, device=x.device)
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, w.shape[1], K,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 launch failed: {rc}")
    return out


def flash_err(torch, got, want, dt):
    if dt == "float32":
        return float((got - want).abs().max())
    return float(((got.float() - want).abs()
                  / want.abs().clamp_min(1.0)).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare_kernel_builds: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im

    builds = {"old": old_build(args.old, build.BUILD_DIR / "compare"),
              "current": {
                  "flash": build.bind("flash_attention",
                                      "flash_attention_launch", fa.ARGTYPES),
                  "int8": build.bind("int8_matmul", "int8_matmul_launch",
                                     im.ARGTYPES)}}
    order = ["old", "current", "current", "old"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    rows = []

    def record(kind, shape, label, err, times):
        row = {"kernel": kind, "shape": shape, "build": label,
               "max_err": err, "ms": min(times) if times else None,
               "ms_each": times}
        rows.append(row)
        t = f"{row['ms']:.5f} ms {times}" if times else "error only"
        print(f"[compare] {kind} {shape} {label}: err {err:.3e}; {t}",
              flush=True)

    for bh, s_len, d, dt in cs.FLASH_SHAPES:
        q, k, v = (torch.from_numpy(rng.normal(0, 1, (bh, s_len, d)).astype(
            np.float32)).cuda().to(getattr(torch, dt)) for _ in range(3))
        want = fa.flash_attention_plain(q.float(), k.float(), v.float())
        times = {b: [] for b in builds}
        for b in order:
            fn = builds[b]["flash"]
            times[b].append(cs._cuda_ms(
                lambda: call_flash(torch, fn, q, k, v), 20))
        for b in builds:
            got = call_flash(torch, builds[b]["flash"], q, k, v)
            record("flash", f"{(bh, s_len, d)} {dt}", b,
                   flash_err(torch, got, want, dt), times[b])
    for dt in ("bfloat16", "float16", "float32"):
        worst = {b: 0.0 for b in builds}
        for bh, s_len, d in TEST_FLASH:
            q, k, v = (torch.from_numpy(rng.normal(
                0, 1, (bh, s_len, d)).astype(np.float32)).cuda().to(
                getattr(torch, dt)) for _ in range(3))
            want = fa.flash_attention_plain(q.float(), k.float(), v.float())
            for b in builds:
                got = call_flash(torch, builds[b]["flash"], q, k, v)
                worst[b] = max(worst[b], flash_err(torch, got, want, dt))
        for b in builds:
            record("flash", f"test shapes {dt} (worst)", b, worst[b], [])
    for M, K, N in cs.OPS_SHAPES:
        x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(
            np.int8)).cuda()
        w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(
            np.int8)).cuda()
        want = im.int8_matmul_plain(x, w)
        times = {b: [] for b in builds}
        for b in order:
            fn = builds[b]["int8"]
            times[b].append(cs._cuda_ms(lambda: call_int8(torch, fn, x, w),
                                        50))
        for b in builds:
            got = call_int8(torch, builds[b]["int8"], x, w)
            err = float((got.to(torch.int64) - want.to(torch.int64)).abs()
                        .max())
            record("int8", f"{(M, K, N)}", b, err, times[b])
    print(smi, flush=True)
    print(json.dumps({"device": smi, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
