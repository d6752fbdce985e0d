#!/usr/bin/env python3
"""Time builds of the port's flash-attention, int8 GEMM, fused DS-CIM MVM,
paged-attention and DS-CIM count kernels side by side on one card, in
turns, and check each against its plain version.

    python3 scripts/compare_kernel_builds.py --old DIR [--only NAME ...]

``DIR`` holds other versions of ``flash_attention.cu``, ``int8_matmul.cu``,
``dscim_fused.cu``, ``paged_attention.cu`` and ``dscim_counts.cu``, for
instance an earlier commit's, unpacked with

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C DIR \\
        --strip-components=4

The old sources are built with ``build.NVCC_FLAGS`` into
``src/repro_torch/kernels/_build/compare/`` and bound with the wrappers'
own argument types, or, for the fused MVM and paged attention, with the
C interface of the source (the one before the redesign took quantized
activations; the one before split-KV had no scratch arguments); the
current ones are the wrappers' own libraries (``build.bind``).  At each of
``chip_smoke.py``'s flash, int8 and count shapes (the counts for both of
its presets, on the blocked tables), the main path's fused-MVM shapes (28
distinct layers' random weights, as the main path meets them) and
paged-attention shapes (the main run's, and 2048 tokens of context), the
two are timed in the order old, current, current, old with
``chip_smoke._cuda_ms`` (device time; the host queues every call before
the device starts), and each one's error against the plain version is
taken at those shapes and at the flash shapes of
``tests/test_torch_cuda.py``.  A fused MVM with the older interface is
timed on activations quantized beforehand (its kernel alone) and with the
quantization in torch before it (its wrapper).  Prints one line per shape
and build, and a JSON object as the last line.  Needs one NVIDIA GPU with
``nvcc``.
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

NAMES = ("flash_attention", "int8_matmul", "dscim_fused", "paged_attention",
         "dscim_counts")
# C interfaces of the fused MVM and paged attention before this redesign
OLD_FUSED_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                      + [ctypes.c_float] * 3 + [ctypes.c_void_p])
OLD_PAGED_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                      + [ctypes.c_float, ctypes.c_void_p])
FUSED_SITES = (("w_gate", 1024, 3072, "bfloat16", 28),
               ("w_down", 3072, 1024, "bfloat16", 28),
               ("lm_head", 1024, 151936, "float32", 1))
PAGED_SHAPES = (("main path", 79, 10), ("long context", 2047, 256))
# the flash shapes of tests/test_torch_cuda.py (errors only)
TEST_FLASH = [(4, 64, 32), (2, 128, 64), (1, 96, 16), (3, 77, 100),
              (2, 130, 256)] + [(2, s, d) for s in (1, 63, 65, 1024)
                                for d in (16, 24, 100, 256)]


def old_build(csrc: Path, out: Path, names) -> dict:
    """Compile the old sources, one ``nvcc`` each, in parallel; their
    launch functions, bound as the wrappers bind the current ones (or with
    the source's older interface)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import dscim_fused as df
    from repro_torch.kernels import dscim_mvm as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import paged_attention as pa
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

    with ThreadPoolExecutor(len(names)) as ex:
        sos = dict(zip(names, ex.map(one, names)))
    text = {n: (csrc / f"{n}.cu").read_text() for n in names}
    interfaces = {
        "flash_attention": fa.ARGTYPES, "int8_matmul": im.ARGTYPES,
        "dscim_fused": df.ARGTYPES if "int x_dtype" in text.get(
            "dscim_fused", "") else OLD_FUSED_ARGTYPES,
        "paged_attention": pa.ARGTYPES if "counters" in text.get(
            "paged_attention", "") else OLD_PAGED_ARGTYPES,
        "dscim_counts": dm.ARGTYPES}
    fns = {}
    for name in names:
        fn = getattr(ctypes.CDLL(str(sos[name])), f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = interfaces[name]
        fns[name] = fn
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


def call_fused(torch, fn, x, qw, cfg, xq=None, sx=None):
    """One call of a fused-MVM build: the current interface takes x and
    quantizes it (one or two launches, with the scratch and counters
    ``dscim_fused._launch_kernel`` passes); the older one takes xq/sx
    quantized beforehand."""
    from repro_torch.kernels import build
    from repro_torch.kernels import dscim_fused as df
    M, K = x.shape
    ta, tb = df._device_mask_tables(cfg, x.device)
    out = torch.empty((M, qw.n), dtype=torch.float32, device=x.device)
    scale, c1, wconst = df._estimator_constants(cfg, qw.g)
    stream = torch.cuda.current_stream().cuda_stream
    if xq is None:
        nbytes, tiles = df._launch_sizes(M, qw.n, qw.nw, qw.g)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        counters = build.tile_counters(x.device, stream, tiles)
        rc = fn(x.data_ptr(), df.X_DTYPES[x.dtype], qw.q.data_ptr(),
                qw.scale.data_ptr(), ta.data_ptr(), tb.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), counters.data_ptr(), M,
                qw.n, K, qw.nw, qw.g, cfg.k, cfg.group, cfg.sbits,
                df._copy_width(qw.q), scale, c1, wconst,
                df._CLAMP_EPS[x.dtype], df.RECIP_127[x.dtype], stream)
    else:
        rc = fn(xq.data_ptr(), sx.data_ptr(), qw.q.data_ptr(),
                qw.scale.data_ptr(), ta.data_ptr(), tb.data_ptr(),
                out.data_ptr(), M, qw.n, qw.nw, qw.g, cfg.k, cfg.group,
                cfg.sbits, scale, c1, wconst, stream)
    if rc != 0:
        raise RuntimeError(f"fused launch failed: {rc}")
    return out


def call_paged(torch, fn, new, args):
    """One launch of a paged-attention build (split-KV interface or the
    one before it)."""
    from repro_torch.kernels import build
    q, kp = args[0], args[1]
    B, KV, R, HD = q.shape
    ps, MP = kp.shape[1], args[7].shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]
    if new:
        runs = build.bind("paged_attention", "paged_attention_max_runs",
                          [ctypes.c_int] * 2)(ps, MP)
        part = torch.empty(B * KV * runs * R * (HD + 2), device=q.device)
        counters = build.tile_counters(q.device, stream, B * KV)
        rc = fn(*ptrs, part.data_ptr(), counters.data_ptr(), B, KV, R, HD,
                ps, MP, int(HD % 16 == 0), HD ** -0.5, stream)
    else:
        rc = fn(*ptrs, B, KV, R, HD, ps, MP, HD ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged launch failed: {rc}")
    return out


def call_counts(torch, fn, x, w, ta, tb, k):
    """One launch of a count-kernel build (the C interface is the same
    before and after the b1 redesign)."""
    M, K = x.shape
    N = w.shape[1]
    G, S, W = ta.shape
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), w.data_ptr(), ta.data_ptr(), tb.data_ptr(),
            out.data_ptr(), M, K, N, k, G, S, W,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"counts launch failed: {rc}")
    return out


def compare_counts(torch, builds, order, record):
    """The count kernel at chip_smoke.py's operator shapes, both presets,
    on the blocked tables (the all-L tables give the same calls)."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_mvm_blocked as blocked
    for (M, K, N), (x, w) in cs._operands(torch).items():
        for key in cs.OPS_PRESETS:
            cfg = calibrated_config(*key)
            ta, tb = blocked.count_tables(cfg, x.device)
            want = blocked.dscim_counts_blocked_plain(x, w, cfg)
            times = {b: [] for b in builds}
            for b in order:
                fn = builds[b]["dscim_counts"]
                times[b].append(cs._cuda_ms(lambda: call_counts(
                    torch, fn, x, w, ta, tb, cfg.k), 20 if M > 16 else 50))
            for b in builds:
                got = call_counts(torch, builds[b]["dscim_counts"], x, w, ta,
                                  tb, cfg.k)
                record("dscim_counts", f"{key[0]}/L{key[1]} M={M} K={K} "
                       f"N={N}", b, float((got - want).abs().max()), times[b])


def compare_fused(torch, builds, order, record, is_new):
    """The fused MVM at the main path's sites, decode (M = 4) and prefill
    (M = 256), over 28 distinct layers' weights (one for the head)."""
    from repro_torch.core.qweights import prepare_linear_weight
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_fused as df
    cfg = calibrated_config("dscim1", 256)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for site, K, N, dt, layers in FUSED_SITES:
        ws = [prepare_linear_weight(torch.randn(
            (K, N), generator=gen, device="cuda") * 0.05, 128)
            for _ in range(layers)]
        for M in (4, 256):
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                getattr(torch, dt))
            xqt = df.quantize_activations_windowed(x, ws[0].nw, ws[0].g)
            xq = xqt.q.contiguous()
            sx = xqt.scale.reshape(M, ws[0].nw).contiguous()
            want = df.dscim_fused_mvm_plain(xq, sx, ws[0].q, ws[0].scale,
                                            cfg) if N < 10000 else None
            times = {b: [] for b in builds}
            wtimes = {b: [] for b in builds}
            for b in order:
                fn = builds[b]["dscim_fused"]
                if is_new[b]:
                    def kern(fn=fn):
                        return [call_fused(torch, fn, x, w, cfg) for w in ws]
                    wrap = kern
                else:
                    def kern(fn=fn):
                        return [call_fused(torch, fn, x, w, cfg, xq, sx)
                                for w in ws]

                    def wrap(fn=fn):
                        out = []
                        for w in ws:
                            t = df.quantize_activations_windowed(x, w.nw, w.g)
                            out.append(call_fused(
                                torch, fn, x, w, cfg, t.q.contiguous(),
                                t.scale.reshape(M, w.nw).contiguous()))
                        return out
                reps = 3 if M > 4 else 10
                times[b].append(cs._cuda_ms(kern, reps) / layers)
                wtimes[b].append(cs._cuda_ms(wrap, reps) / layers)
            for b in builds:
                got = call_fused(torch, builds[b]["dscim_fused"], x, ws[0],
                                 cfg, *(() if is_new[b] else (xq, sx)))
                err = (float((got - want).abs().max())
                       / max(1.0, float(want.abs().max()))
                       if want is not None else float("nan"))
                record("dscim_fused", f"{site} M={M} K={K} N={N}", b, err,
                       times[b], wrapper=wtimes[b])


def compare_paged(torch, builds, order, record, is_new):
    """Paged attention at the main run's shape and at 2048 tokens."""
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    B, KV, R, HD, ps = 4, 8, 2, 128, 8
    for label, pos, MP in PAGED_SHAPES:
        P = B * MP
        args = [torch.randn((B, KV, R, HD), generator=gen, device="cuda")]
        args += [torch.randint(-127, 128, (P, ps, KV, HD), generator=gen,
                               device="cuda").to(torch.int8)
                 for _ in range(2)]
        args += [torch.rand((P, KV), generator=gen, device="cuda") * 0.02
                 for _ in range(2)]
        args += [torch.randn((B, ps, KV, HD), generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for _ in range(2)]
        args += [torch.randperm(P, generator=gen, device="cuda").reshape(
            B, MP).to(torch.int32),
            torch.full((B,), pos, dtype=torch.int32, device="cuda")]
        want = pa.paged_read_plain(*args)
        times = {b: [] for b in builds}
        for b in order:
            fn = builds[b]["paged_attention"]
            times[b].append(cs._cuda_ms(
                lambda: call_paged(torch, fn, is_new[b], args), 50))
        for b in builds:
            got = call_paged(torch, builds[b]["paged_attention"], is_new[b],
                             args)
            record("paged_attention", f"{label} B={B} KV={KV} R={R} HD={HD} "
                   f"ps={ps} pos={pos}", b, float((got - want).abs().max()),
                   times[b])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--only", nargs="+", choices=NAMES, default=list(NAMES))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare_kernel_builds: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels import dscim_fused as df
    from repro_torch.kernels import dscim_mvm as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import paged_attention as pa

    names = tuple(args.only)
    old = old_build(args.old, build.BUILD_DIR / "compare", names)
    argtypes = {"flash_attention": fa.ARGTYPES, "int8_matmul": im.ARGTYPES,
                "dscim_fused": df.ARGTYPES, "paged_attention": pa.ARGTYPES,
                "dscim_counts": dm.ARGTYPES}
    builds = {"old": old,
              "current": {n: build.bind(n, f"{n}_launch", argtypes[n])
                          for n in names}}
    is_new = {b: {n: builds[b][n].argtypes == argtypes[n] for n in names}
              for b in builds}
    order = ["old", "current", "current", "old"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    rows = []

    def record(kind, shape, label, err, times, wrapper=None):
        row = {"kernel": kind, "shape": shape, "build": label,
               "max_err": err, "ms": min(times) if times else None,
               "ms_each": times}
        if wrapper:
            row["wrapper_ms"] = min(wrapper)
            row["wrapper_ms_each"] = wrapper
        rows.append(row)
        t = f"{row['ms']:.5f} ms {times}" if times else "error only"
        if wrapper:
            t += f"; wrapper {row['wrapper_ms']:.5f} ms {wrapper}"
        print(f"[compare] {kind} {shape} {label}: err {err:.3e}; {t}",
              flush=True)

    if "dscim_fused" in names:
        compare_fused(torch, builds, order, record,
                      {b: is_new[b]["dscim_fused"] for b in builds})
    if "paged_attention" in names:
        compare_paged(torch, builds, order, record,
                      {b: is_new[b]["paged_attention"] for b in builds})
    if "dscim_counts" in names:
        compare_counts(torch, builds, order, record)
    if "flash_attention" in names:
        compare_flash(torch, np, rng, builds, order, record)
    if "int8_matmul" in names:
        compare_int8(torch, np, rng, builds, order, record)
    print(smi, flush=True)
    print(json.dumps({"device": smi, "rows": rows}), flush=True)
    return 0


def compare_flash(torch, np, rng, builds, order, record):
    """Flash attention at chip_smoke.py's shapes, and its errors at the
    test shapes."""
    from repro_torch.kernels import flash_attention as fa
    for bh, s_len, d, dt in cs.FLASH_SHAPES:
        q, k, v = (torch.from_numpy(rng.normal(0, 1, (bh, s_len, d)).astype(
            np.float32)).cuda().to(getattr(torch, dt)) for _ in range(3))
        want = fa.flash_attention_plain(q.float(), k.float(), v.float())
        times = {b: [] for b in builds}
        for b in order:
            fn = builds[b]["flash_attention"]
            times[b].append(cs._cuda_ms(
                lambda: call_flash(torch, fn, q, k, v), 20))
        for b in builds:
            got = call_flash(torch, builds[b]["flash_attention"], q, k, v)
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
                got = call_flash(torch, builds[b]["flash_attention"], q, k, v)
                worst[b] = max(worst[b], flash_err(torch, got, want, dt))
        for b in builds:
            record("flash", f"test shapes {dt} (worst)", b, worst[b], [])


def compare_int8(torch, np, rng, builds, order, record):
    """The int8 GEMM at chip_smoke.py's operator shapes."""
    from repro_torch.kernels import int8_matmul as im
    for M, K, N in cs.OPS_SHAPES:
        x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(
            np.int8)).cuda()
        w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(
            np.int8)).cuda()
        want = im.int8_matmul_plain(x, w)
        times = {b: [] for b in builds}
        for b in order:
            fn = builds[b]["int8_matmul"]
            times[b].append(cs._cuda_ms(lambda: call_int8(torch, fn, x, w),
                                        50))
        for b in builds:
            got = call_int8(torch, builds[b]["int8_matmul"], x, w)
            err = float((got.to(torch.int64) - want.to(torch.int64)).abs()
                        .max())
            record("int8", f"{(M, K, N)}", b, err, times[b])


if __name__ == "__main__":
    sys.exit(main())
