#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU with ``nvcc`` (sm_90a); exits non-zero without one.
In order it

1. builds every CUDA kernel of the serving path from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel) and prints the
   registers, spills and static shared memory ``ptxas`` reports for each
   entry of the flash-attention, int8 GEMM, fused DS-CIM MVM, paged
   attention and DS-CIM count kernels, and the tensor-core instructions in
   their SASS;
2. drives the main path: ``repro_torch.launch.serve.serve_batch`` on
   qwen3-0.6b at its published width (random weights from seed 0) with
   ``dscim="kernel:dscim1:256"``, ``kv="int8"``, page size 8, batch 4,
   prompt 64, 16 tokens, through the decode step captured as a CUDA graph
   (``scan=True``; the warm-up request at the same shape captures it, and
   its capture time is printed).  The kernels' launch counters are zeroed
   just before the timed request and read just after, and must show 85
   fused-MVM launches per forward (1360) and 28 paged-attention launches
   per decode step (420), counted over the graph's replays; the eager
   host loop (``scan=False``) must launch as many and give the same
   tokens and logit trace bitwise.  Both loops then serve 5 requests in
   turns: the median and range of tok/s and of one decode step's device
   time (CUDA events) are printed for each;
3. checks the output (shape, range, finite logits) and prints the
   prefill logit RMSE against the port's own ``dscim="off"`` run; serves
   one graph request and one eager request under ``torch.profiler`` and
   prints each one's wall time, device busy time, idle share, kernel
   count and costliest kernels, and checks that the fused-MVM and
   paged-attention kernel calls the device ran equal the counters'
   launches (``profile``); then serves 8 requests (prompt 64, budgets
   ``CB_BUDGETS``) through 4 slots in segments of 4 captured steps
   (``continuous``, ``serve_continuous``) twice, a warm-up and the run
   reported, checks each request's tokens bitwise against a one-shot
   ``serve_batch`` of its prompt tiled to 4 rows with the same budget,
   and prints tok/s with and without the segment step's capture time,
   occupancy, segments and the page allocator's stats; serves the main
   path's request with ``spec=SPEC`` (``spec``: dscim2 drafts a window of
   4, the dscim1 verifier checks them in one batched forward, one captured
   graph a window): its tokens must be bitwise the plain graph path's,
   the window graph's tokens and spec stats the eager window's, and its
   fused-MVM launches (draft and verify apart) and paged-attention
   launches those of the windows replayed, as the profiler sees them; the
   self-draft probe ``SELF_DSCIM`` must accept every draft; it prints
   tok/s of 5 requests in turns with the plain graph path, one window's
   device time, the capture time, accepted tokens per verify, and whether
   the verify forward's ops give a row the same bits at B*(k+1) rows as
   at B (and each way's time); then serves ``bitmatmul``, ``statistical``
   and ``paper_inject`` (``modes``, full depth), each graph bitwise its
   eager loop, ``bitmatmul`` bitwise ``lut`` with its count-kernel
   launches counted, the noise modes' logit RMSE against ``exact``
   printed;
4. holds each kernel's wrapper, as the main path calls it, against its
   plain PyTorch version on the same inputs at the main path's shapes,
   and times kernel, wrapper, plain version, the least
   time the card could take (``bound_ms``) and, for paged attention, one
   ``scaled_dot_product_attention`` call over pre-gathered K/V, and again
   at 2048 tokens of context on a synthetic pool of the same head layout;
   for the fused MVM it checks that the kernel's own activation
   quantization is bitwise the torch one, prints kernel and wrapper time
   per shape and regime, and the estimator's RMSE against the exact f32
   product ``x @ w`` at each shape (the accuracy DS-CIM costs);
5. drives the DS-CIM operator path (``operators``): at qwen3-0.6b's MLP
   shapes (M, K, N) = (256, 1024, 3072), (256, 3072, 1024) and (4, 1024,
   3072), int8 operands from seed 0, it calls ``ops.int8_matmul`` (the
   exact DCIM baseline), ``ops.dscim_mvm`` (all-L counts) and
   ``dscim_counts_blocked`` for dscim1/L256 and dscim2/L64, the staged
   per-window path ``dscim_windowed_vmap_mvm`` beside the fused one at
   (256, 1024) x (1024, 3072), and ``flash_attention`` at (BH, S, d) =
   (64, 1024, 128) in bf16, f32 and f16 and (64, 64, 128) in bf16; the four
   wrappers' launch counters are zeroed before and read after.  Then it
   holds each result against its plain version (counts and int8 products
   bitwise; the all-L plain counts on an N = 384 column slice, where the
   full expansion is GBs), checks the blocked and all-L counts identical,
   and times kernel, plain version, bound and the library yardstick
   (``torch._int_mm``, ``scaled_dot_product_attention``);
6. computes Table I through the card (``table1``): for all 12 presets the
   counts of ``DSCIMMacro.rmse``'s operands through the count kernel must
   equal the LUT's, and the RMSE must equal the JAX reference's;
7. serves the reduced config on the GPU and on the CPU (plain versions)
   and checks that they agree.

Every time is device time (``_cuda_ms``): the device sleeps while the host
queues all the timed calls, so the host's time per call does not enter it.
Then it prints a ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
F32_FLOPS_PER_S = 67e12
# b1 AND + popcount adds (2 per bit pair), the type of the DS-CIM OR
# counts: the data sheet gives no rate, so this is the highest that
# scripts/mma_sync_peak.py measured (b1 wgmma m64n256k256, NVIDIA H100
# 80GB HBM3, 700 W)
B1_OPS_PER_S = 15532e12

BATCH, PROMPT, TOKENS, PAGE = 4, 64, 16, 8
DSCIM = "kernel:dscim1:256"
CB_BUDGETS = (16, 5, 12, 3, 16, 8, 10, 2)   # continuous phase, per request
CB_SEG = 4                                  # its decode steps per segment
SPEC = "dscim2:4"            # spec phase: dscim2 drafts, k = 4
SELF_DSCIM = "kernel:dscim2:64"   # its self-draft probe: draft = verifier
# tokens of the profiled spec request: 2 windows, about 64,000 kernels (a
# 16-token request runs about 456,000, and the profiler then drops calls)
SPEC_PROFILE_TOKENS = 3
MODES = ("bitmatmul", "statistical", "paper_inject")   # modes phase
FUSED_RTOL = 2e-5            # f32 summation order; counts are exact
PAGED_RTOL = 1e-5            # f32 summation order of dot products / sums
LONG_POS = 2047              # paged attention's long-context position
MVM_RTOL = 2e-5              # f32 correction terms; counts are exact
FLASH_F32_ATOL = 3e-5        # the reference test's own tolerance
# bf16 flash output against the plain version in f32 on the same bf16
# inputs: the output's bf16 rounding (2^-8 relative) plus f32 order
FLASH_BF16_RTOL = 8e-3
# f16 keeps 10 bits: its output and P roundings come to about 7e-4, and a
# path that rounded anything at bf16 precision (about 5e-3) fails this
FLASH_F16_RTOL = 2e-3
OPS_SHAPES = ((256, 1024, 3072), (256, 3072, 1024), (4, 1024, 3072))
OPS_PRESETS = (("dscim1", 256, "paper"), ("dscim2", 64, "paper"))
SLICE_N = 384                # columns of the all-L plain count check
FLASH_SHAPES = ((64, 1024, 128, "bfloat16"), (64, 1024, 128, "float32"),
                (64, 64, 128, "bfloat16"), (64, 1024, 128, "float16"))
# instructions each library's SASS must hold: tensor-core products fed by
# cp.async (LDGSTS)
SASS_NEEDS = {"flash_attention": ("HMMA", "LDGSTS"),
              "int8_matmul": ("IMMA", "LDGSTS"),
              "dscim_fused": ("BMMA", "LDGSTS"),
              "dscim_counts": ("BMMA", "LDGSTS")}
# Table I RMSE (unsigned full scale, %) of the JAX reference on the CPU:
# benchmarks/t1_rmse.py run(), n_cols=256, n_vec=48, seed 0, uniform
TABLE1_JAX = {
    ("dscim1", 64, "paper"): 1.274342095885992,
    ("dscim1", 64, "opt"): 0.9307239216821117,
    ("dscim1", 128, "paper"): 0.7895493662023146,
    ("dscim1", 128, "opt"): 0.6598209910414785,
    ("dscim1", 256, "paper"): 0.4810205967700286,
    ("dscim1", 256, "opt"): 0.29943956884213574,
    ("dscim2", 64, "paper"): 2.7825406881695876,
    ("dscim2", 64, "opt"): 2.378362476702778,
    ("dscim2", 128, "paper"): 2.0183949099876872,
    ("dscim2", 128, "opt"): 1.7375698968971294,
    ("dscim2", 256, "paper"): 1.306199180683843,
    ("dscim2", 256, "opt"): 1.0482831949140168,
}
TABLE1_RTOL = 1e-5


def _log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device time of one call of ``fn``: the device first sleeps while the
    host queues all ``reps`` calls between two events, so the host's time
    per call cannot set the number.  If the device still woke before the
    last call was queued (a call that waits on the host), the sleep is
    lengthened once; if that does not help either, the time is reported
    with a note that the host bounds it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for attempt in range(2):
        # about 2e9 cycles a second; twice the host time of the calls
        cycles = int(min(2.0 * reps * host_s * (4 ** attempt) + 2e-3, 1.0)
                     * 2e9)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            break
    else:
        _log("timing note: a timed call waits on the host, so the host "
             "bounds the next time printed")
    return start.elapsed_time(end) / reps


def ptxas_summary(names) -> dict:
    """For each named source: registers, spills and static shared memory of
    each kernel entry from its ``nvcc -Xptxas -v`` log (dynamic shared
    memory is set at launch and is not in the log), and, where the toolkit
    has ``cuobjdump``, how many tensor-core (HMMA, IMMA, BMMA), async-copy
    (LDGSTS) and ldmatrix (LDSM) instructions its SASS holds; there it
    raises unless flash attention holds HMMA, the int8 GEMM IMMA and the
    fused DS-CIM MVM and the count kernel BMMA (their b1 counts), each
    with LDGSTS (the kernels run on the tensor cores, fed by cp.async)."""
    import re
    import shutil

    from repro_torch.kernels import build
    cuobjdump = shutil.which("cuobjdump") or next(
        (str(p) for p in (Path(build._nvcc()).parent / "cuobjdump",)
         if p.exists()), None)
    out = {}
    for name in names:
        so = build._target(name)
        log = build.BUILD_DIR / f"{so.stem}.log"
        rows = []
        for line in (log.read_text().splitlines() if log.exists() else []):
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                rows.append({"entry": m.group(1)})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and rows:
                rows[-1]["spill_stores"] = int(m.group(1))
                rows[-1]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and rows:
                rows[-1]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                rows[-1]["static_smem"] = int(sm.group(1)) if sm else 0
        try:
            names_d = subprocess.run(
                ["c++filt"], input="\n".join(r["entry"] for r in rows),
                capture_output=True, text=True, timeout=30).stdout.split("\n")
        except OSError:
            names_d = []
        for i, r in enumerate(rows):
            if i < len(names_d) and names_d[i]:    # drop the parameter list
                r["entry"] = re.sub(r"^void |\((?:[^()]|\([^()]*\))*\)$",
                                    "", names_d[i])
            _log(f"ptxas {name}: {r['entry']}: {r.get('registers')} regs, "
                 f"spill {r.get('spill_stores')}/{r.get('spill_loads')} B, "
                 f"static smem {r.get('static_smem')} B")
        sass = None
        if cuobjdump and so.exists():
            text = subprocess.run([cuobjdump, "-sass", str(so)],
                                  capture_output=True, text=True,
                                  timeout=300).stdout
            sass = {op: len(re.findall(rf"\b{op}\b", text))
                    for op in ("HMMA", "IMMA", "BMMA", "LDGSTS", "LDSM")}
            _log(f"sass {name}: {sass}")
            need = SASS_NEEDS.get(name, ())
            if not all(sass[op] > 0 for op in need):
                raise AssertionError(f"{name}: SASS lacks one of {need}: "
                                     f"{sass}")
        out[name] = {"entries": rows, "sass_counts": sass}
    return out


def _check_close(name, got, want, rtol):
    """max |got - want| must stay within rtol * max|want| (f32 rounding of
    a different summation order); returns the max abs error."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1.0)
    if err > rtol * scale:
        raise AssertionError(f"{name}: max abs err {err:.3e} > "
                             f"{rtol:.0e} x {scale:.3e}")
    return err


def _decode_step_ms(torch, fn, reset, reps=5):
    """Median device time (CUDA events around it) of one decode step
    ``fn`` of the main path's runner, after ``reset()`` puts the cache
    position and the output row back (the step's writes land on state the
    next request overwrites).  For the eager loop this is the step as the
    device's clock sees it, host-paced gaps between its kernels
    included."""
    import statistics
    times = []
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main_path(torch, cfg, params, served, prompts):
    """Phase 2 + 3: the main path through the captured decode step
    (``serve_batch(scan=True)`` on ``served``, the params prepared once),
    with launch counts over the replays, tokens and logit trace bitwise
    against the eager host loop (``scan=False``), and both loops timed in
    turns."""
    import numpy as np

    from repro_torch.kernels import dscim_fused, paged_attention
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import _generate_runner

    cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
    kw = dict(kv="int8", page_size=PAGE)
    # warm-up at the timed request's shape: the capture happens here
    warm = {}
    serve_batch(cfg_ds, served, prompts, TOKENS, timings=warm, **kw)
    serve_batch(cfg_ds, served, prompts, TOKENS, scan=False, **kw)
    torch.cuda.synchronize()
    if "capture_s" not in warm:
        raise AssertionError("the warm-up request captured no graph")
    capture_s = warm["capture_s"]
    dscim_fused.LAUNCHES.reset()
    paged_attention.LAUNCHES.reset()
    t = {}
    toks, logits, cache = serve_batch(cfg_ds, served, prompts, TOKENS,
                                      timings=t, return_cache=True, **kw)
    launches = {"dscim_fused_mvm": dscim_fused.LAUNCHES.count,
                "paged_attention_decode": paged_attention.LAUNCHES.count}
    want = {"dscim_fused_mvm": (3 * cfg.n_layers + 1) * TOKENS,
            "paged_attention_decode": cfg.n_layers * (TOKENS - 1)}
    _log(f"launches on the main path (graph replays): {launches} "
         f"(expected {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if "capture_s" in t:
        raise AssertionError("the timed request captured again")
    if toks.shape != (BATCH, TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_padded:
        raise AssertionError(f"bad tokens {toks.shape} {toks.min()} "
                             f"{toks.max()}")
    if not np.isfinite(logits[0]).all():
        raise AssertionError("non-finite prefill logits")
    # the eager loop on the same prompts: same launches, same bits
    dscim_fused.LAUNCHES.reset()
    paged_attention.LAUNCHES.reset()
    serve_batch(cfg_ds, served, prompts, TOKENS, scan=False, **kw)
    eager_launches = {"dscim_fused_mvm": dscim_fused.LAUNCHES.count,
                      "paged_attention_decode":
                      paged_attention.LAUNCHES.count}
    if eager_launches != want:
        raise AssertionError(f"eager launch counts {eager_launches}")
    traced = {scan: serve_batch(cfg_ds, served, prompts, TOKENS, scan=scan,
                                trace_logits=True, **kw)
              for scan in (True, False)}
    (tg, lg), (te, le) = traced[True], traced[False]
    if not (np.array_equal(tg, te) and np.array_equal(tg, toks)
            and np.array_equal(np.stack(lg), np.stack(le))):
        raise AssertionError("graph and eager loop disagree (tokens or "
                             "logit trace)")
    _log(f"graph vs eager loop: tokens and the ({TOKENS}, {BATCH}, "
         f"{cfg.vocab_padded}) logit trace bitwise equal")
    # both loops in turns, with the device time of one decode step
    runner = _generate_runner(cfg_ds, BATCH, PROMPT, TOKENS, "int8", PAGE,
                              None, "greedy", False,
                              torch.device("cuda", 0), None)
    st = runner.st

    def reset():
        # the runner holds the params only inside a request; the eager
        # step reads them
        st["params"] = served
        st["cache"]["pos"].fill_(PROMPT + TOKENS // 2)
        st["i"].fill_(TOKENS // 2)
    step_fn = {True: runner.step.graph.replay, False: runner.step.step}
    runs = {True: [], False: []}
    for scan in (True, False, False, True) * 2 + (True, False):
        tt = {}
        serve_batch(cfg_ds, served, prompts, TOKENS, scan=scan, timings=tt,
                    **kw)
        ms = _decode_step_ms(torch, step_fn[scan], reset)
        runs[scan].append((BATCH * TOKENS / tt["generate_s"], ms))
    loops = {}
    for scan, name in ((True, "graph"), (False, "eager")):
        tok_s = [r[0] for r in runs[scan]]
        step_ms = [r[1] for r in runs[scan]]
        loops[name] = {
            "runs": len(tok_s), "tok_s": tok_s,
            "tok_s_median": float(np.median(tok_s)),
            "tok_s_range": [min(tok_s), max(tok_s)],
            "decode_step_ms": step_ms,
            "decode_step_ms_median": float(np.median(step_ms)),
            "decode_step_ms_range": [min(step_ms), max(step_ms)]}
        lp = loops[name]
        _log(f"{name} loop, {lp['runs']} runs: {lp['tok_s_median']:.1f} "
             f"tok/s median (range {lp['tok_s_range'][0]:.1f}-"
             f"{lp['tok_s_range'][1]:.1f}); decode step "
             f"{lp['decode_step_ms_median']:.4f} ms device time median "
             f"(range {lp['decode_step_ms_range'][0]:.4f}-"
             f"{lp['decode_step_ms_range'][1]:.4f})")
    tok_s = BATCH * TOKENS / t["generate_s"]
    _log(f"main path: {BATCH * TOKENS} tokens in {t['generate_s']:.4f} s "
         f"= {tok_s:.1f} tok/s (prepare {t['prepare_s']:.2f} s, capture "
         f"{capture_s:.3f} s in the warm-up)")
    off_toks, off_logits = serve_batch(cfg, params, prompts, TOKENS, **kw)
    rmse = float(np.sqrt(np.mean((logits[0] - off_logits[0]) ** 2)))
    agree = float((toks == off_toks).mean())
    _log(f"dscim={DSCIM} vs dscim=off: prefill logit RMSE {rmse:.6f}, "
         f"token agreement {agree:.3f}")
    if not math.isfinite(rmse):
        raise AssertionError("non-finite logit RMSE")
    return launches, cache, {"tok_s": tok_s, "logit_rmse": rmse,
                             "generate_s": t["generate_s"],
                             "capture_s": capture_s, "loops": loops,
                             "tokens": toks}


# the port's kernels of the main path, as the profiler names them
PROFILED_KERNELS = {"fused_mvm": "::fused_kernel<",
                    "fused_quantize": "::quantize_kernel<",
                    "paged_attention": "::paged_split_kernel"}


def _profile_request(torch, serve):
    """Wall time, device busy time (kernel durations summed), idle share,
    kernel count, the costliest kernel names of one ``serve()``, and the
    calls of each of ``PROFILED_KERNELS`` the device ran."""
    import collections

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda it: -it[1][1])[:8]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_launches": sum(c for c, _ in by_name.values()),
            "port_kernel_calls": {
                k: sum(c for n, (c, _) in by_name.items() if pat in n)
                for k, pat in PROFILED_KERNELS.items()},
            "top_kernels": [{"name": n[:80], "calls": c, "device_ms": ms}
                            for n, (c, ms) in top]}


def profile_main_path(torch, cfg, served, prompts):
    """Phase 3b: one graph request and one eager request of the main path
    under ``torch.profiler``: wall time, the time the device spent running
    kernels, the idle share, the kernel count and the costliest kernels.
    The device's own calls of the fused MVM (one quantize kernel and one
    MVM kernel a wrapper call) and of paged attention must equal what the
    wrappers' counters read for the same request: for the graph request
    the counters add the captured launches once a replay, and this shows
    the replays really ran them."""
    from repro_torch.kernels import dscim_fused, paged_attention
    from repro_torch.launch.serve import serve_batch

    cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
    out = {}
    for scan, name in ((True, "graph"), (False, "eager")):
        dscim_fused.LAUNCHES.reset()
        paged_attention.LAUNCHES.reset()
        out[name] = p = _profile_request(torch, lambda: serve_batch(
            cfg_ds, served, prompts, TOKENS, kv="int8", page_size=PAGE,
            scan=scan))
        seen = p["port_kernel_calls"]
        counted = {"fused_mvm": dscim_fused.LAUNCHES.count,
                   "fused_quantize": dscim_fused.LAUNCHES.count,
                   "paged_attention": paged_attention.LAUNCHES.count}
        p["counted_launches"] = counted
        _log(f"profile, {name} loop: kernel calls the device ran {seen}, "
             f"the counters' {counted}")
        if seen != counted:
            raise AssertionError(f"{name} loop: the profiler saw {seen} "
                                 f"kernel calls, the counters read "
                                 f"{counted}")
        _log(f"profile, {name} loop: wall {p['wall_ms_profiled']:.1f} ms "
             f"(profiler on), device busy {p['device_busy_ms']:.1f} ms, "
             f"idle {p['device_idle_share']:.3f}, "
             f"{p['kernel_launches']} kernels")
        for k in p["top_kernels"][:5]:
            _log(f"  {k['device_ms']:.2f} ms in {k['calls']} x "
                 f"{k['name']}")
        if p["device_busy_ms"] <= 0.0:
            raise AssertionError(f"the profiler saw no device time "
                                 f"({name} loop)")
    return out


def continuous(torch, cfg, served):
    """Phase 3c: continuous batching at full width: 8 requests (prompt 64,
    budgets CB_BUDGETS) through 4 slots in segments of 4 captured steps,
    ``kernel:dscim1:256``, int8 paged KV, page size 8.  The queue is
    served twice, a warm-up and the run reported (each run makes its
    serve state and captures its segment step, whose time is printed
    apart).  Each request's tokens must equal a one-shot ``serve_batch``
    of its prompt tiled to 4 rows with the same budget, bitwise."""
    import numpy as np

    from repro_torch.launch.serve import serve_batch, serve_continuous

    cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
    budgets = np.asarray(CB_BUDGETS, np.int32)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (len(budgets), PROMPT))
    n = int(budgets.max())
    kw = dict(kv="int8", page_size=PAGE, eos_id=-1)
    warm, _ = serve_continuous(cfg_ds, served, prompts, n, slots=BATCH,
                               seg_len=CB_SEG, max_new=budgets, **kw)
    outs, stats = serve_continuous(cfg_ds, served, prompts, n, slots=BATCH,
                                   seg_len=CB_SEG, max_new=budgets, **kw)
    capture_s = stats["capture_s"]
    for r, budget in enumerate(budgets):
        if not np.array_equal(warm[r], outs[r]):
            raise AssertionError(f"continuous request {r}: the two runs "
                                 f"differ: {warm[r]} vs {outs[r]}")
        ref, _ = serve_batch(cfg_ds, served,
                             np.tile(prompts[r:r + 1], (BATCH, 1)), n,
                             max_new=[int(budget)] * BATCH, **kw)
        if len(outs[r]) != budget or not np.array_equal(outs[r],
                                                        ref[0, :budget]):
            raise AssertionError(f"continuous request {r}: {outs[r]} vs "
                                 f"one-shot {ref[0, :budget]}")
    if stats["useful_tokens"] != int(budgets.sum()) \
            or stats["live_slot_steps"] != int(budgets.sum()) - len(budgets) \
            or stats["pages"]["live_pages"] != 0:
        raise AssertionError(f"continuous accounting: {stats}")
    pages = stats["pages"]
    tok_s_uncaptured = stats["useful_tokens"] / (stats["wall_s"] - capture_s)
    _log(f"continuous: {len(budgets)} requests through {BATCH} slots, "
         f"{stats['useful_tokens']} tokens, each equal to its one-shot "
         f"request bitwise (and to the warm-up run's); second run "
         f"{stats['tok_s']:.1f} tok/s over {stats['wall_s']:.3f} s, of "
         f"which {capture_s:.3f} s capture the segment step; "
         f"{tok_s_uncaptured:.1f} tok/s without it; occupancy "
         f"{stats['occupancy']:.3f} "
         f"({stats['live_slot_steps']}/{stats['slot_steps']} slot-steps), "
         f"{stats['segments']} segments of {CB_SEG}; pages: high water "
         f"{pages['high_water']}/{pages['n_pages']}, refusals "
         f"{pages['refusals']}, live after {pages['live_pages']}")
    return {k: stats[k] for k in ("wall_s", "tok_s", "capture_s",
                                  "occupancy", "live_slot_steps",
                                  "slot_steps", "segments", "useful_tokens",
                                  "pages")} \
        | {"tok_s_without_capture": tok_s_uncaptured}


def _batch_invariance(torch, cfg, served, k):
    """For the ops of one verify layer at the main path's shapes: whether
    B*(k+1) rows in one call give each row the bits of the decode's call
    at B rows (position t alone, contiguous), and both calls' device
    time.  The fused MVM must be invariant (decode_multi batches it);
    the others run per position in decode_multi, and this records what
    that buys and costs."""
    from repro_torch.layers.norms import rmsnorm
    from repro_torch.models.lm import _linear_for

    dev = served["embed"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    T = k + 1
    D = cfg.d_model
    attn = served["layers"]["attn"]
    mlp = served["layers"]["mlp"]
    ln = {"scale": served["layers"]["ln1"]["scale"][0]}
    lin = _linear_for(DSCIM)
    wq = attn["wq"][0]
    x = torch.randn((BATCH, T, D), generator=gen, device=dev).to(wq.dtype)
    ops = {"cublas_projection_wq": lambda v: v @ wq,
           "rmsnorm": lambda v: rmsnorm(v, ln),
           "fused_mvm_w_gate": lambda v: lin(v, mlp["w_gate"][0])}
    out = {}
    for name, fn in ops.items():
        whole = fn(x)
        parts = [fn(x[:, t:t + 1].contiguous()) for t in range(T)]
        per = torch.cat(parts, dim=1)
        out[name] = {
            "equal": bool(torch.equal(whole, per)),
            "max_abs_diff": float((whole.float() - per.float()).abs().max()),
            "batched_ms": _cuda_ms(lambda: fn(x), 20),
            "per_position_ms": _cuda_ms(
                lambda: [fn(x[:, t:t + 1].contiguous()) for t in range(T)],
                20)}
        _log(f"batch invariance {name}: {BATCH * T} rows in one call vs "
             f"{T} calls of {BATCH}: bitwise {out[name]['equal']} (max "
             f"diff {out[name]['max_abs_diff']:.3e}); "
             f"{out[name]['batched_ms']:.4f} ms vs "
             f"{out[name]['per_position_ms']:.4f} ms")
    if not out["fused_mvm_w_gate"]["equal"]:
        raise AssertionError("the fused MVM's rows depend on the batch")
    return out


def spec_phase(torch, cfg, served, prompts, plain_toks):
    """Phase 3d: self-speculative decoding on the main path's model and
    options, ``spec=SPEC`` (dscim2 drafts, the dscim1 verifier), each
    window one replay of a captured graph.  Checks: the tokens are
    bitwise the plain graph path's; the window graph gives the eager
    window's tokens, windows and emitted counts; the fused-MVM launches
    (split into draft and verify) and paged-attention launches over the
    replays are those of a whole number R >= max(windows) of windows, and
    the profiler sees as many kernel calls; the self-draft probe
    (``SELF_DSCIM`` verified by itself) accepts every draft.  Prints
    tok/s of 5 requests in turns with the plain graph path, one window's
    device time, the capture time and accepted tokens per verify, and
    the batch-invariance probe of ``_batch_invariance``."""
    import numpy as np

    from repro_torch.kernels import dscim_fused, paged_attention
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import (_draft_cfg, _generate_runner,
                                          _parse_spec)
    from repro_torch.models.lm import _linear_for

    cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
    k = _parse_spec(SPEC)[1]
    L = cfg.n_layers
    kw = dict(kv="int8", page_size=PAGE)
    warm = {}
    serve_batch(cfg_ds, served, prompts, TOKENS, spec=SPEC, timings=warm,
                **kw)
    if "capture_s" not in warm:
        raise AssertionError("the warm-up spec request captured no graph")
    if plain_toks is None:
        plain_toks = serve_batch(cfg_ds, served, prompts, TOKENS, **kw)[0]
    ver = dscim_fused.launches_for(_linear_for(DSCIM).cfg)
    dra = dscim_fused.launches_for(_linear_for(
        _draft_cfg(cfg_ds, SPEC.split(":")[0]).dscim).cfg)
    counters = {"fused_verify": ver, "fused_draft": dra,
                "fused_all": dscim_fused.LAUNCHES,
                "paged_attention": paged_attention.LAUNCHES}
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    toks, _, ss = serve_batch(cfg_ds, served, prompts, TOKENS, spec=SPEC,
                              spec_stats=True, **kw)
    launches = {n: c.count for n, c in counters.items()}
    if not np.array_equal(toks, plain_toks):
        raise AssertionError(f"spec tokens {toks} != plain {plain_toks}")
    per_fwd = 3 * L + 1
    R, rem = divmod(launches["fused_draft"], k * per_fwd)
    want = {"fused_verify": per_fwd * (1 + R), "fused_draft": per_fwd * k * R,
            "fused_all": per_fwd * (1 + R * (k + 1)),
            "paged_attention": L * (2 * k + 1) * R}
    _log(f"spec launches: {launches}; {R} windows replayed (rows took part "
         f"in {ss['windows'].tolist()}, emitted {ss['emitted'].tolist()}); "
         f"expected {want}")
    if rem or launches != want or R < int(ss["windows"].max()):
        raise AssertionError(f"spec launches {launches} vs {want}")
    eager = serve_batch(cfg_ds, served, prompts, TOKENS, spec=SPEC,
                        spec_stats=True, scan=False, **kw)
    if not (np.array_equal(eager[0], toks)
            and all(np.array_equal(eager[2][n], ss[n]) for n in ss)):
        raise AssertionError(f"window graph {toks} {ss} vs eager window "
                             f"{eager[0]} {eager[2]}")
    _log("spec: tokens bitwise the plain graph path's; window graph == "
         "eager window (tokens, windows, emitted)")
    # the profiler sees the counters' kernel calls (a short request: see
    # SPEC_PROFILE_TOKENS; the warm-up captures its window)
    serve_batch(cfg_ds, served, prompts, SPEC_PROFILE_TOKENS, spec=SPEC,
                **kw)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    prof = _profile_request(torch, lambda: serve_batch(
        cfg_ds, served, prompts, SPEC_PROFILE_TOKENS, spec=SPEC, **kw))
    seen = prof["port_kernel_calls"]
    counted = {"fused_mvm": dscim_fused.LAUNCHES.count,
               "fused_quantize": dscim_fused.LAUNCHES.count,
               "paged_attention": paged_attention.LAUNCHES.count}
    _log(f"spec profile ({SPEC_PROFILE_TOKENS} tokens): kernel calls the "
         f"device ran {seen}, the counters' "
         f"{counted}; wall {prof['wall_ms_profiled']:.1f} ms, device busy "
         f"{prof['device_busy_ms']:.1f} ms, idle "
         f"{prof['device_idle_share']:.3f}, {prof['kernel_launches']} "
         "kernels")
    for kk in prof["top_kernels"][:5]:
        _log(f"  {kk['device_ms']:.2f} ms in {kk['calls']} x {kk['name']}")
    if seen != counted:
        raise AssertionError(f"spec profile {seen} vs counters {counted}")
    # the self-draft probe: every greedy draft accepted
    cfg2 = dataclasses.replace(cfg, dscim=SELF_DSCIM)
    p2 = serve_batch(cfg2, served, prompts, TOKENS, **kw)[0]
    t2, _, s2 = serve_batch(cfg2, served, prompts, TOKENS, spec=SPEC,
                            spec_stats=True, **kw)
    full = -(-(TOKENS - 1) // (k + 1))
    _log(f"spec self-draft ({SELF_DSCIM} verified by itself): windows "
         f"{s2['windows'].tolist()} (all accepted: {full}), emitted "
         f"{s2['emitted'].tolist()}")
    if not (np.array_equal(t2, p2) and (s2["windows"] == full).all()
            and (s2["emitted"] == TOKENS).all()):
        raise AssertionError("self-draft: a draft was rejected or the "
                             "tokens differ from the plain path")
    # tok/s in turns with the plain graph path, one window's device time
    runner = _generate_runner(cfg_ds, BATCH, PROMPT, TOKENS, "int8", PAGE,
                              None, "greedy", False, served["embed"].device,
                              SPEC)
    st = runner.st
    runs = {"plain": [], "spec": []}
    for name in ("plain", "spec", "spec", "plain") * 2 + ("plain", "spec"):
        tt = {}
        serve_batch(cfg_ds, served, prompts, TOKENS, timings=tt,
                    spec=SPEC if name == "spec" else None, **kw)
        runs[name].append(BATCH * TOKENS / tt["generate_s"])

    def reset():
        # back to mid-request (pos, emitted counts, budget, done), so the
        # timed replay writes inside the static buffers
        st["params"] = served
        st["cache"]["pos"].fill_(PROMPT + TOKENS // 2)
        st["n_out"].fill_(TOKENS // 2)
        st["max_new"].fill_(TOKENS)
        st["done"].zero_()
    window_ms = _decode_step_ms(torch, runner.step.graph.replay, reset)
    st["params"] = None
    # a draft step alone: the self-draft probe's plain dscim2 step graph
    drunner = _generate_runner(cfg2, BATCH, PROMPT, TOKENS, "int8", PAGE,
                               None, "greedy", False, served["embed"].device,
                               None)
    dst = drunner.st

    def dreset():
        dst["params"] = served
        dst["cache"]["pos"].fill_(PROMPT + TOKENS // 2)
        dst["i"].fill_(TOKENS // 2)
    draft_ms = _decode_step_ms(torch, drunner.step.graph.replay, dreset)
    dst["params"] = None
    res = {n: {"tok_s": v, "tok_s_median": float(np.median(v)),
               "tok_s_range": [min(v), max(v)]} for n, v in runs.items()}
    acc = float((ss["emitted"] - 1).sum() / max(int(ss["windows"].sum()), 1))
    _log(f"spec vs plain graph, 5 requests each in turns: spec "
         f"{res['spec']['tok_s_median']:.1f} tok/s (range "
         f"{res['spec']['tok_s_range'][0]:.1f}-"
         f"{res['spec']['tok_s_range'][1]:.1f}), plain "
         f"{res['plain']['tok_s_median']:.1f} ("
         f"{res['plain']['tok_s_range'][0]:.1f}-"
         f"{res['plain']['tok_s_range'][1]:.1f}); one window "
         f"{window_ms:.4f} ms device time, of which {k} draft steps of "
         f"{draft_ms:.4f} ms each (a {SELF_DSCIM} step) and the verify "
         f"forward, rollback and accept fold the rest; capture "
         f"{warm['capture_s']:.3f} s; {acc:.3f} tokens emitted per verify")
    inv = _batch_invariance(torch, cfg, served, k)
    return {"spec": SPEC, "launches": launches, "windows_replayed": R,
            "windows": ss["windows"].tolist(),
            "emitted": ss["emitted"].tolist(),
            "emitted_per_verify": acc, "window_ms": window_ms,
            "draft_step_ms": draft_ms,
            "capture_s": warm["capture_s"], "loops": res, "profile": prof,
            "self_draft": {"windows": s2["windows"].tolist(),
                           "emitted": s2["emitted"].tolist()},
            "batch_invariance": inv}


def modes_phase(torch, cfg, served, prompts):
    """Phase 3e: the DS-CIM linear's other modes (``MODES``) on the main
    path's model (published width and depth) and options, each decode
    step captured.  Checks: graph == eager loop bitwise
    (tokens and logit trace) for each; ``bitmatmul``'s tokens and logits
    bitwise ``lut``'s; the count kernel's launches over the bitmatmul
    request (one a window: prefill plus the replays).  Prints each mode's
    capture time and the noise modes' logit RMSE against ``exact``."""
    import numpy as np

    from repro_torch.kernels import dscim_mvm
    from repro_torch.launch.serve import logit_drift_rmse, serve_batch
    from repro_torch.launch.steps import clear_graphs

    kw = dict(kv="int8", page_size=PAGE, trace_logits=True)
    runs, out = {}, {}
    for mode in ("exact", "lut") + MODES:
        c = dataclasses.replace(cfg, dscim=f"{mode}:dscim1:256")
        t = {}
        if mode == "bitmatmul":
            torch.cuda.synchronize()
            dscim_mvm.LAUNCHES.reset()
        runs[mode] = serve_batch(c, served, prompts, TOKENS, timings=t, **kw)
        if mode == "bitmatmul":
            launches = dscim_mvm.LAUNCHES.count
        entry = {"capture_s": t.get("capture_s"),
                 "generate_s": t["generate_s"]}
        if mode in MODES:
            eager = serve_batch(c, served, prompts, TOKENS, scan=False, **kw)
            if not (np.array_equal(eager[0], runs[mode][0]) and
                    np.array_equal(np.stack(eager[1]),
                                   np.stack(runs[mode][1]))):
                raise AssertionError(f"modes {mode}: graph != eager loop")
            entry["graph_equals_eager"] = True
        out[mode] = entry
        clear_graphs()
        _log(f"modes {mode}: {TOKENS} tokens in {t['generate_s']:.3f} s "
             f"(capture {t.get('capture_s', 0.0):.3f} s)"
             + (", graph == eager loop bitwise" if mode in MODES else ""))
    nw = {n: -(-n // 128) for n in (cfg.d_model, cfg.d_ff)}
    per_fwd = cfg.n_layers * (2 * nw[cfg.d_model] + nw[cfg.d_ff]) \
        + nw[cfg.d_model]
    want = per_fwd * TOKENS
    _log(f"modes bitmatmul: {launches} count-kernel launches (expected "
         f"{want}: {per_fwd} windows a forward x {TOKENS} forwards)")
    if launches != want:
        raise AssertionError(f"bitmatmul launches {launches} != {want}")
    if not (np.array_equal(runs["bitmatmul"][0], runs["lut"][0]) and
            np.array_equal(np.stack(runs["bitmatmul"][1]),
                           np.stack(runs["lut"][1]))):
        raise AssertionError("bitmatmul != lut (tokens or logits)")
    _log("modes: bitmatmul tokens and logit trace bitwise lut's")
    ex_t, ex_l = runs["exact"]
    for mode in ("statistical", "paper_inject", "bitmatmul"):
        tk, lg = runs[mode]
        rmse = float(np.sqrt(np.mean((lg[0] - ex_l[0]) ** 2)))
        drift = logit_drift_rmse(ex_t, tk, ex_l, lg)
        if not (math.isfinite(rmse) and np.isfinite(np.stack(lg)).all()):
            raise AssertionError(f"modes {mode}: non-finite logits")
        out[mode].update(prefill_logit_rmse_vs_exact=rmse,
                         logit_drift_rmse_vs_exact=drift)
        _log(f"modes {mode} vs exact: prefill logit RMSE {rmse:.4f}, "
             f"teacher-matched drift RMSE {drift:.4f}")
    return {"layers": cfg.n_layers, "bitmatmul_count_launches": launches,
            "modes": out}


def check_fused(torch, cfg, params, launches):
    """Fused DS-CIM MVM vs its plain version at the serving shapes."""
    from repro_torch.kernels import dscim_fused
    from repro_torch.launch.steps import prepare_serving_params

    cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
    prep = prepare_serving_params(cfg_ds, params)
    from repro_torch.models.lm import _linear_for
    dcfg = _linear_for(DSCIM).cfg
    L = cfg.n_layers
    mlp = prep["layers"]["mlp"]
    fmlp = params["layers"]["mlp"]
    # (site, prepared weights of every layer, layer 0's float weight,
    #  activation dtype, calls per forward)
    sites = [("w_gate", [mlp["w_gate"][i] for i in range(L)],
              fmlp["w_gate"][0], torch.bfloat16, 2 * L),
             ("w_down", [mlp["w_down"][i] for i in range(L)],
              fmlp["w_down"][0], torch.bfloat16, L),
             ("lm_head", [prep["lm_head"]], params["embed"].T,
              torch.float32, 1)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    calls = []
    for m in (BATCH, BATCH * PROMPT):
        for site, ws, wf, xdt, per_fwd in sites:
            K, N = ws[0].k_orig, ws[0].n
            x = torch.randn((m, K), generator=gen, device="cuda").to(xdt)
            # the wrapper the main path calls (leading-dim fold, dispatch,
            # one C call: the quantize kernel, then the MVM)
            # against the plain version on the torch-quantized activations
            got = dscim_fused.dscim_fused_mvm_prepared(x, ws[0], dcfg)
            xq = dscim_fused.quantize_activations_windowed(x, ws[0].nw,
                                                           ws[0].g)
            q = xq.q.contiguous()
            sx = xq.scale.reshape(m, ws[0].nw).contiguous()
            want = dscim_fused.dscim_fused_mvm_plain(q, sx, ws[0].q,
                                                     ws[0].scale, dcfg)
            err = _check_close(f"dscim_fused {site} M={m}", got, want,
                               FUSED_RTOL)
            # the kernel's quantization is the torch one, bitwise
            _, kq, ksx = dscim_fused._launch_kernel(x, ws[0], dcfg)
            if not (torch.equal(kq, q) and torch.equal(
                    ksx.view(torch.int32), sx.view(torch.int32))):
                raise AssertionError(f"dscim_fused {site} M={m}: the "
                                     "kernel's quantized activations differ")
            # accuracy cost of the estimator itself: against x @ w in f32
            exact = x.float() @ wf.float()
            est_rmse = float((got - exact).pow(2).mean().sqrt())
            exact_rms = float(exact.pow(2).mean().sqrt())
            # time over distinct layers' weights: the main path meets each
            # weight once per forward, not hot in L2
            reps = 5 if m > BATCH else 20
            ms = _cuda_ms(lambda: [dscim_fused._launch_kernel(x, w, dcfg)
                                   for w in ws], reps) / len(ws)
            # the same through the wrapper the main path calls
            wrapper_ms = _cuda_ms(lambda: [
                dscim_fused.dscim_fused_mvm_prepared(x, w, dcfg) for w in ws],
                reps) / len(ws)
            plain_ms = _cuda_ms(lambda: dscim_fused.dscim_fused_mvm_plain(
                q, sx, ws[0].q, ws[0].scale, dcfg), reps=2, warmup=1)
            kp = ws[0].nw * ws[0].g
            nbytes = (x.numel() * x.element_size() + kp * N
                      + 4 * ws[0].nw * N + 2 * 4 * dcfg.group * dcfg.sbits
                      + 4 * m * N)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = _count_ops(m, N, ws[0].nw, ws[0].g, dcfg) \
                / B1_OPS_PER_S * 1e3
            # prefill runs the head on the last token only (M = batch): the
            # M=256 head call is a check at a larger shape, off the path
            on_path = not (site == "lm_head" and m > BATCH)
            calls.append({
                "shape": f"{site} M={m} K={K} N={N}",
                "per_forward": per_fwd if on_path else 0,
                "phase": ("decode" if m == BATCH else "prefill") if on_path
                else "check only, not on the main path",
                "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper_ms,
                "plain_ms": plain_ms,
                "rmse_vs_float_matmul": est_rmse,
                "float_matmul_rms": exact_rms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            _log(f"dscim_fused {calls[-1]['shape']} ({calls[-1]['phase']}, "
                 f"{'decode' if m <= 16 else 'prefill'} regime): err "
                 f"{err:.3e}, quantization bitwise; "
                 f"{ms:.4f} ms (wrapper {wrapper_ms:.4f} ms, plain "
                 f"{plain_ms:.3f} ms, bound "
                 f"{calls[-1]['bound_ms']:.4f} ms, {calls[-1]['bound_by']}); "
                 f"estimate vs f32 x @ w: RMSE {est_rmse:.4f}, "
                 f"RMS of x @ w {exact_rms:.4f}")
    dec = [c for c in calls if c["phase"] == "decode"]
    step = {k: sum(c[k] * c["per_forward"] for c in dec)
            for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms")}
    pre = [c for c in calls if c["phase"] == "prefill"
           and not c["shape"].startswith("lm_head")]
    regimes = {
        "decode_step": step,
        "prefill_mlp_per_call": {k: sum(c[k] * c["per_forward"] for c in pre)
                                 / sum(c["per_forward"] for c in pre)
                                 for k in ("ms", "wrapper_ms", "bound_ms")},
        "head_decode_per_call": {k: c[k] for c in dec
                                 if c["shape"].startswith("lm_head")
                                 for k in ("ms", "wrapper_ms", "bound_ms")}}
    for name, r in regimes.items():
        _log(f"dscim_fused {name}: kernel {r['ms']:.4f} ms, wrapper "
             f"{r['wrapper_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    return {
        "name": "dscim_fused_mvm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dscim_fused.cu",
        "replaces": "src/repro/kernels/dscim_fused.py:75",
        "launches": launches["dscim_fused_mvm"],
        "max_abs_err": max(c["max_abs_err"] for c in calls),
        "ms": step["ms"], "wrapper_ms": step["wrapper_ms"],
        "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in dec)
        else "operations",
        "library_ms": None,
        "per": "one decode step: 28 x (w_gate + w_up + w_down) + lm_head "
               "at M=4",
        "regimes": regimes,
        "library": "n/a: no PyTorch call computes the DS-CIM estimator",
        "bound_rate": f"bytes at {HBM_BYTES_PER_S:g} B/s; count bit "
                      f"operations at {B1_OPS_PER_S:g}/s (b1 wgmma, "
                      "measured: no published b1 peak)",
        "tolerance": f"max abs err <= {FUSED_RTOL:g} x max|plain|",
        "calls": calls}


def check_paged(torch, cfg, cache, launches):
    """Paged-attention kernel vs its plain version on the main run's final
    pool (layer 0 and the last layer) with a random query."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa

    B, KV, HD = BATCH, cfg.n_kv, cfg.head_dim
    R = cfg.n_heads // KV
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    if cache is None:       # the main path failed: a pool of its shapes
        from repro_torch.core.kvcache import n_pages_for, paged_from_dense
        shape = (cfg.n_layers, B, PROMPT + TOKENS, KV, HD)
        kv = [torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2)]
        mp = n_pages_for(PROMPT + TOKENS, PAGE)
        cache = paged_from_dense(*kv, PAGE, n_pages=B * mp, max_pages=mp)
    q = torch.randn((B, KV, R, HD), generator=gen, device="cuda")
    pos = cache["pos"] - 1          # the last decode step's position
    table = cache["page_table"]
    ps = cache["k_pages"].shape[2]
    errs, out = [], {}
    for li in (0, cfg.n_layers - 1):
        args = (q, cache["k_pages"][li], cache["v_pages"][li],
                cache["k_scale"][li], cache["v_scale"][li],
                cache["k_tail"][li], cache["v_tail"][li], table, pos)
        got = pa.paged_attention_decode(*args)
        want = pa.paged_read_plain(*args)
        errs.append(_check_close(f"paged_attention layer {li}", got, want,
                                 PAGED_RTOL))
    out["ms"] = _cuda_ms(lambda: pa._launch_kernel(*args), reps=50)
    out["plain_ms"] = _cuda_ms(lambda: pa.paged_read_plain(*args), reps=10)
    # library yardstick: SDPA over K/V already gathered and dequantized
    # (the gather is not timed), one query per head, ragged mask
    T = int(pos.max()) + 1
    MP = table.shape[1]
    kd = (args[1][table.long()].float() * args[3][table.long()][
        :, :, None, :, None]).reshape(B, MP * ps, KV, HD)
    vd = (args[2][table.long()].float() * args[4][table.long()][
        :, :, None, :, None]).reshape(B, MP * ps, KV, HD)
    rows = torch.arange(B, device="cuda")
    for j in range(ps):                     # overlay the tails
        tok = (pos // ps) * ps + j
        kd[rows, tok] = args[5][:, j].float()
        vd[rows, tok] = args[6][:, j].float()
    kh = kd[:, :T].permute(0, 2, 1, 3).repeat_interleave(R, dim=1)
    vh = vd[:, :T].permute(0, 2, 1, 3).repeat_interleave(R, dim=1)
    qh = q.reshape(B, KV * R, 1, HD)
    mask = (torch.arange(T, device="cuda")[None, :] <= pos[:, None])[
        :, None, None, :]
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib_err = float((lib.reshape(B, KV, R, HD) - got).abs().max())
    out["library_ms"] = _cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), reps=50)
    bound, by = _paged_bound(pos, ps, KV, R, HD, table)
    _log(f"paged_attention: err {max(errs):.3e}, {out['ms']:.4f} ms "
         f"(plain {out['plain_ms']:.3f} ms, sdpa {out['library_ms']:.4f} "
         f"ms, bound {bound:.5f} ms; sdpa vs kernel max abs diff "
         f"{lib_err:.2e})")
    # long context: a synthetic pool of the same head layout, 2048 tokens
    # a slot (16.8 MB of int8 K/V at B = 4), pages in random order
    MPL = LONG_POS // ps + 1
    PL = B * MPL
    largs = (q,
             *(torch.randint(-127, 128, (PL, ps, KV, HD), generator=gen,
                             device="cuda").to(torch.int8) for _ in range(2)),
             *(torch.rand((PL, KV), generator=gen, device="cuda") * 0.02
               for _ in range(2)),
             *(torch.randn((B, ps, KV, HD), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(2)),
             torch.randperm(PL, generator=gen, device="cuda").reshape(
                 B, MPL).to(torch.int32),
             torch.full((B,), LONG_POS, dtype=torch.int32, device="cuda"))
    lerr = _check_close("paged_attention long context",
                        pa.paged_attention_decode(*largs),
                        pa.paged_read_plain(*largs), PAGED_RTOL)
    lbound, lby = _paged_bound(largs[-1], ps, KV, R, HD, largs[-2])
    long_ctx = {"shape": f"B={B} KV={KV} n_rep={R} HD={HD} ps={ps} "
                         f"pos={LONG_POS}",
                "kv_bytes": 2 * (LONG_POS // ps) * ps * HD * KV * B,
                "max_abs_err": lerr,
                "ms": _cuda_ms(lambda: pa._launch_kernel(*largs), reps=50),
                "plain_ms": _cuda_ms(lambda: pa.paged_read_plain(*largs),
                                     reps=2, warmup=1),
                "bound_ms": lbound, "bound_by": lby}
    long_ctx["share_of_bound"] = lbound / long_ctx["ms"]
    _log(f"paged_attention long context {long_ctx['shape']}: err "
         f"{lerr:.3e}, {long_ctx['ms']:.4f} ms (plain "
         f"{long_ctx['plain_ms']:.3f} ms, bound {lbound:.5f} ms {lby}, "
         f"{100 * long_ctx['share_of_bound']:.1f} % of it)")
    return {
        "name": "paged_attention_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:95",
        "launches": launches["paged_attention_decode"],
        "max_abs_err": max(errs + [lerr]), "ms": out["ms"],
        "plain_ms": out["plain_ms"], "bound_ms": bound, "bound_by": by,
        "library_ms": out["library_ms"], "long_context": long_ctx,
        "per": f"one call: B={B} KV={KV} n_rep={R} HD={HD} ps={ps} "
               f"pos={pos.tolist()} (the main run's last decode step)",
        "library": "F.scaled_dot_product_attention over pre-gathered, "
                   "dequantized K/V; excludes the gather and dequant, so "
                   "not the same function",
        "tolerance": f"max abs err <= {PAGED_RTOL:g} x max(1, max|plain|)"}


def _paged_bound(pos, ps, KV, R, HD, table):
    """(bound_ms, bound_by) of one paged decode call: the int8 pages below
    each slot's tail and their scales, the bf16 tails, q, the output, the
    table and pos, each moved once; f32 dot products and P.V."""
    B = pos.shape[0]
    npages = int((pos // ps).sum())              # full pages read
    nbytes = (npages * ps * HD * 2 * KV + 2 * 4 * npages * KV
              + 2 * 2 * B * ps * KV * HD + 4 * B * KV * R * HD * 2
              + 4 * table.numel() + 4 * B)
    flops = 4.0 * float((pos + 1).sum()) * KV * R * HD
    return _bound(nbytes, flops, F32_FLOPS_PER_S)


def _count_ops(M, N, nw, g, cfg):
    """Bit operations of the DS-CIM OR counts of an (M, nw*g) x (nw*g, N)
    product: an AND and an add for every point of every (row, column,
    K-row), K-row r holding the points of block r % G (the pad slots of
    the point tables excluded)."""
    from repro_torch.kernels.dscim_mvm_blocked import block_point_tables
    tu = block_point_tables(cfg)[0]
    pts = (tu < cfg.sbits).sum(1)                   # points of each block
    per_window = int(sum(int(pts[r % cfg.group]) for r in range(g)))
    return 2.0 * M * N * nw * per_window


def _bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _operands(torch):
    """int8 (x, w) on the card for each of OPS_SHAPES, from seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    return {shape: tuple(torch.from_numpy(rng.integers(
        -128, 128, dims).astype(np.int8)).cuda() for dims in
        ((shape[0], shape[1]), (shape[1], shape[2])))
        for shape in OPS_SHAPES}


def drive_operators(torch):
    """Phase 5a: the operator path once, through the calls a user makes,
    with the four new wrappers' launch counters zeroed just before and
    read just after.  Returns (inputs, outputs, launches)."""
    import numpy as np

    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import (dscim_fused, dscim_mvm,
                                     dscim_mvm_blocked, flash_attention,
                                     int8_matmul, ops)

    counters = {"int8_matmul": int8_matmul.LAUNCHES,
                "dscim_counts": dscim_mvm.LAUNCHES,
                "dscim_counts_blocked": dscim_mvm_blocked.LAUNCHES,
                "flash_attention": flash_attention.LAUNCHES}
    operands = _operands(torch)
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.normal(0, 1, (256, 1024)).astype(
        np.float32)).cuda()
    ws = torch.from_numpy(rng.normal(0, 1, (1024, 3072)).astype(
        np.float32)).cuda()
    qkv = {}
    for bh, s_len, d, dt in FLASH_SHAPES:
        qkv[(bh, s_len, d, dt)] = tuple(torch.from_numpy(rng.normal(
            0, 1, (bh, s_len, d)).astype(np.float32)).cuda().to(
            getattr(torch, dt)) for _ in range(3))
    cfg1 = calibrated_config("dscim1", 256)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    out = {}
    for shape, (x, w) in operands.items():
        out[("int8", shape)] = ops.int8_matmul(x, w)
        for key in OPS_PRESETS:
            cfg = calibrated_config(*key)
            out[("mvm", shape, key)] = ops.dscim_mvm(x, w, cfg)
            out[("blocked", shape, key)] = \
                dscim_mvm_blocked.dscim_counts_blocked(x, w, cfg)
    out["staged"] = dscim_fused.dscim_windowed_vmap_mvm(xs, ws, cfg1,
                                                        group_k=128)
    out["fused"] = dscim_fused.dscim_fused_mvm(xs, ws, cfg1, group_k=128)
    for key, (q, k, v) in qkv.items():
        out[("flash", key)] = flash_attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    launches = {n: c.count for n, c in counters.items()}
    n_sh, n_pre = len(OPS_SHAPES), len(OPS_PRESETS)
    want = {"int8_matmul": n_sh, "dscim_counts": n_sh * n_pre,
            "dscim_counts_blocked": n_sh * n_pre + 1024 // 128,
            "flash_attention": len(FLASH_SHAPES)}
    _log(f"launches on the operator path: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"operator launch counts {launches} != {want}")
    return {"operands": operands, "xs": xs, "ws": ws, "qkv": qkv,
            "cfg1": cfg1}, out, launches


def check_int8(torch, inp, out, launches):
    """int8 GEMM vs its plain version (bitwise) and ``torch._int_mm``."""
    from repro_torch.kernels import int8_matmul as im

    calls = []
    for shape, (x, w) in inp["operands"].items():
        M, K, N = shape
        got = out[("int8", shape)]
        want = im.int8_matmul_plain(x, w)
        if not torch.equal(got, want):
            raise AssertionError(f"int8_matmul {shape}: not bitwise equal, "
                                 f"max diff {(got - want).abs().max()}")
        # _int_mm needs M > 16: pad the rows with zeros (not timed apart)
        mp = max(32, -(-M // 8) * 8)
        xp = torch.zeros((mp, K), dtype=torch.int8, device="cuda")
        xp[:M] = x
        lib = torch._int_mm(xp, w)[:M]
        if not torch.equal(lib, got):
            raise AssertionError(f"torch._int_mm disagrees at {shape}")
        ms = _cuda_ms(lambda: im._launch_kernel(x, w), reps=50)
        plain_ms = _cuda_ms(lambda: im.int8_matmul_plain(x, w), reps=10)
        lib_ms = _cuda_ms(lambda: torch._int_mm(xp, w), reps=50)
        bound, by = _bound(M * K + K * N + 4 * M * N, 2.0 * M * N * K,
                           INT8_OPS_PER_S)
        calls.append({"shape": f"M={M} K={K} N={N}", "max_abs_err": 0.0,
                      "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "library_rows": mp, "bound_ms": bound, "bound_by": by})
        _log(f"int8_matmul {shape}: bitwise equal; {ms:.4f} ms (plain "
             f"{plain_ms:.4f}, _int_mm {lib_ms:.4f} at M={mp}, bound "
             f"{bound:.5f} {by})")
    head = calls[0]
    return {"name": "int8_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
            "replaces": "src/repro/kernels/int8_matmul.py:22",
            "launches": launches["int8_matmul"], "max_abs_err": 0.0,
            **{k: head[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")},
            "per": f"one call at {head['shape']} (the MLP up projection "
                   "at 256 rows); every shape in calls",
            "library": "torch._int_mm (cuBLASLt int8), rows zero-padded "
                       "to a multiple of 8 above 16",
            "tolerance": "bitwise", "calls": calls}


def check_counts(torch, inp, out, launches):
    """The count kernel through both wrappers: all-L (row 6) and blocked
    (row 5) counts identical to each other and to their plain versions
    (the all-L one on an N = SLICE_N column slice), ``ops.dscim_mvm``
    against the estimate from the plain counts, and the staged path
    against the fused one."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import build, dscim_fused, dscim_mvm, ops
    from repro_torch.kernels import dscim_mvm_blocked as blocked

    timing = build.LaunchCounter("timing, not counted")
    rows = {"dscim_counts": [], "dscim_counts_blocked": []}
    mvm_err = 0.0
    for shape, (x, w) in inp["operands"].items():
        M, K, N = shape
        for key in OPS_PRESETS:
            cfg = calibrated_config(*key)
            name = f"{key[0]}/L{key[1]} M={M} K={K} N={N}"
            pts = ops.fold_constants(cfg)
            c5 = out[("blocked", shape, key)]
            c6 = dscim_mvm.dscim_counts(x, w, *pts, k=cfg.k,
                                        length=cfg.length)
            p5 = blocked.dscim_counts_blocked_plain(x, w, cfg)
            ws = w[:, :SLICE_N].contiguous()
            p6 = dscim_mvm.dscim_counts_plain(x, ws, *pts, cfg.k)
            for what, a, b in (("blocked vs all-L", c5, c6),
                               ("blocked vs plain", c5, p5),
                               (f"all-L vs plain, N[:{SLICE_N}]",
                                c6[:, :SLICE_N], p6)):
                if not torch.equal(a, b):
                    raise AssertionError(f"counts {name} {what}: differ by "
                                         f"{(a - b).abs().max()}")
            est = out[("mvm", shape, key)]
            mvm_err = max(mvm_err, _check_close(
                f"dscim_mvm {name}", est, ops.mvm_from_counts(x, w, p5, cfg),
                MVM_RTOL))
            pmax = blocked.block_point_tables(cfg)[2]
            t6 = dscim_mvm.point_tables(*pts, cfg.k, x.device)
            t5 = blocked.count_tables(cfg, x.device)
            W = t5[0].shape[-1]
            nbytes = M * K + K * N + 4 * M * N + 2 * 4 * t5[0].numel()
            bound, by = _bound(nbytes, _count_ops(M, N, 1, K, cfg),
                               B1_OPS_PER_S)
            reps = 20 if M > 16 else 50
            common = {"shape": name, "pmax": pmax, "words": W,
                      "bound_ms": bound, "bound_by": by,
                      "max_abs_err": 0.0}
            ms6 = _cuda_ms(lambda: dscim_mvm.launch_counts(
                x, w, *t6, cfg.k, timing), reps)
            ms5 = _cuda_ms(lambda: dscim_mvm.launch_counts(
                x, w, *t5, cfg.k, timing), reps)
            rows["dscim_counts"].append({**common, "ms": ms6,
                "wrapper_ms": _cuda_ms(lambda: ops.dscim_mvm(x, w, cfg),
                                       reps),
                "plain_ms": _cuda_ms(lambda: dscim_mvm.dscim_counts_plain(
                    x, ws, *pts, cfg.k), reps=2, warmup=1),
                "plain_on": f"N[:{SLICE_N}] only"})
            rows["dscim_counts_blocked"].append({**common, "ms": ms5,
                "wrapper_ms": _cuda_ms(
                    lambda: blocked.dscim_counts_blocked(x, w, cfg), reps),
                "plain_ms": _cuda_ms(
                    lambda: blocked.dscim_counts_blocked_plain(x, w, cfg),
                    reps=2, warmup=1)})
            _log(f"counts {name}: blocked == all-L == plain (all-L plain on "
                 f"N[:{SLICE_N}]); kernel {ms6:.4f} ms all-L tables, "
                 f"{ms5:.4f} ms blocked tables (W={W}, pmax={pmax}); plain "
                 f"{rows['dscim_counts'][-1]['plain_ms']:.3f} ms on the "
                 f"slice, {rows['dscim_counts_blocked'][-1]['plain_ms']:.3f}"
                 f" ms blocked; bound {bound:.5f} ms ({by})")
    # staged (one blocked launch per window) against fused, same operands
    cfg1, xs, wsf = inp["cfg1"], inp["xs"], inp["ws"]
    staged_err = _check_close("staged vs fused", out["staged"], out["fused"],
                              MVM_RTOL)
    staged_ms = _cuda_ms(lambda: dscim_fused.dscim_windowed_vmap_mvm(
        xs, wsf, cfg1, group_k=128), reps=10)
    fused_ms = _cuda_ms(lambda: dscim_fused.dscim_fused_mvm(
        xs, wsf, cfg1, group_k=128), reps=10)
    _log(f"staged vs fused at (256, 1024) x (1024, 3072), dscim1/L256: err "
         f"{staged_err:.3e}; staged {staged_ms:.4f} ms, fused "
         f"{fused_ms:.4f} ms (both from float x and w)")
    result = []
    for name, src_line, extra in (
            ("dscim_counts", "src/repro/kernels/dscim_mvm.py:34",
             {"dscim_mvm_max_abs_err": mvm_err,
              "plain_on": f"plain_ms times the all-L expansion on the "
                          f"N[:{SLICE_N}] column slice"}),
            ("dscim_counts_blocked",
             "src/repro/kernels/dscim_mvm_blocked.py:63",
             {"staged_ms": staged_ms, "fused_ms": fused_ms,
              "staged_vs_fused_max_abs_err": staged_err})):
        head = rows[name][0]
        result.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dscim_counts.cu",
            "replaces": src_line, "launches": launches[name],
            "max_abs_err": 0.0,
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by")},
            "library_ms": None,
            "per": f"one call at {head['shape']}; every shape in calls",
            "library": "n/a: no PyTorch call computes the OR counts",
            "tolerance": "bitwise (counts); dscim_mvm and staged: "
                         f"{MVM_RTOL:g} x max|plain|",
            **extra, "calls": rows[name]})
    return result


def check_flash(torch, inp, out, launches):
    """Flash attention vs its plain version (f32 softmax on the same
    inputs) and ``scaled_dot_product_attention(is_causal=True)``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    calls = []
    for key, (q, k, v) in inp["qkv"].items():
        bh, s_len, d, dt = key
        got = out[("flash", key)]
        want = fa.flash_attention_plain(q.float(), k.float(), v.float())
        if dt == "float32":
            err = float((got - want).abs().max())
            ok = err <= FLASH_F32_ATOL
        else:
            err = float(((got.float() - want).abs()
                         / want.abs().clamp_min(1.0)).max())
            ok = err <= (FLASH_F16_RTOL if dt == "float16"
                         else FLASH_BF16_RTOL)
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash {key}: error {err:.3e}")
        # (1, BH, S, d): SDPA's fused backends take 4-D inputs only; on
        # 3-D ones it falls back to its unfused math path
        q4, k4, v4 = q[None], k[None], v[None]
        lib = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)[0]
        lib_err = float((lib.float() - want).abs().max())
        reps = 20 if s_len > 256 else 50
        ms = _cuda_ms(lambda: fa._launch_kernel(q, k, v), reps)
        plain_ms = _cuda_ms(lambda: fa.flash_attention_plain(q, k, v),
                            reps=3, warmup=1)
        lib_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), reps)
        flops = 4.0 * bh * d * s_len * (s_len + 1) / 2
        # f32 is held to 3e-5, which one TF32 product cannot meet: the least
        # time for f32-accurate work on the tensor cores is three TF32
        # products (3xTF32), 3 x flops at the TF32 rate
        bound, by = _bound(4 * q.numel() * q.element_size(),
                           3 * flops if dt == "float32" else flops,
                           TF32_FLOPS_PER_S if dt == "float32"
                           else BF16_FLOPS_PER_S)
        calls.append({"shape": f"BH={bh} S={s_len} d={d} {dt}",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_max_abs_diff": lib_err,
                      "bound_ms": bound, "bound_by": by})
        _log(f"flash {calls[-1]['shape']}: err {err:.3e}, {ms:.4f} ms "
             f"(plain {plain_ms:.3f}, sdpa {lib_ms:.4f} [max diff to plain "
             f"{lib_err:.2e}], bound {bound:.5f} {by})")
    head = calls[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:29",
            "launches": launches["flash_attention"],
            "max_abs_err": max(c["max_abs_err"] for c in calls
                               if "float32" in c["shape"]),
            **{k: head[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")},
            "per": f"one call at {head['shape']}; every shape in calls "
                   "(bf16/f16 bound: flops at 989 TFLOP/s; f32 bound: 3 x "
                   "flops at the 495 TFLOP/s TF32 rate, since f32 accuracy "
                   "(3e-5) takes three TF32 products on the tensor cores)",
            "library": "F.scaled_dot_product_attention(is_causal=True) on "
                       "(1, BH, S, d)",
            "tolerance": f"f32: max abs err <= {FLASH_F32_ATOL:g}; bf16: "
                         f"|err| <= {FLASH_BF16_RTOL:g} x max(1, |plain|), "
                         f"f16: {FLASH_F16_RTOL:g} x max(1, |plain|), "
                         "against the plain version in f32 on the same "
                         "rounded inputs (max_abs_err lists the f32 calls)",
            "calls": calls}


def table1(torch):
    """Phase 6: Table I through the card: each preset's rmse operands go
    through the count kernel; counts equal to the LUT's, RMSE equal to the
    JAX reference's to TABLE1_RTOL."""
    from repro_torch.core.macro import DSCIMMacro, rmse_operands
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_mvm

    dscim_mvm.LAUNCHES.reset()
    res = {}
    for key, want in TABLE1_JAX.items():
        mac = DSCIMMacro(calibrated_config(*key))
        x, w = (torch.as_tensor(a, dtype=torch.int32, device="cuda")
                for a in rmse_operands(mac.cfg.rows, 256, 48, 0, "uniform"))
        counts = dscim_mvm.dscim_counts(x, w, *mac.folded, k=mac.cfg.k,
                                        length=mac.cfg.length)
        lut = mac.counts_lut(x, w)
        if not torch.equal(counts, lut.to(torch.float32)):
            raise AssertionError(f"table1 {key}: kernel counts != LUT")
        got = mac.rmse(n_cols=256, n_vec=48, seed=0, backend="kernel",
                       device="cuda")["unsigned_fullscale"]
        res["/".join(map(str, key))] = got
        _log(f"table1 {key}: RMSE {got:.6f} % (JAX {want:.6f} %)")
        if abs(got - want) > TABLE1_RTOL * want:
            raise AssertionError(f"table1 {key}: {got} vs JAX {want}")
    _log(f"table1: {dscim_mvm.LAUNCHES.count} count-kernel launches")
    return res


def check_reduced(torch):
    """Phase 7: the reduced config on the GPU (kernels) vs the CPU (plain
    versions), same weights and prompts."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import logit_drift_rmse, serve_batch
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), dscim=DSCIM)
    params = lm.init_params(cfg, 0, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 16))
    res = {dev: serve_batch(cfg, params, prompts, 10, kv="int8",
                            page_size=4, trace_logits=True, device=dev)
           for dev in ("cpu", "cuda")}
    (tc, lc), (tg, lg) = res["cpu"], res["cuda"]
    drift = logit_drift_rmse(tc, tg, lc, lg)
    _log(f"reduced config GPU vs CPU: first tokens {tg[:, 0].tolist()} vs "
         f"{tc[:, 0].tolist()}, logit drift RMSE {drift:.3e}")
    if not (tc[:, 0] == tg[:, 0]).all() or not drift <= 1e-3:
        raise AssertionError("reduced config: GPU and CPU disagree")
    return drift


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    def phase(name, fn, *args):
        """Run one phase; a failure is reported and the later phases still
        run (one run on the card shows every fault), but the script fails."""
        try:
            return fn(*args)
        except Exception:                  # report, keep going, fail at end
            traceback.print_exc()
            failures.append(name)
            _log(f"phase {name} FAILED")
            return None

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import lm
    _log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.time()
    if phase("build", build.build) is None:
        return 1
    _log(f"built {list(build.SOURCES)} in {time.time() - t0:.1f} s")
    ptxas = phase("ptxas", ptxas_summary, ("flash_attention", "int8_matmul",
                                           "dscim_fused", "paged_attention",
                                           "dscim_counts"))

    from repro_torch.launch.serve import prepare_params
    cfg = get_arch("qwen3-0.6b")
    params = lm.init_params(cfg, 0)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT))
    # prepared once, as a serving caller does: every request of the main
    # path hands the same tensors, so the captured graph stays bound
    served = phase("prepare", prepare_params,
                   dataclasses.replace(cfg, dscim=DSCIM), params)
    launches, cache, e2e = phase("main_path", main_path, torch, cfg, params,
                                 served, prompts) or (None, None, {})
    prof = phase("profile", profile_main_path, torch, cfg, served, prompts)
    cb = phase("continuous", continuous, torch, cfg, served)
    spec = phase("spec", spec_phase, torch, cfg, served, prompts,
                 e2e.get("tokens"))
    modes = phase("modes", modes_phase, torch, cfg, served, prompts)
    del served
    counts = launches or {"dscim_fused_mvm": None,
                          "paged_attention_decode": None}
    kernels = [phase("dscim_fused", check_fused, torch, cfg, params, counts),
               phase("paged_attention", check_paged, torch, cfg, cache,
                     counts)]
    del cache
    if spec is not None:
        for entry, key in ((kernels[0], "fused"), (kernels[1], "paged")):
            if entry is not None:
                entry["launches_spec"] = {
                    n: v for n, v in spec["launches"].items()
                    if n.startswith(key)}
    ops_in, ops_out, ops_launches = phase(
        "operators", drive_operators, torch) or (None, None, None)
    if ops_in is None:
        kernels += [None] * 4
    else:
        kernels.append(phase("int8_matmul", check_int8, torch, ops_in,
                             ops_out, ops_launches))
        kernels += phase("counts", check_counts, torch, ops_in, ops_out,
                         ops_launches) or [None, None]
        kernels.append(phase("flash_attention", check_flash, torch, ops_in,
                             ops_out, ops_launches))
    del ops_in, ops_out
    if modes is not None and kernels[3] is not None:
        kernels[3]["launches_modes_bitmatmul"] = \
            modes["bitmatmul_count_launches"]
    t1 = phase("table1", table1, torch)
    drift = phase("reduced_gpu_vs_cpu", check_reduced, torch)
    print(json.dumps({"kernels": kernels, "card": smi[0] if smi else None,
                      "tok_s": e2e.get("tok_s"),
                      "capture_s": e2e.get("capture_s"),
                      "loops": e2e.get("loops"), "continuous": cb,
                      "spec": spec, "modes": modes,
                      "prefill_logit_rmse_vs_off": e2e.get("logit_rmse"),
                      "reduced_gpu_vs_cpu_drift": drift,
                      "table1_rmse_pct": t1,
                      "profile": prof, "ptxas": ptxas,
                      "failed_phases": failures}), flush=True)
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    if failures or not smi:
        print(f"chip_smoke: FAILED phases {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
