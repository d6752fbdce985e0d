#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --phase mesh|train_mesh    # that phase alone

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
   tok/s of 3 requests in turns with the plain graph path, one window's
   device time, the capture time, accepted tokens per verify, and whether
   the verify forward's ops give a row the same bits at B*(k+1) rows as
   at B (and each way's time); then serves ``bitmatmul``, ``statistical``
   and ``paper_inject`` (``modes``, full depth), each graph bitwise its
   eager loop, ``bitmatmul`` bitwise ``lut`` with its count-kernel
   launches counted, the noise modes' logit RMSE against ``exact``
   printed; serves the main path under a mesh (``mesh``, ``mesh_phase``,
   run after ``recurrent_family`` below, whose tokens its leg (e) holds):
   (a) under ``parallel_ctx_from_spec("model=1")`` over NCCL at world 1,
   the decode step and its collectives captured, tokens bitwise the main
   path's, launches counted, one decode step's device time beside the
   unsharded step's in turns; (b) kernel 1 at layer 0's MLP sites and the
   head, M = 4 and 256: each of 4 N-slices and 2 batch slices launched
   alone bitwise that slice of the full call; (c) kernel 2 at the main
   path's head layout and at LONG_POS: 2 batch slices bitwise the full
   call's rows; (d) two ranks on the one card over gloo
   (``chip_smoke.py --mesh-rank``): which collectives gloo carries for
   CUDA tensors, then qwen3 at full width cut to ``MESH_D_LAYERS`` layers
   at model=2, eagerly (a gloo group cannot be captured), both ranks'
   tokens bitwise one process's; (e) rwkv6-7b and zamba2-7b at their
   published width and depth under model=1 over NCCL, the decode step
   captured: tokens bitwise the unsharded request's and the
   ``recurrent_family`` phase's, no kernel launched, a decode step's
   device ms beside the unsharded step's in turns, peak memory; (f) the
   continuous queue with ``integrity='verify'``, a ``deadline_s`` per
   request, the hang watchdog (one hang), the accuracy monitor and one
   weight flip, on one device and under model=1 over NCCL: outputs,
   statuses, replays and integrity records equal, the queue's other
   requests bitwise the ``continuous`` phase's, kernels 1 and 2 counted
   under the mesh (``launches_mesh_knobs``); serves the continuous queue with requests 1-6 sharing
   request 0's first 48 tokens through the prefix cache, ``'cold'`` and
   ``'on'`` (``prefix``): warm tokens bitwise cold, the hit counters, 224
   of 512 prefill positions computed, the extend steps' fused-MVM and
   paged-attention launches those of the chunks fed, the extend graph
   bitwise the eager extend, and the kernel calls the profiler sees in a
   hit admission the counters'; it prints both legs' tok/s, the hit and
   miss admission latency, one extend replay's device time and the
   extend capture time; then the scheduler's fault handling on the
   continuous queue (``faults``): a device loss with a snapshot every
   segment (one replay, no second capture, snapshot and restore times),
   priority eviction in a 20-page pool and a step deadline, each
   bitwise the ``continuous`` phase's outputs (the deadline request's a
   prefix of its own); then the accuracy watchdog on the same queue at
   ``kernel:dscim2:64`` (``watchdog``): a healthy monitored run bitwise
   the unmonitored one with no trip, a stuck-at macro fault from segment
   1 that trips and escalates dscim2 -> dscim1 (every request ``ok``),
   an inf scale quarantined as ``nonfinite`` in its segment, the probe's
   device ms and launches, rels, threshold, escalation time, captures,
   bindings and kernel launches by leg; then the integrity layer at
   ``kernel:dscim1:256`` (``integrity``): ``integrity='verify'`` bitwise
   the ``continuous`` phase with zero mismatches and unchanged launches,
   the page and weight sweeps' device ms, the golden copy's bytes and
   time, a plane repair's wall ms, and the integrity drill's two legs
   (page and weight flips found at their exact coordinates and repaired,
   one replay where decodes read a corrupted plane, every request bitwise
   the fault-free run, one binding a leg); then the asyncio router
   (``router``, ``router_phase``: the load test's own entry point,
   ``run_loadtest``, on its trace of 32 requests through 4 slots and a
   68-page pool at ``kernel:dscim1:256``; every
   request terminal and the pool empty after each drain, bucket requests
   bitwise ``serve_continuous``, a chaos leg's ``ok`` requests bitwise
   the plain leg's with a replay, an inf page scale ``degraded`` after a
   restart, prefix warm bitwise cold with hits, the HTTP shim's stream
   equal to the router's tokens; latency, tok/s, occupancy, admission
   latency by path, bindings, and the two kernels' launches, zeroed
   before the plain leg and read after); then the reference's other
   dense configs (``dense_family``): olmo-1b at its published width and
   depth and starcoder2-7b at its published widths cut to 2 layers
   (q heads padded to 48: n_rep 12 under capture), each served like the
   main path, launches counted, graph bitwise eager, olmo-1b's two loops
   timed in turns; musicgen-large (2 layers, head_dim 64) at model level
   from seeded embeddings, its paged decode held against the plain read
   and against the dense cache; then the MoE configs (``moe_family``):
   granite-moe-1b-a400m at its published width and depth and
   deepseek-moe-16b at its published widths cut to 8 of 28 layers, each
   served like the main path (launches counted: the shared expert's
   matmuls and the head on kernel 1, every layer on kernel 2), the
   tokens each prefill's expert capacity dropped counted, graph bitwise
   eager with no drop at decode, ``spec=SPEC`` bitwise plain, both loops
   timed in turns, the cache bytes and a decode step's bytes bound
   printed; then the RWKV6 and Zamba2 configs (``recurrent_family``):
   rwkv6-7b and zamba2-7b at their published width and depth, served
   like the main path but at ``dscim="off"`` with the float cache (the
   reference serves them only so): no launch of any of the six kernels
   in a counted request, graph bitwise eager, a ragged ``max_new``
   request bitwise eager and each row the plain row cut at its budget,
   both loops timed in turns, the state's bytes a slot, a decode step's
   bytes bound and one profiled step;
4. holds each kernel's wrapper, as the main path calls it, against its
   plain PyTorch version on the same inputs at the main path's shapes,
   and times kernel, wrapper, plain version, the least
   time the card could take (``bound_ms``) and, for paged attention, one
   ``scaled_dot_product_attention`` call over pre-gathered K/V, and again
   at 2048 tokens of context on a synthetic pool of the same head layout;
   for the fused MVM (decode M = 4, the prefix extend chunk's M = 32,
   prefill M = 256, and the watchdog, ladder and router phases' shapes:
   M = 1, 4, 6, 32, 64, 384 as each calls it) it checks that the
   kernel's own activation quantization is bitwise the torch one, prints
   kernel and wrapper time per shape and regime, and the estimator's
   RMSE against the exact f32 product ``x @ w`` at each shape (the
   accuracy DS-CIM costs); both kernels also at every other dense
   config's shapes (``dense_family_fused <arch>``: one layer's MLP sites
   and head at M = 4 and 256; ``dense_family_paged``: each config's (KV,
   n_rep, HD) at the main path's position and at 2048 tokens) and at the
   MoE configs' (``moe_family_fused <arch>``: deepseek-moe-16b's shared expert
   and both heads; ``moe_family_paged``); the count kernel's counts
   must equal the cycle-level OR-MAC's (``core/ormac.py``) at M = 4,
   K = 64, N = 16 for dscim1/L256 and dscim2/L64 (``cycle_oracle``);
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
6. trains (``train``, ``train_phase``): olmo-1b at its published width
   and depth through ``repro_torch.launch.train.TrainLoop`` (bf16, remat,
   batch ``TRAIN_BATCH`` x ``TRAIN_SEQ``, ``TRAIN_STEPS`` steps, a
   checkpoint every ``TRAIN_CKPT_EVERY``): finite losses starting near
   ln(vocab), zero launches of the six kernels, step device ms (median
   and range after the first), tokens/s, the model-FLOPs share of the
   BF16 peak, peak memory, data wait and the row cache's hit rate,
   checkpoint copy and write seconds, one step under the profiler, the
   AdamW update against its bytes bound; a run from the first run's
   step-``TRAIN_CKPT_EVERY`` checkpoint with a failure injected just
   after it must replay bitwise the first run's losses, and
   ``restore_or_init`` must resume at that step and, after the run, at
   ``TRAIN_STEPS`` (leg (a) below holds the steps before the checkpoint
   from the seed); granite-moe-1b-a400m (full), rwkv6-7b and zamba2-7b (depth
   cut so the f32 training state fits ``TRAIN_STATE_SHARE`` of the card)
   take ``TRAIN_OTHER_STEPS`` steps each (finite losses; the MoE aux
   finite and positive, a second MoE run bitwise the first); then trains
   under a mesh and drives the paper-facing surface (``train_mesh``,
   ``train_mesh_phase``): (a) the olmo-1b run under ``REPRO_MESH=d1x1``
   over NCCL at world 1 (every leaf a placed piece gathered each step),
   its first ``TM_A_STEPS`` losses bitwise the train run's, step device
   ms beside it, peak memory; (b) two gloo ranks on the one card
   (``chip_smoke.py --train-mesh-rank``), olmo-1b at full width cut to
   ``TM_LAYERS`` layers under d2x1 with a failure injected on rank 0
   alone: every rank starts again and replays bitwise, the losses and
   gradient norms within ``TM_LOSS_RTOL`` and ``TM_GNORM_RTOL`` of one
   device's, the mesh's checkpoint restored on one device bitwise the
   ranks' final pieces, and its parameters' update within
   ``TM_UPDATE_RTOL`` of one device's; (c)
   ``pp_dryrun`` at the reference's defaults over pod=2, its result
   bitwise the stages applied in turn; (d) ``compressed_psum_tree`` over
   pod=2 bitwise its host re-statement; (e) ``examples/
   serve_dscim_torch.py --kv int8`` at its reduced config, prepared and
   ``--no-prepare``, kernels 1 and 2 counted; (f) ``fp8_cast`` and
   ``fp8_to_int8_aligned`` on the card bitwise the CPU's; (g) the train
   phase's granite-moe-1b-a400m (its experts with expert parallelism),
   rwkv6-7b and zamba2-7b runs under ``REPRO_MESH=d1x1`` over NCCL at
   world 1, their losses bitwise the train phase's, step device ms and
   peak memory beside them;
7. computes Table I through the card (``table1``): for all 12 presets the
   counts of ``DSCIMMacro.rmse``'s operands through the count kernel must
   equal the LUT's, and the RMSE must equal the JAX reference's;
8. serves the reduced qwen3-0.6b (``DSCIM``, int8 KV), rwkv6-7b and
   zamba2-7b (``off``, float cache) configs on the GPU and on the CPU
   (plain versions) and checks that they agree, and takes one train step
   of each family's reduced config on both (loss and gradient norm
   within ``TRAIN_LOSS_RTOL`` and ``TRAIN_GNORM_RTOL``).

Every time is device time (``_cuda_ms``): the device sleeps while the host
queues all the timed calls, so the host's time per call does not enter it.
Then it prints a ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
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
# prefix phase: requests 1-6 take request 0's first 48 tokens (6 pages)
PREFIX_SHARED, PREFIX_SHARERS = 48, range(1, 7)
EVICT_PAGES, EVICT_PRIO_REQ = 20, 2     # faults phase: pool, priority 5
DEADLINE_STEPS = 8                      # faults phase: request 0's budget
# watchdog phase: served at the ladder's top, a stuck-at macro fault from
# segment 1 (every third output column of every DS-CIM linear reads 40)
WD_DSCIM, WD_FAULT, WD_FAULT_AT = "kernel:dscim2:64", "stuck:3:40.0", 1
# its faulted run's ladder: serve_batch of the six quarantined requests
LADDER_B = 6
# router phase: the load test's trace at the serving shapes, through a
# pool under-provisioned by the reference's rule (68 pages, 31 MB of KV)
ROUTER_N, ROUTER_PREFIX_N = 32, 16
ROUTER_BUCKETS, ROUTER_CHUNK = (32, 64), 16
ROUTER_MAX_PROMPT, ROUTER_CAP = 96, 16
# dense_family phase: the reference's other dense configs, served like the
# main path (DSCIM, int8 paged KV, page PAGE, BATCH x PROMPT, TOKENS):
# (arch, layers kept; None = the published depth, widths always kept)
DF_SERVED = (("olmo-1b", None), ("starcoder2-7b", 2))
# a stub frontend at model level from seeded embeddings: layers, steps
DF_STUB, DF_STUB_LAYERS, DF_STUB_STEPS = "musicgen-large", 2, 8
DF_ARCHS = ("olmo-1b", "codeqwen1.5-7b", "starcoder2-7b", "musicgen-large",
            "pixtral-12b")
DF_COLS = 512    # output columns the prefill-M fused checks hold
# moe_family phase: the MoE configs served like the main path: (arch,
# layers kept; None = the published depth, widths always kept).
# deepseek-moe-16b's 64 routed experts are 0.55 G parameters a layer: 8 of
# its 28 layers keep the f32 draw and the bf16 copy near 30 GB
MOE_SERVED = (("granite-moe-1b-a400m", None), ("deepseek-moe-16b", 8))
# recurrent_family phase: the RWKV6 and Zamba2 configs at their published
# width and depth, served at the main path's shape with dscim 'off' and the
# float cache (the reference serves them so and no other way); a ragged
# request's budgets
REC_SERVED = (("rwkv6-7b", None), ("zamba2-7b", None))
# requests of each loop timed in turns (an eager zamba2-7b request takes
# about 4.5 s)
REC_TURNS = 3
REC_BUDGETS = (16, 5, 12, 3)
# kernel 6 against the cycle-level OR-MAC (core/ormac.py): (M, K, N)
CYCLE_SHAPE = (4, 64, 16)
# int8 paged KV against the dense cache on the float path: the
# reference's own bound on their logit drift (tests/test_generate.py
# test_paged_int8_kv_close_to_float_kv, dscim off)
KV_INT8_DRIFT = 1e-2
# train phase: olmo-1b at full width and depth through TrainLoop (bf16
# compute, remat as the config sets it), checkpoints every
# TRAIN_CKPT_EVERY steps, a replay after a failure injected just after a
# checkpoint, a resume; then the other families a few steps each
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "olmo-1b", 8, 512
TRAIN_STEPS, TRAIN_LR, TRAIN_CKPT_EVERY = 8, 3e-4, 4
TRAIN_FAIL_AT = TRAIN_CKPT_EVERY + 1        # just after a checkpoint
# (arch, cut the depth to fit, sequence): three steps each of TRAIN_BATCH
# rows; the recurrent families' eager scans walk their chunks in Python
# (a step of 512 tokens took 5.5-7.7 s), so they take 128
TRAIN_OTHERS = (("granite-moe-1b-a400m", False, TRAIN_SEQ),
                ("rwkv6-7b", True, 128), ("zamba2-7b", True, 128))
TRAIN_OTHER_STEPS = 2
# a cut config keeps the most layers whose f32 parameters, gradients and
# two moments (16 bytes a parameter) take at most this share of the
# card's memory; the rest holds activations and AdamW's temporaries
TRAIN_STATE_SHARE = 0.7
# reduced configs, one train step on the card against the CPU: the loss
# to 1e-5 relative (f32 order); the gradient norm to 1e-3 relative (on
# the CPU a 1e-7 relative change of the parameters moves a leaf's
# gradient by up to 4e-4 of its norm: the attention's and WKV's bf16
# roundings flip)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-5, 1e-3
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
# mesh phase: kernel 1's N-slices and both kernels' batch slices per leg;
# leg (d)'s two gloo ranks serve qwen3 at full width cut to this depth,
# this many tokens (each decode step gathers the f32 embedding through
# the host), each rank given this long
MESH_N_SLICES, MESH_B_SLICES = 4, 2
MESH_D_LAYERS, MESH_D_TOKENS, MESH_D_TIMEOUT_S = 2, 4, 240
# leg (f): the accuracy monitor's exact probe every this many segments, at
# this margin over the moment bound (full width's healthy dscim1/L256
# drift reads 5.1 bounds, C6, so the default 3 would trip a healthy slot)
MESH_F_PROBE, MESH_F_MARGIN = 2, 10.0
# train_mesh phase: (a) the train phase's olmo-1b run under REPRO_MESH
# d1x1 over NCCL at world 1, TM_A_STEPS steps from the seed (losses
# bitwise the train phase's first ones, every step before its
# checkpoint); (b)-(d) two gloo ranks on the one card
# (``chip_smoke.py --train-mesh-rank``): olmo-1b at full width cut to
# TM_LAYERS layers, TM_BATCH x TM_SEQ, TM_STEPS steps under d2x1 with a
# failure injected on rank 0 alone at step TM_FAIL_AT (before any
# checkpoint: every rank starts again from the seed and replays),
# ``pp_dryrun`` at the reference's defaults and ``compressed_psum_tree``
# over pod=2; (e) ``examples/serve_dscim_torch.py`` at its reduced config
# with the int8 cache, prepared and per call; (f) the FP8 helpers on the
# card against the CPU
TM_A_STEPS = TRAIN_CKPT_EVERY
# (b) takes 3 steps: the schedule's step-0 rate is 0, so the last loss is
# the first to follow an update
TM_LAYERS, TM_BATCH, TM_SEQ, TM_STEPS, TM_FAIL_AT = 2, 4, 128, 3, 1
TM_TIMEOUT_S = 420
# (b) at DP=2 against one device: bf16 compute, each rank's half of the
# batch through GEMMs of half the rows (cuBLAS may take another
# algorithm, and so other bf16 roundings) and the f32 mean of two
# half-batch means.  Losses and gradient norms relative; the update
# ||(p_mesh - p0) - (p_one - p0)|| / ||p_one - p0|| over every parameter.
# Read on an H100: losses at most 3.9e-5 off, gradient norms 1.1e-4, the
# update 0.016.  Each bound must lie below its fault reading, which the
# leg measures too: the last loss of a mesh that updated nothing (0.070
# off), and the update of a rank with no DP reduction, one device on
# rank 0's half of each batch.  Gradients summed over DP and not averaged
# double the gradient norm (and leave the parameters as they are: Adam
# and the clip are scale-free)
TM_LOSS_RTOL = 1e-3
TM_GNORM_RTOL = 1e-3
TM_UPDATE_RTOL = 5e-2
TM_EXAMPLE_TOKENS = 12       # serve_dscim_torch.py's default --tokens
# (g) the other families under d1x1 against the train phase's unsharded
# runs: a mesh of one rank with expert parallelism over one rank computes
# what one device does, up to the f32 order of its sums
TM_G_RTOL = 1e-5


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
    import shutil
    import tempfile

    from repro_torch.kernels import build
    cuobjdump = shutil.which("cuobjdump") or next(
        (str(p) for p in (Path(build._nvcc()).parent / "cuobjdump",)
         if p.exists()), None)
    # every library's SASS dumped at once (one cuobjdump each, in
    # parallel, into a file of its own), read below in order
    dumps = {}
    for name in names:
        if cuobjdump and build._target(name).exists():
            f = tempfile.TemporaryFile(mode="w+")
            dumps[name] = (subprocess.Popen(
                [cuobjdump, "-sass", str(build._target(name))], stdout=f,
                stderr=subprocess.DEVNULL), f)
    try:
        return _ptxas_rows(names, dumps)
    finally:
        for p, f in dumps.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()


def _ptxas_rows(names, dumps) -> dict:
    """``ptxas_summary``'s reading of each build log and SASS dump."""
    import re

    from repro_torch.kernels import build
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
        if name in dumps:
            p, f = dumps[name]
            p.wait(timeout=300)
            f.seek(0)
            text = f.read()
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


def _loops_in_turns(torch, cfg_ds, served, prompts, tag="", kv="int8",
                    turns=5):
    """The graph loop (``serve_batch(scan=True)``, already captured at
    these options) and the eager loop, ``turns`` requests each in turns
    (graph, eager, eager, graph, ...) at the main path's shape and cache
    layout ``kv``, each with the median device time of one decode step
    of its runner; returns the two loops' readings, medians and
    ranges."""
    import numpy as np

    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import _generate_runner

    kw = dict(kv=kv, page_size=PAGE)
    runner = _generate_runner(cfg_ds, BATCH, PROMPT, TOKENS, kv, PAGE,
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
    for scan in ((True, False, False, True) * turns)[:2 * turns]:
        tt = {}
        serve_batch(cfg_ds, served, prompts, TOKENS, scan=scan, timings=tt,
                    **kw)
        ms = _decode_step_ms(torch, step_fn[scan], reset)
        runs[scan].append((BATCH * TOKENS / tt["generate_s"], ms))
    st["params"] = None
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
        _log(f"{tag}{name} loop, {lp['runs']} runs: "
             f"{lp['tok_s_median']:.1f} tok/s median (range "
             f"{lp['tok_s_range'][0]:.1f}-{lp['tok_s_range'][1]:.1f}); "
             f"decode step {lp['decode_step_ms_median']:.4f} ms device "
             f"time median (range {lp['decode_step_ms_range'][0]:.4f}-"
             f"{lp['decode_step_ms_range'][1]:.4f})")
    return loops


def main_path(torch, cfg, params, served, prompts):
    """Phase 2 + 3: the main path through the captured decode step
    (``serve_batch(scan=True)`` on ``served``, the params prepared once),
    with launch counts over the replays, tokens and logit trace bitwise
    against the eager host loop (``scan=False``), and both loops timed in
    turns."""
    import numpy as np

    from repro_torch.kernels import dscim_fused, paged_attention
    from repro_torch.launch.serve import serve_batch

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
    want = {"dscim_fused_mvm": _fused_per_forward(cfg) * TOKENS,
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
    loops = _loops_in_turns(torch, cfg_ds, served, prompts)
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


# idle host time kept inside the profiler's window before and after the
# profiled work.  Kineto keeps only the device activity that lies inside
# the window, on the device's timestamps as it converts them to the
# host's clock; without this margin a hit admission's last four fused-MVM
# calls (4 of 170) once fell outside it.
PROFILE_MARGIN_S = 0.1


def _profile_request(torch, serve):
    """Wall time, device busy time (kernel durations summed), idle share,
    kernel count, the costliest kernel names of one ``serve()``, and the
    calls of each of ``PROFILED_KERNELS`` the device ran."""
    import collections

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_MARGIN_S)
    # kineto's own events: ``prof.events()`` would build a FunctionEvent
    # for every host op as well, which took longer than the profiled work
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()][0] += 1
            by_name[e.name()][1] += (e.end_ns() - e.start_ns()) / 1e6
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
    prompts, budgets = _cb_queue(cfg)
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
        | {"tok_s_without_capture": tok_s_uncaptured}, outs


def _cb_queue(cfg):
    """The continuous phase's queue: 8 prompts of PROMPT tokens (seed 1)
    and their budgets."""
    import numpy as np
    budgets = np.asarray(CB_BUDGETS, np.int32)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (len(budgets), PROMPT))
    return prompts, budgets


def _extend_admission(torch, cfg_ds, served, prompt, graph, start=0,
                      ext=None, state=None):
    """One chunked admission of ``prompt`` into slot 1 of a fresh serve
    state (or ``state``, again) through ``make_extend_fn`` (``ext``, made
    here if None) with the logit trace on, fed from position ``start``
    (a hit's first divergent page) onto pages granted from 0.  Returns
    (ext, state, tok0, traces)."""
    from repro_torch.core.kvcache import admission_pages, n_pages_for
    from repro_torch.launch.steps import init_serve_state, make_extend_fn

    S, dev = len(prompt), served["embed"].device
    cap = S + max(CB_BUDGETS) + PAGE - 1
    need = admission_pages(S, max(CB_BUDGETS), PAGE, PAGE - 1)
    if state is None:
        state = init_serve_state(cfg_ds, BATCH, cap, kv="int8",
                                 page_size=PAGE, device=dev)
        mp = n_pages_for(cap, PAGE)
        state["cache"]["page_table"][1] = torch.as_tensor(
            list(range(need)) + [need - 1] * (mp - need), dtype=torch.int32,
            device=dev)
    if ext is None:
        ext = make_extend_fn(cfg_ds, PAGE, eos_id=-1, trace_logits=True,
                             graph=graph)
    state["cache"]["pos"][1] = start
    state["done"][1] = True
    traces = []
    for fed in range(start, S, PAGE):
        _, tok0, tr = ext(served, state, prompt[None, fed:fed + PAGE], 1,
                          PAGE, fed + PAGE >= S, max(CB_BUDGETS))
        traces.append(tr)
    return ext, state, int(tok0), torch.stack(traces).cpu()


def prefix_phase(torch, cfg, served):
    """Phase 3f: the prefix cache at full width: the continuous phase's
    queue, requests 1-6 taking request 0's first PREFIX_SHARED tokens,
    served ``prefix_cache='cold'`` and then ``'on'`` (each admission
    page-aligned chunks of one captured extend graph).  Checks: each
    request's warm tokens bitwise its cold tokens; warm hits 6, 36 pages
    deduped, 288 hit tokens; 224 of 512 prefill positions computed; a
    drained pool with the shared prefix retained; one binding of the
    segment and of the extend step a leg; the fused-MVM and
    paged-attention launches of the extends those of the chunks fed (85
    and 224 a chunk); one admission's extend graph equal to the eager
    extend (first token, logit trace of every chunk, the slot's pages),
    and the kernel calls the profiler sees in a hit admission equal to
    the counters'.  Prints both legs' wall time and useful tok/s, the
    hit and miss admission latency (medians, device-synced), one extend
    replay's device time and the extend capture time."""
    import numpy as np

    from repro_torch.kernels import dscim_fused, paged_attention
    from repro_torch.launch.serve import serve_continuous

    cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
    prompts, budgets = _cb_queue(cfg)
    prompts[list(PREFIX_SHARERS), :PREFIX_SHARED] = prompts[0, :PREFIX_SHARED]
    n = int(budgets.max())
    L = cfg.n_layers
    per_chunk = {"dscim_fused_mvm": 3 * L + 1,
                 "paged_attention_decode": L * PAGE}
    legs = {}
    for mode in ("cold", "on"):
        outs, st = serve_continuous(cfg_ds, served, prompts, n, slots=BATCH,
                                    seg_len=CB_SEG, max_new=budgets,
                                    kv="int8", page_size=PAGE, eos_id=-1,
                                    prefix_cache=mode)
        pf = st["prefix"]
        chunks = pf["prefill_positions_computed"] // PAGE
        got = {k: st["extend_launches"].get(k) for k in per_chunk}
        want = {k: v * chunks for k, v in per_chunk.items()}
        lat = {k: float(np.median(pf[k])) * 1e3 if pf[k] else None
               for k in ("admit_lat_hit", "admit_lat_miss")}
        capt = st["capture_s"] + st["extend_capture_s"]
        legs[mode] = {
            "wall_s": st["wall_s"], "tok_s": st["tok_s"],
            "tok_s_without_captures": st["useful_tokens"]
            / (st["wall_s"] - capt),
            "segment_capture_s": st["capture_s"],
            "extend_capture_s": st["extend_capture_s"],
            "admit_ms_median": lat, "chunks": chunks,
            "admit_ms": {k: [1e3 * t for t in pf[k]]
                         for k in ("admit_lat_hit", "admit_lat_miss")},
            "extend_launches": got, "bindings": st["bindings"],
            "prefix": {k: v for k, v in pf.items()
                       if not k.startswith("admit_lat")},
            "pages": st["pages"]}
        _log(f"prefix {mode}: {st['useful_tokens']} tokens in "
             f"{st['wall_s']:.3f} s = {st['tok_s']:.1f} tok/s "
             f"({legs[mode]['tok_s_without_captures']:.1f} without the "
             f"segment capture {st['capture_s']:.3f} s and the extend "
             f"capture {st['extend_capture_s']:.3f} s); admission median "
             f"hit {lat['admit_lat_hit']} ms, miss {lat['admit_lat_miss']} "
             f"ms; {pf['hits']} hits, {pf['pages_deduped']} pages deduped, "
             f"{pf['prefill_positions_computed']}/"
             f"{pf['prefill_positions_total']} prefill positions; extend "
             f"launches {got} ({chunks} chunks; expected {want}); "
             f"bindings {st['bindings']}; pages {st['pages']}")
        if got != want:
            raise AssertionError(f"prefix {mode}: extend launches {got} "
                                 f"!= {want}")
        if st["bindings"] != {"segment": 1, "extend": 1}:
            raise AssertionError(f"prefix {mode}: bindings {st['bindings']}")
        if st["pages"]["live_pages"] != 0 \
                or st["status"] != ["ok"] * len(budgets):
            raise AssertionError(f"prefix {mode}: {st['pages']} "
                                 f"{st['status']}")
        legs[mode]["outputs"] = outs
    for r in range(len(budgets)):
        if not np.array_equal(legs["on"]["outputs"][r],
                              legs["cold"]["outputs"][r]):
            raise AssertionError(f"prefix request {r}: warm "
                                 f"{legs['on']['outputs'][r]} != cold "
                                 f"{legs['cold']['outputs'][r]}")
    pw = legs["on"]["prefix"]
    hits = len(PREFIX_SHARERS)
    want = {"hits": hits, "pages_deduped": hits * PREFIX_SHARED // PAGE,
            "hit_tokens": hits * PREFIX_SHARED,
            "prefill_positions_computed": len(budgets) * PROMPT
            - hits * PREFIX_SHARED,                  # 224 at full width
            "prefill_positions_total": len(budgets) * PROMPT}
    if {k: pw[k] for k in want} != want \
            or legs["cold"]["prefix"]["hits"] != 0 \
            or legs["on"]["pages"]["retained_pages"] <= 0:
        raise AssertionError(f"prefix counters {pw} (want {want}), cold "
                             f"{legs['cold']['prefix']}, pages "
                             f"{legs['on']['pages']}")
    _log(f"prefix: warm tokens bitwise cold for all {len(budgets)} "
         f"requests; counters {want}; retained pages "
         f"{legs['on']['pages']['retained_pages']}")
    # the extend graph against the eager extend on one cold admission
    prompt = prompts[1]
    ext, state, tok_g, tr_g = _extend_admission(torch, cfg_ds, served,
                                                prompt, True)
    _, estate, tok_e, tr_e = _extend_admission(torch, cfg_ds, served,
                                               prompt, False)
    same_pages = all(torch.equal(state["cache"][k], estate["cache"][k])
                     for k in ("k_pages", "v_pages", "k_scale", "v_scale",
                               "k_tail", "v_tail", "pos"))
    if not (tok_g == tok_e and torch.equal(tr_g, tr_e) and same_pages):
        raise AssertionError(f"extend graph vs eager: tok {tok_g} vs "
                             f"{tok_e}, traces equal "
                             f"{torch.equal(tr_g, tr_e)}, cache equal "
                             f"{same_pages}")
    del estate
    _log(f"prefix: the extend graph equals the eager extend over a "
         f"{PROMPT}-token admission ({PROMPT // PAGE} chunks): first token "
         f"{tok_g}, the ({PROMPT // PAGE}, {PAGE}, {cfg.vocab_padded}) "
         "logit trace and the cache bitwise")
    # a hit admission (the last two chunks) under the profiler
    torch.cuda.synchronize()
    dscim_fused.LAUNCHES.reset()
    paged_attention.LAUNCHES.reset()
    prof = _profile_request(torch, lambda: _extend_admission(
        torch, cfg_ds, served, prompt, True, start=PREFIX_SHARED, ext=ext,
        state=state))
    seen = prof["port_kernel_calls"]
    counted = {"fused_mvm": dscim_fused.LAUNCHES.count,
               "fused_quantize": dscim_fused.LAUNCHES.count,
               "paged_attention": paged_attention.LAUNCHES.count}
    hit_chunks = (PROMPT - PREFIX_SHARED) // PAGE
    _log(f"prefix profile (a hit admission, {hit_chunks} extend replays): "
         f"kernel calls the device ran {seen}, the counters' {counted}; "
         f"wall {prof['wall_ms_profiled']:.1f} ms, device busy "
         f"{prof['device_busy_ms']:.1f} ms, idle "
         f"{prof['device_idle_share']:.3f}, {prof['kernel_launches']} "
         "kernels")
    for kk in prof["top_kernels"][:5]:
        _log(f"  {kk['device_ms']:.2f} ms in {kk['calls']} x {kk['name']}")
    if seen != counted or counted["fused_mvm"] != hit_chunks \
            * per_chunk["dscim_fused_mvm"]:
        raise AssertionError(f"prefix profile {seen} vs counters {counted}")
    def reset():
        state["cache"]["pos"][1] = PROMPT - PAGE
    replay_ms = _decode_step_ms(torch, ext.runs["run"].step.graph.replay,
                                reset)
    _log(f"prefix: one extend replay ({PAGE} positions of one slot, "
         f"{BATCH} slots, the fused MVM at M = {BATCH * PAGE}) "
         f"{replay_ms:.4f} ms device time")
    for leg in legs.values():
        del leg["outputs"]
    return {"legs": legs, "extend_replay_ms": replay_ms,
            "profile_hit_admission": prof,
            "launches": {"fused_" + m: legs[m]["extend_launches"][
                "dscim_fused_mvm"] for m in legs}
            | {"paged_" + m: legs[m]["extend_launches"][
                "paged_attention_decode"] for m in legs}}


def faults_phase(torch, cfg, served, cb_outs):
    """Phase 3g: the scheduler's fault handling at full width on the
    continuous phase's queue, each run's tokens held bitwise against that
    phase's outputs ``cb_outs``: a device loss injected at segment 2 with
    a snapshot every boundary (one replay, the segment step bound once:
    the restore copies back in place; snapshot and restore times
    printed); a pool of EVICT_PAGES pages with request EVICT_PRIO_REQ at
    priority 5 (at least one eviction and one readmission); and a
    DEADLINE_STEPS-step deadline on request 0 (cancelled, its tokens a
    prefix of its continuous output, the others unchanged)."""
    import numpy as np

    from repro_torch.launch.serve import serve_continuous
    from repro_torch.runtime.failover import FailureInjector

    cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
    prompts, budgets = _cb_queue(cfg)
    R = len(budgets)
    kw = dict(slots=BATCH, seg_len=CB_SEG, max_new=budgets, kv="int8",
              page_size=PAGE, eos_id=-1, log=_log)
    prio = np.zeros(R, np.int64)
    prio[EVICT_PRIO_REQ] = 5
    deadlines = np.full(R, -1, np.int64)
    deadlines[0] = DEADLINE_STEPS
    runs = {
        "failover": dict(snapshot_every=1,
                         injector=FailureInjector(fail_at=(2,))),
        "eviction": dict(n_pages=EVICT_PAGES, priority=prio),
        "deadline": dict(deadline_steps=deadlines)}
    out = {}
    for name, knobs in runs.items():
        outs, st = serve_continuous(cfg_ds, served, prompts, int(
            budgets.max()), **kw, **knobs)
        keep = {k: st[k] for k in ("wall_s", "tok_s", "segments", "status",
                                   "replays", "evictions", "readmissions",
                                   "evicted_requests", "deadline_cancelled",
                                   "bindings", "snapshots", "capture_s")}
        keep["pages"] = st["pages"]
        keep["tok_s_without_capture"] = st["useful_tokens"] / (
            st["wall_s"] - st["capture_s"])
        out[name] = keep
        sn = st["snapshots"]
        _log(f"faults {name}: {keep['status']}, replays {st['replays']}, "
             f"evictions {st['evictions']} ({st['evicted_requests']}), "
             f"readmissions {st['readmissions']}, deadline_cancelled "
             f"{st['deadline_cancelled']}, bindings {st['bindings']}, "
             f"{st['tok_s']:.1f} tok/s over {st['wall_s']:.3f} s "
             f"({keep['tok_s_without_capture']:.1f} without the capture "
             f"{st['capture_s']:.3f} s); "
             f"{sn['count']} snapshots, "
             f"{1e3 * sn['snapshot_s'] / max(sn['count'], 1):.2f} ms each, "
             f"{sn['restores']} restores, "
             f"{1e3 * sn['restore_s'] / max(sn['restores'], 1):.2f} ms each")
        if st["bindings"]["segment"] != 1:
            raise AssertionError(f"faults {name}: the segment step bound "
                                 f"{st['bindings']['segment']} times")
        same = [r for r in range(R) if np.array_equal(outs[r], cb_outs[r])]
        if name == "deadline":
            n0 = len(outs[0])
            ok = st["status"][0] == "deadline" and 0 < n0 < budgets[0] \
                and np.array_equal(outs[0], cb_outs[0][:n0]) \
                and same == list(range(1, R)) \
                and st["status"][1:] == ["ok"] * (R - 1)
        elif name == "failover":
            ok = same == list(range(R)) and st["status"] == ["ok"] * R \
                and st["replays"] == 1
        else:
            ok = same == list(range(R)) and st["status"] == ["ok"] * R \
                and st["evictions"] >= 1 and st["readmissions"] >= 1
        if not ok:
            raise AssertionError(f"faults {name}: {keep}; requests equal to "
                                 f"the continuous phase: {same}")
    _log("faults: failover and eviction outputs bitwise the continuous "
         "phase's; the deadline request a prefix of its output, the others "
         "bitwise")
    return out


def _counts():
    """The fused-MVM and paged-attention launch counters, as a dict."""
    from repro_torch.kernels import dscim_fused, paged_attention
    return {"fused": dscim_fused.LAUNCHES.count,
            "paged": paged_attention.LAUNCHES.count}


def _leg(run):
    """``run()``, a ``serve_continuous`` call, with the two kernels'
    launches counted and the graphs it captured (each segment and extend
    binding, the probe's, and the ladder's serve_batch runners), as its
    stats report them."""
    c0 = _counts()
    out = run()
    c1 = _counts()
    st = out[1]
    captures = st["bindings"]["segment"] + st["bindings"]["extend"] \
        + st["probe_bindings"] + st["escalation_captures"]
    return out, {k: c1[k] - c0[k] for k in c1}, captures


def _admitted_state(torch, cfg_x, served, integrity=False):
    """A serve state of BATCH slots holding the continuous queue's first
    BATCH prompts, admitted (the probe's and the sweeps' timed input)."""
    from repro_torch.core.kvcache import admission_pages, n_pages_for
    from repro_torch.launch.steps import init_serve_state, make_admit_fn

    prompts, budgets = _cb_queue(cfg_x)
    cap = PROMPT + int(budgets.max())
    mp = n_pages_for(cap, PAGE)
    need = admission_pages(PROMPT, int(budgets.max()), PAGE)
    dev = served["embed"].device
    state = init_serve_state(cfg_x, BATCH, cap, kv="int8", page_size=PAGE,
                             integrity=integrity, device=dev)
    admit = make_admit_fn(cfg_x, eos_id=-1)
    for b in range(BATCH):
        ids = list(range(b * mp, b * mp + need))
        admit(served, state, torch.as_tensor(prompts[b:b + 1], device=dev),
              b, ids + [ids[-1]] * (mp - need), int(budgets.max()))
    return state


def watchdog_phase(torch, cfg, params):
    """Phase 3h: the accuracy watchdog and its ladder at full width on the
    continuous queue, served at WD_DSCIM (``kernel:dscim2:64``, the
    ladder's top; its params prepared once): a run without a monitor; a
    healthy run with ``watchdog_for_spec(WD_DSCIM, probe_every=1)``,
    bitwise the first with no trip (or, where the margin does not carry
    to full width, the calibration finding stated); a stuck-at macro
    fault from segment WD_FAULT_AT (a second segment runner) that trips
    and escalates dscim2 -> dscim1 with every request ``ok`` and the
    faulted run's lowest live rel above the healthy run's highest; an
    inf scale in slot 0's first page at segment 1, quarantined as
    ``nonfinite`` in that segment.  Prints the probe's device ms, the
    rels, the threshold, the escalation time, captures, bindings and
    kernel 1's and 2's launches by leg."""
    import numpy as np

    from repro_torch.launch.serve import prepare_params, serve_continuous
    from repro_torch.launch.steps import make_probe_fn
    from repro_torch.runtime.failover import FailureInjector
    from repro_torch.runtime.serving import (exact_probe_spec,
                                             watchdog_for_spec)
    from repro_torch.runtime.watchdog import AccuracyWatchdog

    class InfScale(FailureInjector):
        def corrupt_cache(self, segment, cache, slot_pages):
            if segment != 1 or ("inf", 1) in self.fired \
                    or slot_pages[0] is None:
                return cache, []
            self.fired.add(("inf", 1))
            cache["v_scale"][0, int(slot_pages[0][0]), 0] = float("inf")
            return cache, [0]

    cfg_w = dataclasses.replace(cfg, dscim=WD_DSCIM)
    served = prepare_params(cfg_w, params)
    prompts, budgets = _cb_queue(cfg)
    R, n = len(budgets), int(budgets.max())
    kw = dict(slots=BATCH, seg_len=CB_SEG, max_new=budgets, kv="int8",
              page_size=PAGE, eos_id=-1, log=_log)
    (plain, st_p), launch_p, cap_p = _leg(
        lambda: serve_continuous(cfg_w, served, prompts, n, **kw))
    healthy = watchdog_for_spec(WD_DSCIM, probe_every=1)
    (outs_h, st_h), launch_h, cap_h = _leg(
        lambda: serve_continuous(cfg_w, served, prompts, n,
                                 monitor=healthy, **kw))
    faulted = watchdog_for_spec(WD_DSCIM, probe_every=1)
    inj = FailureInjector(macro_fault_at=WD_FAULT_AT,
                          macro_fault=WD_FAULT)
    (outs_f, st_f), launch_f, cap_f = _leg(
        lambda: serve_continuous(cfg_w, served, prompts, n,
                                 monitor=faulted, injector=inj, **kw))
    (outs_n, st_n), launch_n, cap_n = _leg(
        lambda: serve_continuous(cfg_w, served, prompts, n,
                                 monitor=AccuracyWatchdog(None),
                                 injector=InfScale(), snapshot_every=1,
                                 **kw))
    thresh = healthy.rel_threshold
    h_rels, f_rels = healthy.live_rels(), faulted.live_rels(WD_FAULT_AT)
    hops = {(e["frm"], e["to"]) for e in st_f["escalations"]}
    # the probe alone, on the queue's first four admissions
    state = _admitted_state(torch, cfg_w, served)
    probe = make_probe_fn(dataclasses.replace(
        cfg_w, dscim=exact_probe_spec(WD_DSCIM)))
    probe(served, state)                 # captures its graph
    c0 = _counts()
    probe(served, state)
    torch.cuda.synchronize()
    c1 = _counts()
    probe_launch = {k: c1[k] - c0[k] for k in c1}
    probe_ms = _cuda_ms(lambda: probe(served, state), 5)
    probe_prof = _profile_request(torch, lambda: probe(served, state))
    del state

    out = {
        "threshold": thresh, "healthy_max_rel": float(h_rels.max()),
        "healthy_trips": st_h["probe_trips"],
        "faulted_min_rel": float(f_rels.min()),
        "faulted_trips": st_f["probe_trips"],
        "probes": {"healthy": st_h["probes"], "faulted": st_f["probes"]},
        "probe_ms": probe_ms, "probe_launches": probe_launch,
        "probe_profile": probe_prof,
        "probe_bindings": {"healthy": st_h["probe_bindings"],
                           "faulted": st_f["probe_bindings"]},
        "probe_s_healthy_run": st_h["probe_s"],
        "escalation_s": st_f["escalation_s"],
        "escalations": [(e["request"], e["frm"], e["to"], e["reason"],
                         e["accepted"], e["rel"])
                        for e in st_f["escalations"]],
        "quarantined": {"faulted": st_f["quarantined"],
                        "nonfinite": st_n["quarantine_log"]},
        "bindings": {"plain": st_p["bindings"], "healthy": st_h["bindings"],
                     "faulted": st_f["bindings"],
                     "nonfinite": st_n["bindings"]},
        "captures": {"plain": cap_p, "healthy": cap_h, "faulted": cap_f,
                     "nonfinite": cap_n},
        "launches": {"plain": launch_p, "healthy": launch_h,
                     "faulted": launch_f, "nonfinite": launch_n},
        "wall_s": {"plain": st_p["wall_s"], "healthy": st_h["wall_s"],
                   "faulted": st_f["wall_s"], "nonfinite": st_n["wall_s"]},
    }
    _log(f"watchdog ({WD_DSCIM}): threshold {thresh:.4f}; healthy: "
         f"{st_h['probes']} probes, max rel {out['healthy_max_rel']:.4f}, "
         f"{st_h['probe_trips']} trips; faulted ({WD_FAULT} from segment "
         f"{WD_FAULT_AT}): min rel {out['faulted_min_rel']:.4f}, "
         f"{st_f['probe_trips']} trips, quarantined {st_f['quarantined']}, "
         f"hops {sorted(hops)}, escalation {st_f['escalation_s']:.3f} s; "
         f"nonfinite: quarantined {st_n['quarantined']}; probe (one graph "
         f"replay) {probe_ms:.3f} ms device, profiled "
         f"{probe_prof['device_busy_ms']:.3f} ms busy in "
         f"{probe_prof['wall_ms_profiled']:.3f} ms wall, "
         f"{probe_prof['kernel_launches']} kernels, launches "
         f"{probe_launch}")
    _log(f"watchdog captures {out['captures']}, bindings {out['bindings']}, "
         f"launches by leg {out['launches']}, wall s {out['wall_s']}")

    failed = []
    if st_h["probe_trips"] == 0:
        if any(not np.array_equal(a, b) for a, b in zip(outs_h, plain)):
            failed.append("the healthy monitored run is not bitwise the "
                          "plain run")
    else:
        _log(f"CALIBRATION: the healthy full-width run tripped "
             f"{st_h['probe_trips']} times at margin 3 (max rel "
             f"{out['healthy_max_rel']:.4f} > threshold {thresh:.4f}); "
             "held instead: faulted min rel > healthy max rel")
    if not out["faulted_min_rel"] > out["healthy_max_rel"]:
        failed.append("the faulted run's lowest rel is not above the "
                      "healthy run's highest")
    if st_f["probe_trips"] < 1 or not st_f["quarantined"]:
        failed.append("the macro fault never tripped")
    if ("kernel:dscim2:64", "kernel:dscim1:256") not in hops:
        failed.append(f"no dscim2 -> dscim1 escalation: {hops}")
    rung = sum(e["to"] == DSCIM for e in st_f["escalations"])
    if rung != LADDER_B:
        failed.append(f"the ladder's dscim1 batch is {rung}, not the "
                      f"LADDER_B={LADDER_B} rows check_fused holds")
    for name, st, outs in (("faulted", st_f, outs_f),
                           ("nonfinite", st_n, outs_n)):
        if st["status"] != ["ok"] * R \
                or [len(o) for o in outs] != budgets.tolist():
            failed.append(f"{name}: statuses {st['status']}, lengths "
                          f"{[len(o) for o in outs]}")
    if st_f["bindings"]["segment"] != 2 or st_p["bindings"]["segment"] != 1 \
            or st_h["probe_bindings"] != 1 or st_f["probe_bindings"] != 1:
        failed.append(f"bindings {out['bindings']}, probe "
                      f"{out['probe_bindings']}")
    qlog = [(q["request"], q["segment"], q["reason"])
            for q in st_n["quarantine_log"]]
    if qlog != [(0, 1, "nonfinite")] or st_n["probes"] != 0:
        failed.append(f"nonfinite quarantine: {qlog}")
    elif any(not np.array_equal(outs_n[r], plain[r])
             for r in range(1, R)):
        failed.append("nonfinite: an unaffected request changed")
    if probe_launch != {"fused": 0, "paged": cfg.n_layers}:
        failed.append(f"probe launches {probe_launch}")
    if failed:
        raise AssertionError(f"watchdog: {failed}")
    return out


def integrity_phase(torch, cfg, served, cb_outs):
    """Phase 3i: the integrity layer at full width on the continuous
    queue at DSCIM: ``integrity='verify'`` with no fault is bitwise the
    ``continuous`` phase's outputs with zero mismatches and the same
    kernel launches as ``'off'``; the page sweep (the whole pool) and the
    weight sweep (every prepared plane) are timed on the device, the
    golden copy's bytes and time and a one-plane repair measured; then
    the integrity drill's two legs (``integrity_scenario``: a q-plane
    flip caught before use, a scale flip on slot 0 rewound, a page flip
    on slot 2 served again, then a scale-plane flip that costs one
    replay), each found at its exact coordinate, every request bitwise
    the fault-free run, one binding a leg.  Leg 1 arms the watchdog at
    DSCIM unless a monitored fault-free run trips (then NaN-only, the
    trips reported).  ``served`` is checked against its golden digests
    at the end (and restored if it were not clean)."""
    import numpy as np

    from repro_torch.core.kvcache import page_checksums
    from repro_torch.core.qweights import (golden_weight_copy,
                                           iter_qweight_planes,
                                           restore_weight_plane,
                                           weight_plane_digests)
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.runtime.serving import (integrity_scenario,
                                             watchdog_for_spec)
    from repro_torch.runtime.watchdog import AccuracyWatchdog

    cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
    prompts, budgets = _cb_queue(cfg)
    R, n = len(budgets), int(budgets.max())
    kw = dict(slots=BATCH, seg_len=CB_SEG, max_new=budgets, kv="int8",
              page_size=PAGE, eos_id=-1, log=_log)
    t = time.perf_counter()
    golden = golden_weight_copy(served)
    torch.cuda.synchronize()
    golden_s = time.perf_counter() - t
    golden_bytes = sum(x.numel() * x.element_size()
                       for x in golden["planes"].values())
    try:
        (outs_o, st_o), launch_o, _ = _leg(
            lambda: serve_continuous(cfg_ds, served, prompts, n, **kw))
        (outs_v, st_v), launch_v, cap_v = _leg(
            lambda: serve_continuous(cfg_ds, served, prompts, n,
                                     integrity="verify", **kw))
        cal = watchdog_for_spec(DSCIM, probe_every=1)
        (outs_c, st_c), _, _ = _leg(
            lambda: serve_continuous(cfg_ds, served, prompts, n,
                                     monitor=cal, **kw))
        monitor = watchdog_for_spec(DSCIM, probe_every=1) \
            if st_c["probe_trips"] == 0 else AccuracyWatchdog(None)
        report = integrity_scenario(
            cfg_ds, served, prompts, budgets, slots=BATCH, seg_len=CB_SEG,
            page_size=PAGE, rewind_slot=0, reserve_slot=2, layer=1,
            monitor=monitor, outs_ref=cb_outs,
            device=served["embed"].device, log=_log)
        # the sweeps and a repair, timed on the device
        state = _admitted_state(torch, cfg_ds, served, integrity=True)
        cache = state["cache"]
        page_ms = _cuda_ms(lambda: page_checksums(
            cache["k_pages"], cache["v_pages"], cache["k_scale"],
            cache["v_scale"]), 5)
        pool_bytes = sum(cache[k].numel() * cache[k].element_size()
                         for k in ("k_pages", "v_pages", "k_scale",
                                   "v_scale"))
        del state, cache
        weight_ms = _cuda_ms(lambda: weight_plane_digests(served), 3)
        # a repair copies host bytes in: wall time, median of 5
        big = max(iter_qweight_planes(served), key=lambda p: p[2].numel())
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            restore_weight_plane(served, big[0], big[1], golden)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t))
        repair_ms = sorted(walls)[2]
    finally:
        cur = weight_plane_digests(served).cpu().numpy()
        dirty = np.nonzero(cur != golden["digests"])[0].tolist()
        for i in dirty:
            restore_weight_plane(served, *golden["index"][i], golden)
    ig = st_v["integrity"]
    out = {
        "verify": {"checks": ig["checks"],
                   "pages_verified": ig["pages_verified"],
                   "weight_planes_verified": ig["weight_planes_verified"],
                   "mismatches": ig["page_mismatches"]
                   + ig["weight_mismatches"],
                   "scrub_time_s": ig["scrub_time_s"],
                   "wall_s": st_v["wall_s"], "off_wall_s": st_o["wall_s"],
                   "launches": launch_v, "off_launches": launch_o,
                   "captures": cap_v, "bindings": st_v["bindings"]},
        "calibration_dscim1": {"max_rel": float(cal.live_rels().max()),
                               "threshold": cal.rel_threshold,
                               "trips": st_c["probe_trips"]},
        "drill": report,
        "page_sweep_ms": page_ms, "pool_bytes": pool_bytes,
        "weight_sweep_ms": weight_ms,
        "weight_planes": len(golden["index"]),
        "golden_bytes": golden_bytes, "golden_s": golden_s,
        "repair_plane": list(big[:2]), "repair_plane_bytes":
        big[2].numel() * big[2].element_size(), "repair_wall_ms": repair_ms,
    }
    _log(f"integrity: verify {ig['checks']} checks, "
         f"{ig['pages_verified']} page digests and "
         f"{ig['weight_planes_verified']} plane digests verified, "
         f"{out['verify']['mismatches']} mismatches, scrub "
         f"{ig['scrub_time_s']:.3f} s of {st_v['wall_s']:.3f} s wall (off "
         f"{st_o['wall_s']:.3f} s); page sweep {page_ms:.4f} ms over "
         f"{pool_bytes} B, weight sweep {weight_ms:.3f} ms over "
         f"{len(golden['index'])} planes; golden copy {golden_bytes} B in "
         f"{golden_s:.3f} s; repair of {big[0]}/{big[1]} "
         f"({out['repair_plane_bytes']} B) {repair_ms:.3f} ms wall; dscim1 "
         f"calibration: max rel {out['calibration_dscim1']['max_rel']:.4f} "
         f"vs threshold {cal.rel_threshold:.4f}, {st_c['probe_trips']} "
         f"trips; drill: leg 1 {report['leg1']}, leg 2 {report['leg2']}")
    failed = []
    if any(not np.array_equal(a, b) for a, b in zip(outs_v, cb_outs)):
        failed.append("verify is not bitwise the continuous phase")
    if out["verify"]["mismatches"] or launch_v != launch_o:
        failed.append(f"verify: {out['verify']}")
    if report["leg1"]["corrupted_requests"] != [0, 6]:
        failed.append(f"corrupted {report['leg1']['corrupted_requests']}")
    if dirty:
        failed.append(f"planes left corrupted: {dirty}")
    if st_c["probe_trips"]:
        _log(f"CALIBRATION: the fault-free {DSCIM} run tripped "
             f"{st_c['probe_trips']} times at margin 3; the drill's leg 1 "
             "monitored NaN only")
    if failed:
        raise AssertionError(f"integrity: {failed}")
    return out


def router_phase(torch, cfg, served):
    """Phase 3j: the asyncio serving router (runtime/router.py) at full
    width, ``kernel:dscim1:256``, int8 KV, page 8, BATCH slots, segments
    of CB_SEG, through the load test's own entry point
    (launch/loadtest.py ``run_loadtest`` at the ``LoadShape`` below: the
    trace ``make_trace(0, ROUTER_N, ...)``, about 80 % bucket lengths, the
    rest odd lengths 2-96 through chunked prefill, geometric budgets, bursty
    arrivals, a few deadlines and disconnects, through a pool
    under-provisioned by the reference's rule).  After its warm-up leg:
    the plain leg (every request terminal, no live page after the drain;
    the kernels' counters zeroed just before it and read just after); its
    bucket-length ``ok`` requests bitwise ``serve_continuous``; a chaos
    leg (a sampled device loss and two page flips over the first half of
    the plain leg's segments, a snapshot every 4 rounds, the NaN-only
    monitor) whose ``ok`` requests are bitwise the plain leg's, every one
    a flip did not hit, with a replay and one binding a step; the prefix
    legs (ROUTER_PREFIX_N requests, 3/4 sharing an 8-token system prompt,
    all chunked at the page size) cold and ``prefix_cache=True``,
    ``ok``-vs-``ok`` bitwise with hits.  Then, of its own: an inf page
    scale quarantined, its stream restarted and ``degraded``; the HTTP
    shim on an ephemeral port (one streamed request equal to the router's
    tokens, 413, /healthz 200 then 503 while draining)."""
    import asyncio
    import contextlib

    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.launch import loadtest as lt
    from repro_torch.launch.server import HttpFrontend
    from repro_torch.runtime.failover import FailureInjector
    from repro_torch.runtime.router import Router
    from repro_torch.runtime.watchdog import AccuracyWatchdog

    cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
    shape = lt.LoadShape(
        requests=ROUTER_N, slots=BATCH, seg_len=CB_SEG, page_size=PAGE,
        buckets=ROUTER_BUCKETS, chunk_len=ROUTER_CHUNK,
        max_prompt=ROUTER_MAX_PROMPT, max_new_cap=ROUTER_CAP,
        mean_gap_s=0.002, device_losses=1, flips=2, min_fault_segments=2,
        fault_span=0.5, prefix_requests=ROUTER_PREFIX_N, direct=True)
    kn = shape.router_kw()
    launches: dict = {}
    leg_s: dict = {}

    @contextlib.contextmanager
    def around(name):
        if name == "plain":
            for c in build.COUNTERS:
                c.reset()
        t = time.perf_counter()
        yield
        leg_s[name] = time.perf_counter() - t
        if name == "plain":
            launches.update({c.name: c.count for c in build.COUNTERS
                             if c.count})

    legs: dict = {}
    lt.run_loadtest(False, cfg=cfg_ds, params=served, shape=shape,
                    prefix=True, around_leg=around, legs=legs, log=_log)
    ck = legs["checks"]
    st_p, m_plain = legs["plain"]["stats"], legs["plain"]["metrics"]
    st_c, m_chaos = legs["chaos"]["stats"], legs["chaos"]["metrics"]
    st_pc, st_pw = legs["prefix_cold"]["stats"], legs["prefix_warm"]["stats"]
    inj = legs["chaos"]["injector"]
    trace = legs["plain"]["trace"]

    class InfScale(FailureInjector):
        """slot 0's first page's V scale set to +inf at segment 1."""

        def corrupt_cache(self, segment, cache, slot_pages):
            if segment != 1 or "inf" in self.fired or slot_pages[0] is None:
                return cache, []
            self.fired.add("inf")
            cache["v_scale"][0, int(slot_pages[0][0]), 0] = float("inf")
            return cache, [0]

    rng = np.random.default_rng(1)

    async def quarantine():
        r = Router(cfg_ds, served, **kn, injector=InfScale(),
                   monitor=AccuracyWatchdog(None), log=_log)
        await r.start()
        h = r.submit(rng.integers(1, 1000, ROUTER_BUCKETS[0],
                                  dtype=np.int32), 8)
        events = [ev async for ev in h.events()]
        await r.close()
        return events, r.stats()

    q_events, st_q = asyncio.run(quarantine())
    q_kinds = [k for k, _ in q_events]

    async def http():
        r = Router(cfg_ds, served, **kn, log=_log)
        front = HttpFrontend(r, "127.0.0.1", 0, log=_log)
        task = asyncio.create_task(front.serve())
        _, port = await front.wait_ready()
        prompt = trace[1]["prompt"]
        got = {"gen": await _http(port, "POST", "/v1/generate",
                                  {"prompt": prompt.tolist(), "max_new": 6}),
               "direct": await r.submit(prompt, 6).result(),
               "413": await _http(port, "POST", "/v1/generate",
                                  {"prompt": [1] * (ROUTER_MAX_PROMPT + 1),
                                   "max_new": 2}),
               "health": await _http(port, "GET", "/healthz")}
        long = asyncio.create_task(_http(
            port, "POST", "/v1/generate",
            {"prompt": prompt.tolist(), "max_new": ROUTER_CAP}))
        while not any(b >= 0 for b in r._host["slot_rid"]):
            await asyncio.sleep(0.001)
        front.request_drain()
        got["health_drain"] = await _http(port, "GET", "/healthz")
        got["long"] = await long
        await task
        got["pages"] = r.stats()["pages"]
        return got

    web = asyncio.run(http())
    stream = [json.loads(ln) for ln in web["gen"][2].decode().splitlines()
              if ln]
    web_tokens = [e["token"] for e in stream if "token" in e]

    lat = st_p["admit_lat"]
    plat = {k: v for k, v in st_pw["admit_lat"].items() if v}
    med = (lambda xs: float(np.median(xs)) if xs else None)
    out = {
        "requests": ROUTER_N, "pool_pages": kn["n_pages"],
        "warmup_s": leg_s["warmup"],
        "plain": dict(m_plain, bindings=st_p["bindings"],
                      capture_s=st_p["capture_s"],
                      segments=st_p["segments"],
                      admit_lat_median_ms={k: 1e3 * med(v) if v else None
                                           for k, v in lat.items()},
                      admit_lat_n={k: len(v) for k, v in lat.items()}),
        "launches": launches,
        "bitwise_vs_serve_continuous": ck["direct"],
        "chaos": dict(m_chaos, bindings=st_c["bindings"],
                      snapshots=st_c["snapshots"],
                      fail_at=list(inj.fail_at), flips=len(inj.hits),
                      corrupted=ck["corrupted"],
                      bitwise_ok=ck["chaos_bitwise"],
                      corrupted_ok=ck["corrupted_ok"],
                      corrupted_ok_equal=ck["corrupted_ok_equal"]),
        "quarantine": {"events": q_kinds[q_kinds.index("restart"):]
                       .count("token") if "restart" in q_kinds else 0,
                       "end": q_events[-1][1],
                       "restart": "restart" in q_kinds,
                       "ladder": st_q["ladder"],
                       "counters": st_q["counters"]},
        "prefix": {"cold_wall_s": legs["prefix_cold"]["wall_s"],
                   "warm_wall_s": legs["prefix_warm"]["wall_s"],
                   "bitwise_ok": ck["prefix_bitwise"],
                   "stats": st_pw["prefix"],
                   "admit_lat_median_ms": {k: 1e3 * med(v)
                                           for k, v in plat.items()},
                   "cold_admit_lat_median_ms": 1e3 * med(
                       st_pc["admit_lat"]["chunked_miss"]),
                   "bindings": st_pw["bindings"]},
        "http": {"status": web["gen"][0], "tokens": len(web_tokens),
                 "equal": web_tokens == web["direct"].tokens,
                 "413": web["413"][0], "healthz": web["health"][0],
                 "healthz_draining": web["health_drain"][0]},
    }
    _log(f"router: plain leg {ROUTER_N} requests in "
         f"{m_plain['wall_s']:.3f} s: p50 {m_plain['p50_ms']:.1f} ms, p99 "
         f"{m_plain['p99_ms']:.1f} ms (of {m_plain['latencies']} "
         f"latencies), {m_plain['tok_s']:.1f} useful tok/s, refusal rate "
         f"{m_plain['refusal_rate']:.3f}, occupancy "
         f"{m_plain['occupancy']:.3f}, statuses {m_plain['statuses']}, "
         f"pages {m_plain['pages']}; admission to first token (median ms, "
         f"count) {out['plain']['admit_lat_median_ms']} "
         f"{out['plain']['admit_lat_n']}; bindings {st_p['bindings']}, "
         f"capture s {st_p['capture_s']}; launches {launches}; "
         f"{ck['direct']} bucket requests bitwise serve_continuous")
    _log(f"router: chaos leg {m_chaos['wall_s']:.3f} s, replays "
         f"{m_chaos['replays']}, fail_at {inj.fail_at}, flips applied "
         f"{inj.hits}, corrupted {ck['corrupted']} "
         f"({ck['corrupted_ok_equal']} of their {ck['corrupted_ok']} ok in "
         f"both legs still equal), {ck['chaos_bitwise']} ok requests "
         f"bitwise the plain leg, bindings {st_c['bindings']}, snapshots "
         f"{st_c['snapshots']}, statuses {m_chaos['statuses']}")
    _log(f"router: quarantine {out['quarantine']}; prefix cold "
         f"{out['prefix']['cold_wall_s']:.3f} s / warm "
         f"{out['prefix']['warm_wall_s']:.3f} s, {ck['prefix_bitwise']} "
         f"bitwise, {st_pw['prefix']}, admission ms {out['prefix']}; http "
         f"{out['http']}")
    failed = []
    if not (launches.get("dscim_fused_mvm")
            and launches.get("paged_attention_decode")):
        failed.append(f"a serving kernel not launched: {launches}")
    if ck["direct"] == 0:
        failed.append("no bucket request held against serve_continuous")
    if m_chaos["replays"] < 1 or ck["chaos_bitwise"] == 0:
        failed.append(f"chaos: {m_chaos['replays']} replays, "
                      f"{ck['chaos_bitwise']} requests compared")
    for leg, st in (("plain", st_p), ("chaos", st_c), ("prefix", st_pw)):
        if st["bindings"]["segment"] != 1 or st["bindings"]["extend"] != 1:
            failed.append(f"{leg} bindings {st['bindings']}")
    if not out["quarantine"]["restart"] or out["quarantine"]["end"] \
            != "degraded" or out["quarantine"]["events"] != 8:
        failed.append(f"quarantine: {q_events}")
    if ck["prefix_bitwise"] == 0:
        failed.append(f"prefix: {st_pw['prefix']}, none compared")
    h = out["http"]
    if (h["status"], h["413"], h["healthz"], h["healthz_draining"]) \
            != (200, 413, 200, 503) or not h["equal"] or h["tokens"] != 6 \
            or web["pages"]["live_pages"]:
        failed.append(f"http: {h}, pages {web['pages']}")
    if failed:
        raise AssertionError(f"router: {failed}")
    return out


async def _http(port, method, path, body=None):
    """One HTTP/1.1 request to 127.0.0.1:``port``: (status, headers, body
    with the chunked transfer coding removed)."""
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = b"" if body is None else json.dumps(body).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, v in
               (ln.split(":", 1) for ln in lines[1:])}
    if headers.get("transfer-encoding") == "chunked":
        out = b""
        while True:
            size, _, rest = rest.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                break
            out, rest = out + rest[:n], rest[n + 2:]
        rest = out
    return int(lines[0].split(" ")[1]), headers, rest


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
    tok/s of 3 requests in turns with the plain graph path, one window's
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
    for name in ("plain", "spec", "spec", "plain", "plain", "spec"):
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
    _log(f"spec vs plain graph, {len(runs['spec'])} requests each in "
         f"turns: spec "
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


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    return tree.numel()


def _numel_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _family_counters():
    """The main path's kernel counters, by kernel name."""
    from repro_torch.kernels import dscim_fused
    from repro_torch.kernels import paged_attention as pa

    return {"dscim_fused_mvm": dscim_fused.LAUNCHES,
            "paged_attention_decode": pa.LAUNCHES}


def _all_counters():
    """The launch counters of all six kernels, by kernel name."""
    from repro_torch.kernels import (dscim_mvm, dscim_mvm_blocked,
                                     flash_attention, int8_matmul)

    return {**_family_counters(),
            "flash_attention": flash_attention.LAUNCHES,
            "int8_matmul": int8_matmul.LAUNCHES,
            "dscim_counts_blocked": dscim_mvm_blocked.LAUNCHES,
            "dscim_counts": dscim_mvm.LAUNCHES}


def _attention_launches(cfg):
    """A counted request's launches on the attention families' path at
    DSCIM with the int8 cache: a forward's DS-CIM matmuls and head a
    token on kernel 1, the layers a decode step on kernel 2."""
    return {"dscim_fused_mvm": _fused_per_forward(cfg) * TOKENS,
            "paged_attention_decode": cfg.n_layers * (TOKENS - 1)}


def _serve_family(torch, phase, archs, timed, extra=None, *, kv="int8",
                  dscim=DSCIM, want=_attention_launches, turns=5):
    """Serve each (arch, layers kept; None = the published depth, widths
    always kept) of ``archs`` through ``serve_batch`` at the main path's
    shape, with the cache layout ``kv`` and the spec ``dscim`` (random
    weights from seed 0, prepared once): the warm-up request captures the
    decode step; a counted request's launches must be ``want(cfg)``, a
    dict by kernel name (``_all_counters``); the graph's tokens and logit
    trace must equal the eager loop's bitwise.  ``extra(torch, cfg_ds,
    served, prompts, toks)`` returns results of its own checks; the archs
    in ``timed`` are then timed, both loops ``turns`` requests in turns
    (the eager loop's first request is the graph check's).  Returns ({arch:
    results}, launches summed over the counted requests)."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import (clear_graphs, prepare_params,
                                          serve_batch)
    from repro_torch.models.registry import get_model

    clear_graphs()             # the earlier phases' runners and graph pools
    kw = dict(kv=kv, page_size=PAGE)
    counters = _all_counters()
    total = {}
    out = {}
    for name, layers in archs:
        cfg = get_arch(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        cfg_ds = dataclasses.replace(cfg, dscim=dscim)
        params = get_model(cfg).init_params(cfg, 0)
        n_params = _numel(params)
        served = prepare_params(cfg_ds, params)
        del params
        torch.cuda.empty_cache()
        prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                    (BATCH, PROMPT))
        warm = {}
        serve_batch(cfg_ds, served, prompts, TOKENS, timings=warm, **kw)
        torch.cuda.synchronize()
        if "capture_s" not in warm:
            raise AssertionError(f"{name}: the warm-up captured no graph")
        expected = want(cfg)
        for c in counters.values():
            c.reset()
        t = {}
        toks, _ = serve_batch(cfg_ds, served, prompts, TOKENS, timings=t,
                              **kw)
        launches = {k: counters[k].count for k in expected}
        _log(f"{phase} {name} ({cfg.family}, {cfg.n_layers} of "
             f"{get_arch(name).n_layers} layers, d {cfg.d_model}, "
             f"{cfg.q_heads} q heads over {cfg.n_kv} kv heads: n_rep "
             f"{cfg.q_heads // cfg.n_kv}, {n_params} parameters, dscim "
             f"{dscim}, kv {kv}): launches {launches} (expected "
             f"{expected}), capture {warm['capture_s']:.3f} s")
        if launches != expected or "capture_s" in t:
            raise AssertionError(f"{name}: launches {launches} != "
                                 f"{expected} or the timed request "
                                 "captured again")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        (tg, lg), (te, le) = (serve_batch(cfg_ds, served, prompts, TOKENS,
                                          scan=scan, trace_logits=True, **kw)
                              for scan in (True, False))
        if not (np.array_equal(tg, te) and np.array_equal(tg, toks)
                and np.array_equal(np.stack(lg), np.stack(le))):
            raise AssertionError(f"{name}: graph and eager loop disagree")
        if not np.isfinite(np.stack(lg)).all() or toks.min() < 0 \
                or toks.max() >= cfg.vocab_padded:
            raise AssertionError(f"{name}: bad tokens or logits")
        _log(f"{phase} {name}: graph tokens and ({TOKENS}, {BATCH}, "
             f"{cfg.vocab_padded}) logit trace bitwise the eager loop's")
        res = {"layers": cfg.n_layers,
               "published_layers": get_arch(name).n_layers,
               "params": n_params, "n_rep": cfg.q_heads // cfg.n_kv,
               "launches": launches, "capture_s": warm["capture_s"],
               "tok_s": BATCH * TOKENS / t["generate_s"]}
        if extra is not None:
            res.update(extra(torch, cfg_ds, served, prompts, toks))
        if name in timed:
            res["loops"] = _loops_in_turns(torch, cfg_ds, served, prompts,
                                           turns=turns,
                                           tag=f"{phase} {name} ", kv=kv)
        out[name] = res
        del served
        clear_graphs()
        torch.cuda.empty_cache()
    return out, total


def dense_family(torch):
    """Phase dense_family, the reference's other dense configs on the card.
    ``DF_SERVED`` go through ``_serve_family``; olmo-1b (published depth)
    is timed.  starcoder2-7b keeps 2 of its 32 layers at its published
    widths: its 36 q heads padded to 48 over 4 kv heads, n_rep 12 under
    capture.  ``DF_STUB`` (musicgen-large, 2 of
    48 layers, head_dim 64) runs at model level from seeded embeddings,
    at DSCIM and at 'off': prefill, then ``DF_STUB_STEPS`` decode steps on
    the int8 paged cache, each layer's paged attention held against the
    plain read at PAGED_RTOL as the model calls it, the launches counted,
    and the same steps on the dense bf16 cache.  The paged logits' drift
    from the dense ones is held within KV_INT8_DRIFT at 'off'; at DSCIM
    it is printed only: the estimator quantizes its activations, so the
    int8 cache's small perturbation moves whole quantization levels, and
    no contract of the reference bounds that (its own 3e-2 bound fails
    at dscim2:64, ROADMAP C3)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.kvcache import n_pages_for, paged_from_dense
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import prepare_params
    from repro_torch.layers import attention
    from repro_torch.models import lm

    served_out, total = _serve_family(
        torch, "dense_family", DF_SERVED,
        timed=[n for n, layers in DF_SERVED if layers is None])
    out = {"served": served_out, "launches": total}
    counters = _family_counters()

    cfg = dataclasses.replace(get_arch(DF_STUB), n_layers=DF_STUB_LAYERS)
    params = lm.init_params(cfg, 0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    S, T = PROMPT, DF_STUB_STEPS
    emb = torch.randn((BATCH, S + T, cfg.d_model), generator=gen,
                      device="cuda")
    mp = n_pages_for(S + T, PAGE)
    errs = []

    def held(*args):
        got = pa.paged_attention_decode(*args)
        errs.append(_check_close(f"dense_family {DF_STUB} paged decode "
                                 f"call {len(errs)}", got,
                                 pa.paged_read_plain(*args), PAGED_RTOL))
        return got

    out["stub"] = {"arch": DF_STUB, "layers": cfg.n_layers,
                   "published_layers": get_arch(DF_STUB).n_layers,
                   "head_dim": cfg.head_dim, "steps": T}
    for spec in (DSCIM, "off"):
        c_s = dataclasses.replace(cfg, dscim=spec)
        served = prepare_params(c_s, params)
        _, dense = lm.prefill(served, c_s, None, S + T, embeds=emb[:, :S])
        _, short = lm.prefill(served, c_s, None, embeds=emb[:, :S])
        paged = paged_from_dense(short["k"], short["v"], PAGE,
                                 n_pages=BATCH * mp, max_pages=mp)
        for c in counters.values():
            c.reset()
        attention.paged_attention_decode = held
        try:
            lp = [lm.decode(served, c_s, None, paged,
                            embed=emb[:, S + t:S + t + 1])[0]
                  for t in range(T)]
        finally:
            attention.paged_attention_decode = pa.paged_attention_decode
        launches = {k: c.count for k, c in counters.items()}
        want = {"dscim_fused_mvm": _fused_per_forward(cfg) * T
                if spec != "off" else 0,
                "paged_attention_decode": cfg.n_layers * T}
        if launches != want:
            raise AssertionError(f"{DF_STUB} {spec}: launches {launches} "
                                 f"!= {want}")
        for k in total:
            total[k] += launches[k]
        ld = [lm.decode(served, c_s, None, dense,
                        embed=emb[:, S + t:S + t + 1])[0] for t in range(T)]
        lp, ld = torch.stack(lp), torch.stack(ld)
        if not bool(torch.isfinite(lp).all()):
            raise AssertionError(f"{DF_STUB} {spec}: non-finite logits")
        drift = float((lp - ld).pow(2).mean().sqrt())
        agree = float((lp.argmax(-1) == ld.argmax(-1)).float().mean())
        _log(f"dense_family {DF_STUB} ({cfg.n_layers} of "
             f"{get_arch(DF_STUB).n_layers} layers, head_dim "
             f"{cfg.head_dim}, embedding inputs) dscim={spec}: {T} paged "
             f"decode steps, launches {launches}; paged attention vs the "
             f"plain read in the model: max abs err {max(errs):.3e} over "
             f"{len(errs)} calls so far; logits vs the dense bf16 cache: "
             f"RMSE {drift:.3e}"
             + (f" (bound {KV_INT8_DRIFT:g})" if spec == "off" else "")
             + f", logit RMS {float(ld.pow(2).mean().sqrt()):.3f}, argmax "
             f"agreement {agree:.3f}")
        if spec == "off" and drift > KV_INT8_DRIFT:
            raise AssertionError(f"{DF_STUB}: paged vs dense drift {drift}")
        out["stub"][spec] = {"launches": launches,
                             "paged_vs_dense_logit_rmse": drift,
                             "paged_vs_dense_argmax_agreement": agree}
        del served, dense, short, paged
    out["stub"]["paged_vs_plain_max_abs_err"] = max(errs)
    out["stub"]["paged_calls_held"] = len(errs)
    return out


def check_family_fused(torch, phase, name, layers=None):
    """The fused MVM against its plain version at one config's shapes: its
    DS-CIM MLP sites (``_mlp_sites``: an MoE config's shared expert, of
    width ``moe_shared * d_ff``) and the f32 head, one layer of weights
    drawn at its published widths, at decode M = BATCH and prefill M =
    BATCH * PROMPT (the plain version on DF_COLS columns spread over N
    there; the head's M = 256 call is a check off the serving path, which
    runs the head on the last token).  ``layers`` is the depth ``phase``
    serves, which sets the calls a forward."""
    from repro_torch.configs import get_arch
    from repro_torch.core.qweights import prepare_linear_weight
    from repro_torch.models.lm import _linear_for

    cfg = get_arch(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    lin = _linear_for(DSCIM)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    D = cfg.d_model
    F = cfg.moe_shared * cfg.d_ff if cfg.family == "moe" else cfg.d_ff
    pre = "shared " if cfg.family == "moe" else ""
    sites = [(pre + site, (F, D) if site == "w_down" else (D, F),
              torch.bfloat16, n) for site, n in _mlp_sites(cfg)]
    sites.append(("lm_head", (D, cfg.vocab_padded), torch.float32, 1))
    calls = []
    for site, (K, N), xdt, per_fwd in sites:
        wf = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        qw = prepare_linear_weight(wf, lin.group_k)
        for m, regime in ((BATCH, "decode"), (BATCH * PROMPT, "prefill")):
            cols = None if m == BATCH else torch.arange(
                0, N, -(-N // DF_COLS), device="cuda")
            on_path = not (site == "lm_head" and m > BATCH)
            calls.append(dict(
                _fused_case(torch, gen, site, [qw], wf, xdt, m, lin.cfg,
                            f" {name}", cols),
                per_forward=per_fwd if on_path else 0,
                phase=f"{phase} {name} {regime}" if on_path
                else f"{phase} {name}, check only, not on the path"))
            _log_fused(calls[-1])
        del wf, qw
    torch.cuda.empty_cache()
    return calls


def _paged_case(torch, gen, KV, R, HD, pos):
    """Paged attention against its plain version on a synthetic pool of
    BATCH slots at ``pos`` (pages of PAGE tokens in random order), with
    the kernel's and the plain version's device times and the bound."""
    from repro_torch.kernels import paged_attention as pa

    B, ps = BATCH, PAGE
    MP = pos // ps + 1
    P = B * MP
    args = (torch.randn((B, KV, R, HD), generator=gen, device="cuda"),
            *(torch.randint(-127, 128, (P, ps, KV, HD), generator=gen,
                            device="cuda").to(torch.int8) for _ in range(2)),
            *(torch.rand((P, KV), generator=gen, device="cuda") * 0.02
              for _ in range(2)),
            *(torch.randn((B, ps, KV, HD), generator=gen,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2)),
            torch.randperm(P, generator=gen, device="cuda").reshape(
                B, MP).to(torch.int32),
            torch.full((B,), pos, dtype=torch.int32, device="cuda"))
    shape = f"B={B} KV={KV} n_rep={R} HD={HD} ps={ps} pos={pos}"
    err = _check_close(f"paged_attention {shape}",
                       pa.paged_attention_decode(*args),
                       pa.paged_read_plain(*args), PAGED_RTOL)
    bound, by = _paged_bound(args[-1], ps, KV, R, HD, args[-2])
    case = {"shape": shape, "max_abs_err": err,
            "ms": _cuda_ms(lambda: pa._launch_kernel(*args), reps=50),
            "plain_ms": _cuda_ms(lambda: pa.paged_read_plain(*args),
                                 reps=2, warmup=1),
            "bound_ms": bound, "bound_by": by}
    _log(f"paged_attention {shape}: err {err:.3e}, {case['ms']:.4f} ms "
         f"(plain {case['plain_ms']:.3f} ms, bound {bound:.5f} ms {by})")
    return case


def check_family_paged(torch, cfgs):
    """Paged attention against its plain version at each (KV, n_rep, HD)
    of ``cfgs``, at the main path's last decode position and at
    LONG_POS."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    shapes = sorted({(c.n_kv, c.q_heads // c.n_kv, c.head_dim)
                     for c in cfgs})
    return [_paged_case(torch, gen, KV, R, HD, pos)
            for KV, R, HD in shapes
            for pos in (PROMPT + TOKENS - 2, LONG_POS)]


def _step_bytes(served) -> int:
    """Bytes one decode step's weights take: every layer tensor (the
    routed experts all of them: the capacity buffers are dense (E, C, D),
    so every expert runs whether a token reached it or not), the final
    norm and the head; of the embedding only BATCH rows."""
    from repro_torch.core.qweights import QuantizedLinearWeight, map_params

    total = [BATCH * served["embed"].shape[1]
             * served["embed"].element_size()]

    def add(_, a):
        if isinstance(a, QuantizedLinearWeight):
            a = (a.q, a.scale)
        for t in a if isinstance(a, tuple) else (a,):
            total.append(t.numel() * t.element_size())
    map_params(add, {k: v for k, v in served.items() if k != "embed"})
    return sum(total)


def _profile_step(torch, cfg_ds, served, kv="int8"):
    """``_profile_request`` of one replay of the captured decode step of
    the main path's runner at ``cfg_ds`` and cache layout ``kv`` (already
    captured), at the middle of a request: its kernels and the device's
    busy time."""
    from repro_torch.launch.steps import _generate_runner

    runner = _generate_runner(cfg_ds, BATCH, PROMPT, TOKENS, kv, PAGE,
                              None, "greedy", False,
                              torch.device("cuda", 0), None)
    st = runner.st
    st["params"] = served
    st["cache"]["pos"].fill_(PROMPT + TOKENS // 2)
    st["i"].fill_(TOKENS // 2)
    try:
        return _profile_request(torch, runner.step.graph.replay)
    finally:
        st["params"] = None


def _moe_extras(torch, cfg_ds, served, prompts, toks):
    """moe_family's checks beyond ``_serve_family``'s: the (token, expert)
    pairs each layer's capacity dropped, counted by wrapping
    ``layers/moe.py moe_routed`` for one eager request (its prefill drops
    pairs at capacity 1.25; its decode must drop none, and its tokens
    must be the graph's); ``spec=SPEC`` must emit the plain graph's
    tokens bitwise; the paged and dense cache bytes (``core/kvcache.py``)
    and the bytes a decode step reads at most (its weights and the paged
    cache) over the HBM rate: the step's bytes bound; one replay of the
    captured step profiled (its kernels and the device's busy time)."""
    import numpy as np

    from repro_torch.core.kvcache import (dense_cache_bytes, kv_cache_bytes,
                                          paged_cache_specs)
    from repro_torch.launch.serve import serve_batch
    from repro_torch.layers import moe as moe_layer

    cfg, name, L = cfg_ds, cfg_ds.name, cfg_ds.n_layers
    kw = dict(kv="int8", page_size=PAGE)
    routed, drops = moe_layer.moe_routed, []

    def recording(*args, **kwargs):
        res = routed(*args, **kwargs)
        drops.append(int((~res[1]).sum()))
        return res

    moe_layer.moe_routed = recording
    try:
        te, _ = serve_batch(cfg_ds, served, prompts, TOKENS, scan=False, **kw)
    finally:
        moe_layer.moe_routed = routed
    pre, decode_drops = drops[:L], sum(drops[L:])
    C = moe_layer.capacity(BATCH * PROMPT, cfg.moe_topk, cfg.moe_experts,
                           cfg.moe_capacity)
    _log(f"moe_family {name} ({cfg.moe_experts} experts of {cfg.d_ff}, "
         f"top-{cfg.moe_topk}, {cfg.moe_shared} shared): prefill "
         f"({BATCH * PROMPT} tokens, capacity {C} an expert) dropped "
         f"{sum(pre)} of {L * BATCH * PROMPT * cfg.moe_topk} (token, expert) "
         f"pairs, by layer {pre}")
    if not np.array_equal(te, toks) or decode_drops \
            or len(drops) != L * TOKENS:
        raise AssertionError(f"{name}: eager tokens differ from the "
                             f"graph's, or {decode_drops} pairs dropped at "
                             f"decode over {len(drops)} MoE calls")
    ts = {}
    sp, _, sstats = serve_batch(cfg_ds, served, prompts, TOKENS, spec=SPEC,
                                spec_stats=True, timings=ts, **kw)
    if not np.array_equal(sp, toks):
        raise AssertionError(f"{name}: spec={SPEC} tokens differ from the "
                             "plain graph's")
    per_verify = float(sstats["emitted"].sum() / sstats["windows"].sum())
    _log(f"moe_family {name}: no pair dropped at decode; spec={SPEC} tokens "
         f"bitwise the plain graph's ({per_verify:.2f} tokens a verify, "
         f"window capture {ts.get('capture_s', 0.0):.3f} s)")
    specs = paged_cache_specs(cfg, BATCH, PROMPT + TOKENS, PAGE)
    step_bytes = _step_bytes(served) + kv_cache_bytes(specs)
    res = {"prefill_capacity": C, "prefill_drops_by_layer": pre,
           "prefill_pairs": L * BATCH * PROMPT * cfg.moe_topk,
           "spec_tokens_per_verify": per_verify,
           "paged_cache_bytes": kv_cache_bytes(specs),
           "dense_cache_bytes": dense_cache_bytes(cfg, BATCH,
                                                  PROMPT + TOKENS),
           "step_bytes": step_bytes,
           "step_bytes_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3}
    _log(f"moe_family {name}: a decode step reads at most {step_bytes} "
         f"bytes (weights and the whole paged cache), "
         f"{res['step_bytes_bound_ms']:.4f} ms at {HBM_BYTES_PER_S:.3g} B/s; "
         f"KV cache at {BATCH} x {PROMPT + TOKENS}: paged "
         f"{res['paged_cache_bytes']} B, dense {res['dense_cache_bytes']} B")
    res["step_profile"] = prof = _profile_step(torch, cfg_ds, served)
    _log(f"moe_family {name}: one decode step's graph replay under the "
         f"profiler: {prof['kernel_launches']} kernels, device busy "
         f"{prof['device_busy_ms']:.3f} ms of {prof['wall_ms_profiled']:.3f} "
         "ms")
    for k in prof["top_kernels"][:5]:
        _log(f"  {k['device_ms']:.3f} ms in {k['calls']} x {k['name']}")
    return res


def moe_family(torch):
    """Phase moe_family, the MoE configs on the serving path:
    ``MOE_SERVED`` (granite-moe-1b-a400m at its published width and
    depth, deepseek-moe-16b at its published widths cut to 8 of 28
    layers) go through ``_serve_family`` with ``_moe_extras``, both
    timed."""
    served, total = _serve_family(torch, "moe_family", MOE_SERVED,
                                  timed=[n for n, _ in MOE_SERVED],
                                  extra=_moe_extras)
    return {"served": served, "launches": total}


def _recurrent_extras(torch, cfg_ds, served, prompts, toks):
    """recurrent_family's checks beyond ``_serve_family``'s: a ragged
    request (budgets ``REC_BUDGETS``, ``eos_id=-1``) whose graph tokens
    are bitwise the eager loop's, each row the plain request's tokens up
    to its budget and ``PAD_ID`` after; the serving state's bytes a slot
    (the recurrent state; for Zamba2 also the K/V caches at prompt +
    tokens); the bytes a decode step must move (the weights once, BATCH
    embedding rows, the recurrent state read and written, the K/V caches
    read) over the HBM rate: the step's bytes bound; one graph request
    and one replay of the captured step profiled (kernels, the device's
    busy time and idle share)."""
    import numpy as np

    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import PAD_ID
    from repro_torch.models.registry import get_model

    name = cfg_ds.name
    budgets = np.asarray(REC_BUDGETS, np.int32)
    rg, re_ = (serve_batch(cfg_ds, served, prompts, TOKENS, eos_id=-1,
                           max_new=budgets, scan=scan)[0]
               for scan in (True, False))
    if not np.array_equal(rg, re_):
        raise AssertionError(f"{name}: ragged graph tokens differ from the "
                             "eager loop's")
    for b, n in enumerate(budgets):
        if not (np.array_equal(rg[b, :n], toks[b, :n])
                and (rg[b, n:] == PAD_ID).all()):
            raise AssertionError(f"{name}: ragged row {b} is not the plain "
                                 f"row cut at {n}")
    spec = get_model(cfg_ds).cache_specs(cfg_ds, BATCH, PROMPT + TOKENS)
    nbytes = {k: _numel_bytes(v) for k, v in spec.items() if k != "pos"}
    kv_bytes = nbytes.pop("k", 0) + nbytes.pop("v", 0)
    state_bytes = sum(nbytes.values())
    step_bytes = _step_bytes(served) + 2 * state_bytes + kv_bytes
    res = {"tokens": toks.tolist(), "ragged_budgets": list(REC_BUDGETS),
           "state_bytes_per_slot": state_bytes // BATCH,
           "kv_bytes_per_slot": kv_bytes // BATCH,
           "step_bytes": step_bytes,
           "step_bytes_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3}
    _log(f"recurrent_family {name}: ragged request (budgets "
         f"{list(REC_BUDGETS)}) graph bitwise eager, each row the plain "
         f"row cut at its budget; state {res['state_bytes_per_slot']} B a "
         f"slot, K/V {res['kv_bytes_per_slot']} B a slot at "
         f"{PROMPT + TOKENS} positions; a decode step moves {step_bytes} "
         f"bytes, {res['step_bytes_bound_ms']:.4f} ms at "
         f"{HBM_BYTES_PER_S:.3g} B/s")
    res["request_profile"] = prof = _profile_request(
        torch, lambda: serve_batch(cfg_ds, served, prompts, TOKENS))
    _log(f"recurrent_family {name}: one graph request under the profiler: "
         f"{prof['kernel_launches']} kernels, device busy "
         f"{prof['device_busy_ms']:.3f} ms of {prof['wall_ms_profiled']:.3f}"
         f" ms, idle {prof['device_idle_share']:.3f}")
    res["step_profile"] = prof = _profile_step(torch, cfg_ds, served,
                                               kv="float")
    _log(f"recurrent_family {name}: one decode step's graph replay under "
         f"the profiler: {prof['kernel_launches']} kernels, device busy "
         f"{prof['device_busy_ms']:.3f} ms of "
         f"{prof['wall_ms_profiled']:.3f} ms")
    for k in prof["top_kernels"][:5]:
        _log(f"  {k['device_ms']:.3f} ms in {k['calls']} x {k['name']}")
    return res


def recurrent_family(torch):
    """Phase recurrent_family, the RWKV6 and Zamba2 configs on the serving
    path: ``REC_SERVED`` (rwkv6-7b and zamba2-7b at their published width
    and depth) go through ``_serve_family`` at ``dscim="off"`` and the
    float cache with ``_recurrent_extras``, both timed.  None of the six
    kernels runs on this path: a counted request must launch none."""
    served, total = _serve_family(
        torch, "recurrent_family", REC_SERVED,
        timed=[n for n, _ in REC_SERVED], extra=_recurrent_extras,
        kv="float", dscim="off",
        want=lambda cfg: dict.fromkeys(_all_counters(), 0), turns=REC_TURNS)
    return {"served": served, "launches": total}


def check_cycle_oracle(torch):
    """The count kernel (row 6, ``kernels/dscim_mvm.py dscim_counts``)
    against the cycle-level OR-MAC (``core/ormac.py``, through
    ``DSCIMMacro.counts_cycle``, on the card and on the CPU) at
    CYCLE_SHAPE, for OPS_PRESETS: the counts must be equal, exactly."""
    from repro_torch.core.macro import DSCIMMacro
    from repro_torch.core.seed_search import calibrated_config

    M, K, N = CYCLE_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    out = []
    for key in OPS_PRESETS:
        mac = DSCIMMacro(calibrated_config(*key))
        x = torch.randint(-128, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        kern = mac.counts_kernel(x, w)
        cyc = mac.counts_cycle(x, w)
        cyc_cpu = mac.counts_cycle(x.cpu(), w.cpu())
        if not (torch.equal(kern.to(torch.int64), cyc)
                and torch.equal(cyc.cpu(), cyc_cpu)):
            raise AssertionError(f"{key}: count kernel and cycle-level "
                                 "OR-MAC counts differ")
        case = {"preset": "/".join(map(str, key)),
                "shape": f"M={M} K={K} N={N}", "equal": True,
                "count_sum": int(cyc.sum())}
        _log(f"cycle oracle {case['preset']} {case['shape']}: count kernel "
             f"== cycle-level OR-MAC (card and CPU), sum of counts "
             f"{case['count_sum']}")
        out.append(case)
    return out


def _mlp_sites(cfg):
    """(site, calls a forward) of the fused MVM's MLP sites of ``cfg``:
    the first matmul (``w_gate``, whose shape ``w_up`` shares, for SwiGLU;
    ``w_up`` for the GELU MLP) and ``w_down``; for an MoE config its
    shared expert's (none without one: the routed experts stay float)."""
    if cfg.family == "moe":
        return (("w_gate", 2 * cfg.n_layers), ("w_down", cfg.n_layers)) \
            if cfg.moe_shared else ()
    if cfg.mlp_kind == "swiglu":
        return (("w_gate", 2 * cfg.n_layers), ("w_down", cfg.n_layers))
    return (("w_up", cfg.n_layers), ("w_down", cfg.n_layers))


def _fused_per_forward(cfg):
    """Fused-MVM launches of one forward at a kernel spec: every MLP matmul
    of every layer and the head."""
    return sum(n for _, n in _mlp_sites(cfg)) + 1


def _fused_case(torch, gen, site, ws, wf, xdt, m, dcfg, tag="", cols=None):
    """The fused MVM wrapper, as the serving path calls it (leading-dim
    fold, dispatch, one C call: the quantize kernel, then the MVM), on
    random (m, K) activations of ``xdt`` and the prepared weight ``ws[0]``,
    against the plain version on the torch-quantized activations; the
    kernel's own quantization must be the torch one, bitwise.  Times the
    kernel and the wrapper over the weights ``ws`` (distinct layers' where
    given: the serving path meets each weight once a forward, not hot in
    L2), the plain version, and gives the bound and the estimator's RMSE
    against the f32 product with the float weight ``wf``.  ``cols``: hold
    (and time the plain version, and the RMSE) on these output columns
    only, where the plain version over all of N would take minutes."""
    from repro_torch.core.qweights import QuantizedLinearWeight
    from repro_torch.kernels import dscim_fused

    K, N = ws[0].k_orig, ws[0].n
    x = torch.randn((m, K), generator=gen, device="cuda").to(xdt)
    got = dscim_fused.dscim_fused_mvm_prepared(x, ws[0], dcfg)
    xq = dscim_fused.quantize_activations_windowed(x, ws[0].nw, ws[0].g)
    q = xq.q.contiguous()
    sx = xq.scale.reshape(m, ws[0].nw).contiguous()
    held = ws[0]
    if cols is not None:
        held = QuantizedLinearWeight(ws[0].q[..., cols].contiguous(),
                                     ws[0].scale[..., cols].contiguous(),
                                     K, ws[0].group_k)
        got, wf = got[:, cols], wf[:, cols]
    want = dscim_fused.dscim_fused_mvm_plain(q, sx, held.q, held.scale,
                                             dcfg)
    err = _check_close(f"dscim_fused{tag} {site} M={m}", got, want,
                       FUSED_RTOL)
    # the kernel's quantization is the torch one, bitwise
    _, kq, ksx = dscim_fused._launch_kernel(x, ws[0], dcfg)
    if not (torch.equal(kq, q) and torch.equal(
            ksx.view(torch.int32), sx.view(torch.int32))):
        raise AssertionError(f"dscim_fused{tag} {site} M={m}: the "
                             "kernel's quantized activations differ")
    # accuracy cost of the estimator itself: against x @ w in f32
    exact = x.float() @ wf.float()
    est_rmse = float((got - exact).pow(2).mean().sqrt())
    exact_rms = float(exact.pow(2).mean().sqrt())
    reps = 5 if m > BATCH else 20
    ms = _cuda_ms(lambda: [dscim_fused._launch_kernel(x, w, dcfg)
                           for w in ws], reps) / len(ws)
    wrapper_ms = _cuda_ms(lambda: [
        dscim_fused.dscim_fused_mvm_prepared(x, w, dcfg) for w in ws],
        reps) / len(ws)
    plain_ms = _cuda_ms(lambda: dscim_fused.dscim_fused_mvm_plain(
        q, sx, held.q, held.scale, dcfg), reps=2, warmup=1)
    kp = ws[0].nw * ws[0].g
    nbytes = (x.numel() * x.element_size() + kp * N
              + 4 * ws[0].nw * N + 2 * 4 * dcfg.group * dcfg.sbits
              + 4 * m * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = _count_ops(m, N, ws[0].nw, ws[0].g, dcfg) / B1_OPS_PER_S * 1e3
    out = {"shape": f"{tag.strip() + ' ' if tag else ''}{site} M={m} "
                    f"K={K} N={N}",
           "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "rmse_vs_float_matmul": est_rmse,
           "float_matmul_rms": exact_rms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if cols is not None:
        out["held_cols"] = int(cols.numel())
    return out


def _log_fused(c):
    _log(f"dscim_fused {c['shape']} ({c['phase']}, "
         f"{c['per_forward']} a forward): err {c['max_abs_err']:.3e}"
         + (f" on {c['held_cols']} columns" if "held_cols" in c else "")
         + f", quantization bitwise; {c['ms']:.4f} ms (wrapper "
         f"{c['wrapper_ms']:.4f} ms, plain {c['plain_ms']:.3f} ms, "
         f"bound {c['bound_ms']:.4f} ms, {c['bound_by']}); estimate vs "
         f"f32 x @ w: RMSE {c['rmse_vs_float_matmul']:.4f}, RMS of "
         f"x @ w {c['float_matmul_rms']:.4f}")


def check_fused(torch, cfg, params, launches):
    """Fused DS-CIM MVM vs its plain version at the serving shapes: the
    main path's (DSCIM: decode, prefix extend, prefill), the watchdog
    phase's segments and admissions at WD_DSCIM (other count tables), the
    ladder's ``serve_batch`` of the quarantined requests at DSCIM, and
    the router phase's extend chunks and bucket admissions at DSCIM."""
    from repro_torch.launch.steps import prepare_serving_params
    from repro_torch.models.lm import _linear_for

    L = cfg.n_layers
    fmlp = params["layers"]["mlp"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def sites(spec):
        """(site, prepared weights of every layer, layer 0's float weight,
        activation dtype, calls per forward) at ``spec``, and its cfg."""
        prep = prepare_serving_params(dataclasses.replace(cfg, dscim=spec),
                                      params)
        mlp = prep["layers"]["mlp"]
        out = {site: ([mlp[site][i] for i in range(L)], fmlp[site][0],
                      torch.bfloat16, n) for site, n in _mlp_sites(cfg)}
        out["lm_head"] = ([prep["lm_head"]], params["embed"].T,
                          torch.float32, 1)
        return out, _linear_for(spec).cfg

    def one(site, ws, wf, xdt, m, dcfg, tag=""):
        return _fused_case(torch, gen, site, ws, wf, xdt, m, dcfg, tag)

    log = _log_fused

    calls = []
    # the main path: decode (M = slots), an extend chunk of the prefix
    # path (M = slots x page: every MLP site and the f32 head, a partial
    # prefill tile) and prefill (M = slots x prompt)
    main, dcfg = sites(DSCIM)
    phases = {BATCH: "decode", BATCH * PAGE: "prefix extend",
              BATCH * PROMPT: "prefill"}
    for m in (BATCH, BATCH * PAGE, BATCH * PROMPT):
        for site, (ws, wf, xdt, per_fwd) in main.items():
            # prefill runs the head on the last token only (M = batch):
            # the M=256 head call is a check at a larger shape, off the path
            on_path = not (site == "lm_head" and m == BATCH * PROMPT)
            calls.append(dict(
                one(site, ws, wf, xdt, m, dcfg),
                per_forward=per_fwd if on_path else 0,
                phase=phases[m] if on_path
                else "check only, not on the main path"))
            log(calls[-1])
    # off the main path, each phase's calls a forward: the watchdog
    # phase's segments (M = slots) and one-request admissions (M = prompt;
    # the head on the last token) at WD_DSCIM, the ladder's dscim1 rung,
    # serve_batch of the quarantined requests (LADDER_B rows), and the
    # router phase's extend chunk (one replay over every slot: M = slots x
    # chunk, the head on every position) and one-request bucket admission
    # (M = the longer bucket, the head on the last token)
    extra = [(WD_DSCIM, "watchdog segment decode", BATCH, BATCH),
             (WD_DSCIM, "watchdog admission prefill", PROMPT, 1),
             (DSCIM, "ladder decode", LADDER_B, LADDER_B),
             (DSCIM, "ladder prefill", LADDER_B * PROMPT, LADDER_B),
             (DSCIM, "router extend chunk", BATCH * ROUTER_CHUNK,
              BATCH * ROUTER_CHUNK),
             (DSCIM, "router bucket admission", max(ROUTER_BUCKETS), 1)]
    configs = {DSCIM: (main, dcfg), WD_DSCIM: sites(WD_DSCIM)}
    for spec, phase, m, m_head in extra:
        table, dc = configs[spec]
        tag = f" {spec}" if spec != DSCIM else ""
        for site, (ws, wf, xdt, per_fwd) in table.items():
            calls.append(dict(
                one(site, ws, wf, xdt, m_head if site == "lm_head" else m,
                    dc, tag),
                per_forward=per_fwd, phase=phase))
            log(calls[-1])
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
                                 for k in ("ms", "wrapper_ms", "bound_ms")},
        "extend_chunk": {k: sum(c[k] * c["per_forward"] for c in calls
                                if c["phase"] == "prefix extend")
                         for k in ("ms", "wrapper_ms", "plain_ms",
                                   "bound_ms")}}
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
    R = cfg.q_heads // KV
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
    """Phase 7: Table I through the card: each preset's rmse operands go
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


def _train_flops(cfg, B, S) -> dict:
    """Model FLOPs of one train step: 6 N T for the N parameters of the
    matmuls (every stacked layer matrix and the head; the embedding is a
    gather), 2 N_layers T for the forward that remat recomputes, and the
    causal attention's QK^T and PV (2 B H S^2 HD a layer forward over the
    lower triangle; the backward twice that, remat once more)."""
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    p = lm.init_params(cfg, 0, device="meta")
    n_layers = sum(x.numel() for x in leaves(p["layers"]) if x.ndim >= 3)
    n_head = cfg.d_model * cfg.vocab_padded
    T = B * S
    attn_fwd = 2 * B * cfg.n_heads * S * S * cfg.head_dim * cfg.n_layers
    parts = {"matmul_6NT": 6 * (n_layers + n_head) * T,
             "remat_2NT": 2 * n_layers * T if cfg.remat else 0,
             "attention": attn_fwd * (4 if cfg.remat else 3)}
    return dict(parts, total=sum(parts.values()), n_matmul_layers=n_layers,
                n_head=n_head)


def _cut_layers(torch, cfg):
    """The most layers (whole super-blocks for the hybrid family) whose
    training state, 16 bytes a parameter, fits TRAIN_STATE_SHARE of the
    card's memory; with the parameter count at that depth."""
    from repro_torch.models.registry import get_model

    budget = TRAIN_STATE_SHARE * torch.cuda.get_device_properties(0) \
        .total_memory
    step = cfg.mamba_per_block if cfg.family == "hybrid" else 1
    best = None
    for n in range(step, cfg.n_layers + 1, step):
        c = dataclasses.replace(cfg, n_layers=n)
        params = _numel(get_model(c).init_params(c, 0, device="meta"))
        if 16 * params <= budget:
            best = (n, params)
    return best


class _StepTimer:
    """Wraps a train step: CUDA events around each call (the device's
    timeline of the step, its idle gaps included)."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.events = torch, fn, []

    def __call__(self, *args):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.fn(*args)
        ev[1].record()
        self.events.append(ev)
        return out

    def ms(self):
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def _losses(history):
    return [h["loss"] for h in history]


def train_phase(torch):
    """Phase train: training on the card through ``repro_torch.launch.
    train.TrainLoop``.  olmo-1b at its published width and depth (bf16
    compute, remat), TRAIN_BATCH x TRAIN_SEQ tokens, TRAIN_STEPS steps at
    TRAIN_LR with a checkpoint every TRAIN_CKPT_EVERY steps: every loss
    finite, the first near ln(vocab), no launch of the six kernels; step
    device ms (median and range after the first step), tokens/s, the
    model-FLOPs share of the BF16 peak, peak memory, data wait and the
    row cache's hit rate, checkpoint save seconds.  One step under the
    profiler; AdamW's update timed against its bytes bound.  Then a run
    from the first run's step-TRAIN_CKPT_EVERY checkpoint with a failure
    injected at step TRAIN_FAIL_AT: the replay from the checkpoint must
    give bitwise the first run's losses, and ``restore_or_init`` must
    resume at the saved step, at the run's start and after the failure,
    and at TRAIN_STEPS after the run (timed).  Then
    TRAIN_OTHERS, TRAIN_OTHER_STEPS steps each (depth cut to fit where
    marked): finite losses, granite's aux finite and positive, and for
    granite a second run bitwise the first."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainLoop
    from repro_torch.tree import leaves, unflatten

    torch.cuda.empty_cache()
    counters = _all_counters()
    cfg = get_arch(TRAIN_ARCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    res = {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "lr": TRAIN_LR, "remat": cfg.remat,
           "compute_dtype": cfg.compute_dtype}
    try:
        def loop_for(run, data=None, **kw):
            loop = TrainLoop(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ, lr=TRAIN_LR,
                             ckpt_dir=f"{tmp}/{run}",
                             ckpt_every=TRAIN_CKPT_EVERY, log=_log, **kw)
            if data is not None:     # the same corpus, its row cache warm
                loop.data = data
            loop.step_fn = timer = _StepTimer(torch, loop.step_fn)
            return loop, timer

        loop, timer = loop_for("run1")
        data = loop.data
        saves = []
        save = loop.ckpt.save

        def timed_save(step, *a, **kw):
            t0, w0 = time.perf_counter(), time.time()
            save(step, *a, **kw)
            saves.append({"step": step, "start": w0,
                          "host_copy_s": time.perf_counter() - t0})
        loop.ckpt.save = timed_save
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = loop.run()
        res["run_s"] = time.perf_counter() - t0
        for sv in saves:           # the manifest is written after the leaves
            with open(f"{tmp}/run1/step_{sv['step']:09d}/manifest.json") as f:
                sv["write_s"] = json.load(f)["time"] - sv.pop("start")
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        launches = {k: c.count for k, c in counters.items()}
        res["launches"] = launches
        losses = _losses(loop.history)
        res["losses"] = losses
        step_ms = timer.ms()
        timed = step_ms[1:]
        med = float(np.median(timed))
        flops = _train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        n_params = _numel(state["params"])
        res.update(params=n_params, step_ms=step_ms,
                   step_ms_median=med, step_ms_range=[min(timed),
                                                      max(timed)],
                   tok_s=tokens / (med / 1e3), flops=flops,
                   bf16_peak_share=flops["total"] / (med / 1e3)
                   / BF16_FLOPS_PER_S,
                   data_wait_ms=[h["data_s"] * 1e3 for h in loop.history],
                   row_cache_hit_rate=loop.data.hit_rate(),
                   row_cache_rows=len(loop.data._cum), ckpt_saves=saves)
        _log(f"train {TRAIN_ARCH} ({cfg.n_layers} layers, d {cfg.d_model}, "
             f"{n_params} parameters, {cfg.compute_dtype}, remat "
             f"{cfg.remat}, batch {TRAIN_BATCH} x {TRAIN_SEQ}): losses "
             f"{[round(x, 4) for x in losses]}; launches of the six kernels "
             f"over the run {launches}")
        _log(f"train {TRAIN_ARCH}: step device ms median {med:.2f} (range "
             f"{min(timed):.2f}-{max(timed):.2f}, first {step_ms[0]:.1f}), "
             f"{res['tok_s']:.0f} tokens/s; model FLOPs a step "
             f"{flops['total']:.4g} ({flops}): "
             f"{res['bf16_peak_share']:.4f} of the BF16 peak "
             f"{BF16_FLOPS_PER_S:.3g}; peak memory "
             f"{res['peak_memory_bytes'] / 2**30:.2f} GiB")
        _log(f"train {TRAIN_ARCH}: data wait ms a step "
             f"{[round(x, 1) for x in res['data_wait_ms']]}, row cache hit "
             f"rate {res['row_cache_hit_rate']:.4f} ({res['row_cache_rows']}"
             f" rows); checkpoint saves {saves} (host copy: the loop waits "
             f"for it; write: from the call to the manifest, the leaves "
             f"written in the background)")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite train losses {losses}")
        if abs(losses[0] - math.log(cfg.vocab)) > 1.0:
            raise AssertionError(f"first loss {losses[0]} is not near "
                                 f"ln({cfg.vocab}) = {math.log(cfg.vocab)}")
        if any(launches.values()):
            raise AssertionError(f"the train path launched {launches}")
        _log(f"train {TRAIN_ARCH}: the six kernels' counters read 0 over "
             f"every step")

        # one more step under the profiler, then AdamW alone
        batch = loop.data.batch(TRAIN_BATCH, TRAIN_SEQ, step=TRAIN_STEPS)
        params, opt = state["params"], state["opt"]
        res["step_profile"] = prof = _profile_request(
            torch, lambda: make_train_step(cfg, loop.opt, loop.device)(
                params, opt, batch))
        if prof["device_busy_ms"] <= 0.0:
            raise AssertionError("the profiler saw no device time in a "
                                 "train step")
        _log(f"train {TRAIN_ARCH}: one step under the profiler: "
             f"{prof['kernel_launches']} kernels, device busy "
             f"{prof['device_busy_ms']:.2f} ms of "
             f"{prof['wall_ms_profiled']:.2f} ms, idle "
             f"{prof['device_idle_share']:.3f}")
        for k in prof["top_kernels"][:6]:
            _log(f"  {k['device_ms']:.2f} ms in {k['calls']} x {k['name']}")
        grads = unflatten(params, [torch.full_like(p, 1e-3)
                                   for p in leaves(params)])
        adam_ms = _cuda_ms(lambda: loop.opt.update(params, grads, opt),
                           reps=3, warmup=1)
        adam_bytes = 7 * 4 * n_params
        res["adamw"] = {"ms": adam_ms, "bytes": adam_bytes,
                        "bound_ms": adam_bytes / HBM_BYTES_PER_S * 1e3}
        _log(f"train {TRAIN_ARCH}: AdamW update {adam_ms:.3f} device ms "
             f"against a bytes bound of {res['adamw']['bound_ms']:.3f} ms "
             f"(p, g, m, v read, p, m, v written: {adam_bytes} bytes)")
        del grads, params, opt, state, loop
        # the replay starts from the first run's step-TRAIN_CKPT_EVERY
        # checkpoint (moved, not copied: 15.4 GB): a failure just after it
        # restores it and runs again from there (the steps before it from
        # the seed are held again by train_mesh's leg (a))
        first = f"step_{TRAIN_CKPT_EVERY:09d}"
        os.makedirs(f"{tmp}/run2")
        os.rename(f"{tmp}/run1/{first}", f"{tmp}/run2/{first}")
        with open(f"{tmp}/run2/LATEST", "w") as f:
            f.write(first)
        shutil.rmtree(f"{tmp}/run1", ignore_errors=True)
        torch.cuda.empty_cache()
        loop2, _ = loop_for("run2", data, fail_at=(TRAIN_FAIL_AT,))
        restores = []
        restore = loop2.restore_or_init

        def timed_restore():
            t0 = time.perf_counter()
            st = restore()
            torch.cuda.synchronize()
            restores.append((st["step"], time.perf_counter() - t0))
            return st
        loop2.restore_or_init = timed_restore
        loop2.run()
        seen = {}
        for h in loop2.history:
            seen.setdefault(h["step"], []).append(h["loss"])
        replayed = sorted(s for s, v in seen.items() if len(v) > 1)
        res["replayed_steps"] = replayed
        bitwise = all(v == [losses[s]] * len(v) for s, v in seen.items())
        _log(f"train {TRAIN_ARCH}: failure at step {TRAIN_FAIL_AT}, replayed "
             f"steps {replayed}; every loss bitwise the first run's: "
             f"{bitwise}")
        if not bitwise or replayed != list(range(TRAIN_CKPT_EVERY,
                                                 TRAIN_FAIL_AT)) \
                or sorted(seen) != list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS)):
            raise AssertionError(f"replay: {seen} against {losses}")
        timed_restore()            # the run's last save, through LATEST
        res["resumed_step"], res["restore_s"] = restores[0]
        res["restores"] = restores
        _log(f"train {TRAIN_ARCH}: restore_or_init resumed at steps "
             f"{[st for st, _ in restores]} in "
             f"{[round(t, 2) for _, t in restores]} s")
        if [st for st, _ in restores] != [TRAIN_CKPT_EVERY] * 2 \
                + [TRAIN_STEPS]:
            raise AssertionError(f"resumed at {restores}")
        del loop2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

    res["others"] = {name: _train_other(torch, name, cut, seq)
                     for name, cut, seq in TRAIN_OTHERS}
    return res


def _train_other(torch, name, cut, seq):
    """TRAIN_OTHER_STEPS steps of ``name`` (depth cut when ``cut``) through
    TrainLoop, TRAIN_BATCH x ``seq`` tokens: finite losses; an MoE
    config's aux of the first batch finite and positive after the steps,
    and a second run bitwise the first (the MoE dispatch's gathers in the
    backward)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.registry import get_model

    cfg = get_arch(name)
    full = _numel(get_model(cfg).init_params(cfg, 0, device="meta"))
    if cut:
        layers, n = _cut_layers(torch, cfg)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    else:
        n = full
    runs = 2 if cfg.family == "moe" else 1
    out = {"layers": cfg.n_layers, "published_layers":
           get_arch(name).n_layers, "params": n, "seq": seq,
           "published_params": full,
           "state_bytes": 16 * n}
    data = None
    for r in range(runs):
        torch.cuda.reset_peak_memory_stats()
        loop = TrainLoop(cfg, steps=TRAIN_OTHER_STEPS, batch=TRAIN_BATCH,
                         seq=seq, lr=TRAIN_LR, log=_log)
        if data is not None:         # the same corpus, its row cache warm
            loop.data = data
        data = loop.data
        loop.step_fn = timer = _StepTimer(torch, loop.step_fn)
        state = loop.run()
        losses = _losses(loop.history)
        if r == 0:
            out.update(losses=losses, step_ms=timer.ms(),
                       peak_memory_bytes=torch.cuda.max_memory_allocated())
            if cfg.family == "moe":
                b = loop.data.batch(TRAIN_BATCH, seq, step=0)
                tokens = torch.as_tensor(b["tokens"], device=loop.device)
                with torch.no_grad():
                    _, aux = loop.model.forward(state["params"], cfg,
                                                tokens.long())
                out["aux_after"] = float(aux)
        else:
            out["second_run_bitwise"] = losses == out["losses"]
        del state, loop
        torch.cuda.empty_cache()
    _log(f"train {name}: {cfg.n_layers} of {out['published_layers']} "
         f"layers, batch {TRAIN_BATCH} x {seq}, {n} of {full} parameters "
         f"(state {16 * n / 2**30:.1f} GiB), losses "
         f"{[round(x, 4) for x in out['losses']]}, step ms "
         f"{[round(x, 1) for x in out['step_ms']]}, peak memory "
         f"{out['peak_memory_bytes'] / 2**30:.2f} GiB"
         + (f", aux {out['aux_after']:.4f}, second run bitwise "
            f"{out['second_run_bitwise']}" if cfg.family == "moe" else ""))
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"{name}: non-finite losses")
    if cfg.family == "moe" and not (math.isfinite(out["aux_after"])
                                    and out["aux_after"] > 0
                                    and out["second_run_bitwise"]):
        raise AssertionError(f"{name}: aux {out['aux_after']} or a second "
                             "run differs")
    return out


def _train_step_gpu_vs_cpu(torch):
    """One ``make_train_step`` step of each family's reduced config on the
    card and on the CPU from the same parameters (drawn on the CPU) and
    the same batch (4 x 16 from SyntheticLM): the loss within
    TRAIN_LOSS_RTOL and the gradient norm within TRAIN_GNORM_RTOL,
    relative.  Returns the relative differences by arch."""
    from repro_torch.configs import get_arch
    from repro_torch.core.qweights import map_params
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamW

    out = {}
    for name in ("olmo-1b", "granite-moe-1b-a400m", "rwkv6-7b",
                 "zamba2-7b"):
        cfg = get_arch(name).reduced()
        params = get_model(cfg).init_params(cfg, 0, device="cpu")
        batch = SyntheticLM(cfg.vocab).batch(4, 16, step=0)
        opt = AdamW(lr=1e-3)
        got = {}
        for dev in ("cpu", "cuda"):
            p = map_params(lambda _, a: a.to(dev, copy=True), params)
            _, _, m = make_train_step(cfg, opt, dev)(p, opt.init(p), batch)
            got[dev] = (float(m["loss"]), float(m["grad_norm"]))
        (lc, gc), (lg, gg) = got["cpu"], got["cuda"]
        out[name] = rel = {"loss": abs(lg - lc) / abs(lc),
                           "grad_norm": abs(gg - gc) / abs(gc)}
        _log(f"reduced {name} train step GPU vs CPU: loss {lg!r} vs {lc!r}, "
             f"grad norm {gg!r} vs {gc!r} (relative {rel})")
        if not (rel["loss"] <= TRAIN_LOSS_RTOL
                and rel["grad_norm"] <= TRAIN_GNORM_RTOL):
            raise AssertionError(f"reduced {name}: the train step on the "
                                 "GPU and the CPU disagree")
    return out


def check_reduced(torch):
    """Phase 8: the reduced configs on the GPU (kernels) vs the CPU (plain
    versions), same weights and prompts: qwen3-0.6b at DSCIM with the
    int8 cache, rwkv6-7b and zamba2-7b at 'off' with the float cache.
    First tokens equal, logit drift RMSE on the teacher-matched prefix
    <= 1e-3.  Then one train step of each family's reduced config
    (``_train_step_gpu_vs_cpu``).  Returns the drifts by arch and the
    train steps' relative differences."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import logit_drift_rmse, serve_batch
    from repro_torch.models.registry import get_model

    drifts = {}
    for name, spec, kw in (("qwen3-0.6b", DSCIM,
                            dict(kv="int8", page_size=4)),
                           ("rwkv6-7b", "off", {}),
                           ("zamba2-7b", "off", {})):
        cfg = dataclasses.replace(get_arch(name).reduced(), dscim=spec)
        params = get_model(cfg).init_params(cfg, 0, device="cpu")
        prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 16))
        res = {dev: serve_batch(cfg, params, prompts, 10, trace_logits=True,
                                device=dev, **kw)
               for dev in ("cpu", "cuda")}
        (tc, lc), (tg, lg) = res["cpu"], res["cuda"]
        drifts[name] = drift = logit_drift_rmse(tc, tg, lc, lg)
        _log(f"reduced {name} GPU vs CPU: first tokens {tg[:, 0].tolist()} "
             f"vs {tc[:, 0].tolist()}, logit drift RMSE {drift:.3e}")
        if not (tc[:, 0] == tg[:, 0]).all() or not drift <= 1e-3:
            raise AssertionError(f"reduced {name}: GPU and CPU disagree")
    return {"serve_logit_drift": drifts,
            "train_step": _train_step_gpu_vs_cpu(torch)}


def _mesh_world1(torch, cfg, served, prompts, plain_toks):
    """Leg (a): the main path under ``parallel_ctx_from_spec('model=1')``
    over NCCL at world 1, the decode step (and its collectives) captured:
    tokens bitwise the main path's, launches counted over the replays, one
    decode step's device time beside the unsharded step's, in turns."""
    import numpy as np

    from repro_torch.kernels import dscim_fused, paged_attention
    from repro_torch.launch.mesh import parallel_ctx_from_spec
    from repro_torch.launch.serve import prepare_params, serve_batch
    from repro_torch.launch.steps import _generate_runner

    cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
    dev = torch.device("cuda", 0)
    with _nccl_world1():
        try:
            par = parallel_ctx_from_spec("model=1")
            if not par.capturable:
                raise AssertionError(f"backend {par.backend} not capturable")
            placed = prepare_params(cfg_ds, served, par=par)
            kw = dict(kv="int8", page_size=PAGE)
            warm = {}
            serve_batch(cfg_ds, placed, prompts, TOKENS, timings=warm,
                        par=par, **kw)
            if not warm["graph"] or "capture_s" not in warm:
                raise AssertionError(f"no graph captured under the mesh: "
                                     f"{warm}")
            dscim_fused.LAUNCHES.reset()
            paged_attention.LAUNCHES.reset()
            t = {}
            toks, logits = serve_batch(cfg_ds, placed, prompts, TOKENS,
                                       timings=t, par=par, **kw)
            launches = {"dscim_fused_mvm": dscim_fused.LAUNCHES.count,
                        "paged_attention_decode":
                        paged_attention.LAUNCHES.count}
            want = {"dscim_fused_mvm": _fused_per_forward(cfg) * TOKENS,
                    "paged_attention_decode": cfg.n_layers * (TOKENS - 1)}
            if launches != want:
                raise AssertionError(f"mesh launches {launches} != {want}")
            if plain_toks is None or not np.array_equal(toks, plain_toks):
                raise AssertionError("model=1 tokens differ from the main "
                                     "path's")
            if not np.isfinite(logits[0]).all():
                raise AssertionError("non-finite prefill logits")
            runners = {name: _generate_runner(
                cfg_ds, BATCH, PROMPT, TOKENS, "int8", PAGE, None, "greedy",
                False, dev, None, *p) for name, p in (("unsharded", ()),
                                                      ("model=1", (par,)))}
            params = {"unsharded": served, "model=1": placed}
            # the unsharded graph at these options (captured again if a
            # later capture replaced it)
            serve_batch(cfg_ds, served, prompts, TOKENS, **kw)
            step_ms = {name: [] for name in runners}
            for name in ("unsharded", "model=1") * 3:
                st = runners[name].st

                def reset():
                    st["params"] = params[name]
                    st["cache"]["pos"].fill_(PROMPT + TOKENS // 2)
                    st["i"].fill_(TOKENS // 2)
                step_ms[name].append(_decode_step_ms(
                    torch, runners[name].step.graph.replay, reset))
                st["params"] = None
            med = {k: float(np.median(v)) for k, v in step_ms.items()}
            # one replay of each graph under the profiler: the kernels the
            # mesh adds (NCCL's, the gathers' copies)
            prof = {}
            for name in ("unsharded", "model=1"):
                st = runners[name].st
                st["params"] = params[name]
                st["cache"]["pos"].fill_(PROMPT + TOKENS // 2)
                st["i"].fill_(TOKENS // 2)
                try:
                    prof[name] = _profile_request(
                        torch, runners[name].step.graph.replay)
                finally:
                    st["params"] = None
                p = prof[name]
                _log(f"mesh (a) {name} step profiled: "
                     f"{p['kernel_launches']} kernels, "
                     f"{p['device_busy_ms']:.3f} ms busy of "
                     f"{p['wall_ms_profiled']:.3f}; top "
                     + ", ".join(f"{k['name'][:40]} {k['calls']} x "
                                 f"{k['device_ms']:.3f} ms"
                                 for k in p["top_kernels"][:6]))
            _log(f"mesh (a) NCCL world 1, model=1, graph: tokens bitwise "
                 f"the main path, launches {launches}, capture "
                 f"{warm['capture_s']:.3f} s, {BATCH * TOKENS / t['generate_s']:.1f} "
                 f"tok/s; decode step {med['model=1']:.4f} ms device "
                 f"median (unsharded {med['unsharded']:.4f} ms), runs "
                 f"{step_ms}")
            return {"launches": launches, "capture_s": warm["capture_s"],
                    "tok_s": BATCH * TOKENS / t["generate_s"],
                    "decode_step_ms": step_ms, "decode_step_ms_median": med,
                    "profiled_step": prof, "tokens_bitwise_main_path": True}
        finally:
            runners = None


def _mesh_fused_shards(torch, cfg, served):
    """Leg (b): kernel 1 placement-invariant at full width: for each
    prepared weight of layer 0's MLP and the head, at M = 4 and 256, each
    of MESH_N_SLICES N-slices and each of MESH_B_SLICES batch slices,
    launched alone, is bitwise that slice of the full call."""
    from repro_torch.core.qweights import QuantizedLinearWeight
    from repro_torch.kernels.dscim_fused import dscim_fused_mvm_prepared
    from repro_torch.models import lm

    dcfg = lm._lin(dataclasses.replace(cfg, dscim=DSCIM)).cfg
    mlp = served["layers"]["mlp"]
    sites = [(n, mlp[n][0], torch.bfloat16) for n in
             ("w_gate", "w_up", "w_down")]
    sites.append(("head", served["lm_head"], torch.float32))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    checked = []
    for name, qw, xdt in sites:
        for M in (4, 256):
            x = torch.randn((M, qw.k_orig), generator=gen,
                            device="cuda").to(xdt)
            full = dscim_fused_mvm_prepared(x, qw, dcfg)
            n = qw.n // MESH_N_SLICES
            for j in range(MESH_N_SLICES):
                part = QuantizedLinearWeight(
                    qw.q[..., j * n:(j + 1) * n].contiguous(),
                    qw.scale[..., j * n:(j + 1) * n].contiguous(),
                    qw.k_orig, qw.group_k)
                got = dscim_fused_mvm_prepared(x, part, dcfg)
                if not torch.equal(got, full[:, j * n:(j + 1) * n]):
                    raise AssertionError(f"kernel 1 {name} M={M}: N-slice "
                                         f"{j} differs from the full call")
            b = M // MESH_B_SLICES
            for j in range(MESH_B_SLICES):
                got = dscim_fused_mvm_prepared(x[j * b:(j + 1) * b], qw, dcfg)
                if not torch.equal(got, full[j * b:(j + 1) * b]):
                    raise AssertionError(f"kernel 1 {name} M={M}: batch "
                                         f"slice {j} differs from the full "
                                         "call")
            checked.append(f"{name} M={M} K={qw.k_orig} N={qw.n}")
    _log(f"mesh (b) kernel 1: {MESH_N_SLICES} N-slices and {MESH_B_SLICES} "
         f"batch slices bitwise the full call at {checked}")
    return checked


def _mesh_paged_shards(torch, cfg):
    """Leg (c): kernel 2 placement-invariant: at the main path's head
    layout, at its last decode position and at LONG_POS, each of
    MESH_B_SLICES batch slices (the pool whole) is bitwise the full
    call's rows."""
    from repro_torch.kernels import paged_attention as pa

    B, ps, KV, HD = BATCH, PAGE, cfg.n_kv, cfg.head_dim
    R = cfg.q_heads // KV
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    checked = []
    for pos in (PROMPT + TOKENS - 2, LONG_POS):
        MP = pos // ps + 1
        P = B * MP
        q = torch.randn((B, KV, R, HD), generator=gen, device="cuda")
        pages = [torch.randint(-127, 128, (P, ps, KV, HD), generator=gen,
                               device="cuda").to(torch.int8)
                 for _ in range(2)]
        scales = [torch.rand((P, KV), generator=gen, device="cuda") * 0.02
                  for _ in range(2)]
        tails = [torch.randn((B, ps, KV, HD), generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for _ in range(2)]
        table = torch.randperm(P, generator=gen, device="cuda").reshape(
            B, MP).to(torch.int32)
        # ragged: each slot at its own position
        posv = torch.tensor([pos - 3 * i for i in range(B)],
                            dtype=torch.int32, device="cuda")
        full = pa.paged_attention_decode(q, *pages, *scales, *tails, table,
                                         posv)
        b = B // MESH_B_SLICES
        for j in range(MESH_B_SLICES):
            s = slice(j * b, (j + 1) * b)
            got = pa.paged_attention_decode(
                q[s], *pages, *scales, tails[0][s], tails[1][s], table[s],
                posv[s])
            if not torch.equal(got, full[s]):
                raise AssertionError(f"kernel 2 pos={pos}: batch slice {j} "
                                     "differs from the full call")
        checked.append(f"B={B} KV={KV} n_rep={R} HD={HD} ps={ps} "
                       f"pos={posv.tolist()}")
    _log(f"mesh (c) kernel 2: {MESH_B_SLICES} batch slices bitwise the full "
         f"call at {checked}")
    return checked


def _mesh_rank(rank: int, store: str, out: str) -> int:
    """One rank of leg (d) (``chip_smoke.py --mesh-rank RANK STORE OUT``):
    joins a 2-rank gloo group on the one card, probes which collectives
    gloo carries for CUDA tensors, and serves the cut qwen3 at model=2
    eagerly if ``all_gather`` is among them; writes its results to OUT."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    res = {"rank": rank, "collectives": {}}
    try:
        x = torch.full((2, 3), float(rank), device="cuda")
        probes = {
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(2)], x),
            "all_to_all_single": lambda: dist.all_to_all_single(
                torch.empty_like(x), x),
            "all_reduce": lambda: dist.all_reduce(x.clone())}
        for name, fn in probes.items():
            try:
                fn()
                torch.cuda.synchronize()
                res["collectives"][name] = "ok"
            except Exception as e:          # report which one is missing
                res["collectives"][name] = f"missing: {type(e).__name__}: " \
                                           f"{str(e)[:200]}"
        if res["collectives"]["all_gather"] == "ok":
            from repro_torch.configs import get_arch
            from repro_torch.kernels import dscim_fused, paged_attention
            from repro_torch.launch.mesh import parallel_ctx_from_spec
            from repro_torch.launch.serve import serve_batch
            from repro_torch.models import lm
            par = parallel_ctx_from_spec("model=2")
            cfg = dataclasses.replace(get_arch("qwen3-0.6b"),
                                      n_layers=MESH_D_LAYERS, dscim=DSCIM)
            params = lm.init_params(cfg, 0)
            prompts = np.random.default_rng(0).integers(
                0, cfg.vocab, (BATCH, PROMPT))
            dscim_fused.LAUNCHES.reset()
            paged_attention.LAUNCHES.reset()
            t = {}
            toks, logits = serve_batch(cfg, params, prompts, MESH_D_TOKENS,
                                       kv="int8", page_size=PAGE, par=par,
                                       timings=t)
            res.update(tokens=toks.tolist(), graph=t["graph"],
                       eager_reason=t.get("eager_reason"),
                       generate_s=t["generate_s"],
                       launches={"dscim_fused_mvm": dscim_fused.LAUNCHES.count,
                                 "paged_attention_decode":
                                 paged_attention.LAUNCHES.count},
                       finite=bool(np.isfinite(logits[0]).all()))
    finally:
        dist.destroy_process_group()
        with open(out, "w") as f:
            json.dump(res, f)
    return 0


def _mesh_gloo(torch):
    """Leg (d): two ranks on the one card over gloo (``_mesh_rank``), the
    cut qwen3 at model=2 eagerly, tokens bitwise one process's."""
    import tempfile

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), n_layers=MESH_D_LAYERS,
                              dscim=DSCIM)
    params = lm.init_params(cfg, 0)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                (BATCH, PROMPT))
    want, _ = serve_batch(cfg, params, prompts, MESH_D_TOKENS, kv="int8",
                          page_size=PAGE)
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
             str(r), f"{tmp}/store", f"{tmp}/r{r}.json"], cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MESH_D_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if any(p.returncode for p in procs):
            raise AssertionError("a gloo rank failed:\n" + "\n".join(
                o[-3000:] for o in outs))
        res = [json.loads(Path(f"{tmp}/r{r}.json").read_text())
               for r in range(2)]
    coll = res[0]["collectives"]
    missing = [k for k, v in coll.items() if v != "ok"]
    _log(f"mesh (d) gloo on CUDA tensors: {coll}"
         + (f"; missing: {missing}" if missing else ""))
    leg = {"collectives": coll, "missing": missing}
    if "tokens" not in res[0]:
        _log("mesh (d): gloo carries no all_gather of CUDA tensors, so "
             "the two-rank serve did not run")
        return leg
    for r in res:
        if r["tokens"] != want.tolist() or not r["finite"]:
            raise AssertionError(f"rank {r['rank']} tokens differ from one "
                                 "process's")
        if r["graph"] or not r["eager_reason"]:
            raise AssertionError(f"rank {r['rank']}: gloo step not eager "
                                 "or not said so")
    leg.update(tokens_bitwise_world1=True, eager_reason=res[0]["eager_reason"],
               generate_s=[r["generate_s"] for r in res],
               launches=res[0]["launches"])
    _log(f"mesh (d) model=2 over gloo, {MESH_D_LAYERS} layers at full "
         f"width, {MESH_D_TOKENS} tokens: both ranks' tokens bitwise one "
         f"process's; eager ({res[0]['eager_reason']}); generate "
         f"{leg['generate_s']} s; rank 0 launches {leg['launches']}")
    return leg


@contextlib.contextmanager
def _nccl_world1():
    """A one-rank NCCL process group over a ``file://`` store, destroyed
    after."""
    import tempfile

    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _mesh_recurrent(torch, rec_tokens):
    """Leg (e): REC_SERVED (rwkv6-7b and zamba2-7b at their published width
    and depth, ``dscim='off'``, the float cache) under
    ``parallel_ctx_from_spec('model=1')`` over NCCL at world 1, the
    decode step and its collectives captured: the tokens bitwise the
    unsharded request's and the ``recurrent_family`` phase's
    (``rec_tokens``, when that phase ran), no launch of the six kernels,
    one decode step's device ms beside the unsharded step's in turns, and
    each request's peak memory."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import parallel_ctx_from_spec
    from repro_torch.launch.serve import (clear_graphs, prepare_params,
                                          serve_batch)
    from repro_torch.launch.steps import _generate_runner
    from repro_torch.models.registry import get_model

    dev = torch.device("cuda", 0)
    counters = _all_counters()
    kw = dict(kv="float", page_size=PAGE)
    out = {}
    with _nccl_world1():
        par = parallel_ctx_from_spec("model=1")
        for name, layers in REC_SERVED:
            cfg = get_arch(name)
            if layers is not None:
                cfg = dataclasses.replace(cfg, n_layers=layers)
            cfg_ds = dataclasses.replace(cfg, dscim="off")
            clear_graphs()
            torch.cuda.empty_cache()
            served = prepare_params(cfg_ds, get_model(cfg).init_params(cfg,
                                                                       0))
            placed = prepare_params(cfg_ds, served, par=par)
            prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                        (BATCH, PROMPT))
            toks, peak, capture_s = {}, {}, {}
            for tag, p, extra in (("unsharded", served, {}),
                                  ("model=1", placed, {"par": par})):
                warm = {}
                serve_batch(cfg_ds, p, prompts, TOKENS, timings=warm, **kw,
                            **extra)
                if "capture_s" not in warm:
                    raise AssertionError(f"mesh (e) {name} {tag}: no graph")
                capture_s[tag] = warm["capture_s"]
                for c in counters.values():
                    c.reset()
                torch.cuda.reset_peak_memory_stats()
                toks[tag], _ = serve_batch(cfg_ds, p, prompts, TOKENS, **kw,
                                           **extra)
                peak[tag] = torch.cuda.max_memory_allocated()
                if any(c.count for c in counters.values()):
                    raise AssertionError(f"mesh (e) {name} {tag} launched "
                                         f"{[c.count for c in counters.values()]}")
            want = toks["unsharded"] if rec_tokens is None \
                else np.asarray(rec_tokens[name])
            if not (np.array_equal(toks["model=1"], toks["unsharded"])
                    and np.array_equal(toks["unsharded"], want)):
                raise AssertionError(f"mesh (e) {name}: model=1 tokens "
                                     "differ from the unsharded ones")
            runners = {tag: _generate_runner(
                cfg_ds, BATCH, PROMPT, TOKENS, "float", PAGE, None, "greedy",
                False, dev, None, *p) for tag, p in (("unsharded", ()),
                                                     ("model=1", (par,)))}
            params = {"unsharded": served, "model=1": placed}
            step_ms = {tag: [] for tag in runners}
            for tag in ("unsharded", "model=1") * 3:
                st = runners[tag].st

                def reset():
                    st["params"] = params[tag]
                    st["cache"]["pos"].fill_(PROMPT + TOKENS // 2)
                    st["i"].fill_(TOKENS // 2)
                step_ms[tag].append(_decode_step_ms(
                    torch, runners[tag].step.graph.replay, reset))
                st["params"] = None
            med = {k: float(np.median(v)) for k, v in step_ms.items()}
            out[name] = {"layers": cfg.n_layers, "tokens_bitwise": True,
                         "recurrent_family_tokens": rec_tokens is not None,
                         "decode_step_ms": step_ms,
                         "decode_step_ms_median": med,
                         "peak_memory_bytes": peak,
                         "capture_s": capture_s}
            _log(f"mesh (e) {name} ({cfg.n_layers} layers, d "
                 f"{cfg.d_model}) under model=1 over NCCL, graph: tokens "
                 f"bitwise the unsharded request's"
                 + (" and the recurrent_family phase's" if rec_tokens
                    is not None else "")
                 + f", no kernel launched; decode step {med['model=1']:.4f} "
                 f"ms device median (unsharded {med['unsharded']:.4f} ms), "
                 f"runs {step_ms}; peak memory "
                 f"{peak['model=1'] / 2**30:.2f} GiB (unsharded "
                 f"{peak['unsharded'] / 2**30:.2f})")
            runners = st = params = served = placed = None
            clear_graphs()
            torch.cuda.empty_cache()
    return out


def _hang_at(at: int):
    """A hang watchdog (``runtime/watchdog.py Watchdog``) that flags a
    hang before its ``at``-th step, once."""
    from repro_torch.runtime.watchdog import Watchdog

    class HangAt(Watchdog):
        n = 0

        def step(self, par=None):
            self.n += 1
            if self.n == at:
                self._hang.set()
            return super().step(par)
    return HangAt(hang_timeout=600.0)


def _mesh_knobs(torch, cfg, served, cb_outs):
    """Leg (f): the continuous phase's queue at ``kernel:dscim1:256``, int8
    KV, with ``integrity='verify'``, a ``deadline_s`` per request (request
    0's expires at the first boundary after its admission), the hang
    watchdog (a hang flagged before the third segment: one replay), the
    accuracy monitor (an exact probe every MESH_F_PROBE segments) and one
    weight flip (an int8 element of layer 0's first w_up plane at segment
    1: found, repaired, replayed; the monitor at MESH_F_MARGIN), served
    on one device and under
    ``parallel_ctx_from_spec('model=1')`` over NCCL at world 1: outputs,
    statuses, replays, quarantines and the integrity record equal;
    requests 1-7 bitwise the continuous phase's outputs and request 0 a
    prefix of its; the two kernels' launches under the mesh counted; the
    shared prepared planes digest as before."""
    import numpy as np

    from repro_torch.core.qweights import weight_plane_digests
    from repro_torch.launch.mesh import parallel_ctx_from_spec
    from repro_torch.launch.serve import prepare_params, serve_continuous
    from repro_torch.runtime.failover import FailureInjector
    from repro_torch.runtime.serving import watchdog_for_spec

    if cb_outs is None:
        raise AssertionError("no continuous outputs to hold leg (f) to")
    cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
    prompts, budgets = _cb_queue(cfg)
    R = len(budgets)
    deadlines = np.full(R, 1e6)
    deadlines[0] = 1e-6
    digests0 = weight_plane_digests(served).cpu().numpy()
    res = {}
    with _nccl_world1():
        par = parallel_ctx_from_spec("model=1")
        placed = prepare_params(cfg_ds, served, par=par)
        for tag, p, extra in (("one_device", served, {}),
                              ("model=1", placed, {"par": par})):
            wd = _hang_at(3)
            monitor = watchdog_for_spec(DSCIM, margin=MESH_F_MARGIN,
                                        probe_every=MESH_F_PROBE)
            inj = FailureInjector(weight_flips={
                1: (("layers/mlp/w_up", "q", 2026, 0x10),)})
            c0 = _counts()
            try:
                outs, st = serve_continuous(
                    cfg_ds, p, prompts, int(budgets.max()), slots=BATCH,
                    seg_len=CB_SEG, max_new=budgets, kv="int8",
                    page_size=PAGE, eos_id=-1, deadline_s=deadlines,
                    watchdog=wd, monitor=monitor, injector=inj,
                    snapshot_every=1, integrity="verify", log=_log, **extra)
            finally:
                wd.close()
            c1 = _counts()
            ig = {k: v for k, v in st["integrity"].items()
                  if k != "scrub_time_s"}
            res[tag] = {"outs": [o.tolist() for o in outs],
                        "status": st["status"], "replays": st["replays"],
                        "quarantined": st["quarantined"],
                        "probes": st["probes"],
                        "probe_trips": st["probe_trips"], "integrity": ig,
                        "wall_s": st["wall_s"],
                        "launches": {"dscim_fused_mvm":
                                     c1["fused"] - c0["fused"],
                                     "paged_attention_decode":
                                     c1["paged"] - c0["paged"]}}
    one, mesh = res["one_device"], res["model=1"]
    same = {k: one[k] == mesh[k] for k in ("outs", "status", "replays",
                                           "quarantined", "probes",
                                           "probe_trips", "integrity")}
    n0 = len(mesh["outs"][0])
    checks = {
        "mesh equals one device": all(same.values()),
        "request 0 cancelled, a prefix of its continuous output":
        mesh["status"][0] == "deadline" and 0 < n0 < budgets[0]
        and mesh["outs"][0] == cb_outs[0][:n0].tolist(),
        "requests 1-7 bitwise the continuous phase": all(
            mesh["outs"][r] == cb_outs[r].tolist() for r in range(1, R))
        and mesh["status"][1:] == ["ok"] * (R - 1),
        "the hang and the flip replayed": mesh["replays"] == 2,
        "the flip found at its plane and repaired":
        mesh["integrity"]["weight_mismatches"] == 1
        and mesh["integrity"]["weight_repairs"] == 1
        and mesh["integrity"]["detections"] == [
            {"kind": "weight", "coords": [("layers/mlp/w_up", "q")]}],
        "probed, no trip": mesh["probes"] > 0 and mesh["probe_trips"] == 0,
        "kernels 1 and 2 launched under the mesh":
        all(v > 0 for v in mesh["launches"].values()),
        "the shared planes digest as before": bool(np.array_equal(
            weight_plane_digests(served).cpu().numpy(), digests0)),
    }
    _log(f"mesh (f) the continuous queue with integrity verify, deadline_s, "
         f"the hang watchdog, the monitor and a weight flip, one device and "
         f"model=1 over NCCL: statuses {mesh['status']}, replays "
         f"{mesh['replays']}, probes {mesh['probes']} (trips "
         f"{mesh['probe_trips']}), integrity {mesh['integrity']}, launches "
         f"under the mesh {mesh['launches']} (one device "
         f"{one['launches']}), wall s {mesh['wall_s']:.3f} (one device "
         f"{one['wall_s']:.3f}); checks {checks}; equal by key {same}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh (f): {failed}")
    return {"checks": checks, "launches": mesh["launches"],
            "one_device_launches": one["launches"],
            **{k: mesh[k] for k in ("status", "replays", "probes",
                                    "integrity", "wall_s")},
            "one_device_wall_s": one["wall_s"]}


def mesh_phase(torch, cfg, served, prompts, plain_toks, cb_outs=None,
               rec_tokens=None):
    """The serving path under a mesh (``mesh``): legs (a) NCCL world 1 at
    full width, captured; (b) kernel 1 and (c) kernel 2 per shard; (d)
    two ranks on the one card over gloo; (e) the recurrent families under
    model=1 at full width, captured; (f) the scheduler's knobs on the
    continuous queue under model=1."""
    t0 = time.perf_counter()
    out = {}
    for name, fn, args in (
            ("nccl_world1", _mesh_world1,
             (torch, cfg, served, prompts, plain_toks)),
            ("fused_shards", _mesh_fused_shards, (torch, cfg, served)),
            ("paged_shards", _mesh_paged_shards, (torch, cfg)),
            ("gloo_two_ranks", _mesh_gloo, (torch,)),
            ("knobs", _mesh_knobs, (torch, cfg, served, cb_outs)),
            ("recurrent", _mesh_recurrent, (torch, rec_tokens))):
        t1 = time.perf_counter()
        out[name] = fn(*args)
        _log(f"mesh {name}: {time.perf_counter() - t1:.1f} s")
    out["s"] = time.perf_counter() - t0
    return out


def _piece_digests(tree) -> list:
    """(spec, digest) of each leaf of a placed tree in ``tree.leaves``
    order: this rank's piece's uint32 digest (``core/qweights.py
    plane_digest``, on the device: any change to one element moves it)
    and the spec it was cut by (None for a whole leaf)."""
    from repro_torch.core.qweights import plane_digest
    from repro_torch.parallel import Sharded
    from repro_torch.tree import leaves
    return [(x.spec, int(plane_digest(x.local))) if isinstance(x, Sharded)
            else (None, int(plane_digest(x.detach()))) for x in leaves(tree)]


def _pieces_match(tree, rank_coords, digests) -> bool:
    """Whether the pieces a rank at ``rank_coords`` would cut from the
    whole leaves of ``tree`` have the rank's ``digests``
    (``_piece_digests``)."""
    from repro_torch.core.qweights import plane_digest
    from repro_torch.launch.sharding import shard_for
    from repro_torch.tree import leaves
    flat = leaves(tree)
    if len(flat) != len(digests):
        return False
    for x, (spec, d) in zip(flat, digests):
        piece = x if spec is None else \
            shard_for(rank_coords, spec, x).contiguous()
        if int(plane_digest(piece)) != d:
            return False
    return True


def _train_mesh_world1(torch, train_res):
    """Leg (a): olmo-1b at full width and depth through ``TrainLoop`` under
    ``REPRO_MESH=d1x1`` (``runtime/elastic.py mesh_from_env``) over NCCL
    at world 1, TRAIN_BATCH x TRAIN_SEQ, TM_A_STEPS steps: every leaf is a
    placed piece gathered each step (ZeRO-3), the gradients' mean over
    the DP axis an all-reduce; the losses bitwise the train phase's first
    TM_A_STEPS (the same seed, data and learning rates), no launch of the
    six kernels, step device ms beside the unsharded step's, peak
    memory."""
    import os

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import TrainLoop
    from repro_torch.runtime.elastic import mesh_from_env

    if train_res is None:
        raise AssertionError("no train phase losses to hold leg (a) to")
    cfg = get_arch(TRAIN_ARCH)
    counters = _all_counters()
    torch.cuda.empty_cache()
    with _nccl_world1():
        try:
            os.environ["REPRO_MESH"] = "d1x1"
            loop = TrainLoop(cfg, steps=TM_A_STEPS, batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ, lr=TRAIN_LR, mesh=mesh_from_env(),
                             log=_log)
            if loop.par.backend != "nccl":
                raise AssertionError(f"backend {loop.par.backend}")
            loop.step_fn = timer = _StepTimer(torch, loop.step_fn)
            for c in counters.values():
                c.reset()
            torch.cuda.reset_peak_memory_stats()
            loop.run()
            peak = torch.cuda.max_memory_allocated()
            launches = {k: c.count for k, c in counters.items()}
            step_ms = timer.ms()
        finally:
            os.environ.pop("REPRO_MESH", None)
    losses = _losses(loop.history)
    want = train_res["losses"][:TM_A_STEPS]
    unsharded = train_res["step_ms"][:TM_A_STEPS]
    res = {"losses": losses, "unsharded_losses": want,
           "bitwise": losses == want, "launches": launches,
           "step_ms": step_ms, "unsharded_step_ms": unsharded,
           "step_ms_median_after_first": float(np.median(step_ms[1:])),
           "unsharded_step_ms_median_after_first":
           float(np.median(unsharded[1:])), "peak_memory_bytes": peak,
           "unsharded_peak_memory_bytes": train_res["peak_memory_bytes"]}
    _log(f"train_mesh (a) {TRAIN_ARCH} under d1x1 over NCCL at world 1, "
         f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TM_A_STEPS} steps: losses "
         f"{losses} (unsharded {want}: bitwise {res['bitwise']}); step "
         f"device ms {[round(x, 1) for x in step_ms]} (unsharded "
         f"{[round(x, 1) for x in unsharded]}); peak memory "
         f"{peak / 2**30:.2f} GiB (unsharded "
         f"{train_res['peak_memory_bytes'] / 2**30:.2f}); launches "
         f"{launches}")
    if not res["bitwise"]:
        raise AssertionError(f"d1x1 losses {losses} differ from {want}")
    if any(launches.values()):
        raise AssertionError(f"the mesh train path launched {launches}")
    return res


def _train_mesh_others(torch, train_res):
    """Leg (g): TRAIN_OTHERS (granite-moe-1b-a400m at full width and
    depth, its experts with expert parallelism; rwkv6-7b and zamba2-7b cut
    as the train phase cuts them) through ``TrainLoop`` under
    ``REPRO_MESH=d1x1`` over NCCL at world 1, TRAIN_OTHER_STEPS steps of
    TRAIN_BATCH x the train phase's sequence: the losses bitwise the train
    phase's runs of the same configs (the same seed, data and learning
    rates), or within TM_G_RTOL where they are not; no launch of the six
    kernels; step device ms beside the unsharded steps', peak memory."""
    import os

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import TrainLoop
    from repro_torch.runtime.elastic import mesh_from_env

    others = (train_res or {}).get("others")
    if not others:
        raise AssertionError("no train phase runs of the other families to "
                             "hold leg (g) to")
    counters = _all_counters()
    out = {}
    with _nccl_world1():
        os.environ["REPRO_MESH"] = "d1x1"
        try:
            for name, _, seq in TRAIN_OTHERS:
                want = others[name]
                cfg = dataclasses.replace(get_arch(name),
                                          n_layers=want["layers"])
                gc.collect()
                torch.cuda.empty_cache()
                loop = TrainLoop(cfg, steps=TRAIN_OTHER_STEPS,
                                 batch=TRAIN_BATCH, seq=seq, lr=TRAIN_LR,
                                 mesh=mesh_from_env(), log=_log)
                loop.step_fn = timer = _StepTimer(torch, loop.step_fn)
                for c in counters.values():
                    c.reset()
                torch.cuda.reset_peak_memory_stats()
                loop.run()
                peak = torch.cuda.max_memory_allocated()
                launches = {k: c.count for k, c in counters.items()}
                losses = _losses(loop.history)
                rel = [abs(a - b) / abs(b) for a, b in
                       zip(losses, want["losses"])]
                out[name] = {"layers": cfg.n_layers, "seq": seq,
                             "losses": losses,
                             "unsharded_losses": want["losses"],
                             "bitwise": losses == want["losses"],
                             "relative": rel, "step_ms": timer.ms(),
                             "unsharded_step_ms": want["step_ms"],
                             "peak_memory_bytes": peak,
                             "unsharded_peak_memory_bytes":
                             want["peak_memory_bytes"],
                             "launches": launches}
                del loop
                _log(f"train_mesh (g) {name} ({cfg.n_layers} layers, "
                     f"{TRAIN_BATCH} x {seq}) under d1x1 over NCCL at world "
                     f"1: losses {losses} (unsharded {want['losses']}: "
                     f"bitwise {out[name]['bitwise']}, relative {rel}); "
                     f"step device ms "
                     f"{[round(x, 1) for x in out[name]['step_ms']]} "
                     f"(unsharded "
                     f"{[round(x, 1) for x in want['step_ms']]}); peak "
                     f"memory {peak / 2**30:.2f} GiB (unsharded "
                     f"{want['peak_memory_bytes'] / 2**30:.2f})")
                if max(rel) > TM_G_RTOL or any(launches.values()):
                    raise AssertionError(f"train_mesh (g) {name}: losses "
                                         f"{rel} off, launches {launches}")
        finally:
            os.environ.pop("REPRO_MESH", None)
    torch.cuda.empty_cache()
    return {"archs": out}


def _with_grad_norms(step_fn, out: list):
    """``step_fn`` appending each step's gradient norm to ``out`` (one
    entry a ``TrainLoop.history`` entry)."""
    def step(params, opt_state, batch):
        params, opt_state, m = step_fn(params, opt_state, batch)
        out.append(float(m["grad_norm"]))
        return params, opt_state, m
    return step


def _train_mesh_rank(rank: int, store: str, out: str) -> int:
    """One rank of legs (b)-(d) (``chip_smoke.py --train-mesh-rank RANK
    STORE OUT``): joins a 2-rank gloo group on the one card; (b) trains
    the cut olmo-1b under d2x1 with the failure injected on rank 0 alone
    and digests its final state's pieces; (c) ``pp_dryrun`` over pod=2 and
    its stages applied
    in turn on this rank; (d) ``compressed_psum_tree`` over pod=2 on a
    seeded tree; pickles the results to OUT."""
    import pickle

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    res = {"rank": rank}
    try:
        from repro_torch.configs import get_arch
        from repro_torch.launch.mesh import make_debug_mesh, make_parallel_ctx
        from repro_torch.launch.pipeline import gelu_mlp_stage, pp_dryrun
        from repro_torch.launch.train import TrainLoop
        from repro_torch.optim.compression import compressed_psum_tree

        counters = _all_counters()
        for c in counters.values():
            c.reset()
        cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TM_LAYERS)
        ck = str(Path(store).parent / "ckpt")
        t0 = time.perf_counter()
        loop = TrainLoop(cfg, steps=TM_STEPS, batch=TM_BATCH, seq=TM_SEQ,
                         lr=TRAIN_LR, ckpt_dir=ck, ckpt_every=TM_STEPS,
                         mesh=make_debug_mesh(2, 1), device="cuda:0",
                         fail_at=(TM_FAIL_AT,) if rank == 0 else (),
                         log=_log)
        gnorms = []
        loop.step_fn = _with_grad_norms(loop.step_fn, gnorms)
        state = loop.run()
        torch.cuda.synchronize()
        res["train_s"] = time.perf_counter() - t0
        par = loop.par
        res["history"] = [(h["step"], h["loss"], h["time"])
                          for h in loop.history]
        res["grad_norms"] = gnorms
        res["coords"] = par.rank_coords
        res["digests"] = _piece_digests({"params": state["params"],
                                         "opt": state["opt"]})
        del state, loop
        torch.cuda.empty_cache()

        pod = make_parallel_ctx(make_debug_mesh(1, 1, pod=2))
        t0 = time.perf_counter()
        rec = pp_dryrun(par=pod, device="cuda:0")
        res["pp_s"] = time.perf_counter() - t0
        w1, w2, x = rec.pop("inputs")
        out_pp = rec.pop("out")
        in_turn = torch.stack([gelu_mlp_stage(
            (w1[1], w2[1]), gelu_mlp_stage((w1[0], w2[0]), xm))
            for xm in x])
        rec["bitwise_stages_in_turn"] = bool(torch.equal(out_pp, in_turn))
        res["pp"] = rec
        del w1, w2, x, out_pp, in_turn

        g = torch.Generator(device="cuda")
        g.manual_seed(100 + rank)
        grads = {"w": torch.randn((256, 512), generator=g, device="cuda")
                 * (rank + 1), "b": torch.randn((512,), generator=g,
                                                device="cuda") * 1e-3}
        err = {k: torch.randn(v.shape, generator=g, device="cuda") * 1e-4
               for k, v in grads.items()}
        ng, ne = compressed_psum_tree(grads, err, "pod", pod)
        host = lambda t: {k: v.cpu().numpy() for k, v in t.items()}  # noqa
        res["psum"] = {"g": host(grads), "e": host(err), "mean": host(ng),
                       "err": host(ne)}
        res["launches"] = {k: c.count for k, c in counters.items()}
        # both ranks done with their last collective before either tears
        # its connections down (a gloo peer cut off mid-transfer aborts)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(res, f)
    return 0


def _update_rel(torch, got, want, start):
    """(||(got - start) - (want - start)|| / ||want - start||, max |got -
    want|) over every leaf of the parameter trees, in f64."""
    from repro_torch.tree import leaves
    num = den = 0.0
    worst = 0.0
    for g, w, s0 in zip(leaves(got), leaves(want), leaves(start)):
        d = (g.double() - w.double())
        num += float(torch.sum(d * d))
        u = (w.double() - s0.double())
        den += float(torch.sum(u * u))
        worst = max(worst, float(d.abs().max()))
    return math.sqrt(num / den), worst


def _psum_restated(ranks):
    """``compressed_psum_tree``'s arithmetic re-stated on the host in
    numpy f32 over the two ranks' inputs: (mean, [each rank's new
    error])."""
    import numpy as np

    f32 = np.float32
    recip = f32(1.0) / f32(127.0)
    out_mean, out_err = {}, [{}, {}]
    for k in ranks[0]["psum"]["g"]:
        g32 = [r["psum"]["g"][k].astype(f32) + r["psum"]["e"][k]
               for r in ranks]
        s = [f32(max(np.abs(a).max(), f32(1e-12))) * recip for a in g32]
        s_max = f32(max(s))
        q = [np.clip(np.round(a / s_max), -127, 127) for a in g32]
        out_mean[k] = ((q[0] + q[1]) * s_max / f32(2)).astype(f32)
        for i in range(2):
            out_err[i][k] = g32[i] - q[i] * s_max
    return out_mean, out_err


def _train_mesh_gloo(torch):
    """Legs (b)-(d): two gloo ranks on the one card (``_train_mesh_rank``);
    (b) the cut olmo-1b under d2x1: the failure on rank 0 alone made
    every rank start again and replay step 0 bitwise, the losses and
    gradient norms within TM_LOSS_RTOL and TM_GNORM_RTOL of one device's,
    the mesh's last checkpoint restored on one device bitwise the final
    state (each rank's pieces' digests against the same pieces cut from
    the restored leaves; restoring under a mesh is held on the CPU,
    tests/test_torch_train_mesh.py) and its parameters' update within
    TM_UPDATE_RTOL of one device's (``_update_rel``); the loss of the
    unchanged parameters on the last batch, and the update of one device
    on rank 0's half of each batch (no DP reduction), above the loss and
    update bounds; (c)
    ``pp_dryrun``'s record, its result bitwise the stages
    applied in turn; (d) ``compressed_psum_tree`` bitwise its host
    re-statement."""
    import pickle
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_eval_step
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.registry import get_model

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TM_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--train-mesh-rank", str(r), f"{tmp}/store",
             f"{tmp}/r{r}.pkl"], cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=TM_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        ranks_s = time.perf_counter() - t0
        if any(p.returncode for p in procs):
            raise AssertionError("a gloo rank failed:\n" + "\n".join(
                o[-3000:] for o in outs))
        ranks = []
        for r in range(2):
            with open(f"{tmp}/r{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        for r in ranks:
            if "launches" not in r:
                raise AssertionError(f"rank {r['rank']} stopped early:\n"
                                     + outs[r["rank"]][-3000:])
        # one device: the same run, no mesh; the mesh's checkpoint on it
        one = TrainLoop(cfg, steps=TM_STEPS, batch=TM_BATCH, seq=TM_SEQ,
                        lr=TRAIN_LR, log=_log)
        want_gn = []
        one.step_fn = _with_grad_norms(one.step_fn, want_gn)
        final = one.run()
        want = _losses(one.history)
        meta = get_model(cfg).init_params(cfg, 0, device="meta")
        step, tree, _ = Checkpointer(f"{tmp}/ckpt").restore_latest(
            {"params": meta, "opt": one.opt.init(meta)}, device="cuda")
        restored = [_pieces_match(tree, r["coords"], r["digests"])
                    for r in ranks]
        p0 = one.init_state()["params"]
        update_rel, param_max_abs = _update_rel(
            torch, tree["params"], final["params"], p0)
        last = one.data.batch(TM_BATCH, TM_SEQ, step=TM_STEPS - 1)
        unchanged_loss = float(make_eval_step(cfg, one.device)(p0, last))
        del one, tree
        half = TrainLoop(cfg, steps=TM_STEPS, batch=TM_BATCH, seq=TM_SEQ,
                         lr=TRAIN_LR, log=_log)
        whole_step = half.step_fn
        half.step_fn = lambda p, o, b: whole_step(
            p, o, {k: v[:TM_BATCH // 2] for k, v in b.items()})
        no_dp_rel, _ = _update_rel(torch, half.run()["params"],
                                   final["params"], p0)
        del half, final, p0
        torch.cuda.empty_cache()
    hist = ranks[0]["history"]
    steps = [s for s, _, _ in hist]
    by_step = {}
    for s, loss, _ in hist:
        by_step.setdefault(s, []).append(loss)
    got = [by_step[s][0] for s in range(TM_STEPS)]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    gn = ranks[0]["grad_norms"][-TM_STEPS:]          # the replayed run's
    gn_rel = [abs(a - b) / abs(b) for a, b in zip(gn, want_gn)]
    res = {"ranks_s": ranks_s, "history": hist, "one_device_losses": want,
           "rel_diff": rel, "grad_norms": ranks[0]["grad_norms"],
           "one_device_grad_norms": want_gn, "grad_norm_rel_diff": gn_rel,
           "update_rel_diff": update_rel, "param_max_abs_diff":
           param_max_abs, "unchanged_params_last_loss": unchanged_loss,
           "unchanged_rel_diff": abs(unchanged_loss - want[-1])
           / abs(want[-1]), "no_dp_reduction_update_rel_diff": no_dp_rel,
           "train_s": [r["train_s"] for r in ranks],
           "restored_step": step, "pp": ranks[0]["pp"],
           "pp_s": [r["pp_s"] for r in ranks],
           "launches": ranks[0]["launches"]}
    _log(f"train_mesh (b) {TRAIN_ARCH} at full width, {TM_LAYERS} layers, "
         f"d2x1 over gloo on one card, {TM_BATCH} x {TM_SEQ}: history "
         f"(step, loss, s) {hist}; one device {want}; relative "
         f"{rel}; gradient norms {ranks[0]['grad_norms']} against "
         f"{want_gn}, relative {gn_rel}; the mesh checkpoint (step "
         f"{step}) restored on one device: its update {update_rel:.6g} "
         f"off one device's (relative), parameters at most "
         f"{param_max_abs:.6g} apart; the last batch's loss on the "
         f"unchanged parameters {unchanged_loss} "
         f"({res['unchanged_rel_diff']:.6g} off one device's); rank 0's "
         f"half of each batch alone (no DP reduction): its update "
         f"{no_dp_rel:.6g} off; ranks' train s {res['train_s']}")
    _log(f"train_mesh (c) pp_dryrun over pod=2: {ranks[0]['pp']} "
         f"(rank 1 {ranks[1]['pp']}), s {res['pp_s']}")
    for r in ranks[1:]:
        if [(s, loss) for s, loss, _ in r["history"]] != \
                [(s, loss) for s, loss, _ in hist]:
            raise AssertionError("the ranks' losses differ")
    if steps != list(range(TM_FAIL_AT)) + list(range(TM_STEPS)):
        raise AssertionError(f"steps run {steps}")
    if any(len(set(v)) != 1 for v in by_step.values()):
        raise AssertionError(f"a replayed loss differs: {by_step}")
    if not all(x <= TM_LOSS_RTOL for x in rel):
        raise AssertionError(f"DP=2 losses {got} vs one device {want}")
    if len(ranks[0]["grad_norms"]) != len(hist) \
            or not all(x <= TM_GNORM_RTOL for x in gn_rel):
        raise AssertionError(f"DP=2 gradient norms {ranks[0]['grad_norms']}"
                             f" vs one device {want_gn}")
    if not update_rel <= TM_UPDATE_RTOL:
        raise AssertionError(f"DP=2 update {update_rel} off one device's")
    if not (res["unchanged_rel_diff"] > TM_LOSS_RTOL
            and no_dp_rel > TM_UPDATE_RTOL):
        raise AssertionError("a bound lies above its fault reading: "
                             f"{res['unchanged_rel_diff']}, {no_dp_rel}")
    if not all(restored) or step != TM_STEPS:
        raise AssertionError("the mesh checkpoint restored on one device "
                             "differs from the final state")
    for r in ranks:
        pp = r["pp"]
        if not (pp["ok"] and pp["bitwise_stages_in_turn"]
                and pp["stages"] == 2 and pp["microbatches"] == 8
                and pp["sends"] == 9):
            raise AssertionError(f"pp_dryrun on rank {r['rank']}: {pp}")
    mean, errs = _psum_restated(ranks)
    for r in ranks:
        for k in mean:
            if not (np.array_equal(r["psum"]["mean"][k], mean[k])
                    and np.array_equal(r["psum"]["err"][k],
                                       errs[r["rank"]][k])):
                raise AssertionError(f"compressed_psum_tree rank "
                                     f"{r['rank']} leaf {k} differs from "
                                     "its host re-statement")
    res["psum_bitwise_host"] = True
    _log("train_mesh (d) compressed_psum_tree over pod=2 (gloo, CUDA "
         "tensors): both ranks' means and errors bitwise the host "
         "re-statement")
    if any(v for r in ranks for v in r["launches"].values()):
        raise AssertionError(f"the ranks launched "
                             f"{[r['launches'] for r in ranks]}")
    return res


def _serve_example(torch):
    """Leg (e): ``examples/serve_dscim_torch.py`` at its reduced config
    with ``--kv int8`` (its five specs through the captured decode step),
    prepared and with ``--no-prepare``: kernel 1 launched by the
    ``kernel`` spec alone, a forward's matmuls a token, kernel 2 by every
    spec, the layers a decode step; each spec's request captures its
    step (the example's params are new tensors), and the capture's
    preparation launches kernel 1 once on each weight shape in f32 and
    bf16 and kernel 2 once; the kernel spec's tokens per call bitwise
    prepared."""
    import contextlib
    import importlib.util
    import io

    import numpy as np

    from repro_torch.configs import get_arch

    spec = importlib.util.spec_from_file_location(
        "serve_dscim_torch", ROOT / "examples" / "serve_dscim_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = get_arch("qwen3-0.6b").reduced()
    n = TM_EXAMPLE_TOKENS
    shapes = len(_mlp_sites(cfg)) + 1            # the MLP sites and head
    want = {"dscim_fused_mvm": _fused_per_forward(cfg) * n + 2 * shapes,
            "paged_attention_decode":
            len(mod.SPECS) * (cfg.n_layers * (n - 1) + 1)}
    counters = _family_counters()
    res = {}
    for tag, argv in (("prepared", ["--kv", "int8"]),
                      ("per_call", ["--kv", "int8", "--no-prepare"])):
        for c in counters.values():
            c.reset()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv)
        launches = {k: c.count for k, c in counters.items()}
        res[tag] = {"lines": buf.getvalue().splitlines(),
                    "launches": launches, "s": time.perf_counter() - t0,
                    "tokens": {t: v[0] for t, v in out.items()}}
        _log(f"train_mesh (e) serve_dscim_torch.py {' '.join(argv)}: "
             f"{res[tag]['lines']}; launches {launches} (expected {want})")
        if launches != want or len(res[tag]["lines"]) != len(mod.SPECS):
            raise AssertionError(f"serve example {tag}: {launches}")
    key = "dscim1/L256/fused-kernel"
    if not np.array_equal(res["prepared"]["tokens"][key],
                          res["per_call"]["tokens"][key]):
        raise AssertionError("--no-prepare tokens differ from prepared")
    for r in res.values():
        r["tokens"] = {t: v.tolist() for t, v in r["tokens"].items()}
    return {**res, "launches": res["prepared"]["launches"]}


def _fp8_on_card(torch):
    """Leg (f): ``fp8_cast`` and ``fp8_to_int8_aligned`` on CUDA bitwise
    the CPU's on the same values (both signs over 1e-4 to 1e3 and the
    format's edges), NaN positions included."""
    import numpy as np

    from repro_torch.core.quant import fp8_cast, fp8_to_int8_aligned

    rng = np.random.default_rng(0)
    x = (np.exp(rng.uniform(np.log(1e-4), np.log(1e3), 19200))
         * rng.choice([-1.0, 1.0], 19200)).astype(np.float32)
    edge = np.asarray([448, 464, np.nextafter(np.float32(464),
                                              np.float32(np.inf)),
                       480, np.inf, np.nan, 0.0, 2.0 ** -10], np.float32)
    x = np.concatenate([x, edge, -edge])
    cpu = torch.from_numpy(x)
    gpu = cpu.cuda()

    def same(a, b):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if a.dtype.kind != "f":
            return bool(np.array_equal(a, b))
        nan = np.isnan(a)
        return bool(np.array_equal(nan, np.isnan(b)) and np.array_equal(
            a[~nan].view(np.uint32), b[~nan].view(np.uint32)))
    ok = {"fp8_cast": same(fp8_cast(gpu), fp8_cast(cpu))}
    xa = x[:19200].reshape(64, 300)
    ga = fp8_to_int8_aligned(torch.from_numpy(xa).cuda())
    ca = fp8_to_int8_aligned(torch.from_numpy(xa))
    ok["fp8_to_int8_aligned"] = same(ga[0], ca[0]) and same(ga[1], ca[1])
    n_nan = int(torch.isnan(fp8_cast(gpu)).sum())
    _log(f"train_mesh (f) FP8 on CUDA bitwise the CPU's: {ok}; {n_nan} "
         f"NaNs of {x.size} values")
    if not all(ok.values()):
        raise AssertionError(f"FP8 on the card differs: {ok}")
    return {**ok, "nan": n_nan, "values": int(x.size)}


def train_mesh_phase(torch, train_res):
    """Phase train_mesh: training under a mesh and the paper-facing
    surface on the card: legs (a) NCCL world 1 at full width, (b)-(d) two
    gloo ranks, (e) the serving example, (f) FP8, (g) the other families
    under d1x1 (the MoE with expert parallelism)."""
    out = {}
    for name, fn, args in (("nccl_world1", _train_mesh_world1,
                            (torch, train_res)),
                           ("gloo_two_ranks", _train_mesh_gloo, (torch,)),
                           ("serve_example", _serve_example, (torch,)),
                           ("fp8", _fp8_on_card, (torch,)),
                           ("others_world1", _train_mesh_others,
                            (torch, train_res))):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        out[name]["s"] = time.perf_counter() - t0
        _log(f"train_mesh {name}: {out[name]['s']:.1f} s")
    return out


def phase_alone(torch, name: str) -> int:
    """``chip_smoke.py --phase mesh|train_mesh``: one phase alone, for
    iterating on the card without the whole run.  Builds the fused-MVM
    and paged-attention kernels, makes what the phase takes from earlier
    phases (``mesh``: qwen3-0.6b prepared once and its tokens served
    one-shot on the int8 cache; ``train_mesh``: olmo-1b trained unsharded
    for TM_A_STEPS steps, as the train phase's first steps), runs the
    phase and prints its result as one JSON line; 1 if it failed."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(("dscim_fused", "paged_attention"))
    _log(f"built in {time.perf_counter() - t0:.1f} s")
    if name == "mesh":
        from repro_torch.launch.serve import prepare_params, serve_batch
        from repro_torch.models import lm
        cfg = get_arch("qwen3-0.6b")
        prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                    (BATCH, PROMPT))
        cfg_ds = dataclasses.replace(cfg, dscim=DSCIM)
        served = prepare_params(cfg_ds, lm.init_params(cfg, 0))
        toks, _ = serve_batch(cfg_ds, served, prompts, TOKENS, kv="int8",
                              page_size=PAGE)
        _, cb_outs = continuous(torch, cfg, served)
        fn, args = mesh_phase, (torch, cfg, served, prompts, toks, cb_outs)
    elif name == "train_mesh":
        from repro_torch.launch.train import TrainLoop
        loop = TrainLoop(get_arch(TRAIN_ARCH), steps=TM_A_STEPS,
                         batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                         log=_log)
        loop.step_fn = timer = _StepTimer(torch, loop.step_fn)
        torch.cuda.reset_peak_memory_stats()
        loop.run()
        train = {"losses": _losses(loop.history), "step_ms": timer.ms(),
                 "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        del loop
        torch.cuda.empty_cache()
        train["others"] = {name: _train_other(torch, name, cut, seq)
                           for name, cut, seq in TRAIN_OTHERS}
        fn, args = train_mesh_phase, (torch, train)
    else:
        print(f"chip_smoke: --phase {name!r}: want mesh or train_mesh",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except Exception:
        traceback.print_exc()
        _log(f"phase {name} FAILED")
        return 1
    _log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out, default=str), flush=True)
    return 0


def main(argv) -> int:
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    if argv[:1] == ["--phase"]:
        print(smi[0] if smi else "nvidia-smi: no output", flush=True)
        return phase_alone(torch, argv[1])
    failures = []

    def phase(name, fn, *args):
        """Run one phase and print its wall time; a failure is reported
        and the later phases still run (one run on the card shows every
        fault), but the script fails."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:                  # report, keep going, fail at end
            traceback.print_exc()
            failures.append(name)
            _log(f"phase {name} FAILED")
            return None
        finally:
            _log(f"phase {name}: {time.perf_counter() - t0:.1f} s")

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
    cb, cb_outs = phase("continuous", continuous, torch, cfg, served) \
        or (None, None)
    pfx = phase("prefix", prefix_phase, torch, cfg, served)
    faults = phase("faults", faults_phase, torch, cfg, served, cb_outs) \
        if cb_outs is not None else None
    if cb_outs is None:
        failures.append("faults (no continuous outputs to compare)")
    wd = phase("watchdog", watchdog_phase, torch, cfg, params)
    integ = phase("integrity", integrity_phase, torch, cfg, served,
                  cb_outs) if cb_outs is not None else None
    if cb_outs is None:
        failures.append("integrity (no continuous outputs to compare)")
    rt = phase("router", router_phase, torch, cfg, served)
    spec = phase("spec", spec_phase, torch, cfg, served, prompts,
                 e2e.get("tokens"))
    modes = phase("modes", modes_phase, torch, cfg, served, prompts)
    df = phase("dense_family", dense_family, torch)
    df_fused = [phase(f"dense_family_fused {name}", check_family_fused,
                      torch, "dense_family", name) for name in DF_ARCHS]
    df_paged = phase("dense_family_paged", check_family_paged, torch,
                     [get_arch(n) for n in DF_ARCHS]
                     + [get_arch("starcoder2-7b").reduced()])
    t_moe = time.perf_counter()
    moe_fam = phase("moe_family", moe_family, torch)
    moe_fused = [c for name, layers in MOE_SERVED
                 for c in phase(f"moe_family_fused {name}",
                                check_family_fused, torch, "moe_family",
                                name, layers) or []]
    moe_paged = phase("moe_family_paged", check_family_paged, torch,
                      [get_arch(n) for n, _ in MOE_SERVED])
    cycle = phase("cycle_oracle", check_cycle_oracle, torch)
    _log(f"moe_family phases: {time.perf_counter() - t_moe:.1f} s")
    rec = phase("recurrent_family", recurrent_family, torch)
    # after recurrent_family: leg (e) holds its tokens
    mesh = phase("mesh", mesh_phase, torch, cfg, served, prompts,
                 e2e.get("tokens"), cb_outs,
                 None if rec is None else {
                     n: r["tokens"] for n, r in rec["served"].items()})
    del served
    counts = launches or {"dscim_fused_mvm": None,
                          "paged_attention_decode": None}
    kernels = [phase("dscim_fused", check_fused, torch, cfg, params, counts),
               phase("paged_attention", check_paged, torch, cfg, cache,
                     counts)]
    del cache
    for entry, name in ((kernels[0], "dscim_fused_mvm"),
                        (kernels[1], "paged_attention_decode")):
        if entry is not None and rt is not None:
            entry["launches_router"] = rt["launches"].get(name, 0)
    for entry, name, checks in ((kernels[0], "dscim_fused_mvm",
                                 [c for cs in df_fused if cs for c in cs]),
                                (kernels[1], "paged_attention_decode",
                                 df_paged or [])):
        if entry is not None:
            entry["dense_family"] = checks
            if df is not None:
                entry["launches_dense_family"] = df["launches"][name]
    for entry, name, checks in ((kernels[0], "dscim_fused_mvm", moe_fused),
                                (kernels[1], "paged_attention_decode",
                                 moe_paged)):
        if entry is not None:
            entry["moe_family"] = checks or []
            if moe_fam is not None:
                entry["launches_moe_family"] = moe_fam["launches"][name]
    if mesh is not None:
        for entry, name in ((kernels[0], "dscim_fused_mvm"),
                            (kernels[1], "paged_attention_decode")):
            if entry is not None:
                entry["launches_mesh"] = \
                    mesh["nccl_world1"]["launches"][name]
                entry["launches_mesh_knobs"] = \
                    mesh["knobs"]["launches"][name]
    for extra, name in ((spec, "launches_spec"), (pfx, "launches_prefix")):
        if extra is None:
            continue
        for entry, key in ((kernels[0], "fused"), (kernels[1], "paged")):
            if entry is not None:
                entry[name] = {n: v for n, v in extra["launches"].items()
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
    # the main path's f32 weights are done with: the training phases' cut
    # configs fill the card (train_mesh (g) gathers a second f32 copy)
    del ops_in, ops_out, params
    gc.collect()
    torch.cuda.empty_cache()
    if modes is not None and kernels[3] is not None:
        kernels[3]["launches_modes_bitmatmul"] = \
            modes["bitmatmul_count_launches"]
    if kernels[3] is not None:
        kernels[3]["cycle_oracle"] = cycle or []
    if rec is not None:
        for entry in kernels:
            if entry is not None:
                entry["launches_recurrent_family"] = \
                    rec["launches"][entry["name"]]
    train = phase("train", train_phase, torch)
    if train is not None:
        for entry in kernels:
            if entry is not None:
                entry["launches_train"] = train["launches"][entry["name"]]
    tmesh = phase("train_mesh", train_mesh_phase, torch, train)
    if tmesh is not None:
        for entry in kernels:
            if entry is not None:
                name = entry["name"]
                entry["launches_train_mesh"] = \
                    tmesh["nccl_world1"]["launches"][name] \
                    + tmesh["gloo_two_ranks"]["launches"][name] \
                    + sum(r["launches"][name] for r in
                          tmesh["others_world1"]["archs"].values())
                entry["launches_serve_example"] = \
                    tmesh["serve_example"]["launches"].get(name, 0)
    t1 = phase("table1", table1, torch)
    drift = phase("reduced_gpu_vs_cpu", check_reduced, torch)
    print(json.dumps({"kernels": kernels, "card": smi[0] if smi else None,
                      "tok_s": e2e.get("tok_s"),
                      "capture_s": e2e.get("capture_s"),
                      "loops": e2e.get("loops"), "continuous": cb,
                      "spec": spec, "modes": modes, "prefix": pfx,
                      "faults": faults, "watchdog": wd,
                      "integrity": integ, "router": rt, "mesh": mesh,
                      "dense_family": df, "moe_family": moe_fam,
                      "recurrent_family": rec, "train": train,
                      "train_mesh": tmesh,
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
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(_mesh_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--train-mesh-rank"]:
        sys.exit(_train_mesh_rank(int(sys.argv[2]), sys.argv[3],
                                  sys.argv[4]))
    sys.exit(main(sys.argv[1:]))
