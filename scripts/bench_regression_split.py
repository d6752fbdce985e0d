#!/usr/bin/env python3
"""Where the CI regression gate's two overhead legs spend their time.

    python3 scripts/bench_regression_split.py [--reps 5] [--device cpu]
                                              [--src DIR] [--tag NAME]

Serves the gate's continuous queue (the one of ``repro_torch.launch.
bench_regression``'s legs 2 and 3: the reduced qwen3-0.6b at
``kernel:dscim1:256``, 4 prompts of 8 through 2 slots, segments of 4,
int8 KV at page 4) once per variant to warm it, then ``--reps`` rounds of
every variant in turns: ``plain``; ``monitored`` (the watchdog probing
every 8 segments and a snapshot every 8 boundaries, leg 2's); ``probe``
and ``snapshot`` alone; ``scrub:2`` (leg 3's).  Each run's wall s (the
device synchronized before the clock stops) and the parts its stats
report: the segment captures and their seconds (none once the runners
of these options are kept: ``graph_captures``), the probe's bindings,
probes and their seconds, snapshots and their seconds, integrity checks
and their seconds, the host seconds of the integrity layer's and the
snapshots' functions (``host_s``); on CUDA each run's CUDA graph captures, split into the
kernels' preparation, ``torch.cuda.graph``'s entry (a synchronize and
the allocators' cache release), the step under capture, the exit (end
and instantiation) and the rest.  Prints one JSON line a run, then each
variant's min and median wall s and their ratios to ``plain``'s, and the
card's name and power limit.  ``--gate-reps N`` also runs the gate's own
legs 2 and 3 (their estimators: median of 3, interleaved min of 5) N
times each and prints every ratio.

``--series N`` first serves ``plain`` N times back to back and prints
each run's wall ms, the CUDA allocator's device allocations and frees
and the collector's collections by generation during it (``--no-gc``:
with the collector off), to tell the host's slow and fast spells from
the program's own work.

``--src DIR`` imports ``repro_torch`` from ``DIR`` (another checkout's
``src``, e.g. the parent commit's from ``git archive``), so two trees are
compared in one call; ``--tag`` names the tree in every line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _capture_parts(torch, graph_mod, parts: list):
    """Wrap ``CapturedStep.capture`` and ``torch.cuda.graph``'s entry and
    exit so each capture appends its split to ``parts``."""
    cls = torch.cuda.graph
    enter, exit_ = cls.__enter__, cls.__exit__
    capture = graph_mod.CapturedStep.capture
    box = {}

    def t_enter(self):
        t0 = time.perf_counter()
        out = enter(self)
        box["enter_end"] = time.perf_counter()
        box["enter_s"] = box["enter_end"] - t0
        return out

    def t_exit(self, *a):
        t0 = time.perf_counter()
        box["body_s"] = t0 - box["enter_end"]
        out = exit_(self, *a)
        box["exit_s"] = time.perf_counter() - t0
        return out

    def t_capture(self):
        prep = self.prepare
        if prep is not None:
            def timed_prepare(stream):
                t0 = time.perf_counter()
                prep(stream)
                box["prepare_s"] = time.perf_counter() - t0
            self.prepare = timed_prepare
        box.clear()
        t0 = time.perf_counter()
        try:
            capture(self)
        finally:
            self.prepare = prep
        total = time.perf_counter() - t0
        rec = {k: box.get(k, 0.0) for k in ("prepare_s", "enter_s",
                                              "body_s", "exit_s")}
        rec["total_s"] = total
        rec["rest_s"] = total - sum(rec[k] for k in ("prepare_s", "enter_s",
                                                     "body_s", "exit_s"))
        parts.append(rec)

    cls.__enter__, cls.__exit__ = t_enter, t_exit
    graph_mod.CapturedStep.capture = t_capture


def _host_parts(parts: dict):
    """Wrap the integrity layer's and the snapshots' functions so each
    adds its host seconds (its own syncs included) to ``parts`` under its
    name; a function called inside another is counted in both (a check's
    ``sweep`` holds both digest sweeps and its one host read)."""
    from repro_torch.core import kvcache, qweights
    from repro_torch.launch import steps
    from repro_torch.runtime import failover, integrity

    def wrap(owner, name):
        fn = getattr(owner, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
        setattr(owner, name, timed)

    for owner, name in ((qweights, "golden_weight_copy"),
                        (qweights, "weight_plane_digests"),
                        (kvcache, "page_checksums"),
                        (kvcache, "refresh_page_checksums"),
                        (kvcache, "_update_page_sums"),
                        (steps, "init_serve_state"),
                        (failover, "to_host"),
                        (integrity.IntegrityEngine, "sweep"),
                        (integrity.IntegrityEngine, "check_pages"),
                        (integrity.IntegrityEngine, "check_weights")):
        if hasattr(owner, name):      # an older tree lacks some
            wrap(owner, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[1] / "src"),
                    help="the src directory to import repro_torch from")
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--gate-reps", type=int, default=0,
                    help="then run the gate's own legs 2 and 3 "
                         "(repro_torch.launch.bench_regression) this many "
                         "times each, printing each ratio and its runs")
    ap.add_argument("--series", type=int, default=0,
                    help="first serve plain this many times back to back, "
                         "one line a run")
    ap.add_argument("--no-gc", action="store_true",
                    help="hold the collector off during --series")
    ap.add_argument("--cprofile", nargs="*", default=[],
                    help="variants to run once more under cProfile, "
                         "printing the 30 costliest functions by "
                         "cumulative host time")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.launch import graph as graph_mod
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models import lm
    from repro_torch.runtime.serving import watchdog_for_spec

    dev = resolve_device(args.device)
    spec = "kernel:dscim1:256"
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), dscim=spec)
    params = lm.init_params(cfg, 0, device=dev)
    R, prompt_len, n_tokens = 4, 8, 8
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                (R, prompt_len),
                                                dtype=np.int32)
    knobs = dict(slots=2, seg_len=4, kv="int8", page_size=4, device=dev,
                 max_new=np.linspace(2, n_tokens, R).round().astype(np.int32),
                 eos_id=-1)
    monitor = watchdog_for_spec(spec, probe_every=8)
    variants = {"plain": {},
                "monitored": dict(monitor=monitor, snapshot_every=8),
                "probe": dict(monitor=monitor),
                "snapshot": dict(snapshot_every=8),
                "scrub:2": dict(integrity="scrub:2")}
    parts: list = []
    if dev.type == "cuda":
        _capture_parts(torch, graph_mod, parts)
    host: dict = {}
    _host_parts(host)

    def run(name):
        parts.clear()
        host.clear()
        t0 = time.perf_counter()
        _, st = serve_continuous(cfg, params, prompts, n_tokens, **knobs,
                                 **variants[name])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        integ = st.get("integrity") or {}
        return {"tree": args.tag, "variant": name, "wall_s": wall,
                "serve_wall_s": st["wall_s"], "segments": st["segments"],
                "capture_s": st["capture_s"], "bindings": st["bindings"],
                "graph_captures": st.get("captures"),
                "probe_bindings": st["probe_bindings"],
                "probes": st["probes"], "probe_s": st["probe_s"],
                "snapshots": st["snapshots"],
                "integrity_checks": integ.get("checks"),
                "scrub_time_s": integ.get("scrub_time_s"),
                "captures": list(parts), "host_s": dict(host)}

    if args.series:
        import gc
        run("plain")
        if args.no_gc:
            gc.disable()
        for i in range(args.series):
            mem0 = torch.cuda.memory_stats(dev) if dev.type == "cuda" \
                else {}
            gc0 = [g["collections"] for g in gc.get_stats()]
            r = run("plain")
            mem1 = torch.cuda.memory_stats(dev) if dev.type == "cuda" \
                else {}
            print(json.dumps({
                "tree": args.tag, "series": i, "gc": not args.no_gc,
                "wall_ms": 1e3 * r["wall_s"],
                "device_allocs": mem1.get("num_device_alloc", 0)
                - mem0.get("num_device_alloc", 0),
                "device_frees": mem1.get("num_device_free", 0)
                - mem0.get("num_device_free", 0),
                "collections": [b - a for a, b in zip(
                    gc0, [g["collections"] for g in gc.get_stats()])]}),
                flush=True)
        gc.enable()
    for name in variants:
        run(name)
    walls = {name: [] for name in variants}
    for _ in range(args.reps):
        for name in variants:
            r = run(name)
            walls[name].append(r["wall_s"])
            print(json.dumps(r), flush=True)
    for name in args.cprofile:
        import cProfile
        import io
        import pstats
        prof = cProfile.Profile()
        prof.enable()
        run(name)
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative") \
            .print_stats(30)
        print(f"cProfile {args.tag} {name}:\n{buf.getvalue()}", flush=True)
    if args.gate_reps:
        from repro_torch.launch import bench_regression as br
        for i in range(args.gate_reps):
            for name, fn in (("chaos_monitor_overhead",
                              br._chaos_monitor_overhead),
                             ("integrity_overhead", br._integrity_overhead)):
                runs: dict = {}
                ratio = fn(True, dev, runs=runs)
                print(json.dumps({"tree": args.tag, "gate_leg": name,
                                  "rep": i, "ratio": ratio, "runs_s": runs}),
                      flush=True)
    base_min, base_med = min(walls["plain"]), statistics.median(walls["plain"])
    for name, w in walls.items():
        print(json.dumps({"tree": args.tag, "variant": name, "min_s": min(w),
                          "median_s": statistics.median(w),
                          "min_ratio": min(w) / base_min,
                          "median_ratio": statistics.median(w) / base_med}),
              flush=True)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
