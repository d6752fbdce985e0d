"""Per-cell cost profile (port of ``repro/launch/profile.py``): the tool
behind a change that moves a cell's roofline.

For one (arch x shape x mesh) cell, run on ``meta`` tensors as the dry
run runs it (launch/dryrun.py; nothing is allocated, no GPU), it
reports:

* the roofline terms (the H100 data sheet's peaks, not measured) and
  their deltas against a baseline JSON (a record of this tool's
  ``--out`` or of the dry run);
* the top-K largest single buffers the step makes;
* FLOPs and bytes by layer (launch/cost.py: the model function that made
  each op), in place of the reference's attribution by while loop, which
  an eager step does not have;
* bytes by op kind and payloads by collective kind.

Usage:

  PYTHONPATH=src python -m repro_torch.launch.profile --arch rwkv6-7b \\
      --shape train_4k [--multipod] [--sp] [--baseline FILE] [--out FILE]
"""
from __future__ import annotations

import argparse
import json

from ..configs import get_arch
from .dryrun import build_cell

__all__ = ["profile"]


def _top(d: dict, k: int) -> dict:
    return dict(sorted(d.items(), key=lambda kv: -kv[1])[:k])


def profile(arch: str, shape: str, multi_pod: bool = False, sp: bool = False,
            top: int = 10, baseline: str | None = None, cfg=None,
            log=print) -> dict:
    """The cell's report as a dict (roofline, memory, delta, top_buffers,
    by_layer, bytes_by_kind, collectives), also printed through ``log``.
    ``cfg``: a config to run in place of ``arch``'s (the reduced one in
    tests)."""
    cfg = cfg or get_arch(arch)
    rec = build_cell(cfg, shape, multi_pod, sp, top)
    rf = rec["roofline"]
    terms = ("t_compute_s", "t_memory_s", "t_collective_s")
    delta = {}
    if baseline:
        with open(baseline) as f:
            base = json.load(f)["roofline"]
        delta = {t: rf[t] - base[t] for t in terms}
        delta["ratio"] = {t: base[t] / rf[t] if rf[t] else None
                          for t in terms}
    out = {
        "cell": {"arch": cfg.name, "shape": shape, "mesh": rec["mesh"],
                 "sp": sp},
        "roofline": rf,
        "memory": rec["memory"],
        "delta": delta,
        "top_buffers": rec["top_buffers"][:top],
        "by_layer": {"flops": _top(rec["flops_by_layer"], top),
                     "bytes": _top(rec["bytes_by_layer"], top)},
        "bytes_by_kind": rec["bytes_by_kind_top"],
        "collectives": rec["collective_bytes_per_device"],
    }
    log(f"== {cfg.name} x {shape} x {rec['mesh']}{' +sp' if sp else ''} ==")
    log(f"dot flops/dev {rec['flops_per_device']:.3e}  bytes/dev "
        f"{rec['bytes_per_device']:.3e}  coll/dev "
        f"{rec['collective_bytes_per_device']['total']:.3e}  mem/dev "
        f"{rec['memory']['total_per_device'] / 2**30:.2f} GiB")
    log(f"t_comp {rf['t_compute_s']:.4f}s  t_mem {rf['t_memory_s']:.4f}s  "
        f"t_coll {rf['t_collective_s']:.4f}s  ({rf['peaks']})")
    if baseline:
        log("vs baseline: " + ", ".join(
            f"{t} {delta[t]:+.4f}s" for t in terms))
    log("\n-- top buffers --")
    for b in out["top_buffers"]:
        log(f"  {b['bytes'] / 2**30:8.3f} GiB  {b['op']:<28s} "
            f"{b['shape']} {b['dtype']}  in {b['layer']}")
    log("\n-- by layer (flops, bytes) --")
    for k, v in out["by_layer"]["flops"].items():
        log(f"  {v:10.3e} FLOP  {k}")
    for k, v in out["by_layer"]["bytes"].items():
        log(f"  {v / 1e12:10.4f} TB    {k}")
    log("\n-- bytes by op kind --")
    for k, v in out["bytes_by_kind"].items():
        log(f"  {v / 1e12:10.4f} TB  {k}")
    log("\n-- collectives --")
    for k, v in sorted(out["collectives"].items(), key=lambda kv: -kv[1]):
        log(f"  {v / 2**30:10.3f} GiB  {k}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="the sequence-parallel residual stream "
                         "(ParallelCtx.sp)")
    ap.add_argument("--baseline", help="a JSON written by --out or by the "
                                       "dry run: print the deltas")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--out", help="write the report as JSON here")
    args = ap.parse_args(argv)
    out = profile(args.arch, args.shape, args.multipod, args.sp, args.top,
                  args.baseline)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
