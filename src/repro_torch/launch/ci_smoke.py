"""CI serve smokes on the port (port of ``scripts/ci_smoke.py``): one
named argv preset a smoke for the operators' own entry points, so one CI
step chains several smokes and adding one is a one-line edit.

    PYTHONPATH=src python -m repro_torch.launch.ci_smoke continuous paged-kernel
    PYTHONPATH=src python -m repro_torch.launch.ci_smoke --list
    PYTHONPATH=src python -m repro_torch.launch.ci_smoke mesh --device cpu

Each preset is the reference's argv plus ``--reduced`` (the reference's
serve CLI serves the reduced config by default, the port's the published
width unless asked).  ``--device <dev>`` is passed on to every preset;
without it the smokes run on CUDA.  The serve presets run in-process
through ``launch/serve.py main``; ``router`` and ``prefix-router`` through
``launch/loadtest.py main`` (which appends to no file, so the reference's
``--no-append`` is dropped).  The three mesh presets start ``torchrun
--nproc-per-node 4 -m repro_torch.launch.serve``: the port's ``--mesh``
joins a process group of one process a device and has no single-process
form.  They need four GPUs, or ``--device cpu`` (gloo).

Smokes (reduced configs):
  continuous         staggered admission, EOS early exit, int8 paged KV
  paged-kernel       --kv int8 through the paged-attention kernel
                     (--paged-attn kernel)
  paged-jnp          the same serve through the plain paged read
                     (--paged-attn jnp): the A/B leg
  mesh               the captured generate under --mesh model=4
  mesh-paged         int8 paged KV under --mesh model=4 through the plain
                     paged read
  mesh-paged-kernel  the paged-attention kernel under --mesh model=4
  chaos              the fault-tolerant serving drill (--chaos)
  spec               self-speculative decoding through the continuous
                     scheduler (--spec dscim2:4)
  integrity          continuous int8 paged serving with integrity checks
                     (--integrity scrub:2) under the sampled chaos schedule
  integrity-drill    the self-verifying integrity drill
  prefix             the prefix-cache drill (--prefix-drill)
  prefix-router      the asyncio router replaying a shared-prefix trace,
                     warm against the cold reference (loadtest
                     --prefix-cache)
  router             the asyncio router under a mini load-test trace with
                     the sampled fault schedule (loadtest --smoke)
"""
from __future__ import annotations

import os
import subprocess
import sys

__all__ = ["SMOKES", "MESH_SMOKES", "MESH_RANKS", "argv_for", "run", "main"]

_DSCIM = "kernel:dscim1:256"
_PAGED = ["--kv", "int8", "--page-size", "4", "--eos", "7"]
_R = "--reduced"

SMOKES: dict = {
    "continuous": ["--continuous", "--requests", "6", "--batch", "2",
                   "--segment-len", "2", "--tokens", "6",
                   "--dscim", _DSCIM, *_PAGED, _R],
    "paged-kernel": ["--tokens", "8", "--batch", "4", "--dscim", _DSCIM,
                     *_PAGED, "--paged-attn", "kernel", _R],
    "paged-jnp": ["--tokens", "8", "--batch", "4", "--dscim", _DSCIM,
                  *_PAGED, "--paged-attn", "jnp", _R],
    "mesh": ["--tokens", "8", "--batch", "4", "--dscim", _DSCIM,
             "--mesh", "model=4", _R],
    "mesh-paged": ["--tokens", "8", "--batch", "4", "--dscim", _DSCIM,
                   "--mesh", "model=4", *_PAGED, "--paged-attn", "jnp", _R],
    "mesh-paged-kernel": ["--tokens", "8", "--batch", "4",
                          "--dscim", _DSCIM, "--mesh", "model=4", *_PAGED,
                          "--paged-attn", "kernel", _R],
    "chaos": ["--chaos", _R],
    "integrity": ["--continuous", "--requests", "6", "--batch", "2",
                  "--segment-len", "2", "--tokens", "6", "--dscim", _DSCIM,
                  *_PAGED, "--integrity", "scrub:2", "--sampled-chaos",
                  "--chaos-seed", "21", _R],
    "integrity-drill": ["--integrity-drill", _R],
    "spec": ["--continuous", "--requests", "6", "--batch", "2",
             "--segment-len", "2", "--tokens", "6", "--dscim", _DSCIM,
             *_PAGED, "--spec", "dscim2:4", _R],
    "router": ["--smoke", _R],
    "prefix": ["--prefix-drill", _R],
    "prefix-router": ["--smoke", "--prefix-cache", _R],
}

# smokes whose preset drives the load test rather than serve.main
_LOADTEST = ("router", "prefix-router")
# smokes served by MESH_RANKS processes under torchrun
MESH_SMOKES = ("mesh", "mesh-paged", "mesh-paged-kernel")
MESH_RANKS = 4


def argv_for(name: str, device=None) -> list:
    """The preset's argv, with ``--device`` appended when given."""
    return SMOKES[name] + (["--device", str(device)] if device else [])


def _mesh(argv: list, device) -> int:
    """One mesh preset under torchrun: MESH_RANKS ranks over NCCL, one GPU
    each, or over gloo when the CPU is asked for.  Fails at once, without
    starting a rank, on a host with fewer GPUs."""
    if device is None or str(device).startswith("cuda"):
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < MESH_RANKS:
            print(f"a mesh smoke needs {MESH_RANKS} GPUs (one rank each) "
                  f"and this host has {have}; pass --device cpu to run its "
                  "ranks on the CPU over gloo", file=sys.stderr)
            return 1
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path
                                             else ""))
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(MESH_RANKS), "-m",
         "repro_torch.launch.serve", *argv], env=env).returncode


def run(names, device=None) -> int:
    """Run the named smokes in turn; the first that fails ends the run
    with its code, an unknown name with 2."""
    unknown = [n for n in names if n not in SMOKES]
    if unknown:
        print(f"unknown smoke(s) {unknown}; have {sorted(SMOKES)}",
              file=sys.stderr)
        return 2
    for name in names:
        argv = argv_for(name, device)
        if name in _LOADTEST:
            entry = "repro_torch.launch.loadtest"
        elif name in MESH_SMOKES:
            entry = (f"torchrun --nproc-per-node {MESH_RANKS} -m "
                     "repro_torch.launch.serve")
        else:
            entry = "repro_torch.launch.serve"
        print(f"# === ci_smoke {name}: {entry} {' '.join(argv)} ===",
              flush=True)
        if name in _LOADTEST:
            from . import loadtest
            rc = loadtest.main(argv)
        elif name in MESH_SMOKES:
            rc = _mesh(argv, device)
        else:
            from . import serve
            rc = serve.main(argv)
        if rc:
            print(f"# ci_smoke {name} FAILED (rc={rc})", file=sys.stderr)
            return rc
        print(f"# ci_smoke {name} OK", flush=True)
    return 0


def main(argv=None) -> int:
    """``<name> ... [--device DEV]`` or ``--list``; no name lists the
    presets and gives 2."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print("--device needs a value", file=sys.stderr)
            return 2
        device = argv[i + 1]
        del argv[i:i + 2]
    if not argv or "--list" in argv:
        for name, args in SMOKES.items():
            entry = "loadtest" if name in _LOADTEST else "serve"
            print(f"{name}: {entry} {' '.join(args)}")
        return 0 if "--list" in argv else 2
    return run(argv, device)


if __name__ == "__main__":
    sys.exit(main())
