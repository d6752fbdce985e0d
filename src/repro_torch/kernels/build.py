"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` (the
hash covers the source and the flags, so an edited source rebuilds) and
loaded with ``ctypes``.  ``build()`` starts one ``nvcc`` per source, all
at once.  Nothing here runs at import time: the CPU tests import every
module of the package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["LaunchCounter", "COUNTERS", "bind", "build", "load",
           "tile_counters", "SOURCES"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("dscim_fused", "paged_attention", "dscim_counts", "int8_matmul",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_counters: dict = {}
COUNTERS: list = []       # every LaunchCounter made, for graph replays
_retired: list = []       # outgrown tile-counter buffers, kept alive


@dataclasses.dataclass(eq=False)          # hashed by identity
class LaunchCounter:
    """Kernel launches made by one wrapper (incremented where it launches,
    nowhere else), so a run can show that its path went through it.  A
    CUDA graph's capture runs the wrappers without launching anything, so
    the graph runner (launch/graph.py) takes back what they counted there
    and adds it once per replay."""
    name: str
    count: int = 0

    def __post_init__(self):
        COUNTERS.append(self)

    def reset(self) -> None:
        self.count = 0


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cands:
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no current library, one
    ``nvcc`` process per source, all started together; raise with the
    compiler's output if any fails.  Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, so)
    errors = []
    for n, (p, tmp, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
            continue
        (BUILD_DIR / f"{so.stem}.log").write_text(log)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            _loaded[name] = lib
        return lib


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu`` (int return), loaded
    and given its argument types once, at first use."""
    fn = _bound.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _bound[(name, symbol)] = fn
    return fn


def tile_counters(device, stream: int, n: int):
    """Completion counters of the kernels that split a reduction over
    blocks (the last block of a tile adds the staged partials): at least n
    int32 zeros on ``device`` for launches on ``stream``.  Each launch
    leaves them zero, so one buffer serves every such launch in stream
    order; it is made (one fill) at first use and when it must grow.

    A CUDA graph replays the buffer of the stream it was captured on, so
    that stream's buffer must exist, large enough, before capture starts
    (the wrappers' ``prepare_capture``): making it during capture would
    put it in the graph's pool, and this raises instead."""
    import torch
    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"tile counters for {n} tiles on stream {stream:#x} made "
                "during a CUDA graph capture; prepare the kernels for "
                "capture on that stream first")
        if buf is not None:
            # a graph captured earlier may still launch on the old buffer
            _retired.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf
