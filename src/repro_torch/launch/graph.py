"""One decode step (or one speculative draft/verify window) captured as a
CUDA graph and replayed (the port's counterpart of the reference's jitted
``lax.scan``/``while_loop`` carry).

``CapturedStep`` wraps a step function that reads and writes only static
tensors (the serve state, the KV cache, the output buffers, the
parameters) in place.  On CUDA its first ``run`` prepares the kernels for
capture, captures one call of the step on a side stream, and every ``run``
replays it: one host call per decode step instead of one per kernel.  On
the CPU there are no graphs, and ``run`` calls the step itself.

What capture needs, and where it is met:

* no host read on the step (``.item()``, ``bool()``, ``nonzero``, boolean
  masks): the step functions in ``launch/steps.py`` have none, and the
  paged flush is written without one (``layers/attention.py``);
* no host-to-device copy and no lazily made buffer: ``prepare`` (the
  kernel wrappers' ``prepare_capture``) runs before capture, and the
  wrappers raise if they would make one during it;
* static addresses: the step writes its results into buffers made before
  capture, and ``decode`` advances ``pos`` in place; the runners replay a
  graph only for params at the addresses it was captured with
  (``steps._binding``);
* random draws: the sampler's uniforms and the noise modes' normals are
  hashed on the device from integer keys held in static tensors
  (``core/counter_rng``), so a replay draws what an eager call would,
  with no generator state;
* launch counts: the kernel wrappers count in Python, which a replay does
  not run, so the counts the capture made are taken back and added once
  per replay (``chip_smoke.py``'s profile phase holds the counts so made
  against the kernel calls the profiler sees the device run);
* memory: what the step allocates during capture (the wrappers' outputs
  and scratch) comes from the graph's private pool, which eager code
  never reuses while the graph lives;
* tile counters: the kernels that combine split work in their last block
  share a zeroed counter buffer per stream (``build.tile_counters``).
  Every graph is captured on one side stream (``capture_stream``), so
  its kernels use that stream's buffer, while eager launches on the
  current stream use another; graphs replay in stream order, and each
  launch leaves the buffer zero.

A capture or replay failure raises; nothing falls back to eager steps.
"""
from __future__ import annotations

import time

import torch

from ..kernels import build

__all__ = ["CapturedStep", "capture_stream"]

_STREAMS: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream every graph of ``device`` is captured on, so
    the kernels' per-stream buffers are made for it once."""
    s = _STREAMS.get(device)
    if s is None:
        s = torch.cuda.Stream(device)
        _STREAMS[device] = s
    return s


class CapturedStep:
    """``step()`` replayed as a CUDA graph on CUDA, called directly on the
    CPU.  ``prepare(stream)`` makes what the step's kernels need before
    capture.  ``capture_s`` is the time the last capture took,
    ``captures`` how many were made."""

    def __init__(self, step, device: torch.device, prepare=None):
        self.step = step
        self.device = torch.device(device)
        self.prepare = prepare
        self.graph = None
        self.launches: dict = {}
        self.capture_s = 0.0
        self.captures = 0

    def capture(self) -> None:
        """Capture ``step`` once (after ``prepare``); raises on failure."""
        if self.device.type != "cuda":
            raise ValueError(f"no CUDA graph on {self.device}")
        t0 = time.perf_counter()
        self.graph = None
        stream = capture_stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        if self.prepare is not None:
            self.prepare(stream)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = {c: c.count for c in build.COUNTERS}
        try:
            with torch.cuda.graph(graph, stream=stream):
                self.step()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the decode step "
                               f"failed: {e}") from e
        finally:
            # the capture launched nothing: take its counts back
            self.launches = {c: c.count - n for c, n in before.items()
                             if c.count != n}
            for c, n in before.items():
                c.count = n
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.captures += 1

    def run(self) -> None:
        """One step: a replay on CUDA (capturing first if needed), the
        step itself on the CPU."""
        if self.device.type != "cuda":
            self.step()
            return
        if self.graph is None:
            self.capture()
        self.graph.replay()
        for c, n in self.launches.items():
            c.count += n
