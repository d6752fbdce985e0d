"""Splits a port test file's time between the JAX reference and the port:
runs pytest on the given files in this process and samples the main
thread's stack every few milliseconds.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_ref_share.py \\
        tests/test_torch_spec.py [more files] [-- pytest args]

A sample counts for the JAX side when the innermost frame that belongs
to a side is in ``src/repro/``, ``jax`` or ``jaxlib``, for the port when
it is in ``src/repro_torch/``, and for neither otherwise (pytest, the
test's own numpy, imports outside both).  Native work (XLA, torch's
kernels) counts for the side whose Python frame called it.
"""
import os
import sys
import threading
import time

SIDES = {
    "jax": (os.sep + os.path.join("src", "repro") + os.sep,
            os.sep + "jax" + os.sep, os.sep + "jaxlib" + os.sep),
    "port": (os.sep + os.path.join("src", "repro_torch") + os.sep,),
}


def side_of(filename: str):
    for side, marks in SIDES.items():
        if any(m in filename for m in marks):
            return side
    return None


def classify(frame):
    """The side of the innermost frame of ``frame``'s stack that belongs
    to one, or None."""
    while frame is not None:
        side = side_of(frame.f_code.co_filename)
        if side is not None:
            return side
        frame = frame.f_back
    return None


class StackSampler:
    """Counts, every ``interval`` s, which side the watched thread is
    in; ``seconds()`` scales the counts to the sampled wall time."""

    def __init__(self, thread_id: int, interval: float = 0.005):
        self.thread_id = thread_id
        self.interval = interval
        self.counts = {side: 0 for side in SIDES} | {None: 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            frame = sys._current_frames().get(self.thread_id)
            self.counts[classify(frame)] += 1

    def __enter__(self):
        self.t0 = time.perf_counter()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.wall = time.perf_counter() - self.t0

    def seconds(self) -> dict:
        n = max(sum(self.counts.values()), 1)
        return {side: self.wall * c / n for side, c in self.counts.items()}


def main(argv=None):
    import pytest
    argv = list(sys.argv[1:] if argv is None else argv)
    files, extra = (argv[:argv.index("--")], argv[argv.index("--") + 1:]) \
        if "--" in argv else (argv, [])
    with StackSampler(threading.get_ident()) as sampler:
        rc = pytest.main(["-q", "-p", "no:cacheprovider", *extra, *files])
    print(f"pytest rc {int(rc)}, wall {sampler.wall:.1f} s")
    for side, s in sampler.seconds().items():
        name = side or "neither"
        print(f"  {name}: {s:.1f} s ({100 * s / sampler.wall:.1f} %)")
    return int(rc)


if __name__ == "__main__":
    raise SystemExit(main())
