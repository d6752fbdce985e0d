"""Caps torch's CPU threads in a port test process at its share of the
cores.

Every ``tests/test_torch_*.py`` calls ``cap_torch_threads(torch)`` right
after ``torch = pytest.importorskip("torch")``
(``tests/test_torch_threads.py`` checks that each does).  Torch's default
is one intra-op thread per core.  Under pytest-xdist (``-n N``) each of
the N workers would take that default, N times the cores in all, and the
port's small ops would spend their time in OpenMP barriers: one
train-loop test took 319 s under ``-n 6`` on 8 cores and 9.3 s alone.
Capped, each worker runs ``cores // N`` threads (at least one).  Outside
xdist torch keeps its default.

``set_num_interop_threads`` is left alone: torch refuses it once
inter-op work has begun, and the port's tests run no inter-op work
worth a thread of its own.  Rank processes that a test starts set one
thread themselves (``OMP_NUM_THREADS=1`` or ``torch.set_num_threads(1)``).
"""
import os


def thread_cap(cpus: int, workers: int) -> int | None:
    """The intra-op thread count for one of ``workers`` test processes on
    ``cpus`` cores; None (torch's default) outside xdist (``workers``
    0)."""
    if workers <= 0:
        return None
    return max(1, cpus // workers)


def cap_torch_threads(torch) -> int:
    """Set torch's intra-op threads to this process's share of the cores
    (``thread_cap`` of the worker count that pytest-xdist exports to each
    worker as ``PYTEST_XDIST_WORKER_COUNT``); returns the count in
    force."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    n = thread_cap(os.cpu_count() or 1, workers)
    if n is not None and torch.get_num_threads() != n:
        torch.set_num_threads(n)
    return torch.get_num_threads()
