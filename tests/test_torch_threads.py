"""The thread cap of the port's CPU tests (``tests/_torch_threads.py``,
ROADMAP C16):

* every ``tests/test_torch_*.py`` imports ``cap_torch_threads`` and calls
  it on the line after ``torch = pytest.importorskip("torch")``, so that
  no port test file runs torch's one thread a core in each of the
  workers of ``pytest -n 6``;
* the cap's value: the cores over xdist's worker count, at least one,
  and torch's own count left alone outside xdist.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import os  # noqa: E402
import pathlib  # noqa: E402

import _torch_threads  # noqa: E402

TESTS = pathlib.Path(__file__).resolve().parent
SKIP_LINE = 'torch = pytest.importorskip("torch")'


def test_every_port_test_file_caps_torch_threads():
    files = sorted(TESTS.glob("test_torch_*.py"))
    assert len(files) >= 41
    missing = []
    for path in files:
        lines = path.read_text().splitlines()
        ok = (SKIP_LINE in lines
              and "from _torch_threads import cap_torch_threads" in lines
              and lines[lines.index(SKIP_LINE) + 1]
              == "cap_torch_threads(torch)")
        if not ok:
            missing.append(path.name)
    assert not missing, f"no cap_torch_threads(torch) call: {missing}"


@pytest.mark.parametrize("cpus,workers,want", [
    (8, 6, 1), (8, 4, 2), (8, 1, 8), (32, 6, 5), (4, 8, 1), (8, 0, None)])
def test_thread_cap_value(cpus, workers, want):
    assert _torch_threads.thread_cap(cpus, workers) == want


def test_cap_follows_the_xdist_worker_count(monkeypatch):
    before = torch.get_num_threads()
    try:
        monkeypatch.setattr(os, "cpu_count", lambda: 12)
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
        assert cap_torch_threads(torch) == 2 == torch.get_num_threads()
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "24")
        assert cap_torch_threads(torch) == 1 == torch.get_num_threads()
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
        torch.set_num_threads(3)
        assert cap_torch_threads(torch) == 3 == torch.get_num_threads()
    finally:
        torch.set_num_threads(before)
