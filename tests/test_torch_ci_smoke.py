"""The CI serve smokes on the port (``repro_torch.launch.ci_smoke``)
against the reference's ``scripts/ci_smoke.py``, on the CPU:

* the same thirteen preset names; each argv is the reference's
  ``SMOKES[name]`` plus ``--reduced`` (the reference's serve CLI serves
  the reduced config by default, the port's the published width), less
  ``--no-append`` (the port's load test appends to no file);
* ``--list`` prints every preset and gives 0, no name gives 2, an
  unknown name gives 2;
* ``continuous`` and ``paged-kernel`` run in-process with ``--device
  cpu`` and return 0;
* ``mesh`` runs as four gloo ranks under ``torchrun`` and returns 0;
* without ``--device cpu`` on a host without four GPUs a mesh preset
  fails at once, naming the four GPUs it needs, and starts no rank.

``scripts/ci_smoke.py`` imports JAX only inside ``run()``, which this test
does not call.
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import io  # noqa: E402
import subprocess  # noqa: E402

from repro_torch.launch import ci_smoke  # noqa: E402
from scripts import ci_smoke as jci_smoke  # noqa: E402


def test_presets_are_the_reference_s():
    assert list(ci_smoke.SMOKES) == list(jci_smoke.SMOKES)
    assert len(ci_smoke.SMOKES) == 13
    for name, jargv in jci_smoke.SMOKES.items():
        want = [a for a in jargv if a != "--no-append"] + ["--reduced"]
        assert ci_smoke.SMOKES[name] == want, name
        assert ci_smoke.argv_for(name, "cpu") == want + ["--device", "cpu"]
    assert set(ci_smoke.MESH_SMOKES) == {n for n, a in jci_smoke.SMOKES.items()
                                         if "--mesh" in a}


def _main(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = ci_smoke.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_list_and_unknown():
    rc, out, _ = _main(["--list"])
    assert rc == 0
    assert [ln.split(":")[0] for ln in out.splitlines()] \
        == list(jci_smoke.SMOKES)
    assert _main([])[0] == 2
    rc, out, err = _main(["continuous", "no-such-smoke", "--device", "cpu"])
    assert rc == 2 and "no-such-smoke" in err and "===" not in out


def test_serve_presets_on_cpu():
    rc, out, err = _main(["continuous", "paged-kernel", "--device", "cpu"])
    assert rc == 0, err[-3000:]
    assert "# ci_smoke continuous OK" in out
    assert "# ci_smoke paged-kernel OK" in out
    # each served its DS-CIM run beside 'off', at the reduced width
    assert out.count("dscim=kernel:dscim1:256 kv=int8 qwen3-0.6b (reduced) "
                     "on cpu") == 2


def test_mesh_preset_over_gloo(tmp_path, capfd, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    rc = ci_smoke.main(["mesh", "--device", "cpu"])
    out = capfd.readouterr().out
    assert rc == 0, out[-3000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve]")]
    # rank 0 alone prints: 'off' and the DS-CIM run, under the mesh
    assert len(lines) == 2, out
    assert all("(reduced) on cpu under mesh model=4" in ln for ln in lines)


def test_mesh_preset_needs_four_gpus(monkeypatch):
    """No fallback to the CPU: the preset fails before starting a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def started(*a, **k):
        raise AssertionError("a rank was started")
    monkeypatch.setattr(subprocess, "run", started)
    for name in ci_smoke.MESH_SMOKES:
        rc, _, err = _main([name])
        assert rc == 1 and "needs 4 GPUs" in err, err
