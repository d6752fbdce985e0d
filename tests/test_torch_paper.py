"""The paper's host and count experiments on the port (``repro_torch.paper``)
against the reference's ``benchmarks/`` sections, on the CPU, each
reference run once per module:

* ``t3_efficiency`` (Table III, Fig. 4): the hardware model is the same
  plain arithmetic, so every row is equal to 1e-12 relative;
* ``seedsearch`` (Sec. IV-C), defaults: the same numpy grid, so the
  ``best`` strings are equal and the RMSEs equal to 1e-9 relative;
* ``t1_rmse`` (Table I) at 32 columns x 8 vectors: the counts are the
  count kernel's plain version, integers equal to the reference's LUT, so
  ``rmse_pct`` and ``bias`` agree to 1e-5 relative (f32 correction terms;
  measured equal);
* ``fig6_sparsity`` (Fig. 6(c)) at one trial: the conventional OR-MAC's
  error is host integer arithmetic, equal; the DS-CIM error to 1e-6
  relative (one f32 estimate a trial; measured equal);
* every section's ``main()`` prints lines of the reference's names and
  derived fields (``t1_rmse``'s wall time aside), and ``python -m
  repro_torch.paper`` runs a section, refuses an unknown one with exit
  code 2 and, with no device named on a host without CUDA, fails.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import contextlib  # noqa: E402
import importlib  # noqa: E402
import io  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmarks import fig6_sparsity as jfig6  # noqa: E402
from benchmarks import seedsearch as jseed  # noqa: E402
from benchmarks import t1_rmse as jt1  # noqa: E402
from benchmarks import t3_efficiency as jt3  # noqa: E402
from repro_torch.paper import (SECTIONS, fig6_sparsity, seedsearch,  # noqa: E402
                               t1_rmse, t3_efficiency)

ROOT = Path(__file__).resolve().parents[1]
T1_SIZE = {"n_cols": 32, "n_vec": 8}
FIG6_SIZE = {"n_trials": 1}
# (reference module, port module, the small run's arguments)
CHEAP = {"t3_efficiency": (jt3, t3_efficiency, {}),
         "seedsearch": (jseed, seedsearch, {}),
         "t1_rmse": (jt1, t1_rmse, T1_SIZE),
         "fig6_sparsity": (jfig6, fig6_sparsity, FIG6_SIZE)}


@pytest.fixture(scope="module")
def rows():
    """{section: (reference rows, port rows)} at the small sizes."""
    return {name: (jmod.run(**kw), mod.run(**kw, device="cpu"))
            for name, (jmod, mod, kw) in CHEAP.items()}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def test_t3_efficiency_rows(rows):
    want, got = rows["t3_efficiency"]
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        for key in ("tops_w", "tops_mm2", "area_mm2"):
            assert _rel(g[key], w[key]) <= 1e-12, (g["name"], key)
        assert g["paper"] == w["paper"]
        if w["pwr_breakdown"] is None:
            assert g["pwr_breakdown"] is None
        else:
            assert g["pwr_breakdown"].keys() == w["pwr_breakdown"].keys()
            for k, v in w["pwr_breakdown"].items():
                assert _rel(g["pwr_breakdown"][k], v) <= 1e-12, (g["name"], k)


def test_seedsearch_rows(rows):
    want, got = rows["seedsearch"]
    assert [(r["name"], r["best"]) for r in got] \
        == [(r["name"], r["best"]) for r in want]
    for g, w in zip(got, want):
        assert _rel(g["rmse"], w["rmse"]) <= 1e-9, g["name"]
        assert _rel(g["second"], w["second"]) <= 1e-9, g["name"]


def test_t1_rmse_rows(rows):
    want, got = rows["t1_rmse"]
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert _rel(g["rmse_pct"], w["rmse_pct"]) <= 1e-5, g["name"]
        assert _rel(g["bias"], w["bias"]) <= 1e-5, g["name"]
        assert g["paper_pct"] == w["paper_pct"]
        assert g["us"] > 0


def test_fig6_sparsity_rows(rows):
    want, got = rows["fig6_sparsity"]
    for g, w in zip(got, want, strict=True):
        assert (g["name"], g["product_sparsity"], g["naive_or_err"]) \
            == (w["name"], w["product_sparsity"], w["naive_or_err"])
        assert _rel(g["dscim_err_pct"], w["dscim_err_pct"]) <= 1e-6, \
            g["name"]


def _lines(main, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(**kw)
    return [ln.split(",") for ln in out.getvalue().splitlines()]


@pytest.mark.parametrize("name", list(CHEAP))
def test_main_lines_match_reference(name, rows, monkeypatch):
    """Each ``main()`` over the rows already computed: the same line names,
    and the same derived fields (``t1_rmse``'s second field is its wall
    time, which differs)."""
    jmod, mod, _ = CHEAP[name]
    want_rows, got_rows = rows[name]
    monkeypatch.setattr(jmod, "run", lambda *a, **k: want_rows)
    monkeypatch.setattr(mod, "run", lambda *a, **k: got_rows)
    if name == "seedsearch":
        monkeypatch.setattr(sys, "argv", ["seedsearch"])
        want = _lines(jmod.main)
        got = _lines(mod.main, argv=[], device="cpu")
    else:
        want, got = _lines(jmod.main), _lines(mod.main, device="cpu")
    assert [ln[0] for ln in got] == [ln[0] for ln in want]
    assert [ln[2:] for ln in got] == [ln[2:] for ln in want]


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.paper", *args],
                          env=env, capture_output=True, text=True, timeout=120)


def test_cli_sections():
    r = _cli("t3_efficiency", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    names = [ln.split(",")[0] for ln in r.stdout.splitlines()
             if not ln.startswith("#")]
    assert names == [row["name"] for row in jt3.run()]
    r = _cli("t3_efficiency", "kernel_bench", "--device", "cpu")
    assert r.returncode == 2 and "kernel_bench" in r.stderr
    assert r.stdout == ""
    assert SECTIONS == ("t1_rmse", "fig6_sparsity", "t3_efficiency",
                        "seedsearch", "t1_accuracy", "t2_llm")
    if not torch.cuda.is_available():
        # no fallback: with no device named, a section needs CUDA
        r = _cli("t3_efficiency")
        assert r.returncode == 1 and "no CUDA device" in r.stdout


@pytest.mark.parametrize("name", SECTIONS)
def test_sections_need_cuda_unless_cpu_is_asked(name, monkeypatch):
    """No fallback: every section's ``run()`` with no device named raises
    on a host without CUDA before doing any work."""
    mod = importlib.import_module(f"repro_torch.paper.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run()
