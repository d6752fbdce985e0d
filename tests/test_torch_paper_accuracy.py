"""The paper's Table I accuracy experiment on the port (``repro_torch.paper
t1_accuracy``) against the reference's ``benchmarks/t1_accuracy.py``, on
the CPU, at a small size, the reference run once per module:

* ``t1_accuracy.run(steps=3, widths=(64,))``, the port started from the
  reference's ``init_net(PRNGKey(0), ...)`` weights (``init=``) and fed
  the same numpy batches: the float, int8_exact and both LUT rows are
  within 2/512 (two of the 512 eval samples; the f32 SGD steps round in
  another order, which may flip an argmax at a near tie);
* the ``paper_inject`` rows draw the port's counter RNG, not
  ``jax.random``, so they agree only in distribution: each row's
  accuracy is a mean of 512 samples whose correctness the noise decides,
  so two independent draws differ with a standard deviation of at most
  sqrt(2 p (1 - p) / 512) at the rows' mean accuracy p (the variance of a
  mean of Bernoullis is largest when they share one rate); they are held
  within four of those;
* the classifier's logits under ``exact`` and both ``lut`` point sets on
  one parameter set (the reference's initial weights) within 1e-5 of the
  reference's largest logit: integer psums, f32 dequant;
* ``main()`` prints lines of the reference's names.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import t1_accuracy as jacc  # noqa: E402
from repro.core.dscim_layer import make_linear as jmake_linear  # noqa: E402
from repro_torch.core.dscim_layer import make_linear  # noqa: E402
from repro_torch.paper import t1_accuracy  # noqa: E402

WIDTH, STEPS, N_EVAL = 64, 3, 512
ACC_TOL = 2 / N_EVAL
LOGIT_RTOL = 1e-5
EXACT_ROWS = ("float", "int8_exact", "dscim1_L256_lut_paper",
              "dscim1_L256_lut_opt")


def _jinit_net():
    p = jacc.init_net(jax.random.PRNGKey(0), 192, WIDTH, 10)
    return {k: np.array(v, np.float32) for k, v in p.items()}


@pytest.fixture(scope="module")
def acc_rows():
    want = jacc.run(steps=STEPS, widths=(WIDTH,))
    got = t1_accuracy.run(steps=STEPS, widths=(WIDTH,),
                          init={WIDTH: _jinit_net()}, device="cpu")
    return want, got


def test_t1_accuracy_rows(acc_rows):
    want, got = acc_rows
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        row = g["name"].split("/")[-1]
        if row in EXACT_ROWS:
            tol = ACC_TOL
        else:
            p = (g["acc"] + w["acc"]) / 2
            tol = 4 * math.sqrt(2 * p * (1 - p) / N_EVAL)
        assert abs(g["acc"] - w["acc"]) <= tol, (g, w, tol)


@pytest.mark.parametrize("args", [("dscim1", 256, "exact"),
                                  ("dscim1", 256, "lut"),
                                  ("dscim1", 256, "lut", "opt")],
                         ids=["exact", "lut_paper", "lut_opt"])
def test_t1_accuracy_logits(args):
    """The forward under one mode on the reference's initial weights, 64
    eval rows."""
    p = _jinit_net()
    xe, _ = jacc.make_task(64, seed=1)
    want = np.asarray(jacc.fwd({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(xe), jmake_linear(*args)))
    with torch.no_grad():
        got = t1_accuracy.fwd({k: torch.as_tensor(v) for k, v in p.items()},
                              torch.as_tensor(xe), make_linear(*args)).numpy()
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_RTOL * float(np.abs(want).max()), err


def test_main_lines_match_reference(acc_rows, monkeypatch, capsys):
    """``main()`` over the rows already computed prints the reference's
    line names."""
    want_rows, got_rows = acc_rows
    monkeypatch.setattr(jacc, "run", lambda *a, **k: want_rows)
    monkeypatch.setattr(t1_accuracy, "run", lambda *a, **k: got_rows)
    jacc.main()
    want = capsys.readouterr().out.splitlines()
    t1_accuracy.main(device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert [ln.split(",")[0] for ln in got] == [ln.split(",")[0]
                                                for ln in want]
    assert all(ln.split(",")[1] == "0" for ln in got)
