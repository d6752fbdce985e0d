"""The paper's Table II experiment on the port (``repro_torch.paper
t2_llm``) against the reference's ``benchmarks/t2_llm.py``, on the CPU,
at a small size (Table I's accuracy rows: test_torch_paper_accuracy.py):

* ``t2_llm.evaluate`` on the reference's reduced qwen3-0.6b
  ``init_params`` (``convert.params_from_jax``), one eval batch, against
  the reference's ``model.forward`` + ``lm_loss`` composed as
  ``benchmarks/t2_llm.py`` composes them: for ``off``, ``exact`` and
  both ``lut`` specs the loss within 1e-5 relative and the accuracy
  within 1/256 (one of the batch's 256 tokens).  The attention's bf16
  operand rounding is off in both packages, as
  tests/test_torch_train_dscim.py holds the DS-CIM forward: a last-bit
  f32 difference before a bf16 rounding moves it by 2^-8 relative, which
  1e-5 cannot hold (``lut:dscim1:256:opt`` read 1.8e-5 with it on);
* ``paper_inject`` draws the port's counter RNG, not ``jax.random``, so
  it agrees only in distribution; its bound is derived from the port's
  own noise: with d_t the change the noise makes to token t's loss (the
  port's injected loss less its exact loss, per token) and f the share
  of tokens whose argmax the noise moves, two independent draws' mean
  losses differ with a standard deviation of about sqrt(2) sd(d) /
  sqrt(256) and their accuracies of at most sqrt(2 f / 256); each is held
  within four of those (plus one token for the accuracy);
* ``t2_llm.run(steps=2, eval_batches=1)`` returns the reference's six
  row names (``benchmarks/t2_llm.py``'s specs), finite, and ``main()``
  prints them as the reference's ``main()`` does.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import t2_llm as jt2  # noqa: E402
import repro.layers.attention as jattention  # noqa: E402
import repro_torch.layers.attention as attention  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models.lm import lm_loss as jlm_loss  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.paper import t2_llm  # noqa: E402

LOSS_RTOL = 1e-5
TOKENS = t2_llm.EVAL_BATCH * t2_llm.EVAL_SEQ
# benchmarks/t2_llm.py's rows: 'off', then its five specs
T2_NAMES = ["t2/float", "t2/exact_dscim1_256", "t2/paper_inject_dscim1_256",
            "t2/paper_inject_dscim2_64", "t2/lut_dscim1_256",
            "t2/lut_dscim1_256_opt"]
T2_EXACT_SPECS = ("off", "exact:dscim1:256", "lut:dscim1:256",
                  "lut:dscim1:256:opt")
T2_INJECT_SPECS = ("paper_inject:dscim1:256", "paper_inject:dscim2:64")


class _NoBf16:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def no_bf16(monkeypatch):
    """The attention's bf16 operand rounding off in both packages."""
    monkeypatch.setattr(jattention, "jnp", _NoBf16())
    monkeypatch.setattr(attention, "_bf16", lambda t: t)


@pytest.fixture(scope="module")
def qwen():
    """(reference cfg, reference params, port params) of reduced
    qwen3-0.6b from the reference's ``init_params(PRNGKey(0))``."""
    jcfg = jget_arch(t2_llm.ARCH).reduced()
    jp = jax.jit(lambda k: jget_model(jcfg).init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _jeval(jcfg, jp, spec):
    """``benchmarks/t2_llm.py``'s ``eval_under`` at one batch: (loss,
    accuracy).  The forward is jitted (a third of its eager time here)."""
    c = dataclasses.replace(jcfg, dscim=spec)
    b = JSyntheticLM(jcfg.vocab, seed=0).batch(
        t2_llm.EVAL_BATCH, t2_llm.EVAL_SEQ, step=t2_llm.EVAL_STEP0)
    logits = jax.jit(lambda p, t: jget_model(c).forward(
        p, c, {"tokens": t, "labels": b["labels"]})[0])(jp, b["tokens"])
    return (float(jlm_loss(logits, b["labels"])),
            float((np.asarray(logits).argmax(-1) == b["labels"]).mean()))


@pytest.mark.parametrize("spec", T2_EXACT_SPECS)
def test_t2_evaluate_matches_reference(spec, qwen, no_bf16):
    jcfg, jp, params = qwen
    want = _jeval(jcfg, jp, spec)
    got = t2_llm.evaluate(t2_llm.config(), params, spec, 1, device="cpu")
    assert abs(got[0] - want[0]) <= LOSS_RTOL * abs(want[0]), (got, want)
    assert abs(got[1] - want[1]) <= 1 / TOKENS, (got, want)


def _token_stats(params, spec):
    """Per-token losses and argmax of the port's forward under ``spec``."""
    cfg = dataclasses.replace(t2_llm.config(), dscim=spec)
    b = JSyntheticLM(cfg.vocab, seed=0).batch(
        t2_llm.EVAL_BATCH, t2_llm.EVAL_SEQ, step=t2_llm.EVAL_STEP0)
    with torch.no_grad():
        logits, _ = get_model(cfg).forward(params, cfg,
                                           torch.as_tensor(b["tokens"]))
    labels = torch.as_tensor(b["labels"], dtype=torch.int64)
    ce = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels[..., None])[..., 0]
    return ce.flatten().numpy(), logits.argmax(-1).flatten().numpy()


@pytest.mark.parametrize("spec", T2_INJECT_SPECS)
def test_t2_evaluate_inject_in_distribution(spec, qwen, no_bf16):
    jcfg, jp, params = qwen
    want = _jeval(jcfg, jp, spec)
    got = t2_llm.evaluate(t2_llm.config(), params, spec, 1, device="cpu")
    ce_x, arg_x = _token_stats(params, "exact:dscim1:256")
    ce_n, arg_n = _token_stats(params, spec)
    assert abs(float(ce_n.mean()) - got[0]) <= 1e-6 * got[0]
    loss_tol = 4 * math.sqrt(2) * float((ce_n - ce_x).std()) \
        / math.sqrt(TOKENS)
    acc_tol = 4 * math.sqrt(2 * float((arg_n != arg_x).mean()) / TOKENS) \
        + 1 / TOKENS
    assert abs(got[0] - want[0]) <= loss_tol, (got, want, loss_tol)
    assert abs(got[1] - want[1]) <= acc_tol, (got, want, acc_tol)


def test_t2_run_rows(monkeypatch, capsys):
    """``run()``'s rows, and ``main()``'s lines over them, carry the
    reference's names."""
    rows = t2_llm.run(steps=2, eval_batches=1, device="cpu")
    assert [r["name"] for r in rows] == T2_NAMES
    assert [s.replace(":", "_") for s in t2_llm.SPECS] \
        == [n.split("/")[1] for n in T2_NAMES[1:]]
    for r in rows:
        assert np.isfinite([r["loss"], r["acc"], r["delta"]]).all(), r
    monkeypatch.setattr(jt2, "run", lambda *a, **k: rows)
    monkeypatch.setattr(t2_llm, "run", lambda *a, **k: rows)
    jt2.main()
    want = capsys.readouterr().out
    t2_llm.main(device="cpu")
    assert capsys.readouterr().out == want
