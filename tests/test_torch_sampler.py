"""The port's sampler (``repro_torch.launch.steps._make_sampler``) against
the reference's (``repro.launch.steps._make_sampler``).

``jax.random`` and the port's counter-based draws (``core/counter_rng``,
keyed by seed, row stream and emitted count) give different numbers, so
draws have no cross-framework contract.  The masks do: the reference's masked
logits are read off the one call it makes to ``jax.random.categorical``
(patched here to record its argument), and the port's top-k and top-p
kept sets must equal them on the same numpy logits.  The rest holds the
reference's own invariants within the port: top-1 and a tiny p are
greedy, ``topp:1.0:<t>`` is ``temp:<t>`` draw for draw, degenerate rows
fall back to greedy while healthy rows draw as before, bad specs raise,
and serving draws the same tokens per seed in every loop.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import _sample_spec, serve_batch  # noqa: E402
from repro_torch.models import lm  # noqa: E402

SPECS = ["topk:1", "topk:5:0.7", "topk:40:1.3", "topp:0.9", "topp:0.5:0.7",
         "topp:0.999:2.0", "topp:1e-6", "temp:0.8"]


def _logits(seed=0, B=6, V=256):
    rng = np.random.default_rng(seed)
    lg = rng.normal(0, 3, (B, V)).astype(np.float32)
    lg[0, :10] = lg[0, 0]                 # ties at the top
    lg[1] = np.round(lg[1])               # many ties everywhere
    return lg


def _reference_masked(spec, logits, monkeypatch):
    """The masked logits the reference's draw hands to categorical."""
    seen = {}

    def fake(key, lg, axis=-1):
        seen["lg"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", fake)
    jsteps._make_sampler(spec)(jax.random.PRNGKey(0), jnp.asarray(logits))
    return seen["lg"]


def _port_masked(spec, logits):
    draw = steps._make_sampler(spec)
    kw = draw.keywords
    return steps._mask_logits(torch.from_numpy(logits), **kw).numpy()


@pytest.mark.parametrize("spec", SPECS)
def test_masks_equal_reference(spec, monkeypatch):
    logits = _logits()
    want = _reference_masked(spec, logits, monkeypatch)
    got = _port_masked(spec, logits)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])


def _draws(spec, logits, seed, steps_n=1):
    """``steps_n`` draws of ``spec`` under seed ``seed``: row b's stream is
    b and draw s its count, as a serving loop keys them."""
    draw = steps._make_sampler(spec)
    lg = torch.from_numpy(logits)
    stream = torch.arange(lg.shape[0])
    return np.stack([draw((seed, stream, torch.full_like(stream, s)),
                          lg).numpy() for s in range(steps_n)])


def test_top1_and_tiny_p_equal_greedy():
    logits = _logits(1)
    logits[0, 3] += 100.0                  # break the built-in ties
    logits[1, 7] += 100.0
    greedy = logits.argmax(-1)
    for spec in ("topk:1", "topk:1:0.3", "topp:1e-6", "topp:1e-4:2.0"):
        for seed in range(3):
            np.testing.assert_array_equal(_draws(spec, logits, seed)[0],
                                          greedy, err_msg=spec)


def test_topp_one_is_temperature_draw_for_draw():
    logits = _logits(2)
    for t in ("0.7", "1.0", "1.8"):
        a = _draws(f"topp:1.0:{t}", logits, 5, steps_n=8)
        b = _draws(f"temp:{t}", logits, 5, steps_n=8)
        np.testing.assert_array_equal(a, b)
    # and the draws are real draws: they vary across steps
    assert len(np.unique(a[:, 2])) > 1


def test_degenerate_rows_fall_back_to_greedy():
    logits = _logits(3)
    healthy = logits.copy()
    logits[1, 5] = np.nan
    logits[2, 9] = np.inf
    logits[3] = -np.inf
    for spec in ("temp:0.8", "topk:4:1.2", "topp:0.9:0.7"):
        got = _draws(spec, logits, 11)[0]
        ok = _draws(spec, healthy, 11)[0]
        for b in (0, 4, 5):                # healthy rows draw as before
            assert got[b] == ok[b], (spec, b)
        clean = np.where(np.isnan(logits), -np.inf, logits)
        for b in (1, 2, 3):
            assert got[b] == clean[b].argmax(), (spec, b)


@pytest.fixture(scope="module")
def reduced():
    cfg = get_arch("qwen3-0.6b").reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 8))
    return cfg, params, prompts


def test_bad_sample_spec_rejected(reduced):
    cfg, params, prompts = reduced
    for spec in ("nucleus:0.9", "temp:0", "topk:4:0:1", "topp:0",
                 "topp:1.5", "topp:0.9:0"):
        with pytest.raises(ValueError):
            serve_batch(cfg, params, prompts, 4, sample=spec, device="cpu")


def test_sampled_serving_per_seed_and_across_loops(reduced):
    """Sampled serving is a function of the seed: the step loop and the
    eager host loop draw the same tokens, another seed draws others, and
    the EOS loop emits the fixed loop's tokens up to the first EOS."""
    cfg, params, prompts = reduced
    kw = dict(sample="topp:0.9:0.8", device="cpu", kv="int8", page_size=4)
    a, la = serve_batch(cfg, params, prompts, 8, rng_seed=3,
                        trace_logits=True, **kw)
    b, lb = serve_batch(cfg, params, prompts, 8, rng_seed=3, scan=False,
                        trace_logits=True, **kw)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(la), np.stack(lb))
    c, _ = serve_batch(cfg, params, prompts, 8, rng_seed=4, **kw)
    assert (a != c).any()
    eos = int(a[0, 2])
    e, _ = serve_batch(cfg, params, prompts, 8, rng_seed=3, eos_id=eos,
                       **kw)
    for row_a, row_e in zip(a, e):
        hits = np.nonzero(row_a == eos)[0]
        stop = hits[0] + 1 if len(hits) else len(row_a)
        np.testing.assert_array_equal(row_e[:stop], row_a[:stop])
        assert (row_e[stop:] == steps.PAD_ID).all()


def test_cli_sample_spec():
    class A:
        temp = top_k = top_p = None
    a = A()
    assert _sample_spec(a) == "greedy"
    a.temp = 0.5
    assert _sample_spec(a) == "temp:0.5"
    a.top_k = 4
    assert _sample_spec(a) == "topk:4:0.5"
    a.top_k, a.top_p, a.temp = None, 0.9, None
    assert _sample_spec(a) == "topp:0.9:1.0"
    a.top_k = 3
    with pytest.raises(SystemExit):
        _sample_spec(a)
