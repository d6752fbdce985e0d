"""The DS-CIM linear's remaining modes in the port (``bitmatmul``,
``statistical``, ``paper_inject``) and ``core/error_model.py``, on the CPU.

* ``ErrorModel.from_macro`` gives the reference's (mu1, sig1) to float64
  equality (the same numpy draws), and the same moment bound.
* ``bitmatmul`` (the count kernel's plain version here) is bitwise the
  port's ``lut``, with float and prepared weights, and matches the
  reference's ``bitmatmul`` to f32 rounding (rtol 2e-5 of the largest
  output, the fused tests' bar).
* The noise modes: the exact part equals the reference's ``exact`` to the
  same f32 bar; the noise's mean and std sit within 4 standard errors of
  ``mu1*g`` and ``sqrt(g)*sig1`` (statistical, per window) and of
  ``mu1*128`` and ``sqrt(128)*sig1`` (paper_inject, per output) over
  >= 1e5 draws; the same (seed, K, N, salt) gives the same noise, and
  distinct salts or seeds draw noise correlated below 4/sqrt(n).
* The model threads the reference's salt map: layer li's MLP sites
  8*li + 0..2, its attention projections 8*li + 4..7 (``+attn``) and the
  head 8*n_layers.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dscim_layer import DSCIMLinear as JLinear  # noqa: E402
from repro.core.error_model import ErrorModel as JErrorModel  # noqa: E402
from repro.core.macro import DSCIMMacro as JMacro  # noqa: E402
from repro.core.seed_search import calibrated_config as jcalib  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.dscim_layer import DSCIMLinear  # noqa: E402
from repro_torch.core.error_model import ErrorModel  # noqa: E402
from repro_torch.core.macro import DSCIMMacro  # noqa: E402
from repro_torch.core.qweights import prepare_linear_weight  # noqa: E402
from repro_torch.core.quant import quantize_int8  # noqa: E402
from repro_torch.core.seed_search import calibrated_config  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.models import lm  # noqa: E402

PRESETS = [("dscim1", 256, "paper"), ("dscim2", 64, "paper"),
           ("dscim1", 256, "opt")]


def _assert_matches(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def _operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (M, K)).astype(np.float32),
            rng.normal(0, 1, (K, N)).astype(np.float32))


@pytest.mark.parametrize("key", PRESETS)
@pytest.mark.parametrize("dist", ["uniform", "gaussian"])
def test_error_model_moments_equal_reference(key, dist):
    want = JErrorModel.from_macro(JMacro(jcalib(*key)), n_samples=50_000,
                                  dist=dist)
    got = ErrorModel.from_macro(DSCIMMacro(calibrated_config(*key)),
                                n_samples=50_000, dist=dist)
    assert (got.mu1, got.sig1, got.name) == (want.mu1, want.sig1, want.name)
    assert got.relative_moment_bound() == want.relative_moment_bound()


@pytest.mark.parametrize("key", PRESETS[:2])
@pytest.mark.parametrize("group_k", [64, 128])
def test_bitmatmul_bitwise_lut_and_matches_reference(key, group_k):
    x, w = _operands(3, 5, 200, 24)
    cfg = calibrated_config(*key)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    bit = DSCIMLinear(cfg, "bitmatmul", group_k)
    lut = DSCIMLinear(cfg, "lut", group_k)
    got = bit(xt, wt)
    assert torch.equal(got, lut(xt, wt))
    qw = prepare_linear_weight(wt, group_k)
    assert torch.equal(bit(xt, qw), got)
    want = np.asarray(JLinear(jcalib(*key), mode="bitmatmul",
                              group_k=group_k)(jnp.asarray(x),
                                               jnp.asarray(w)))
    _assert_matches(got.numpy(), want)


def _noise_parts(lin, x, w, salt):
    """(output, the reference's exact output, the noise term added)."""
    out = lin(torch.from_numpy(x), torch.from_numpy(w), salt=salt)
    want = np.asarray(JLinear(jcalib("dscim1", 256), mode="exact",
                              group_k=lin.group_k)(jnp.asarray(x),
                                                   jnp.asarray(w)))
    exact = DSCIMLinear(lin.cfg, "exact", lin.group_k)(
        torch.from_numpy(x), torch.from_numpy(w))
    return out, want, out - exact


@pytest.mark.parametrize("mode", ["statistical", "paper_inject"])
def test_noise_modes_exact_part_matches_reference(mode):
    """Subtracting the noise term, rebuilt from the error model under the
    layer's key, leaves the reference's exact product."""
    M, K, N, g = 6, 300, 20, 128
    x, w = _operands(7, M, K, N)
    lin = DSCIMLinear(calibrated_config("dscim1", 256), mode, g)
    out, want, _ = _noise_parts(lin, x, w, salt=3)
    key = lin._resolve_key(3, K, N)
    nw = -(-K // g)
    xq = quantize_int8(torch.nn.functional.pad(
        torch.from_numpy(x), (0, nw * g - K)).reshape(M, nw, g), axis=-1)
    sx = xq.scale.reshape(M, nw)
    sw = prepare_linear_weight(torch.from_numpy(w), g).scale
    em = lin._errmodel
    if mode == "statistical":
        z = em.inject(torch.zeros((M, nw, N)), key, g)
        noise = (z * sx[:, :, None] * sw[None]).sum(1)
    else:
        s = sx.mean(1, keepdim=True) * sw.mean(0, keepdim=True)
        noise = em.inject_paper(torch.zeros((M, N)), key, 128) * s
    _assert_matches((out - noise).numpy(), want)


def _within(values, mean, std):
    """Sample mean and std of ``values`` within 4 standard errors of
    (mean, std): se(mean) = std/sqrt(n), se(std) ~ std/sqrt(2n)."""
    v = values.double().flatten()
    n = v.numel()
    assert abs(float(v.mean()) - mean) <= 4 * std / np.sqrt(n)
    assert abs(float(v.std()) - std) <= 4 * std / np.sqrt(2 * n)


@pytest.mark.parametrize("key", PRESETS[:2])
def test_statistical_noise_moments(key):
    em = ErrorModel.from_macro(DSCIMMacro(calibrated_config(*key)))
    g = 128
    noise = em.inject(torch.zeros((200, 3, 200)), 11, g)
    _within(noise, em.mu1 * g, np.sqrt(g) * em.sig1)


def test_paper_inject_noise_moments():
    """Over 64 x 2048 outputs of the layer: (out - exact) / s is one
    window-magnitude error per output."""
    M, K, N = 64, 128, 2048
    x, w = _operands(2, M, K, N)
    lin = DSCIMLinear(calibrated_config("dscim2", 64), "paper_inject", 128)
    out, _, noise = _noise_parts(lin, x, w, salt=0)
    xq = quantize_int8(torch.from_numpy(x), axis=-1)
    sw = prepare_linear_weight(torch.from_numpy(w), 128).scale
    em = lin._errmodel
    _within(noise / (xq.scale * sw), em.mu1 * 128, np.sqrt(128) * em.sig1)


def test_noise_is_a_function_of_seed_shape_and_salt():
    """The same (seed, K, N, salt) draws the same noise at every call;
    another salt or seed draws noise correlated below 4/sqrt(n)."""
    M, K, N = 64, 256, 512
    x, w = _operands(9, M, K, N)
    cfg = calibrated_config("dscim1", 256)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    exact = DSCIMLinear(cfg, "exact")(xt, wt)
    for mode in ("statistical", "paper_inject"):
        lin = DSCIMLinear(cfg, mode)
        a = lin(xt, wt, salt=5) - exact
        assert torch.equal(lin(xt, wt, salt=5) - exact, a)
        others = [lin(xt, wt, salt=6) - exact, lin(xt, wt) - exact,
                  DSCIMLinear(cfg, mode, seed=1)(xt, wt, salt=5) - exact]
        n = a.numel()
        for b in others:
            r = np.corrcoef(a.flatten().double().numpy(),
                            b.flatten().double().numpy())[0, 1]
            assert abs(r) < 4 / np.sqrt(n), (mode, r)


@pytest.mark.parametrize("spec,attn", [("statistical:dscim1:256", False),
                                       ("paper_inject+attn:dscim2:64", True)])
def test_model_threads_the_reference_salt_map(spec, attn, monkeypatch):
    """Every DS-CIM call of a prefill and a decode carries its call site's
    salt: 8*li + {0, 1, 2} (MLP), 8*li + {4, 5, 6, 7} (attention, with
    '+attn') and 8*n_layers (head); each site is met once a forward."""
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), dscim=spec)
    lin = lm._linear_for(spec)
    seen = []
    real = DSCIMLinear.__call__

    def spy(self, x, w, *, salt=None):
        seen.append(salt)
        return real(self, x, w, salt=salt)

    monkeypatch.setattr(DSCIMLinear, "__call__", spy)
    params = lm.init_params(cfg, 0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    sites = (0, 1, 2) + ((4, 5, 6, 7) if attn else ())
    want = sorted([8 * li + s for li in range(cfg.n_layers) for s in sites]
                  + [8 * cfg.n_layers])
    _, cache = lm.prefill(params, cfg, tokens, capacity=12)
    assert sorted(seen) == want
    seen.clear()
    lm.decode(params, cfg, tokens[:, 0].to(torch.int32), cache)
    assert sorted(seen) == want
    assert lin is lm._linear_for(spec)


def test_modes_serve_the_reduced_model():
    """Every mode serves the reduced model end to end: ``bitmatmul``'s
    tokens and prefill logits are bitwise ``lut``'s, and the noise modes
    give finite logits that differ from ``exact``'s."""
    cfg = get_arch("qwen3-0.6b").reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
    out = {}
    for mode in ("lut", "bitmatmul", "exact", "statistical", "paper_inject"):
        c = dataclasses.replace(cfg, dscim=f"{mode}:dscim1:256")
        out[mode] = serve_batch(c, params, prompts, 4, kv="int8",
                                page_size=4, trace_logits=True,
                                device="cpu")
    np.testing.assert_array_equal(out["bitmatmul"][0], out["lut"][0])
    np.testing.assert_array_equal(np.stack(out["bitmatmul"][1]),
                                  np.stack(out["lut"][1]))
    for mode in ("statistical", "paper_inject"):
        lg = np.stack(out[mode][1])
        assert np.isfinite(lg).all()
        assert not np.array_equal(lg[0], np.stack(out["exact"][1])[0])
