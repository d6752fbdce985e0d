"""Training through the DS-CIM modes: the port's ``make_train_step`` with
``cfg.dscim`` set, held against the reference's ``jax.value_and_grad`` of
its ``forward`` on the same parameters (converted from the reference's
``init_params``) and the same numpy batches, on the CPU.

The gradient is the one JAX computes, not a straight-through estimator:
the int8 values and the psums made from them (exact, LUT or bitmatmul
counts and ``mvm_from_counts``' terms) are integers and carry none, so it
reaches x and w only through the dequant scales (``max|x| / 127`` per
window, and ``paper_inject``'s mean scales).  Contracts, each with the
error measured on the CPU:

* one layer (``DSCIMLinear``, M, K, N = 6, 300, 20: K padded to three
  128-row windows), float weights: the gradients of x and w within 1e-5
  of the reference's max (measured 8.4e-8) in ``exact``, ``lut`` and
  ``bitmatmul``; a window whose maximum is tied (three equal |x|, of both
  signs) shares its gradient evenly among them, as ``jnp.max`` does;
  an all-zero window and one whose maximum equals eps (where
  ``jnp.maximum`` halves the gradient) as the reference; for
  ``statistical`` and ``paper_inject`` the port's gradient less its own
  noise term's (rebuilt from ``_resolve_key``, tests/test_torch_modes.py)
  is the reference's ``exact`` gradient;
* the model (reduced olmo-1b and granite-moe-1b-a400m at 2 x 16, with
  the attention's bf16 operand rounding off in both packages, as
  tests/test_torch_train.py holds the float model): ``lut`` and
  ``exact`` at dscim1/L256, ``lut`` at dscim2/L64, ``lut+attn`` and
  ``lut`` with a stuck-at ``dscim_fault``; the
  loss within 1e-5 relative (measured 1.8e-7), the gradient norm within
  1e-4 (measured 3.8e-7) and every leaf's ||g_port - g_ref|| within 1e-4
  of ||g_ref|| (measured 1.8e-6).  A miss names the leaf and its worst
  element;
* ``bitmatmul`` (the count kernel's plain version here) trains bitwise
  ``lut``; remat on and off give the same loss and gradients bitwise
  (the noise keys are per call site, so remat's recompute draws the
  same noise);
* rwkv6-7b and zamba2-7b do not read the spec: under ``lut`` (and
  ``kernel``) their loss and gradients are ``off``'s bitwise, as the
  reference's are, and ``make_train_step`` logs that once;
* ``kernel:`` raises ``ValueError`` for the attention families (the
  reference's ``pallas_call`` has no gradient; held in
  tests/test_torch_train.py ``test_train_step_refuses_dscim_modes``);
* the layer's psums, made window by window where autograd keeps them and
  in one batched product where nothing needs a gradient, give the same
  output bitwise in every mode, float and prepared weights.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.layers.attention as jattention  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.dscim_layer import DSCIMLinear as JLinear  # noqa: E402
from repro.core.seed_search import calibrated_config as jcalib  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models.lm import lm_loss as jlm_loss  # noqa: E402
import repro_torch.layers.attention as attention  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.dscim_layer import DSCIMLinear  # noqa: E402
from repro_torch.core.qweights import prepare_linear_weight  # noqa: E402
from repro_torch.core.quant import quantize_int8  # noqa: E402
from repro_torch.core.seed_search import calibrated_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import global_norm  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

B, S = 2, 16
LAYER_RTOL = 1e-5
LOSS_RTOL, GNORM_RTOL, LEAF_RTOL = 1e-5, 1e-4, 1e-4
# (arch, spec, dscim_fault) of the model cases held against the reference
MODEL_CASES = (("olmo-1b", "lut:dscim1:256", ""),
               ("olmo-1b", "exact:dscim1:256", ""),
               ("granite-moe-1b-a400m", "lut:dscim1:256", ""),
               ("granite-moe-1b-a400m", "exact:dscim1:256", ""),
               ("olmo-1b", "lut:dscim2:64", ""),
               ("granite-moe-1b-a400m", "lut+attn:dscim1:256", ""),
               ("olmo-1b", "lut:dscim1:256", "stuck:3:40.0"))


class _NoBf16:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def _no_bf16(mp):
    """The attention's bf16 operand rounding off in both packages."""
    mp.setattr(jattention, "jnp", _NoBf16())
    mp.setattr(attention, "_bf16", lambda t: t)


@functools.lru_cache(maxsize=None)
def _jinit(name):
    jcfg = jget_arch(name).reduced()
    params = jax.jit(lambda k: jget_model(jcfg).init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def ref():
    """The reference's (loss, gradient leaves) of every MODEL_CASES entry,
    the rounding off."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _no_bf16(mp)
        for name, spec, fault in MODEL_CASES:
            jcfg = dataclasses.replace(jget_arch(name).reduced(), dscim=spec,
                                       dscim_fault=fault)
            model = jget_model(jcfg)
            jb = jax.tree.map(jnp.asarray, _batch(jcfg.vocab))

            def loss(p, jcfg=jcfg, model=model, jb=jb):
                logits, aux = model.forward(p, jcfg, jb, None)
                return jlm_loss(logits, jb["labels"]) \
                    + steps.AUX_WEIGHT * aux
            jl, jg = jax.jit(jax.value_and_grad(loss))(
                jax.tree.map(jnp.asarray, _jinit(name)))
            out[name, spec, fault] = (float(jl), [np.asarray(g, np.float64)
                                           for g in jax.tree.leaves(jg)])
    return out


class _KeepGrads:
    """An optimizer that keeps the gradients ``make_train_step`` hands it
    and updates nothing."""

    def update(self, params, grads, state, gnorm=None):
        self.grads = [g.detach().clone() for g in leaves(grads)]
        return params, state, global_norm(grads)


def _port_step(cfg, params, batch, log=None):
    """One ``make_train_step`` step on ``params``: (loss, gradient norm,
    gradient leaves)."""
    opt = _KeepGrads()
    kw = {} if log is None else {"log": log}
    step = steps.make_train_step(cfg, opt, device="cpu", **kw)
    _, _, m = step(params, None, batch)
    return float(m["loss"]), float(m["grad_norm"]), opt.grads


def _rel(want, got) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


# ---------------- one layer ----------------

M, K, N = 6, 300, 20


def _layer_inputs(edit=None):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    w = rng.normal(0, 1, (K, N)).astype(np.float32)
    ct = rng.normal(0, 1, (M, N)).astype(np.float32)
    if edit is not None:
        edit(x)
    return x, w, ct


def _ref_layer_grads(mode, x, w, ct):
    lin = JLinear(jcalib("dscim1", 256), mode=mode)
    gx, gw = jax.grad(lambda a, b: jnp.sum(lin(a, b, salt=3) * ct),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(gx), np.asarray(gw)


def _port_layer_grads(fn, x, w, ct):
    """Gradients of sum(fn(x, w) * ct) by autograd."""
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    gx, gw = torch.autograd.grad((fn(xt, wt) * torch.from_numpy(ct)).sum(),
                                 (xt, wt))
    return gx.numpy(), gw.numpy()


def _assert_close(name, want, got, rtol):
    err = np.abs(want - got)
    i = np.unravel_index(int(np.argmax(err)), err.shape)
    assert err[i] <= rtol * np.abs(want).max(), \
        f"{name}: element {i} differs by {err[i]} (want {want[i]}, got " \
        f"{got[i]})"


def _window_scales(x, w):
    """The layer's int8 scales, differentiable: sx (M, nw), sw (nw, N)."""
    g, nw = 128, -(-K // 128)
    pad = nw * g - K
    sx = quantize_int8(torch.nn.functional.pad(x, (0, pad)).reshape(M, nw, g),
                       axis=-1).scale.reshape(M, nw)
    sw = quantize_int8(torch.nn.functional.pad(w, (0, 0, 0, pad))
                       .reshape(nw, g, N), axis=1).scale.reshape(nw, N)
    return sx, sw


def _noise_term(lin, mode):
    """The noise the port's ``mode`` adds, as a function of (x, w) through
    the scales, from the layer's own key (salt 3)."""
    key = lin._resolve_key(3, K, N)
    em = lin._errmodel

    def term(x, w):
        sx, sw = _window_scales(x, w)
        if mode == "statistical":
            z = em.psum_noise(key, (M, sx.shape[1], N), 128, x.device)
            return (z * sx[:, :, None] * sw[None]).sum(1)
        s = sx.mean(1, keepdim=True) * sw.mean(0, keepdim=True)
        return em.inject_paper(torch.zeros((M, N)), key, 128) * s
    return term


@pytest.mark.parametrize("mode", ["exact", "lut", "bitmatmul",
                                  "statistical", "paper_inject"])
def test_layer_gradients_match_reference(mode):
    """x and w's gradients; the noise modes less their own noise term's
    against the reference's ``exact``."""
    x, w, ct = _layer_inputs()
    lin = DSCIMLinear(calibrated_config("dscim1", 256), mode)
    gx, gw = _port_layer_grads(lambda a, b: lin(a, b, salt=3), x, w, ct)
    if mode in ("statistical", "paper_inject"):
        nx, nw_ = _port_layer_grads(_noise_term(lin, mode), x, w, ct)
        gx, gw = gx - nx, gw - nw_
        assert np.abs(nx).max() > 0.1 * np.abs(gx).max()  # noise has one
    want_x, want_w = _ref_layer_grads("exact" if mode in (
        "statistical", "paper_inject") else mode, x, w, ct)
    _assert_close(f"{mode} dx", want_x, gx, LAYER_RTOL)
    _assert_close(f"{mode} dw", want_w, gw, LAYER_RTOL)
    # only each row's largest |x| of each window has a gradient
    assert np.count_nonzero(gx) == M * 3


def _tie(x):
    """Row 0's first window: three entries at the window's max |x|."""
    x[0, :128] = np.clip(x[0, :128], -3.0, 3.0)
    x[0, 3], x[0, 10], x[0, 20] = 5.0, 5.0, -5.0


def _zero(x):
    """Row 1's second window all zero; row 2's third window (K 256..299
    and the pad) at most eps = 1e-8, reached once (a tie with eps)."""
    x[1, 128:256] = 0.0
    x[2, 256:] = np.float32(1e-9)
    x[2, 260] = np.float32(1e-8)


@pytest.mark.parametrize("case", ["tie", "zero_and_eps"])
@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_layer_gradient_at_ties_and_empty_windows(case, mode):
    edit = _tie if case == "tie" else _zero
    x, w, ct = _layer_inputs(edit)
    lin = DSCIMLinear(calibrated_config("dscim1", 256), mode)
    gx, gw = _port_layer_grads(lambda a, b: lin(a, b, salt=3), x, w, ct)
    want_x, want_w = _ref_layer_grads(mode, x, w, ct)
    _assert_close(f"{case} dx", want_x, gx, LAYER_RTOL)
    _assert_close(f"{case} dw", want_w, gw, LAYER_RTOL)
    if case == "tie":
        tied = gx[0, [3, 10, 20]]
        assert tied[0] != 0 and tied[0] == tied[1] == -tied[2]
        assert np.count_nonzero(gx[0, :128]) == 3
    else:
        assert np.all(gx[1, 128:256] == 0)
        assert np.count_nonzero(gx[2, 256:]) == 1 and gx[2, 260] != 0
        assert np.isfinite(gx).all() and np.isfinite(gw).all()


@pytest.mark.parametrize("mode", ["exact", "lut", "bitmatmul",
                                  "statistical", "paper_inject"])
def test_layer_batched_psums_bitwise_windowed(mode):
    """No gradient wanted: every window's psums at once (one f64 product,
    or the counts then a stack); x tracked: one window at a time.  The
    same output."""
    x, w, _ = _layer_inputs()
    lin = DSCIMLinear(calibrated_config("dscim1", 256), mode)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for weight in (wt, prepare_linear_weight(wt, 128)):
        with torch.no_grad():
            batched = lin(xt, weight, salt=3)
        windowed = lin(xt.clone().requires_grad_(True), weight, salt=3)
        assert windowed.requires_grad
        assert torch.equal(batched, windowed.detach()), mode


# ---------------- the model ----------------

def _setup(name, spec, fault=""):
    cfg = dataclasses.replace(get_arch(name).reduced(), dscim=spec,
                              dscim_fault=fault)
    return cfg, params_from_jax(_jinit(name), device="cpu"), \
        _batch(cfg.vocab)


@pytest.mark.parametrize("name,spec,fault", MODEL_CASES)
def test_train_step_matches_reference(name, spec, fault, ref, monkeypatch):
    _no_bf16(monkeypatch)
    cfg, params, batch = _setup(name, spec, fault)
    loss, gnorm, grads = _port_step(cfg, params, batch)
    jl, jgrads = ref[name, spec, fault]
    assert _rel(jl, loss) <= LOSS_RTOL
    jnorm = float(np.sqrt(sum(np.sum(g * g) for g in jgrads)))
    assert _rel(jnorm, gnorm) <= GNORM_RTOL
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(
        _jinit(name))[0]]
    assert len(grads) == len(jgrads) == len(paths)
    for path, want, got in zip(paths, jgrads, grads):
        got = got.double().numpy()
        err = np.linalg.norm(want - got)
        bad = np.unravel_index(int(np.argmax(np.abs(want - got))),
                               want.shape)
        assert err <= LEAF_RTOL * np.linalg.norm(want), \
            f"{jax.tree_util.keystr(path)}: ||diff|| {err} against " \
            f"||ref|| {np.linalg.norm(want)}; worst element {bad}: " \
            f"{want[bad]} vs {got[bad]}"


def _same_port_step(a, b):
    return a[:2] == b[:2] and all(torch.equal(x, y)
                                  for x, y in zip(a[2], b[2]))


@pytest.mark.parametrize("name", ["olmo-1b", "granite-moe-1b-a400m"])
def test_bitmatmul_bitwise_lut_and_remat_bitwise(name):
    """``bitmatmul`` (plain counts here) trains bitwise ``lut``; remat on
    and off bitwise under ``bitmatmul`` and both noise modes."""
    base, params, batch = _setup(name, "off")
    runs = {}
    for spec in ("lut:dscim1:256", "bitmatmul:dscim1:256",
                 "statistical:dscim1:256", "paper_inject:dscim1:256"):
        for remat in (False, True):
            cfg = dataclasses.replace(base, dscim=spec, remat=remat)
            runs[spec, remat] = _port_step(cfg, params, batch)
        assert np.isfinite(runs[spec, False][0])
        assert _same_port_step(runs[spec, False], runs[spec, True]), spec
    assert _same_port_step(runs["lut:dscim1:256", False],
                      runs["bitmatmul:dscim1:256", False])
    assert runs["statistical:dscim1:256", False][0] != \
        runs["lut:dscim1:256", False][0]


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-7b"])
def test_recurrent_families_train_as_off(name):
    cfg, _, batch = _setup(name, "off")
    params = get_model(cfg).init_params(cfg, 0, device="cpu")
    want = _port_step(cfg, params, batch)
    for spec in ("lut:dscim1:256", "kernel:dscim1:256"):
        logs = []
        got = _port_step(dataclasses.replace(cfg, dscim=spec), params,
                         batch, log=logs.append)
        assert _same_port_step(want, got), spec
        assert len(logs) == 1 and cfg.family in logs[0] \
            and spec in logs[0]
