"""Port parity, training's model side: ``forward`` and ``lm_loss`` of the
four families (dense olmo-1b, MoE granite-moe-1b-a400m, RWKV6 rwkv6-7b,
Zamba2 zamba2-7b) at ``.reduced()`` in f32, their gradients by autograd,
and ``make_train_step``, against the reference's ``forward``,
``jax.value_and_grad`` and ``make_train_step`` on the same parameters
(converted from the reference's ``init_params``) and the same batches.
Contracts, each with the error measured on the CPU:

* with the bf16 rounding of the attention's q, k, p, v and of the WKV
  scan's scores and v switched off in both packages (the one place where
  the two compute other bits: a one-ulp f32 difference upstream can move
  a rounded operand by a bf16 ulp, and a 1e-7 relative change of the
  parameters moves the port's own gradients by up to 4e-4 of a leaf's
  norm): the logits within 1e-5 of their max (measured 8.4e-7), the loss
  and the MoE aux within 1e-5 relative (measured 0), every gradient leaf
  within 1e-4 of its norm, max-abs (measured 8e-7);
* with the rounding on, as both packages ship: the loss and the MoE aux
  within 1e-5 relative (measured 2.1e-6 and 2.3e-7), the logits within
  2e-3 of their max (measured 9.2e-4: olmo-1b's LayerNorm sums in
  another order than XLA's and flips a rounding), the attention's and the
  WKV scan's vector-Jacobian products, where the rounding sits, within
  1e-5 of each leaf's norm (measured 6e-6);
* three ``make_train_step`` steps from the same parameters and batches,
  rounding off: every step's loss and gradient norm within 1e-4 relative
  (measured 1.7e-7).  With the rounding on, the first step's loss is the
  forward's (above), but later steps can part: AdamW's first step moves
  each parameter by +-lr whatever its gradient's size, so a near-zero
  gradient element whose sign a flipped rounding changes moves by 2 lr,
  and the MoE's top-k routing is discontinuous (measured: granite's third
  step 1.9e-3 relative, zamba2's 5.6e-5, the others <= 7.4e-6);
* the port's own gradients bitwise the same with ``cfg.remat`` on and
  off (per-layer ``torch.utils.checkpoint``), and train steps bitwise the
  same from run to run (8 x 64 tokens, dense and MoE);
* ``make_eval_step``, ``make_prefill_step`` and ``make_decode_step``
  give what the model's functions give, bitwise;
* ``make_train_step`` refuses a 'kernel:' spec (no gradient, in the
  reference either) and takes the other DS-CIM modes
  (tests/test_torch_train_dscim.py holds them against the reference).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.layers.attention as jattention  # noqa: E402
import repro.layers.rwkv6 as jrwkv6  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402,E501
from repro.models import get_model as jget_model  # noqa: E402
from repro.models.lm import lm_loss as jlm_loss  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
import repro_torch.layers.attention as attention  # noqa: E402
import repro_torch.layers.rwkv6 as rwkv6  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

FAMILIES = ("olmo-1b", "granite-moe-1b-a400m", "rwkv6-7b", "zamba2-7b")
B, S = 2, 16


class _NoBf16:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def no_bf16(monkeypatch):
    """The attention's and the WKV scan's bf16 operand rounding off in the
    reference and in the port, for this test only."""
    monkeypatch.setattr(jattention, "jnp", _NoBf16())
    monkeypatch.setattr(jrwkv6, "jnp", _NoBf16())
    monkeypatch.setattr(attention, "_bf16", lambda t: t)
    monkeypatch.setattr(rwkv6, "_bf16", lambda t: t)


@functools.lru_cache(maxsize=None)
def _jinit(name):
    """The reference's parameters of ``name``'s reduced config (drawn once
    a process, under ``jax.jit``)."""
    jcfg = jget_arch(name).reduced()
    params = jax.jit(lambda k: jget_model(jcfg).init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _setup(name):
    jcfg, cfg = jget_arch(name).reduced(), get_arch(name).reduced()
    npp = _jinit(name)
    jparams = jax.tree.map(jnp.asarray, npp)
    params = params_from_jax(npp, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    return jcfg, cfg, jparams, params, batch


def _jloss(jcfg, batch):
    model = jget_model(jcfg)
    jb = jax.tree.map(jnp.asarray, batch)

    def loss(p):
        logits, aux = model.forward(p, jcfg, jb, None)
        return jlm_loss(logits, jb["labels"]) + steps.AUX_WEIGHT * aux, \
            (logits, aux)
    return loss


def _port_loss(cfg, params, batch):
    logits, aux = get_model(cfg).forward(
        params, cfg, torch.from_numpy(batch["tokens"]).long())
    loss = lm.lm_loss(logits, torch.from_numpy(batch["labels"])) \
        + steps.AUX_WEIGHT * aux
    return loss, logits, aux


def _rel(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    assert want.shape == got.shape
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _leaf_errs(jgrads, grads):
    """Each gradient leaf's max-abs error over its norm."""
    out = []
    for want, got in zip(jax.tree.leaves(jgrads), grads):
        want = np.asarray(want, np.float64)
        out.append(float(np.abs(want - got.double().numpy()).max()
                         / max(np.linalg.norm(want), 1e-30)))
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_grads_and_train_steps_match_reference(name, no_bf16):
    """The rounding off in both: logits, loss, aux and every gradient leaf;
    then three train steps of each package from the same parameters and
    batches."""
    jcfg, cfg, jparams, params, batch = _setup(name)
    (jl, (jlogits, jaux)), jgrads = jax.jit(jax.value_and_grad(
        _jloss(jcfg, batch), has_aux=True))(jparams)
    flat = [p.requires_grad_(True) for p in leaves(params)]
    loss, logits, aux = _port_loss(cfg, params, batch)
    grads = torch.autograd.grad(loss, flat)
    assert logits.shape == (B, S, cfg.vocab_padded)
    assert _rel(jlogits, logits) <= 1e-5
    assert _rel(jl, loss) <= 1e-5 and _rel(jaux, aux) <= 1e-5
    assert len(grads) == len(jax.tree.leaves(jgrads))
    assert max(_leaf_errs(jgrads, grads)) <= 1e-4

    sched = (1e-3, 1, 10)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(*sched))
    opt = adamw.AdamW(lr=adamw.cosine_schedule(*sched))
    jstep = jax.jit(jmake_train_step(jcfg, None, jopt))
    step = steps.make_train_step(cfg, opt, device="cpu")
    jstate, state = jopt.init(jparams), opt.init(params)
    rng = np.random.default_rng(1)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jparams, jstate, jm = jstep(jparams, jstate,
                                    jax.tree.map(jnp.asarray, b))
        params, state, m = step(params, state, b)
        assert _rel(jm["loss"], m["loss"]) <= 1e-4
        assert _rel(jm["grad_norm"], m["grad_norm"]) <= 1e-4


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_as_shipped_matches_reference(name):
    """The rounding on, as both packages ship it: the loss and the aux at
    the contract's bar, the logits at the bar a flipped rounding leaves."""
    jcfg, cfg, jparams, params, batch = _setup(name)
    (jl, (jlogits, jaux)) = jax.jit(_jloss(jcfg, batch))(jparams)
    with torch.no_grad():
        loss, logits, aux = _port_loss(cfg, params, batch)
    assert _rel(jl, loss) <= 1e-5 and _rel(jaux, aux) <= 1e-5
    assert _rel(jlogits, logits) <= 2e-3
    if cfg.family == "moe":
        assert float(aux) > 0


@pytest.mark.parametrize("which", ["attention", "wkv6"])
def test_vjp_through_the_bf16_roundings(which):
    """The layers holding the rounding, reference against port, as
    shipped: output and every input's vector-Jacobian product."""
    rng = np.random.default_rng(2)
    if which == "attention":
        cfg, jcfg = get_arch("zamba2-7b").reduced(), \
            jget_arch("zamba2-7b").reduced()
        jp = jattention.init_attention(jax.random.PRNGKey(1), cfg.d_model,
                                       cfg.n_heads, cfg.n_kv, cfg.head_dim,
                                       cfg.qk_norm)
        x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
        pos = np.arange(S)[None]
        jf = lambda p, x: jattention.attention(  # noqa: E731
            p, x, jcfg, jnp.asarray(pos), jcfg.q_chunk, jcfg.kv_chunk)[0]
        tf = lambda p, x: attention.attention(  # noqa: E731
            p, x, cfg, torch.from_numpy(pos), cfg.q_chunk)[0]
        args = (jp, x)
    else:
        H, dk, c = 4, 16, 8
        r, k, v = (rng.normal(0, 1, (B, S, H, dk)).astype(np.float32)
                   for _ in range(3))
        lw = -rng.uniform(1e-4, 4.0, (B, S, H, dk)).astype(np.float32)
        u = rng.normal(0, 0.3, (H, dk)).astype(np.float32)
        s0 = rng.normal(0, 0.5, (B, H, dk, dk)).astype(np.float32)
        jf = lambda *a: jrwkv6.wkv6(*a, chunk=c)  # noqa: E731
        tf = lambda *a: rwkv6.wkv6(*a, chunk=c)  # noqa: E731
        args = (r, k, v, lw, u, s0)
    jargs = jax.tree.map(jnp.asarray, args)
    jout = jax.jit(jf)(*jargs)
    cts = jax.tree.map(
        lambda o: rng.normal(0, 1, o.shape).astype(np.float32), jout)
    jgrads = jax.jit(lambda a, c: jax.vjp(jf, *a)[1](c))(
        jargs, jax.tree.map(jnp.asarray, cts))
    targs = params_from_jax({str(i): jax.tree.map(np.asarray, a)
                             for i, a in enumerate(args)}, device="cpu")
    flat = [t.requires_grad_(True) for t in leaves(targs)]
    touts = tf(*(targs[str(i)] for i in range(len(args))))
    touts = touts if isinstance(touts, tuple) else (touts,)
    grads = torch.autograd.grad(
        touts, flat, [torch.from_numpy(c) for c in jax.tree.leaves(cts)])
    for want, got in zip(jax.tree.leaves(jout), touts):
        assert _rel(want, got) <= 1e-5
    assert max(_leaf_errs(jgrads, grads)) <= 1e-5


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_gives_the_same_gradients_bitwise(name):
    base = get_arch(name).reduced()
    rng = np.random.default_rng(3)
    b = {"tokens": rng.integers(0, base.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, base.vocab, (B, S)).astype(np.int32)}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        params = get_model(cfg).init_params(cfg, 0, device="cpu")
        flat = [p.requires_grad_(True) for p in leaves(params)]
        loss, _, _ = _port_loss(cfg, params, b)
        out.append((loss.detach(), torch.autograd.grad(loss, flat)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("name", ["olmo-1b", "granite-moe-1b-a400m"])
def test_train_steps_are_deterministic(name):
    """Four runs of two steps from the same start give the same bits: the
    differentiated gathers with repeated rows (the token embedding, an
    MoE token's k copies) go through ``F.embedding``, whose backward sums
    the repeats in a fixed order (at 8 x 64 tokens an index's backward
    added them in a varying order on the CPU, and the runs differed)."""
    from repro_torch.data.synthetic import SyntheticLM

    cfg = get_arch(name).reduced()
    data = SyntheticLM(cfg.vocab)
    batches = [data.batch(8, 64, step=s) for s in range(2)]
    runs = []
    for _ in range(4):
        params = get_model(cfg).init_params(cfg, 0, device="cpu")
        opt = adamw.AdamW(lr=1e-3)
        state = opt.init(params)
        step = steps.make_train_step(cfg, opt, device="cpu")
        out = []
        for b in batches:
            params, state, m = step(params, state, b)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((out, [p.detach().clone() for p in leaves(params)]))
    for out, ps in runs[1:]:
        assert out == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(ps, runs[0][1]))


def test_eval_prefill_and_decode_steps():
    jcfg, cfg, _, params, batch = _setup("olmo-1b")
    with torch.no_grad():
        logits, _ = lm.forward(params, cfg,
                               torch.from_numpy(batch["tokens"]).long())
        want = lm.lm_loss(logits, torch.from_numpy(batch["labels"]))
    got = steps.make_eval_step(cfg, device="cpu")(params, batch)
    assert torch.equal(got, want)
    toks = torch.from_numpy(batch["tokens"]).long()
    cap = S + 2
    want_l, want_c = lm.prefill(params, cfg, toks, cap)
    got_l, got_c = steps.make_prefill_step(cfg, cap)(params,
                                                     {"tokens": toks})
    assert torch.equal(got_l, want_l)
    tok = torch.argmax(got_l, -1)
    want_t, want_lg, _ = steps.make_decode_step(cfg, return_logits=True)(
        params, {"token": tok}, want_c)
    got_t, got_c = steps.make_decode_step(cfg)(params, {"token": tok}, got_c)
    assert torch.equal(got_t, want_t)
    assert torch.equal(want_t, torch.argmax(want_lg, -1).to(torch.int32))
    assert torch.equal(got_c["pos"], want_c["pos"])


@pytest.mark.parametrize("spec", ["kernel:dscim1:256", "kernel:dscim2:64"])
def test_train_step_refuses_dscim_modes(spec):
    """'kernel' is refused for the dense and MoE families (the fused MVM
    has no gradient, in the reference either); 'float' is taken
    (tests/test_torch_train_dscim.py trains through the other modes
    against the reference)."""
    for name in ("olmo-1b", "granite-moe-1b-a400m"):
        cfg = dataclasses.replace(get_arch(name).reduced(), dscim=spec)
        with pytest.raises(ValueError, match="no gradient"):
            steps.make_train_step(cfg, adamw.AdamW(), device="cpu")
    ok = dataclasses.replace(cfg, dscim="float:dscim1:256")
    steps.make_train_step(ok, adamw.AdamW(), device="cpu")
