"""Port parity, the rest of the dense family: olmo-1b (non-parametric
LayerNorm), codeqwen1.5-7b (MHA, untied head), starcoder2-7b (parametric
LayerNorm, the GELU MLP, q heads padded 4 -> 48 at ``.reduced()``),
musicgen-large and pixtral-12b (stub frontends: embedding inputs), each
at ``.reduced()`` with the port's parameters converted from the
reference's ``init_params``.  Contracts:

* ``layernorm`` (empty, scale, scale + bias) and the GELU MLP (float and
  ``kernel:dscim1:256``) within 1e-5 of the reference's functions;
* ``init_params``: the reference's keys and shapes (empty ``ln`` dicts
  for olmo, no ``w_gate`` for GELU, no ``embed`` for a stub frontend,
  zero pad columns of ``wq`` and pad rows of ``wo`` for starcoder2), and
  ``params_from_jax`` carries the tree over exactly;
* the token configs through ``serve_batch``, with the contracts of
  ``test_torch_model.py`` but one: ``off`` with float and int8 KV,
  tokens equal and logits within 1e-3 (qwen3's test holds 1e-4);
  ``kernel:dscim1:256`` with int8 KV, the same first token per row and
  ``logit_drift_rmse <= 1e-3``.  Why 1e-3: the prefill attention rounds
  q, k, p and v to bf16, as the reference does, so a one-ulp f32
  difference upstream (here olmo's layer-1 LayerNorm, whose mean and
  variance sum in another order than XLA's) can move an operand by one
  bf16 ulp.  Measured on the CPU for these inputs (3 rows, prompt 16, 5
  tokens): olmo-1b ``off`` max-abs 2.1e-4 (the prefill logits; its
  decode steps 2e-6), codeqwen1.5-7b 3.3e-6, starcoder2-7b 1.7e-6; the
  kernel spec's drift RMSE at most 4.4e-7 with every token equal;
* the stub configs at model level from the same seeded embeddings:
  prefill logits, then 4 decode steps on the dense cache and on the int8
  paged cache, against the reference's ``prefill({"embeds"})`` /
  ``decode({"embed"})``, within 1e-4 at ``off`` and at
  ``kernel:dscim1:256`` (the DS-CIM counts are integers; the f32 sums
  round differently): measured max-abs at most 3.5e-6 at ``off`` and
  1.4e-6 at the kernel spec on the CPU;
* the refusals (spec, ``decode_multi``, the serving loops for stub
  configs; embeddings to a token config), the paged kernel's capture
  sized by the padded q heads, and the load test's chaos schedule equal
  to the reference's (ROADMAP C9).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.serve import serve_batch as jserve_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import (ARCHS, CONTINUOUS_ARCHS,  # noqa: E402
                                 TOKEN_ARCHS, get_arch)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import logit_drift_rmse, serve_batch  # noqa: E402
from repro_torch.models import lm  # noqa: E402

NEW = ("olmo-1b", "codeqwen1.5-7b", "starcoder2-7b", "musicgen-large",
       "pixtral-12b")
TOKEN = ("olmo-1b", "codeqwen1.5-7b", "starcoder2-7b")
STUB = ("musicgen-large", "pixtral-12b")
DSCIM = "kernel:dscim1:256"


def _jtree(jp):
    return jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def converted():
    """arch -> (reference cfg, port cfg, reference params, port params),
    reduced, the port's converted from the reference's (PRNGKey(0))."""
    out = {}
    for name in NEW:
        jcfg = jget_arch(name).reduced()
        jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        out[name] = (jcfg, get_arch(name).reduced(), jp,
                     params_from_jax(_jtree(jp), device="cpu"))
    return out


def test_registry_equals_reference():
    from repro.configs import ARCHS as JARCHS
    assert set(TOKEN_ARCHS) == {"qwen3-0.6b", *TOKEN, "granite-moe-1b-a400m",
                                "deepseek-moe-16b", "rwkv6-7b", "zamba2-7b"}
    assert set(CONTINUOUS_ARCHS) == set(TOKEN_ARCHS) - {"rwkv6-7b",
                                                        "zamba2-7b"}
    assert list(ARCHS) == list(JARCHS)
    for name, cfg in ARCHS.items():
        ours = dataclasses.asdict(cfg)
        # the port's own serving knob (the reference threads it through
        # its decode batch), at its default
        assert ours.pop("paged_attn") == "auto", name
        assert ours == dataclasses.asdict(JARCHS[name]), name


@pytest.mark.parametrize("params", [None, "scale", "scale+bias"])
def test_layernorm_matches_reference(params):
    from repro.layers.norms import layernorm as jlayernorm
    from repro_torch.layers.norms import layernorm

    rng = np.random.default_rng(3)
    x = rng.normal(1.5, 3, (2, 5, 64)).astype(np.float32)
    p = {}
    if params:
        p["scale"] = rng.uniform(0.5, 1.5, (64,)).astype(np.float32)
    if params == "scale+bias":
        p["bias"] = rng.normal(0, 1, (64,)).astype(np.float32)
    got = layernorm(torch.from_numpy(x),
                    {k: torch.from_numpy(v) for k, v in p.items()})
    want = jlayernorm(jnp.asarray(x), {k: jnp.asarray(v)
                                       for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("spec", ["off", DSCIM])
def test_gelu_mlp_matches_reference(spec):
    from repro.layers.mlp import init_mlp, mlp as jmlp
    from repro.models.lm import _linear_for as jlinear_for
    from repro_torch.layers.mlp import mlp

    jp = init_mlp(jax.random.PRNGKey(4), 64, 96, "gelu")
    assert set(jp) == {"w_up", "w_down"}
    tp = params_from_jax(_jtree(jp), device="cpu")
    x = np.random.default_rng(4).normal(0, 1, (2, 3, 64)).astype(np.float32)
    jl = None if spec == "off" else jlinear_for(spec)
    tl = None if spec == "off" else lm._linear_for(spec)
    want = jmlp(jp, jnp.asarray(x), "gelu", linear=jl, salt=8)
    got = mlp(tp, torch.from_numpy(x), "gelu", linear=tl, salt=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def _shapes(tree, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            out[p] = "{}" if not v else None
            out.update(_shapes(v, p))
        else:
            out[p] = tuple(v.shape)
    return out


@pytest.mark.parametrize("name", NEW)
def test_init_params_tree_matches_reference(converted, name):
    jcfg, cfg, jp, tp = converted[name]
    ours = lm.init_params(cfg, 0, device="cpu")
    want = _shapes(_jtree(jp))
    assert _shapes(ours) == want
    assert _shapes(tp) == want              # the conversion invents nothing
    if cfg.norm == "layernorm_np":
        assert ours["layers"]["ln1"] == {} == ours["final_norm"]
    assert ("w_gate" in ours["layers"]["mlp"]) == (cfg.mlp_kind == "swiglu")
    assert ("embed" in ours) != cfg.stub_frontend
    attn = ours["layers"]["attn"]
    live = cfg.n_heads * cfg.head_dim
    assert attn["wq"].shape[-1] == cfg.q_heads * cfg.head_dim
    if cfg.head_pad_to:
        assert cfg.q_heads == 48 and live < attn["wq"].shape[-1]
        assert not attn["wq"][..., live:].any()
        assert not attn["wo"][:, live:].any()
        assert attn["wo"][:, :live].std() > 0


def _serve_both(setup, spec, kv, n=5):
    jcfg, cfg, jp, tp = setup
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 16)).astype(np.int32)
    jt, jl = jserve_batch(dataclasses.replace(jcfg, dscim=spec), jp,
                          prompts, n, kv=kv, trace_logits=True)
    tt, tl = serve_batch(dataclasses.replace(cfg, dscim=spec), tp, prompts,
                         n, kv=kv, trace_logits=True, device="cpu")
    return np.asarray(jt), np.stack(jl), tt, np.stack(tl)


@pytest.mark.parametrize("spec,kv", [("off", "float"), ("off", "int8"),
                                     (DSCIM, "int8")])
@pytest.mark.parametrize("name", TOKEN)
def test_token_config_serves_like_reference(converted, name, spec, kv):
    jt, jl, tt, tl = _serve_both(converted[name], spec, kv)
    assert tl.shape == jl.shape
    if spec == "off":
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
    else:
        np.testing.assert_array_equal(tt[:, 0], jt[:, 0])
        assert logit_drift_rmse(jt, tt, list(jl), list(tl)) <= 1e-3


_JIT = {}


def _jfn(name):
    """The reference's prefill/decode, jitted once per module."""
    if name not in _JIT:
        fn = getattr(jlm, name)
        _JIT[name] = jax.jit(fn, static_argnums=(1,),
                             static_argnames=("capacity",)) \
            if name == "prefill" else jax.jit(fn, static_argnums=(1,))
    return _JIT[name]


@pytest.mark.parametrize("spec", ["off", DSCIM])
@pytest.mark.parametrize("name", STUB)
def test_stub_config_model_level_matches_reference(converted, name, spec):
    from repro.core.kvcache import paged_from_dense as jpaged_from_dense
    from repro_torch.core.kvcache import n_pages_for, paged_from_dense

    jcfg, cfg, jp, tp = converted[name]
    jcfg = dataclasses.replace(jcfg, dscim=spec)
    cfg = dataclasses.replace(cfg, dscim=spec)
    B, S, T, ps = 2, 16, 4, 4
    emb = np.random.default_rng(7).normal(
        0, 1, (B, S + T, cfg.d_model)).astype(np.float32)
    cap = S + T
    jl0, jdense = _jfn("prefill")(jp, jcfg, {"embeds": jnp.asarray(
        emb[:, :S])}, capacity=cap)
    tl0, dense = lm.prefill(tp, cfg, None, cap,
                            embeds=torch.from_numpy(emb[:, :S]))
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), atol=1e-4,
                               rtol=0)
    _, jshort = _jfn("prefill")(jp, jcfg, {"embeds": jnp.asarray(
        emb[:, :S])})
    _, short = lm.prefill(tp, cfg, None, embeds=torch.from_numpy(
        emb[:, :S]))
    mp = n_pages_for(cap, ps)
    jcaches = {"dense": jdense,
               "paged": jpaged_from_dense(jshort["k"], jshort["v"], ps,
                                          n_pages=B * mp, max_pages=mp)}
    caches = {"dense": dense,
              "paged": paged_from_dense(short["k"], short["v"], ps,
                                        n_pages=B * mp, max_pages=mp)}
    for layout in ("dense", "paged"):
        jc, c = jcaches[layout], caches[layout]
        for t in range(T):
            e = emb[:, S + t:S + t + 1]
            jl, jc = _jfn("decode")(jp, jcfg, {"embed": jnp.asarray(e)}, jc)
            tl, c = lm.decode(tp, cfg, None, c, embed=torch.from_numpy(e))
            np.testing.assert_allclose(
                tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0,
                err_msg=f"{layout} decode step {t}")


def test_refusals(converted):
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.runtime.router import Router

    _, stub, _, sp = converted["musicgen-large"]
    _, tok, _, tp = converted["olmo-1b"]
    prompts = np.zeros((2, 8), np.int64)
    with pytest.raises(ValueError, match="token inputs"):
        steps._check_spec(stub)
    with pytest.raises(ValueError, match="stub-frontend configs are "
                                         "unsupported"):
        lm.decode_multi(sp, stub, torch.zeros((2, 3), dtype=torch.long),
                        {"pos": torch.zeros(2, dtype=torch.int32)})
    for call in (lambda: serve_batch(stub, sp, prompts, 2, device="cpu"),
                 lambda: serve_batch(stub, sp, prompts, 2, device="cpu",
                                     spec="dscim2:2"),
                 lambda: serve_continuous(stub, sp, prompts, 2,
                                          device="cpu"),
                 lambda: Router(stub, sp, device="cpu")):
        with pytest.raises(ValueError, match="stub frontend"):
            call()
    emb = torch.zeros((2, 8, tok.d_model))
    with pytest.raises(ValueError, match="not embeddings"):
        lm.prefill(tp, tok, torch.zeros((2, 8), dtype=torch.long),
                   embeds=emb)
    with pytest.raises(ValueError, match="stub frontend"):
        lm.prefill(sp, stub, torch.zeros((2, 8), dtype=torch.long))


def test_padded_heads_size_the_paged_capture(converted, monkeypatch):
    """The paged kernel's capture preparation takes n_rep from the padded
    q heads (starcoder2: 48 // 2 = 24 at ``.reduced()``), the R the live
    call derives from ``wq``'s width; and under '+attn' a zero pad column
    quantizes to zero with a finite scale."""
    from repro_torch.core.qweights import QuantizedLinearWeight
    from repro_torch.kernels import dscim_fused, paged_attention
    from repro_torch.launch import steps

    _, cfg, _, tp = converted["starcoder2-7b"]
    cfg = dataclasses.replace(cfg, dscim="kernel+attn:dscim1:256")
    prepared = steps.prepare_serving_params(cfg, tp)
    wq = prepared["layers"]["attn"]["wq"]
    assert isinstance(wq, QuantizedLinearWeight)
    live = cfg.n_heads * cfg.head_dim
    assert not wq.q[..., live:].any()
    assert torch.isfinite(wq.scale).all()
    got = {}
    monkeypatch.setattr(paged_attention, "prepare_capture",
                        lambda B, KV, R, *a: got.update(KV=KV, R=R))
    monkeypatch.setattr(dscim_fused, "prepare_capture", lambda *a: None)
    st = {"tok": torch.zeros(3, dtype=torch.int32), "params": prepared,
          "cache": steps._static_cache(cfg, 3, 16, "int8", 4, None, "cpu")}
    steps._prepare_fn(st, steps._uses(cfg, 3, None))(None)
    heads = wq.shape[-1] // cfg.head_dim      # layers/attention.py _project
    assert got == {"KV": cfg.n_kv, "R": heads // cfg.n_kv} == {"KV": 2,
                                                               "R": 24}


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("segments,seed", [(17, 3), (22, 4), (40, 11)])
def test_loadtest_chaos_schedule_equals_reference(smoke, segments, seed):
    """ROADMAP C9: the port's load test draws the reference's fault
    schedule (``benchmarks/loadtest.py`` builds it inline from the plain
    leg's segment count) for the same plain-leg segments and seed."""
    from repro.runtime.failover import FailureInjector as JInjector
    from repro_torch.launch.loadtest import LoadShape, chaos_injector

    cfg = get_arch("qwen3-0.6b").reduced()
    shape = LoadShape.smoke() if smoke else LoadShape()
    got = chaos_injector(shape, cfg, segments, seed)
    want = JInjector.sampled(
        seed, segments=max(16, segments), slots=2 if smoke else 4,
        n_layers=cfg.n_layers, page_size=4, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, device_losses=1 if smoke else 3,
        flips=2 if smoke else 6)
    for name in ("fail_at", "page_flips", "weight_flips", "macro_fault_at",
                 "macro_fault"):
        assert getattr(got, name) == getattr(want, name), name
