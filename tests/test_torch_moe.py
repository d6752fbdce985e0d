"""Port parity, the MoE family: ``layers/moe.py`` and granite-moe-1b-a400m
(32 routed experts, top-8, no shared expert) and deepseek-moe-16b (64
routed, top-6, 2 shared) at ``.reduced()`` (8 experts, top-2, capacity
factor 8.0, deepseek with one shared expert), the port's parameters
converted from the reference's ``init_params``.  Contracts:

* the MoE layer on the same numpy inputs: the router's expert ids and the
  dispatch's drop mask exactly the reference's (its ``_route`` ids; its
  sort, ``searchsorted`` and capacity test recomputed with ``jnp`` from
  those ids), with and without a shared expert (float and
  ``kernel:dscim1:256``), at capacity 8.0 and 0.25 (where pairs drop),
  and at the published configs' experts and capacity 1.25 over 256
  tokens (drops too);
  the routing weights within 1e-6, the outputs within 1e-5 (f32
  rounding: the router's matmul and the combine's sums run in another
  order); the reference's ``test_moe_capacity_drops_bounded`` property;
* ``init_params``: the reference's tree, keys and shapes;
  ``prepare_dscim_params`` prepares exactly the reference's leaves (the
  shared expert and the head; not the router or the routed experts);
* both configs at model level: prefill logits, then 3 decode steps on
  the dense and on the int8 paged cache, within 1e-3 of the reference's
  at ``off`` and ``kernel:dscim1:256``.  Why 1e-3, the dense family's
  bound for its served token configs: the prefill attention rounds q, k,
  p and v to bf16, as the reference does, so a one-ulp f32 difference
  upstream (here the router's f32 matmul, summed in another order than
  XLA's) can move an operand by one bf16 ulp.  Measured on the CPU:
  deepseek-moe-16b's ``off`` prefill 4.5e-4, every other logit at most
  1.2e-5;
* ``serve_batch``: greedy tokens at ``off`` (float and int8 KV) equal and
  the logit trace within 1e-3; ``kernel:dscim1:256`` with int8 KV, every
  token equal and ``logit_drift_rmse <= 1e-2`` (the reference's own bound
  on the int8 cache's logit drift); ``kernel:dscim2:64`` with int8 KV
  held the same way against the reference run with its plain paged read
  (``paged_attn='jnp'``): its Pallas read at that spec fails the
  reference's own test (ROADMAP C3).  Why 1e-2 and not the dense
  family's 1e-3: the int8 path rounds each decoded token's k and v to the
  bf16 tail, where a one-ulp f32 difference can move one bf16 ulp (4e-3
  relative), and the estimator quantizes the head's activations, which
  moves whole levels.  Measured on the CPU: granite-moe-1b-a400m at
  ``kernel:dscim1:256`` drifts 1.7e-3 with every token equal (row 1 of
  its first decode step is already 5.1e-5 off when both decode the
  reference's own paged cache; with the float cache it stays within
  5e-6), the other runs at most 3.8e-7;
* within the port: spec (``dscim2:2``) tokens bitwise the plain loop's,
  continuous serving bitwise one-shot per request, prefix hits bitwise
  cold, MoE configs refused by nothing (``TOKEN_ARCHS`` lists them);
* ``models/registry.py get_model`` as the reference's for every family
  (``models/rwkv.py`` and ``models/zamba.py`` for the ssm and hybrid
  ones, which ``lm.init_params`` refuses);
* the cache accounting (``paged_cache_specs``, ``kv_cache_bytes``,
  ``dense_cache_bytes``) and ``dequantize_page`` equal to the
  reference's.
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
from repro_torch.configs import TOKEN_ARCHS, get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    logit_drift_rmse, serve_batch, serve_continuous)
from repro_torch.layers import moe  # noqa: E402
from repro_torch.models import lm  # noqa: E402

MOE = ("granite-moe-1b-a400m", "deepseek-moe-16b")
DSCIM = "kernel:dscim1:256"
ATOL = 1e-3
KV_INT8_DRIFT = 1e-2


def _jtree(jp):
    return jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def converted():
    """arch -> (reference cfg, port cfg, reference params, port params),
    reduced, the port's converted from the reference's (PRNGKey(0))."""
    out = {}
    for name in MOE:
        jcfg = jget_arch(name).reduced()
        jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        out[name] = (jcfg, get_arch(name).reduced(), jp,
                     params_from_jax(_jtree(jp), device="cpu"))
    return out


# -- the layer ---------------------------------------------------------------

def _jkeep(ids, E, C):
    """The reference's dispatch (``repro/layers/moe.py moe``) from its
    ids: the drop mask in expert-sorted order and the sort order."""
    flat = ids.reshape(-1)
    order = jnp.argsort(flat)
    sids = flat[order]
    pos = jnp.cumsum(jnp.ones_like(sids)) - 1
    starts = jnp.searchsorted(sids, jnp.arange(E), side="left")
    return np.asarray(pos - starts[sids] < C), np.asarray(order)


# (has shared, spec, experts, top-k, tokens, capacity factor): the
# reduced configs' 8 of top-2 with no drop (8.0) and with drops (0.25),
# and the published configs' expert counts at their capacity 1.25 over a
# 4 x 64 prefill's 256 tokens, where random routing drops pairs
LAYER_CASES = [(0, "off", 8, 2, 24, 8.0), (1, "off", 8, 2, 24, 8.0),
               (1, DSCIM, 8, 2, 24, 8.0), (0, "off", 8, 2, 24, 0.25),
               (1, "off", 8, 2, 24, 0.25), (1, DSCIM, 8, 2, 24, 0.25),
               (0, "off", 32, 8, 256, 1.25), (1, DSCIM, 64, 6, 256, 1.25)]


@pytest.mark.parametrize("shared,spec,E,k,T,cap", LAYER_CASES)
def test_moe_layer_matches_reference(shared, spec, E, k, T, cap):
    from repro.layers.moe import _route as jroute, init_moe, moe as jmoe
    from repro.models.lm import _linear_for as jlinear_for

    D, F_ = 32, 48
    jp = init_moe(jax.random.PRNGKey(5), D, F_, E, k, shared)
    tp = params_from_jax(_jtree(jp), device="cpu")
    # a component common to every token, as a random model's residual
    # stream carries one: it concentrates the routing
    rng = np.random.default_rng(6)
    x = (rng.normal(0, 1, (1, 1, D)) + rng.normal(0, 1, (2, T // 2, D))
         ).astype(np.float32)
    jl = None if spec == "off" else jlinear_for(spec)
    tl = None if spec == "off" else lm._linear_for(spec)
    want, _ = jmoe(jp, jnp.asarray(x), top_k=k, capacity_factor=cap,
                      has_shared=bool(shared), linear=jl, salt=8)
    got = moe.moe(tp, torch.from_numpy(x), top_k=k, capacity_factor=cap,
                  has_shared=bool(shared), linear=tl, salt=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)

    xt = x.reshape(-1, D)
    jids, jw, _ = jroute(jnp.asarray(xt), jp["router"], k)
    ids, w = moe.route(torch.from_numpy(xt), tp["router"], k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    C = moe.capacity(T, k, E, cap)
    assert C == max(int(T * k / E * cap), k)
    jkeep, jorder = _jkeep(jids, E, C)
    order, _, keep = moe.dispatch(ids, E, C)
    np.testing.assert_array_equal(order.numpy(), jorder)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    _, keep_l = moe.moe_routed(tp, torch.from_numpy(x), top_k=k,
                               capacity_factor=cap)
    np.testing.assert_array_equal(keep_l.numpy(), jkeep)
    assert jkeep.all() == (cap == 8.0)          # 8.0 cannot drop; others do


def test_moe_capacity_drops_bounded():
    """The reference's property: at full capacity the output is the
    undropped one; at a tiny capacity it is damped, finite, not NaN."""
    from repro.layers.moe import init_moe

    tp = params_from_jax(_jtree(init_moe(jax.random.PRNGKey(0), 16, 32, 4,
                                         1, 0)), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (1, 8, 16)).astype(np.float32))
    full = moe.moe(tp, x, top_k=1, capacity_factor=8.0)
    tiny = moe.moe(tp, x, top_k=1, capacity_factor=0.25)
    assert torch.isfinite(tiny).all()
    assert float(tiny.abs().sum()) <= float(full.abs().sum()) + 1e-4


# -- parameters --------------------------------------------------------------

def _shapes(tree, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            out.update(_shapes(v, p))
        else:
            out[p] = tuple(v.shape)
    return out


@pytest.mark.parametrize("name", MOE)
def test_init_params_tree_matches_reference(converted, name):
    jcfg, cfg, jp, tp = converted[name]
    ours = lm.init_params(cfg, 0, device="cpu")
    want = _shapes(_jtree(jp))
    assert _shapes(ours) == want == _shapes(tp)
    m = ours["layers"]["moe"]
    assert "mlp" not in ours["layers"]
    assert ("shared" in m) == (cfg.moe_shared > 0)
    L, E, D, F_ = cfg.n_layers, cfg.moe_experts, cfg.d_model, cfg.d_ff
    assert m["experts"]["w_down"].shape == (L, E, F_, D)
    # the reference's scales: router and gate/up D^-0.5, down F^-0.5
    for leaf, std in ((m["router"], D ** -0.5),
                      (m["experts"]["w_up"], D ** -0.5),
                      (m["experts"]["w_down"], F_ ** -0.5)):
        assert abs(float(leaf.std()) / std - 1) < 0.1


def test_prepare_leaves_match_reference(converted):
    from repro.core.qweights import (QuantizedLinearWeight as JQ,
                                     prepare_dscim_params as jprepare)
    from repro_torch.core.qweights import (QuantizedLinearWeight,
                                           map_params, prepare_dscim_params)

    jcfg, cfg, jp, tp = converted["deepseek-moe-16b"]
    jcfg = dataclasses.replace(jcfg, dscim=DSCIM)
    cfg = dataclasses.replace(cfg, dscim=DSCIM)
    jout = jprepare(jp, jcfg)
    out = prepare_dscim_params(tp, cfg)
    want = {"/".join(str(k.key) for k in path) for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                jout, is_leaf=lambda a: isinstance(a, JQ))[0]
            if isinstance(leaf, JQ)}
    got = set()
    map_params(lambda p, a: got.add(p) if isinstance(
        a, QuantizedLinearWeight) else None, out)
    shared = {f"layers/moe/shared/{w}" for w in ("w_gate", "w_up",
                                                  "w_down")}
    assert got == want == {"lm_head"} | shared
    assert out["layers"]["moe"]["router"] is tp["layers"]["moe"]["router"]


# -- the model ---------------------------------------------------------------

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
@pytest.mark.parametrize("name", MOE)
def test_model_level_matches_reference(converted, name, spec):
    from repro.core.kvcache import paged_from_dense as jpaged_from_dense
    from repro_torch.core.kvcache import n_pages_for, paged_from_dense

    jcfg, cfg, jp, tp = converted[name]
    jcfg = dataclasses.replace(jcfg, dscim=spec)
    cfg = dataclasses.replace(cfg, dscim=spec)
    B, S, T, ps = 2, 16, 3, 4
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, S + T))
    cap = S + T
    jl0, jdense = _jfn("prefill")(jp, jcfg, {"tokens": jnp.asarray(
        toks[:, :S])}, capacity=cap)
    tl0, dense = lm.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), cap)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), atol=ATOL,
                               rtol=0)
    _, jshort = _jfn("prefill")(jp, jcfg, {"tokens": jnp.asarray(
        toks[:, :S])})
    _, short = lm.prefill(tp, cfg, torch.from_numpy(toks[:, :S]))
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
            tok = toks[:, S + t]
            jl, jc = _jfn("decode")(jp, jcfg, {"token": jnp.asarray(tok)},
                                    jc)
            tl, c = lm.decode(tp, cfg, torch.from_numpy(tok), c)
            np.testing.assert_allclose(
                tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0,
                err_msg=f"{layout} decode step {t}")


def _prompts(cfg, B=3, S=16):
    return np.random.default_rng(0).integers(0, cfg.vocab, (B, S))


@pytest.mark.parametrize("spec,kv,paged_attn", [
    ("off", "float", "auto"), ("off", "int8", "auto"), (DSCIM, "int8", "auto"),
    ("kernel:dscim2:64", "int8", "jnp")])
@pytest.mark.parametrize("name", MOE)
def test_serve_batch_matches_reference(converted, name, spec, kv,
                                       paged_attn):
    jcfg, cfg, jp, tp = converted[name]
    prompts = _prompts(cfg).astype(np.int32)
    n = 5
    jt, jl = jserve_batch(dataclasses.replace(jcfg, dscim=spec), jp,
                          prompts, n, kv=kv, trace_logits=True,
                          paged_attn=paged_attn)
    tt, tl = serve_batch(dataclasses.replace(cfg, dscim=spec), tp, prompts,
                         n, kv=kv, trace_logits=True, device="cpu")
    jt, jl, tl = np.asarray(jt), np.stack(jl), np.stack(tl)
    assert tl.shape == jl.shape and tt.shape == jt.shape
    if spec == "off":
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(tt, jt)
        assert logit_drift_rmse(jt, tt, list(jl), list(tl)) <= KV_INT8_DRIFT


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("name", MOE)
def test_spec_bitwise_plain(converted, name, kv):
    _, cfg, _, tp = converted[name]
    cfg = dataclasses.replace(cfg, dscim=DSCIM)
    prompts = _prompts(cfg)
    kw = dict(kv=kv, page_size=4, trace_logits=False, device="cpu")
    plain, _ = serve_batch(cfg, tp, prompts, 7, **kw)
    spec, _, stats = serve_batch(cfg, tp, prompts, 7, spec="dscim2:2",
                                 spec_stats=True, **kw)
    np.testing.assert_array_equal(spec, plain)
    assert (stats["emitted"] == 7).all()


@pytest.mark.parametrize("name", MOE)
def test_continuous_bitwise_oneshot(converted, name):
    _, cfg, _, tp = converted[name]
    cfg = dataclasses.replace(cfg, dscim=DSCIM)
    budgets = np.asarray([5, 2, 4, 3], np.int32)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (4, 8))
    outs, stats = serve_continuous(cfg, tp, prompts, 5, slots=2, seg_len=2,
                                   max_new=budgets, eos_id=-1, kv="int8",
                                   page_size=4, device="cpu")
    assert stats["status"] == ["ok"] * 4
    for r in range(4):
        ref, _ = serve_batch(cfg, tp, np.tile(prompts[r:r + 1], (2, 1)), 5,
                             eos_id=-1, max_new=[int(budgets[r])] * 2,
                             kv="int8", page_size=4, device="cpu")
        np.testing.assert_array_equal(outs[r], ref[0, :budgets[r]],
                                      err_msg=str(r))


def test_prefix_hit_bitwise_cold(converted):
    _, cfg, _, tp = converted["deepseek-moe-16b"]
    cfg = dataclasses.replace(cfg, dscim=DSCIM)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, (4, 12))
    prompts[1:3, :8] = prompts[0, :8]
    budgets = np.asarray([4, 3, 5, 2], np.int32)
    kw = dict(slots=2, seg_len=2, max_new=budgets, eos_id=-1, kv="int8",
              page_size=4, device="cpu")
    cold, st_c = serve_continuous(cfg, tp, prompts, 5, prefix_cache="cold",
                                  **kw)
    warm, st_w = serve_continuous(cfg, tp, prompts, 5, prefix_cache="on",
                                  **kw)
    for r, (a, b) in enumerate(zip(warm, cold)):
        np.testing.assert_array_equal(a, b, err_msg=str(r))
    assert st_c["prefix"]["hits"] == 0 and st_w["prefix"]["hits"] == 2


# -- registry and accounting -------------------------------------------------

def test_registry_and_refusals():
    from repro.models.registry import get_model as jget_model
    from repro_torch.launch.steps import _check_continuous, _check_kv
    from repro_torch.models import rwkv, zamba
    from repro_torch.models.registry import get_model

    assert set(MOE) <= set(TOKEN_ARCHS)
    for name in MOE + ("qwen3-0.6b",):
        assert get_model(get_arch(name)) is lm
        assert jget_model(jget_arch(name)) is jlm
    for family, module in (("ssm", rwkv), ("hybrid", zamba)):
        cfg = dataclasses.replace(get_arch("qwen3-0.6b"), family=family)
        assert get_model(cfg) is module
        assert jget_model(cfg).__name__.split(".")[-1] == \
            module.__name__.split(".")[-1]
        with pytest.raises(NotImplementedError, match=family):
            lm.init_params(cfg.reduced(), 0, device="cpu")
        _check_kv(cfg, "float")
        for refused in (lambda: _check_kv(cfg, "int8"),
                        lambda: _check_kv(dataclasses.replace(
                            cfg, dscim="kernel:dscim1:256"), "float"),
                        lambda: _check_continuous(cfg)):
            with pytest.raises(ValueError, match=family):
                refused()


@pytest.mark.parametrize("integrity", [False, True])
@pytest.mark.parametrize("name,reduced", [(n, r) for n in MOE
                                          for r in (False, True)])
def test_cache_accounting_matches_reference(name, reduced, integrity):
    from repro.core import kvcache as jkv
    from repro_torch.core import kvcache

    jcfg, cfg = jget_arch(name), get_arch(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jspecs = jkv.paged_cache_specs(jcfg, 4, 80, 8, integrity=integrity)
    specs = kvcache.paged_cache_specs(cfg, 4, 80, 8, integrity=integrity)
    assert set(specs) == set(jspecs)
    for k, v in specs.items():
        assert tuple(v.shape) == tuple(jspecs[k].shape), k
        assert v.element_size() == np.dtype(jspecs[k].dtype).itemsize or \
            k == kvcache.CHECKSUM_KEY, k
    assert kvcache.kv_cache_bytes(specs) == jkv.kv_cache_bytes(jspecs)
    assert kvcache.dense_cache_bytes(cfg, 4, 80) == \
        jkv.dense_cache_bytes(jcfg, 4, 80)
    if reduced:
        live = kvcache.init_paged_cache(cfg.n_layers, 4, 40, 8, 10,
                                        cfg.n_kv, cfg.head_dim,
                                        integrity=integrity)
        assert kvcache.kv_cache_bytes(live) == kvcache.kv_cache_bytes(specs)


def test_dequantize_page_matches_reference():
    from repro.core.kvcache import (dequantize_page as jdequant,
                                    quantize_page as jquant)
    from repro_torch.core.kvcache import dequantize_page, quantize_page

    x = np.random.default_rng(9).normal(0, 2, (3, 2, 8, 4, 16)).astype(
        np.float32)
    q, s = quantize_page(torch.from_numpy(x))
    jq, js = jquant(jnp.asarray(x))
    got = dequantize_page(q, s).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdequant(
        jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))))
    np.testing.assert_allclose(got, np.asarray(jdequant(jq, js)),
                               rtol=1e-6, atol=1e-6)
    assert float(np.abs(got - x).max()) <= float(s.max()) / 2 + 1e-6


@pytest.mark.parametrize("name", MOE)
def test_router_load_test_serves_moe(name):
    """The asyncio router serves the reduced MoE configs under the load
    test's own invariants, which ``run_loadtest`` raises on (every
    request terminal and the pool empty after each drain, the chaos leg's
    ok requests no flip hit bitwise the plain leg's, prefix warm bitwise
    cold with hits)."""
    from repro_torch.launch.loadtest import run_loadtest

    rows, plain, chaos = run_loadtest(True, arch=name, reduced=True,
                                      device="cpu", prefix=True,
                                      log=lambda *a: None)
    assert plain["statuses"]["ok"] > 0 and chaos["statuses"]["ok"] > 0
    assert sum(plain["statuses"].values()) == plain["requests"]
    assert any(r["name"].startswith("serve/prefix_router") for r in rows)
