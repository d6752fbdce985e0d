"""Port parity, the RWKV6 family (rwkv6-7b, ``family="ssm"``) at
``.reduced()``: the port's ``layers/rwkv6.py`` and ``models/rwkv.py``
against the reference's on the same inputs (numpy seeds; the port's
parameters converted from the reference's ``init_params``).  Contracts,
each with the error measured on the CPU:

* ``wkv6`` alone (B 2, S 16, 4 heads of 16, decays in [-4, -1e-4]) at
  chunk 1, 4 and 16 from a zero and a nonzero state: the output within
  1e-3 of its max (measured 3.7e-4 at chunk 16, 2e-7 at chunks 1 and 4:
  the chunk's scores and v are rounded to bf16, as the reference rounds
  them, and a one-ulp f32 difference upstream can flip a rounding), the
  state within 1e-5 (measured 2.2e-6);
* ``rwkv6_block`` (d 64, 4 heads of 16) at chunk 1, 4 and 8 (= S), zero
  and nonzero state: output and state within 1e-4 of their max
  (measured 2.4e-5); in bf16 compute within 2e-2 (measured 8.6e-3: XLA
  rounds a fused chain of bf16 ops once, torch after every op, so about
  half the elements differ by an ulp);
* the model (``.reduced()``: 2 layers, one head of 64, chunk 4): prefill
  logits and state, then 5 decode steps, within 1e-3 (the WKV's bf16
  rounding; measured 8e-7); at ``compute_dtype="bfloat16"`` within 5e-2
  (measured 1.3e-2), teacher-forced with the reference's tokens;
* decode == prefill within the port at the reference's own bar (atol
  2e-2, ``tests/test_models.py``): the logits after decoding tokens 1..t
  equal those of a prefill of tokens 0..t (t + 1 a multiple of the
  chunk);
* ``serve_batch`` against the reference's ``serve_batch``: greedy tokens
  equal and the logit trace within 1e-3 (measured 6e-7), ``eos_id`` with
  ``max_new`` budgets, ``scan=False`` bitwise ``scan=True`` (greedy and
  sampled);
* ``init_params`` and ``cache_specs`` trees (keys, shapes, dtypes) equal
  to the reference's, and ``params_from_jax`` carries the tree exactly;
* the refusals: int8 KV, a DS-CIM spec, ``spec=``, continuous serving,
  the router, the load test and the drills, each a ``ValueError`` naming
  the family; a chunk that does not divide S, or one past the f32 bound.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.serve import serve_batch as jserve_batch  # noqa: E402
from repro.layers import rwkv6 as jrwkv6  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.layers import rwkv6  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402

NAME = "rwkv6-7b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(want, got) -> float:
    """max |want - got| over max |want|."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert want.shape == got.shape
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _cast(tree, jdt, tdt):
    """Both packages' leaf cast of a layer (the f32 leaves to the compute
    dtype)."""
    if isinstance(tree, dict):
        return {k: _cast(v, jdt, tdt) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(tdt) if tree.dtype == torch.float32 else tree
    return tree.astype(jdt) if tree.dtype == jnp.float32 else tree


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params) at
    .reduced(), the port's converted from the reference's PRNGKey(0)."""
    jcfg, cfg = jget_arch(NAME).reduced(), get_arch(NAME).reduced()
    jp = jrwkv.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(_np(jp), device="cpu")


# -- layer --------------------------------------------------------------------

def _wkv_inputs(seed, B=2, S=16, H=4, dk=16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, S, H, dk)).astype(np.float32)
               for _ in range(3))
    lw = -rng.uniform(1e-4, 4.0, (B, S, H, dk)).astype(np.float32)
    u = rng.normal(0, 0.3, (H, dk)).astype(np.float32)
    state = rng.normal(0, 1, (B, H, dk, dk)).astype(np.float32)
    return r, k, v, lw, u, state


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_wkv6_matches_reference(chunk, carried):
    r, k, v, lw, u, state = _wkv_inputs(chunk)
    if not carried:
        state = np.zeros_like(state)
    args = (r, k, v, lw, u, state)
    jo, js = jrwkv6.wkv6(*map(jnp.asarray, args), chunk=chunk)
    to, ts = rwkv6.wkv6(*map(_t, args), chunk=chunk)
    assert _rel(jo, to) <= 1e-3
    assert _rel(js, ts) <= 1e-5


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_block_matches_reference(chunk, carried, bf16):
    D, Fd, hd, B, S = 64, 96, 16, 2, 8
    jp = jrwkv6.init_rwkv6(jax.random.PRNGKey(chunk), D, Fd, hd)
    tp = params_from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(chunk)
    x = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    state = {"x_att": rng.normal(0, 1, (B, D)),
             "x_ffn": rng.normal(0, 1, (B, D)),
             "wkv": rng.normal(0, 1, (B, D // hd, hd, hd))}
    state = {k: (v if carried else 0 * v).astype(np.float32)
             for k, v in state.items()}
    jx, tx = jnp.asarray(x), _t(x)
    if bf16:
        jp, tp = _cast(jp, jnp.bfloat16, None), _cast(tp, None,
                                                      torch.bfloat16)
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jo, js = jrwkv6.rwkv6_block(jp, jx, {k: jnp.asarray(v) for k, v in
                                         state.items()}, hd, chunk)
    to, ts = rwkv6.rwkv6_block(tp, tx, {k: _t(v) for k, v in state.items()},
                               hd, chunk)
    assert to.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert all(ts[k].dtype == torch.float32 for k in ts)
    tol = 2e-2 if bf16 else 1e-4
    assert _rel(jo, to) <= tol
    for k in js:
        assert _rel(js[k], ts[k]) <= tol, k


def test_chunk_refusals():
    r, k, v, lw, u, state = map(_t, _wkv_inputs(0, S=24))
    with pytest.raises(ValueError, match="divide"):
        rwkv6.wkv6(r, k, v, lw, u, state, chunk=16)
    with pytest.raises(ValueError, match="DECAY_CLIP"):
        rwkv6.wkv6(r, k, v, lw, u, state, chunk=24)
    assert (rwkv6.LORA_R, rwkv6.DECAY_CLIP) == (jrwkv6.LORA_R,
                                                jrwkv6.DECAY_CLIP)


# -- model --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_matches_reference(model, dtype):
    jcfg, cfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, compute_dtype=dtype, cache_dtype=dtype)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, cache_dtype=dtype)
    tol = 1e-3 if dtype == "float32" else 5e-2
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (3, 16))
    jl, jc = jrwkv.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           capacity=22)
    tl, tc = rwkv.prefill(tp, cfg, torch.as_tensor(toks), capacity=22)

    def check_state():
        got = dict(_leaves(tc))
        for path, want in _leaves(jc):
            assert got[path].shape == np.shape(want), path
            if np.ndim(want):
                assert _rel(want, got[path]) <= tol, path
            else:
                assert int(got[path]) == int(want)
    assert _rel(jl, tl) <= tol
    check_state()
    for _ in range(5):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jl, jc = jrwkv.decode(jp, jcfg, {"token": jnp.asarray(tok)}, jc)
        tl, tc = rwkv.decode(tp, cfg, torch.as_tensor(tok).long(), tc)
        assert _rel(jl, tl) <= tol
    check_state()


def test_decode_matches_prefill(model):
    _, cfg, _, tp = model
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 8)))
    lg, cache = rwkv.prefill(tp, cfg, toks[:, :1], capacity=8)
    want = {0: lg}
    for t in (3, 7):
        want[t] = rwkv.prefill(tp, cfg, toks[:, :t + 1])[0]
    for t in range(1, 8):
        lg, cache = rwkv.decode(tp, cfg, toks[:, t], cache)
        if t in want:
            np.testing.assert_allclose(lg.numpy(), want[t].numpy(),
                                       atol=2e-2, rtol=1e-2)
    assert int(cache["pos"]) == 8


def test_init_and_cache_specs_match_reference(model):
    jcfg, cfg, jp, tp = model
    mine = rwkv.init_params(cfg, 0, device="cpu")
    want = {p: (np.shape(a), np.asarray(a).dtype) for p, a in _leaves(jp)}
    assert {p: (tuple(a.shape), np.dtype(str(a.dtype).split(".")[1]))
            for p, a in _leaves(mine)} == want
    for path, a in _leaves(jp):                 # conversion is exact
        np.testing.assert_array_equal(dict(_leaves(tp))[path].numpy(),
                                      np.asarray(a))
    layers = mine["layers"]
    assert torch.equal(layers["wr_ffn"], layers["wr"])
    assert float(layers["decay_base"][0, 0]) == -1.5
    for c in (cfg, get_arch(NAME)):
        j = jget_arch(NAME) if c is not cfg else jcfg
        got = {p: (tuple(t.shape), t.dtype)
               for p, t in _leaves(rwkv.cache_specs(c, 4, 80))}
        assert got == {p: (tuple(s.shape), getattr(torch, str(s.dtype)))
                       for p, s in _leaves(jrwkv.cache_specs(j, 4, 80))}


# -- serving ------------------------------------------------------------------

@pytest.fixture(scope="module")
def prompts(model):
    return np.random.default_rng(1).integers(0, model[1].vocab, (3, 16))


def test_serve_batch_matches_reference(model, prompts):
    jcfg, cfg, jp, tp = model
    jt, jl = jserve_batch(jcfg, jp, prompts, 6, trace_logits=True)
    tt, tl = serve_batch(cfg, tp, prompts, 6, trace_logits=True,
                         device="cpu")
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert _rel(np.stack(jl), np.stack(tl)) <= 1e-3
    et, el = serve_batch(cfg, tp, prompts, 6, trace_logits=True,
                         device="cpu", scan=False)
    np.testing.assert_array_equal(et, tt)
    np.testing.assert_array_equal(np.stack(el), np.stack(tl))


def test_serve_batch_eos_and_budgets(model, prompts):
    jcfg, cfg, jp, tp = model
    plain, _ = serve_batch(cfg, tp, prompts, 6, device="cpu")
    eos = int(plain[0, 2])                       # row 0 stops at step 2
    budgets = np.asarray([6, 3, 1], np.int32)
    jt, _ = jserve_batch(jcfg, jp, prompts, 6, eos_id=eos, max_new=budgets)
    runs = [serve_batch(cfg, tp, prompts, 6, eos_id=eos, max_new=budgets,
                        device="cpu", scan=scan)[0] for scan in (True, False)]
    np.testing.assert_array_equal(runs[0], np.asarray(jt))
    np.testing.assert_array_equal(runs[1], runs[0])
    assert (runs[0][2, 1:] == 0).all() and (runs[0][1, 3:] == 0).all()


def test_serve_batch_sampled_graph_equals_eager(model, prompts):
    _, cfg, _, tp = model
    runs = [serve_batch(cfg, tp, prompts, 5, sample="temp:0.8", rng_seed=3,
                        device="cpu", scan=scan)[0] for scan in (True, False)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].min() >= 0 and runs[0].max() < cfg.vocab_padded


def test_refusals(model, prompts):
    from repro_torch.launch.loadtest import run_loadtest
    from repro_torch.launch.serve import prepare_params, serve_continuous
    from repro_torch.launch.steps import init_serve_state
    from repro_torch.models.registry import get_model
    from repro_torch.runtime import serving
    from repro_torch.runtime.router import Router

    _, cfg, _, tp = model
    assert get_model(cfg) is rwkv
    with pytest.raises(ValueError, match="'ssm'"):
        serve_batch(cfg, tp, prompts, 4, kv="int8", device="cpu")
    kernel = dataclasses.replace(cfg, dscim="kernel:dscim1:256")
    for call in (lambda: serve_batch(kernel, tp, prompts, 4, device="cpu"),
                 lambda: prepare_params(kernel, tp, "cpu")):
        with pytest.raises(ValueError, match="'ssm'"):
            call()
    with pytest.raises(ValueError, match="'ssm'"):
        serve_batch(cfg, tp, prompts, 4, spec="dscim2:2", device="cpu")
    for call in (
            lambda: init_serve_state(cfg, 2, 32, device="cpu"),
            lambda: serve_continuous(cfg, tp, prompts, 4, device="cpu"),
            lambda: serve_continuous(cfg, tp, prompts, 4, kv="int8",
                                     integrity="verify", device="cpu"),
            lambda: Router(cfg, tp, kv="float", device="cpu"),
            lambda: run_loadtest(arch=NAME, reduced=True, device="cpu"),
            lambda: serving.chaos_drill(NAME, device="cpu"),
            lambda: serving.integrity_drill(NAME, device="cpu"),
            lambda: serving.prefix_drill(NAME, device="cpu")):
        with pytest.raises(ValueError, match="'ssm'"):
            call()
    # 'float' serves as 'off' does: the family has no DS-CIM site
    ft, _ = serve_batch(dataclasses.replace(cfg, dscim="float:dscim1:256"),
                        tp, prompts, 4, device="cpu")
    np.testing.assert_array_equal(
        ft, serve_batch(cfg, tp, prompts, 4, device="cpu")[0])
