"""Port parity, the Zamba2 hybrid family (zamba2-7b, ``family="hybrid"``)
at ``.reduced()``: the port's ``layers/mamba2.py`` and ``models/zamba.py``
against the reference's on the same inputs (numpy seeds; the port's
parameters converted from the reference's ``init_params``).  Contracts,
each with the error measured on the CPU:

* ``_ssd_chunk`` alone (B 2, 4 heads of 16, state 16) at chunk 1, 4 and
  16 from a zero and a nonzero state: y and h within 1e-5 of their max
  (f32 rounding; measured 1.8e-6: the SSD rounds nothing to bf16);
* ``mamba2_block`` (d 64, 4 heads of 16, state 16) at chunk 1, 4 and 8
  (= S), zero and nonzero state (conv tail and h): output and state
  within 1e-5 (measured 6e-7); in bf16 compute within 2e-2 (measured
  7.1e-3: XLA rounds a fused chain of bf16 ops once, torch after every
  op), the conv tail and h f32 as the reference promotes them;
* the model (``.reduced()``: 4 Mamba2 layers in 2 blocks of 2, the
  shared attention 4/2 heads of 16, chunk 4): prefill logits, the Mamba2
  states and the 2 K/V caches, then 5 decode steps, within 1e-3 (the
  prefill attention rounds q, k, p and v to bf16 as the reference does,
  so a one-ulp f32 difference upstream can move an operand by a bf16
  ulp; measured 7.4e-5 on another prompt, 1.1e-6 here); at
  ``compute_dtype="bfloat16"`` within 5e-2 (measured 1.8e-2),
  teacher-forced with the reference's tokens;
* decode == prefill within the port at the reference's own bar (atol
  2e-2, ``tests/test_models.py``);
* ``serve_batch`` against the reference's ``serve_batch``: greedy tokens
  equal and the logit trace within 1e-3 (measured 9e-7), ``eos_id`` with
  ``max_new`` budgets, ``scan=False`` bitwise ``scan=True`` (greedy and
  sampled);
* ``init_params`` and ``cache_specs`` trees (keys, shapes, dtypes) equal
  to the reference's (zamba2-7b's: 27 K/V caches of (B, T, 32, 112)),
  and ``params_from_jax`` carries the (n_blocks, mamba_per_block, ...)
  tree exactly;
* the refusals, as for RWKV6, each a ``ValueError`` naming the family;
  a chunk that does not divide S.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.serve import serve_batch as jserve_batch  # noqa: E402
from repro.layers import mamba2 as jmamba2  # noqa: E402
from repro.models import zamba as jzamba  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.layers import mamba2  # noqa: E402
from repro_torch.models import zamba  # noqa: E402

NAME = "zamba2-7b"


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
    jp = jzamba.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(_np(jp), device="cpu")


# -- layer --------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_ssd_chunk_matches_reference(chunk, carried):
    rng = np.random.default_rng(chunk)
    B, H, P, N = 2, 4, 16, 16
    x = rng.normal(0, 1, (B, chunk, H, P)).astype(np.float32)
    Bm, Cm = (rng.normal(0, 1, (B, chunk, N)).astype(np.float32)
              for _ in range(2))
    dt = rng.uniform(0.01, 2.0, (B, chunk, H)).astype(np.float32)
    lw = np.clip(-dt * rng.uniform(0.5, 2.0, (H,)), -30.0,
                 -1e-6).astype(np.float32)
    h0 = rng.normal(0, 1, (B, H, P, N)).astype(np.float32) * carried
    jh, jy = jmamba2._ssd_chunk(jnp.asarray(h0), tuple(
        map(jnp.asarray, (x, Bm, Cm, lw, dt))))
    th, ty = mamba2._ssd_chunk(*map(_t, (h0, x, Bm, Cm, lw, dt)))
    assert _rel(jy, ty) <= 1e-5
    if carried or chunk > 1:
        assert _rel(jh, th) <= 1e-5
    else:
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_block_matches_reference(chunk, carried, bf16):
    D, hd, N, B, S = 64, 16, 16, 2, 8
    jp = jmamba2.init_mamba2(jax.random.PRNGKey(chunk), D, hd, N)
    tp = params_from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(chunk)
    x = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    state = {"conv": rng.normal(0, 1, (B, mamba2.CONV_K - 1, D + 2 * N)),
             "h": rng.normal(0, 1, (B, D // hd, hd, N))}
    state = {k: (v if carried else 0 * v).astype(np.float32)
             for k, v in state.items()}
    jx, tx = jnp.asarray(x), _t(x)
    if bf16:
        jp, tp = _cast(jp, jnp.bfloat16, None), _cast(tp, None,
                                                      torch.bfloat16)
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jo, js = jmamba2.mamba2_block(jp, jx, {k: jnp.asarray(v) for k, v in
                                           state.items()}, hd, chunk)
    to, ts = mamba2.mamba2_block(tp, tx, {k: _t(v) for k, v in
                                          state.items()}, hd, chunk)
    assert to.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert all(ts[k].dtype == torch.float32 for k in ts)
    tol = 2e-2 if bf16 else 1e-5
    assert _rel(jo, to) <= tol
    for k in js:
        assert _rel(js[k], ts[k]) <= tol, k


def test_chunk_refusal():
    D, hd, N = 64, 16, 16
    tp = params_from_jax(_np(jmamba2.init_mamba2(jax.random.PRNGKey(0), D,
                                                 hd, N)), device="cpu")
    state = mamba2.init_mamba2_state(2, D, hd, N)
    with pytest.raises(ValueError, match="divide"):
        mamba2.mamba2_block(tp, torch.zeros((2, 6, D)), state, hd, chunk=4)
    assert mamba2.CONV_K == jmamba2.CONV_K


# -- model --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_matches_reference(model, dtype):
    jcfg, cfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, compute_dtype=dtype, cache_dtype=dtype)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, cache_dtype=dtype)
    tol = 1e-3 if dtype == "float32" else 5e-2
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (3, 16))
    jl, jc = jzamba.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           capacity=22)
    tl, tc = zamba.prefill(tp, cfg, torch.as_tensor(toks), capacity=22)

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
        jl, jc = jzamba.decode(jp, jcfg, {"token": jnp.asarray(tok)}, jc)
        tl, tc = zamba.decode(tp, cfg, torch.as_tensor(tok).long(), tc)
        assert _rel(jl, tl) <= tol
    check_state()


def test_decode_matches_prefill(model):
    _, cfg, _, tp = model
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 8)))
    lg, cache = zamba.prefill(tp, cfg, toks[:, :1], capacity=8)
    want = {0: lg}
    for t in (3, 7):
        want[t] = zamba.prefill(tp, cfg, toks[:, :t + 1])[0]
    for t in range(1, 8):
        lg, cache = zamba.decode(tp, cfg, toks[:, t], cache)
        if t in want:
            np.testing.assert_allclose(lg.numpy(), want[t].numpy(),
                                       atol=2e-2, rtol=1e-2)
    assert int(cache["pos"]) == 8


def test_init_and_cache_specs_match_reference(model):
    jcfg, cfg, jp, tp = model
    mine = zamba.init_params(cfg, 0, device="cpu")
    want = {p: (np.shape(a), np.asarray(a).dtype) for p, a in _leaves(jp)}
    assert {p: (tuple(a.shape), np.dtype(str(a.dtype).split(".")[1]))
            for p, a in _leaves(mine)} == want
    for path, a in _leaves(jp):                 # conversion is exact
        np.testing.assert_array_equal(dict(_leaves(tp))[path].numpy(),
                                      np.asarray(a))
    assert mine["blocks"]["mamba"]["wz"].shape[:2] == (2, 2)
    for c in (cfg, get_arch(NAME)):
        j = jget_arch(NAME) if c is not cfg else jcfg
        got = {p: (tuple(t.shape), t.dtype)
               for p, t in _leaves(zamba.cache_specs(c, 4, 80))}
        assert got == {p: (tuple(s.shape), getattr(torch, str(s.dtype)))
                       for p, s in _leaves(jzamba.cache_specs(j, 4, 80))}


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
    assert get_model(cfg) is zamba
    with pytest.raises(ValueError, match="'hybrid'"):
        serve_batch(cfg, tp, prompts, 4, kv="int8", device="cpu")
    kernel = dataclasses.replace(cfg, dscim="kernel:dscim1:256")
    for call in (lambda: serve_batch(kernel, tp, prompts, 4, device="cpu"),
                 lambda: prepare_params(kernel, tp, "cpu")):
        with pytest.raises(ValueError, match="'hybrid'"):
            call()
    with pytest.raises(ValueError, match="'hybrid'"):
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
        with pytest.raises(ValueError, match="'hybrid'"):
            call()
    # 'float' serves as 'off' does: the family has no DS-CIM site
    ft, _ = serve_batch(dataclasses.replace(cfg, dscim="float:dscim1:256"),
                        tp, prompts, 4, device="cpu")
    np.testing.assert_array_equal(
        ft, serve_batch(cfg, tp, prompts, 4, device="cpu")[0])
