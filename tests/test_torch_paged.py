"""Port parity, int8 paged KV cache and paged-attention decode.

* ``quantize_page`` and ``paged_from_dense`` are bitwise the jitted JAX
  reference (pages, scales, tails, table, pos);
* the port's plain page walk (what ``paged_attention_decode`` runs on CPU
  tensors) matches the reference's Pallas kernel in interpret mode and its
  jnp read path ``_paged_read_jnp`` to atol=1e-5, over page sizes
  {4, 8, 16}, GQA and MHA, permuted page tables, ragged and edge
  positions (the properties of test_paged_kernel.py);
* the paged decode layer (tail write, read, flush) matches the reference's
  ``decode_attention_paged`` over a page boundary.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.kvcache import paged_from_dense as jpaged_from_dense  # noqa: E402
from repro.core.kvcache import quantize_page as jquantize_page  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention_decode as jpaged_decode)
from repro.layers.attention import _paged_read_jnp  # noqa: E402
from repro_torch.core.kvcache import (n_pages_for, paged_from_dense,  # noqa: E402
                                      quantize_page)
from repro_torch.kernels import paged_attention  # noqa: E402


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _rand_paged(rng, B, KV, R, HD, ps, MP, extra_pages=2):
    P = B * MP + extra_pages
    return {
        "q": rng.normal(0, 1, (B, KV, R, HD)).astype(np.float32),
        "k_pages": rng.integers(-127, 128, (P, ps, KV, HD)).astype(np.int8),
        "v_pages": rng.integers(-127, 128, (P, ps, KV, HD)).astype(np.int8),
        "k_scale": rng.uniform(0.005, 0.02, (P, KV)).astype(np.float32),
        "v_scale": rng.uniform(0.005, 0.02, (P, KV)).astype(np.float32),
        "k_tail": rng.normal(0, 1, (B, ps, KV, HD)).astype(np.float32),
        "v_tail": rng.normal(0, 1, (B, ps, KV, HD)).astype(np.float32),
        "page_table": rng.permutation(P)[:B * MP].reshape(B, MP).astype(
            np.int32),
        "pos": rng.integers(0, MP * ps, (B,)).astype(np.int32),
    }


_ORDER = ("q", "k_pages", "v_pages", "k_scale", "v_scale", "k_tail",
          "v_tail", "page_table", "pos")


def _jax_args(d):
    out = {k: jnp.asarray(v) for k, v in d.items()}
    out["k_tail"] = out["k_tail"].astype(jnp.bfloat16)
    out["v_tail"] = out["v_tail"].astype(jnp.bfloat16)
    return out


def _torch_args(d):
    out = {k: torch.from_numpy(v) for k, v in d.items()}
    out["k_tail"] = out["k_tail"].to(torch.bfloat16)
    out["v_tail"] = out["v_tail"].to(torch.bfloat16)
    return [out[k] for k in _ORDER]


def _refs(d):
    j = _jax_args(d)
    kern = jpaged_decode(*[j[k] for k in _ORDER], interpret=True)
    view = {k: j[k] for k in ("k_pages", "v_pages", "k_scale", "v_scale",
                              "page_table", "pos")}
    ref = _paged_read_jnp(j["q"], view, j["k_tail"], j["v_tail"])
    return np.asarray(kern), np.asarray(ref)


@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("KV,R,HD", [(2, 2, 16), (4, 1, 8)],
                         ids=["gqa", "mha"])
def test_paged_plain_vs_jax(ps, KV, R, HD):
    d = _rand_paged(np.random.default_rng(ps * 100 + KV), 3, KV, R, HD,
                    ps, 3)
    kern, ref = _refs(d)
    before = paged_attention.LAUNCHES.count
    got = paged_attention.paged_attention_decode(*_torch_args(d)).numpy()
    assert paged_attention.LAUNCHES.count == before    # CPU: plain version
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, kern, atol=1e-5, rtol=0)


def test_paged_plain_edge_positions():
    """pos at the page boundaries: 0, ps-1, ps, MP*ps-1."""
    KV, R, HD, ps, MP = 2, 2, 16, 4, 3
    d = _rand_paged(np.random.default_rng(7), 4, KV, R, HD, ps, MP)
    d["pos"] = np.asarray([0, ps - 1, ps, MP * ps - 1], np.int32)
    kern, ref = _refs(d)
    got = paged_attention.paged_read_plain(*_torch_args(d)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, kern, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(5, 8, 4, 16), (3, 4, 2, 8)])
def test_quantize_page_bitwise_vs_jitted(shape):
    """The page scale is amax*(1/127), what XLA makes of the reference's
    ``/127.0`` inside jit (the serving path is jitted)."""
    rng = np.random.default_rng(len(shape))
    x = rng.normal(0, 1, (2, *shape)).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero head row is fine
    jq, js = jax.jit(jquantize_page)(jnp.asarray(x))
    q, s = quantize_page(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("S,ps", [(13, 4), (16, 8), (5, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_from_dense_bitwise(S, ps, dtype):
    L, B, KV, HD = 2, 3, 2, 16
    rng = np.random.default_rng(S * ps)
    ks = rng.normal(0, 1, (L, B, S, KV, HD)).astype(np.float32)
    vs = rng.normal(0, 1, (L, B, S, KV, HD)).astype(np.float32)
    mp = n_pages_for(S + 6, ps)
    jdt = jnp.dtype(dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref = jax.jit(lambda a, b: jpaged_from_dense(
        a, b, ps, n_pages=B * mp, max_pages=mp))(
            jnp.asarray(ks, jdt), jnp.asarray(vs, jdt))
    got = paged_from_dense(torch.from_numpy(ks).to(tdt),
                           torch.from_numpy(vs).to(tdt), ps,
                           n_pages=B * mp, max_pages=mp)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(_np(got[k]),
                                      np.asarray(ref[k], np.float32)
                                      if ref[k].dtype == jnp.bfloat16
                                      else np.asarray(ref[k]), err_msg=k)


def test_decode_layer_tail_write_read_flush_vs_jax():
    """Three decode steps of one attention layer straddling a page flush,
    ragged positions, a done slot: outputs, tails, pages and scales."""
    import dataclasses

    from repro.configs import get_arch as jget_arch
    from repro.layers.attention import (decode_attention_paged as jdap,
                                        init_attention)
    from repro_torch.layers.attention import decode_attention_paged

    cfg = dataclasses.replace(jget_arch("qwen3-0.6b").reduced())
    B, ps, D = 3, 4, cfg.d_model
    jp = init_attention(jax.random.PRNGKey(1), D, cfg.n_heads, cfg.n_kv,
                        cfg.head_dim, True)
    tp = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in jp.items()}
    rng = np.random.default_rng(3)
    S = 6
    ks = rng.normal(0, 1, (1, B, S, cfg.n_kv, cfg.head_dim)).astype(
        np.float32)
    vs = rng.normal(0, 1, ks.shape).astype(np.float32)
    mp = n_pages_for(S + 4, ps)
    jc = jpaged_from_dense(jnp.asarray(ks), jnp.asarray(vs), ps,
                           n_pages=B * mp, max_pages=mp)
    jc["pos"] = jnp.asarray([6, 3, 7], jnp.int32)
    tc = {k: torch.from_numpy(np.array(v.astype(jnp.float32)
                                       if v.dtype == jnp.bfloat16 else v))
          for k, v in jc.items()}
    for k in ("k_tail", "v_tail"):
        tc[k] = tc[k].to(torch.bfloat16)
    done = np.asarray([False, False, True])
    names = ("k_pages", "v_pages", "k_scale", "v_scale", "k_tail", "v_tail")
    for step in range(3):
        x = rng.normal(0, 1, (B, 1, D)).astype(np.float32)
        jview = {k: jc[k][0] for k in names}
        jview.update(page_table=jc["page_table"], pos=jc["pos"])
        jout, planes = jax.jit(lambda p, xx, v, dn: jdap(
            p, xx, v, cfg, done=dn, use_kernel=False))(
                jp, jnp.asarray(x), jview, jnp.asarray(done))
        tview = {k: tc[k][0] for k in names}
        tview.update(page_table=tc["page_table"], pos=tc["pos"])
        tout = decode_attention_paged(tp, torch.from_numpy(x), tview, cfg,
                                      done=torch.from_numpy(done))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=1e-5, rtol=1e-5)
        for k, plane in zip(names, planes):
            jc[k] = jc[k].at[0].set(plane)
            np.testing.assert_array_equal(_np(tc[k][0]),
                                          np.asarray(plane, np.float32)
                                          if plane.dtype == jnp.bfloat16
                                          else np.asarray(plane),
                                          err_msg=f"step {step} {k}")
        adv = np.where(done, 0, 1).astype(np.int32)
        jc["pos"] = jc["pos"] + adv
        tc["pos"] = tc["pos"] + torch.from_numpy(adv)
