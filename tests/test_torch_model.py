"""Port parity, the reduced qwen3-0.6b slice end to end: the JAX
reference's ``serve_batch`` and the port's, with the port's parameters
converted from the reference's (``repro_torch.convert``), on the same
prompts.  Contracts:

* ``dscim="off"`` (dense float and int8 paged KV): every step's logits
  within 1e-4 max-abs, tokens identical;
* ``kernel:dscim1:256`` with ``kv="int8"``: the same first token per row
  and ``logit_drift_rmse <= 1e-3`` on the teacher-matched prefix.

Measured on the CPU for these inputs (3 rows, prompt 16, 6 tokens): off
max-abs 5.1e-7 (float KV) and 3.6e-7 (int8 KV); kernel:dscim1:256 int8
drift RMSE 3.9e-8 with all tokens equal.  The layer tests hold rmsnorm,
RoPE and the chunked bf16 prefill attention to 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.serve import serve_batch as jserve_batch  # noqa: E402
from repro.models.lm import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import logit_drift_rmse, serve_batch  # noqa: E402

ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = jget_arch(ARCH).reduced()
    cfg = get_arch(ARCH).reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 16)).astype(np.int32)
    return jcfg, cfg, jp, tp, prompts


def _serve_both(setup, spec, kv, n=6, **kw):
    jcfg, cfg, jp, tp, prompts = setup
    jt, jl = jserve_batch(dataclasses.replace(jcfg, dscim=spec), jp,
                          prompts, n, kv=kv, trace_logits=True, **kw)
    tt, tl = serve_batch(dataclasses.replace(cfg, dscim=spec), tp, prompts,
                         n, kv=kv, trace_logits=True, device="cpu", **kw)
    return np.asarray(jt), np.stack(jl), tt, np.stack(tl)


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_slice_dscim_off_matches_reference(slice_setup, kv):
    jt, jl, tt, tl = _serve_both(slice_setup, "off", kv)
    np.testing.assert_array_equal(tt, jt)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def test_slice_dscim_kernel_int8_matches_reference(slice_setup):
    jt, jl, tt, tl = _serve_both(slice_setup, "kernel:dscim1:256", "int8")
    np.testing.assert_array_equal(tt[:, 0], jt[:, 0])
    assert logit_drift_rmse(jt, tt, list(jl), list(tl)) <= 1e-3


def test_slice_eos_early_exit_matches_reference(slice_setup):
    """The EOS early-exit loop with per-slot budgets: pad-pinned tails and
    ragged completion follow the reference token for token."""
    jcfg, cfg, jp, tp, prompts = slice_setup
    eos = int(serve_batch(cfg, tp, prompts, 3, device="cpu")[0][1, 2])
    kw = dict(eos_id=eos, max_new=[6, 6, 2], kv="int8")
    jt, _ = jserve_batch(jcfg, jp, prompts, 6, **kw)
    tt, _ = serve_batch(cfg, tp, prompts, 6, device="cpu", **kw)
    np.testing.assert_array_equal(tt, np.asarray(jt))


def test_layers_match_reference():
    """rmsnorm, RoPE and chunked causal prefill attention (bf16 operands,
    f32 statistics, lower-triangle chunk pairs) against the reference."""
    from repro.layers.attention import _flash as jflash
    from repro.layers.norms import rmsnorm as jrmsnorm
    from repro.layers.rope import apply_rope as japply, rope_angles as jangles
    from repro_torch.layers.attention import _flash
    from repro_torch.layers.norms import rmsnorm
    from repro_torch.layers.rope import apply_rope, rope_angles

    rng = np.random.default_rng(5)
    x = rng.normal(0, 3, (2, 16, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (64,)).astype(np.float32)
    np.testing.assert_allclose(
        rmsnorm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)}),
        np.asarray(jrmsnorm(jnp.asarray(x), {"scale": jnp.asarray(scale)})),
        atol=1e-5, rtol=1e-5)
    pos = np.arange(16, dtype=np.int32)[None]
    c, s = rope_angles(torch.from_numpy(pos), 16, 1e6)
    jc, js = jangles(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    q = rng.normal(0, 1, (2, 16, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(q), c, s).numpy(),
        np.asarray(japply(jnp.asarray(q), jc, js)), atol=1e-5)
    k = rng.normal(0, 1, (2, 16, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, 16, 2, 16)).astype(np.float32)
    p1 = np.arange(16, dtype=np.int32)
    for chunk in (4, 16):
        want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(p1), jnp.asarray(p1), chunk, chunk, 2)
        got = _flash(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), torch.from_numpy(p1),
                     torch.from_numpy(p1), chunk, chunk, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
