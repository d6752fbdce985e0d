"""Port parity, numpy/integer half: the PyTorch port's macro constants,
quantizers and prepared weights against the JAX reference, bit for bit
(the same numpy-seeded inputs go through both packages)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import prng as jprng  # noqa: E402
from repro.core import remap as jremap  # noqa: E402
from repro.core.macro import DSCIMMacro as JMacro  # noqa: E402
from repro.core.quant import quantize_int8 as jquantize  # noqa: E402
from repro.core.qweights import (prepare_dscim_params as jprepare_params,
                                 prepare_linear_weight as jprepare)  # noqa: E402
from repro.core.seed_search import (CALIBRATED as JCAL,
                                    calibrated_config as jcalib)  # noqa: E402
from repro.kernels.dscim_mvm_blocked import (
    block_point_tables as jtables)  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import prng, remap  # noqa: E402
from repro_torch.core.macro import DSCIMMacro  # noqa: E402
from repro_torch.core.quant import quantize_int8  # noqa: E402
from repro_torch.core.qweights import (QuantizedLinearWeight,  # noqa: E402
                                       prepare_dscim_params,
                                       prepare_linear_weight,
                                       split_dscim_mode)
from repro_torch.core.seed_search import (CALIBRATED,  # noqa: E402
                                          calibrated_config)
from repro_torch.kernels.dscim_fused import mask_tables  # noqa: E402
from repro_torch.kernels.dscim_mvm_blocked import (  # noqa: E402
    block_point_tables)

KEYS = sorted(JCAL)


def test_calibrated_presets_identical():
    assert CALIBRATED == JCAL
    for key in KEYS:
        ours, ref = calibrated_config(*key), jcalib(*key)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.scale == ref.scale and ours.group == ref.group


@pytest.mark.parametrize("key", KEYS, ids=lambda k: "-".join(map(str, k)))
def test_points_folds_lut_tables_bitwise(key):
    """Point sets, folds, the joint-count LUT and the blocked point tables
    are bitwise the reference's for every calibrated preset."""
    cfg, jcfg = calibrated_config(*key), jcalib(*key)
    u, v = prng.make_points(cfg.points, cfg.length, cfg.seed_u, cfg.seed_v,
                            cfg.param_u, cfg.param_v)
    ju, jv = jprng.make_points(jcfg.points, jcfg.length, jcfg.seed_u,
                               jcfg.seed_v, jcfg.param_u, jcfg.param_v)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(v, jv)
    for a, b in zip(remap.fold(u, cfg.k), jremap.fold(ju, cfg.k)):
        np.testing.assert_array_equal(a, b)
    lut = remap.build_count_lut(u, v, cfg.k)
    np.testing.assert_array_equal(lut, jremap.build_count_lut(ju, jv, cfg.k))
    tu, tv, pmax = block_point_tables(cfg)
    jtu, jtv, jpmax = jtables(jcfg)
    assert pmax == jpmax
    np.testing.assert_array_equal(tu, jtu)
    np.testing.assert_array_equal(tv, jtv)
    # the kernel's bit-mask tables are the LUT: popc(ta[g,a] & tb[g,b])
    # == LUT[g, a, b] for every block and shifted value pair
    ta, tb = (t.view(np.uint32).astype(np.int64) for t in mask_tables(cfg))
    both = ta[:, :, None] & tb[:, None, :]
    pop = np.zeros_like(both)
    for bit in range(32):
        pop += (both >> bit) & 1
    np.testing.assert_array_equal(pop, lut)


@pytest.mark.parametrize("shape,axis", [((5, 37), -1), ((3, 4, 128), -1),
                                        ((2, 64, 7), -2), ((6, 1), -1)])
def test_quantize_int8_bitwise(shape, axis):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0, 1, shape).astype(np.float32)
    x.reshape(-1)[::7] *= 40.0                    # outliers
    jq = jquantize(jnp.asarray(x), axis=axis)
    q = quantize_int8(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(q.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))


def test_quantize_int8_bf16_bitwise():
    """bf16 activations (full-width compute) quantize in bf16 like JAX."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (4, 2, 128)).astype(np.float32)
    jq = jquantize(jnp.asarray(x, jnp.bfloat16), axis=-1)
    q = quantize_int8(torch.from_numpy(x).to(torch.bfloat16), axis=-1)
    np.testing.assert_array_equal(q.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))


@pytest.mark.parametrize("stack,K,N,group_k", [((), 200, 24, 128),
                                               ((), 64, 9, None),
                                               ((3,), 130, 17, 64),
                                               ((2,), 96, 64, 128)])
def test_prepare_linear_weight_bitwise(stack, K, N, group_k):
    rng = np.random.default_rng(K + N)
    w = rng.normal(0, 1, (*stack, K, N)).astype(np.float32)
    ref = jprepare(jnp.asarray(w), group_k)
    ours = prepare_linear_weight(torch.from_numpy(w), group_k)
    assert (ours.k_orig, ours.group_k, ours.shape) == (
        ref.k_orig, ref.group_k, ref.shape)
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))
    if stack:
        one = ours[1]
        assert isinstance(one, QuantizedLinearWeight) and one.stack == ()
        np.testing.assert_array_equal(one.q.numpy(), np.asarray(ref.q)[1])


def test_prepare_dscim_params_tied_head():
    """Every eligible matrix is prepared, attention stays float, and the
    tied head is materialized from embed.T — bitwise the reference's."""
    import jax

    from repro.configs import get_arch as jget_arch
    from repro.models.lm import init_params as jinit
    from repro_torch.convert import params_from_jax
    spec = "kernel:dscim1:256"
    jcfg = dataclasses.replace(jget_arch("qwen3-0.6b").reduced(), dscim=spec)
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), dscim=spec)
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    ref = jprepare_params(jp, jcfg, group_k=128)
    ours = prepare_dscim_params(
        params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), cfg,
        group_k=128)
    for site in ("w_up", "w_gate", "w_down"):
        got, want = ours["layers"]["mlp"][site], ref["layers"]["mlp"][site]
        assert isinstance(got, QuantizedLinearWeight)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
    assert isinstance(ours["layers"]["attn"]["wq"], torch.Tensor)
    np.testing.assert_array_equal(ours["lm_head"].q.numpy(),
                                  np.asarray(ref["lm_head"].q))
    np.testing.assert_array_equal(ours["lm_head"].scale.numpy(),
                                  np.asarray(ref["lm_head"].scale))
    assert split_dscim_mode("kernel+attn:dscim1:256") == ("kernel", True)
    assert prepare_dscim_params(ours, dataclasses.replace(cfg, dscim="off")) \
        is ours


@pytest.mark.parametrize("key", [("dscim1", 256, "paper"),
                                 ("dscim2", 64, "paper"),
                                 ("dscim1", 256, "opt")],
                         ids=lambda k: "-".join(map(str, k)))
def test_counts_oracle_bitwise(key):
    """The torch LUT oracle's counts and psums equal DSCIMMacro.counts_lut's."""
    rng = np.random.default_rng(11)
    x = rng.integers(-128, 128, (5, 70)).astype(np.int8)
    w = rng.integers(-128, 128, (70, 13)).astype(np.int8)
    jm = JMacro(jcalib(*key))
    m = DSCIMMacro(calibrated_config(*key))
    ref = np.asarray(jm.counts_lut(jnp.asarray(x), jnp.asarray(w)))
    got = m.counts_lut(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(
        m.mvm_from_counts(torch.from_numpy(x), torch.from_numpy(w),
                          got).numpy(),
        np.asarray(jm.mvm_from_counts(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(ref))), rtol=0, atol=0)


def test_reduced_config_matches_reference():
    from repro.configs import get_arch as jget_arch
    for full in (False, True):
        ours = get_arch("qwen3-0.6b")
        ref = jget_arch("qwen3-0.6b")
        if not full:
            ours, ref = ours.reduced(), ref.reduced()
        for f in dataclasses.fields(ours):
            if f.name == "paged_attn":
                # the port's own serving knob (the reference threads it
                # through its decode batch), at its default
                assert ours.paged_attn == "auto"
            elif f.name == "shapes":        # two packages' Shape classes
                assert [dataclasses.asdict(s) for s in ours.shapes] == \
                    [dataclasses.asdict(s) for s in ref.shapes]
            else:
                assert getattr(ours, f.name) == getattr(ref, f.name), f.name
        assert ours.vocab_padded == ref.vocab_padded
