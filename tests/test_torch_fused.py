"""Port parity, fused DS-CIM MVM: the port's plain fused estimator (what
``dscim_fused_mvm`` runs on CPU tensors) against the JAX reference's fused
Pallas kernel in interpret mode, over the axes of test_kernels_fused.py:
group_k {None, 64, 128}, dscim1/L256 and dscim2/L64, odd K, center
truncation and leading batch dims.  Contract: identical estimator up to
f32 summation order, rtol=2e-5, atol=2e-5*max|ref| (the counts themselves
are exact integers on both sides)."""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dscim_layer import DSCIMLinear as JLinear  # noqa: E402
from repro.core.macro import dscim1 as jdscim1  # noqa: E402
from repro.core.seed_search import calibrated_config as jcalib  # noqa: E402
from repro.kernels.dscim_fused import dscim_fused_mvm as jfused  # noqa: E402
from repro_torch.core.dscim_layer import DSCIMLinear, make_linear  # noqa: E402
from repro_torch.core.macro import dscim1  # noqa: E402
from repro_torch.core.qweights import prepare_linear_weight  # noqa: E402
from repro_torch.core.seed_search import calibrated_config  # noqa: E402
from repro_torch.kernels import dscim_fused  # noqa: E402


def _assert_matches(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def _operands(seed, lead, K, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (*lead, K)).astype(np.float32),
            rng.normal(0, 1, (K, N)).astype(np.float32))


def _both(x, w, key_or_cfg, group_k):
    if isinstance(key_or_cfg[0], str):
        cfg, jcfg = calibrated_config(*key_or_cfg), jcalib(*key_or_cfg)
    else:
        cfg, jcfg = key_or_cfg
    want = np.asarray(jfused(jnp.asarray(x), jnp.asarray(w), jcfg,
                             group_k=group_k, interpret=True))
    got = dscim_fused.dscim_fused_mvm(torch.from_numpy(x),
                                      torch.from_numpy(w), cfg,
                                      group_k=group_k)
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("group_k", [None, 64, 128])
@pytest.mark.parametrize("key", [("dscim1", 256, "paper"),
                                 ("dscim2", 64, "paper")],
                         ids=lambda k: f"{k[0]}-L{k[1]}")
def test_fused_plain_vs_jax_granularities(group_k, key):
    x, w = _operands(key[1] + (group_k or 0), (6,), 200, 24)
    got, want = _both(x, w, key, group_k)
    _assert_matches(got, want)


@pytest.mark.parametrize("shape", [(3, 100, 17), (5, 130, 9), (1, 64, 1)])
def test_fused_plain_vs_jax_odd_shapes(shape):
    M, K, N = shape
    x, w = _operands(sum(shape), (M,), K, N)
    got, want = _both(x, w, ("dscim1", 256, "paper"), 128)
    _assert_matches(got, want)


@pytest.mark.parametrize("lead", [(2, 3), (2, 2, 4)])
def test_fused_plain_vs_jax_leading_dims(lead):
    x, w = _operands(len(lead), lead, 150, 20)
    got, want = _both(x, w, ("dscim2", 64, "paper"), 64)
    assert got.shape == (*lead, 20)
    _assert_matches(got, want)


def test_fused_plain_vs_jax_center_truncation():
    x, w = _operands(9, (4,), 130, 11)
    cfgs = (dscim1(256, points="sobol", seed_u=0, seed_v=60, trunc="center"),
            jdscim1(256, points="sobol", seed_u=0, seed_v=60, trunc="center"))
    got, want = _both(x, w, cfgs, 64)
    _assert_matches(got, want)


@pytest.mark.parametrize("mode", ["exact", "lut", "kernel", "float"])
def test_dscim_linear_modes_vs_jax(mode):
    """DSCIMLinear in each ported mode, float and prepared weights, against
    the reference's DSCIMLinear (kernel = Pallas interpret); the prepared
    and float-weight paths are identical within the port."""
    x, w = _operands(21, (5,), 150, 12)
    cfg, jcfg = calibrated_config("dscim1", 256), jcalib("dscim1", 256)
    want = np.asarray(JLinear(jcfg, mode=mode, group_k=64)(
        jnp.asarray(x), jnp.asarray(w)))
    lin = DSCIMLinear(cfg, mode=mode, group_k=64)
    got = lin(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    _assert_matches(got, want)
    if mode != "float":
        qw = prepare_linear_weight(torch.from_numpy(w), 64)
        np.testing.assert_array_equal(lin(torch.from_numpy(x), qw).numpy(),
                                      got)


def test_kernel_mode_equals_lut_oracle():
    """Within the port: the fused estimator (kernel mode) agrees with the
    bit-exact LUT oracle to f32 rounding, the reference's own contract."""
    x, w = _operands(5, (3,), 256, 40)
    lut = make_linear("dscim2", 64, "lut")(torch.from_numpy(x),
                                           torch.from_numpy(w))
    ker = make_linear("dscim2", 64, "kernel")(torch.from_numpy(x),
                                              torch.from_numpy(w))
    _assert_matches(ker.numpy(), lut.numpy())


def test_wrapper_dispatch_and_launch_counter():
    """CPU tensors run the plain version (no launch counted); a prepared
    weight with the wrong K is refused; N-chunking is invisible."""
    x, w = _operands(4, (2,), 70, 33)
    cfg = calibrated_config("dscim1", 256)
    qw = prepare_linear_weight(torch.from_numpy(w), 128)
    before = dscim_fused.LAUNCHES.count
    out = dscim_fused.dscim_fused_mvm_prepared(torch.from_numpy(x), qw, cfg)
    assert dscim_fused.LAUNCHES.count == before
    xq = dscim_fused.quantize_activations_windowed(torch.from_numpy(x), 1,
                                                   128)
    sx = xq.scale.reshape(2, 1)
    old = dscim_fused._N_CHUNK
    try:
        dscim_fused._N_CHUNK = 8
        chunked = dscim_fused.dscim_fused_mvm_plain(xq.q, sx, qw.q, qw.scale,
                                                    cfg)
    finally:
        dscim_fused._N_CHUNK = old
    np.testing.assert_array_equal(chunked.numpy(), out.numpy())
    with pytest.raises(ValueError):
        dscim_fused.dscim_fused_mvm_prepared(torch.from_numpy(x[:, :60]),
                                             qw, cfg)


def test_fused_plain_vs_jax_bf16_activations():
    """bf16 activations, as the full-width MLP passes them: the per-window
    quantization runs in bf16 on both sides, the output is f32."""
    x, w = _operands(13, (2, 3), 300, 16)
    cfg, jcfg = calibrated_config("dscim1", 256), jcalib("dscim1", 256)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jfused(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                             jnp.asarray(w), jcfg, group_k=128,
                             interpret=True))
    got = dscim_fused.dscim_fused_mvm(xb, torch.from_numpy(w), cfg,
                                      group_k=128)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 16)
    _assert_matches(got.numpy(), want)
