"""Port parity, the DS-CIM operator path: the port's CPU route (the plain
versions its wrappers run on CPU tensors) against the JAX reference's
Pallas kernels in interpret mode, on the same numpy inputs and the axes of
the reference's own tests (test_kernels.py, test_kernels_fused.py,
test_core_remap.py).

Contracts: counts and int8 products are bitwise equal; float estimates
agree to f32 summation order, rtol=2e-5, atol=2e-5*max|ref| (the counts
are exact integers on both sides, only the f32 correction terms and the
dequant sums run in another order)."""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.macro import DSCIMMacro as JMacro  # noqa: E402
from repro.core.seed_search import calibrated_config as jcalib  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dscim_fused import \
    dscim_windowed_vmap_mvm as jstaged  # noqa: E402
from repro.kernels.dscim_mvm import dscim_counts_pallas  # noqa: E402
from repro.kernels.dscim_mvm_blocked import \
    dscim_counts_blocked as jblocked  # noqa: E402
from repro_torch.core.macro import DSCIMMacro  # noqa: E402
from repro_torch.core.seed_search import calibrated_config  # noqa: E402
from repro_torch.kernels import dscim_fused, dscim_mvm, ops  # noqa: E402
from repro_torch.kernels import dscim_mvm_blocked as blocked  # noqa: E402
from repro_torch.kernels import int8_matmul as im  # noqa: E402

KEYS = [("dscim1", 256, "paper"), ("dscim1", 64, "paper"),
        ("dscim2", 64, "paper")]


def _assert_matches(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def _int8(seed, M, K, N):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (M, K)).astype(np.int8),
            rng.integers(-128, 128, (K, N)).astype(np.int8))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_fold_constants_bitwise():
    for key in KEYS + [("dscim1", 256, "opt")]:
        got = ops.fold_constants(calibrated_config(*key))
        want = jops.fold_constants(jcalib(*key))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert ops.round_up(100, 16) == 112 and ops.round_up(128, 16) == 128


@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]}-L{k[1]}")
@pytest.mark.parametrize("shape", [(4, 128, 8), (3, 100, 17), (16, 256, 32)])
def test_dscim_mvm_vs_jax(key, shape):
    """ops.dscim_mvm (unpadded formula) == the reference's padded one,
    at K = 100 as well as at tile-aligned K."""
    x, w = _int8(sum(shape) + key[1], *shape)
    want = np.asarray(jops.dscim_mvm(jnp.asarray(x), jnp.asarray(w),
                                     jcalib(*key), bm=8, bn=8, bk=16))
    got = ops.dscim_mvm(*_t(x, w), calibrated_config(*key))
    assert got.dtype == torch.float32 and got.shape == shape[::2]
    _assert_matches(got.numpy(), want)


def test_dscim_mvm_vs_jax_center_truncation():
    key = ("dscim1", 256, "opt")
    x, w = _int8(7, 5, 130, 9)
    want = np.asarray(jops.dscim_mvm(jnp.asarray(x), jnp.asarray(w),
                                     jcalib(*key), bm=8, bn=8, bk=8))
    _assert_matches(ops.dscim_mvm(*_t(x, w), calibrated_config(*key)).numpy(),
                    want)


@pytest.mark.parametrize("key", KEYS + [("dscim2", 128, "opt")],
                         ids=lambda k: f"{k[0]}-L{k[1]}-{k[2]}")
def test_dscim_counts_vs_pallas_and_lut(key):
    """Kernel 6's CPU route: bitwise equal to the Pallas kernel and to the
    joint-count LUT, for an odd K."""
    x, w = _int8(5, 16, 136, 16)
    cfg, jcfg = calibrated_config(*key), jcalib(*key)
    got = dscim_mvm.dscim_counts(*_t(x, w), *ops.fold_constants(cfg),
                                 k=cfg.k, length=cfg.length).numpy()
    want = np.asarray(dscim_counts_pallas(
        jnp.asarray(x), jnp.asarray(w), *jops.fold_constants(jcfg), k=jcfg.k,
        length=jcfg.length, bm=16, bn=16, bk=8, bl=min(jcfg.length, 64)))
    np.testing.assert_array_equal(got, want)
    lut = np.asarray(JMacro(jcfg).counts_lut(jnp.asarray(x),
                                             jnp.asarray(w)))
    np.testing.assert_array_equal(got, lut)


def test_dscim_counts_skewed_point_set():
    """A point set the calibrated presets never give: 200 of L=256 points
    in one block (more than 32, so 8-word masks), the rest spread, some
    with block codes outside [0, 2^k) that belong to no row.  The count
    tables and the all-L plain version agree bitwise with the Pallas
    kernel."""
    rng = np.random.default_rng(3)
    L, k = 256, 3
    cu = np.where(np.arange(L) < 200, 2, rng.integers(-1, 9, L))
    cv = np.where(np.arange(L) < 200, 5, rng.integers(0, 8, L))
    lu, lv = rng.integers(0, 32, L), rng.integers(0, 32, L)
    pts = [a.astype(np.int32) for a in (cu, lu, cv, lv)]
    tu, tv = dscim_mvm.points_by_block(*pts, k)
    assert tu.shape == (64, 200)
    ta, _ = dscim_mvm.count_mask_tables(tu, tv, 32)
    assert ta.shape == (64, 32, 8)
    x, w = _int8(4, 8, 200, 12)
    got = dscim_mvm.dscim_counts(*_t(x, w), *_t(*pts), k=k,
                                 length=L).numpy()
    want = np.asarray(dscim_counts_pallas(
        jnp.asarray(x), jnp.asarray(w), *(jnp.asarray(p) for p in pts), k=k,
        length=L, bm=8, bn=12, bk=8, bl=64))
    np.testing.assert_array_equal(got, want)
    assert want.max() > 32   # the dense block fires more than one word's worth


def test_count_mask_tables_reproduce_the_counts():
    """popc(ta & tb) summed over rows, in numpy, equals the LUT counts:
    the rewrite the count kernel computes, checked where it can run."""
    cfg = calibrated_config("dscim1", 256, "paper")
    tu, tv, _ = blocked.block_point_tables(cfg)
    ta, tb = dscim_mvm.count_mask_tables(tu, tv, cfg.sbits)
    x, w = _int8(9, 3, 40, 5)
    a = (x.astype(np.int64) + 128) >> cfg.k
    b = (w.astype(np.int64) + 128) >> cfg.k
    g = np.arange(40) % cfg.group
    both = ta.view(np.uint32)[g[None, :, None], a[:, :, None]] \
        & tb.view(np.uint32)[g[None, :, None], b[None, :, :]]
    popc = np.unpackbits(both.view(np.uint8), axis=-1).sum(-1)
    want = DSCIMMacro(cfg).counts_lut(*_t(x, w)).numpy()
    np.testing.assert_array_equal(popc.sum(1), want)


@pytest.mark.parametrize("key", [("dscim1", 256, "paper"),
                                 ("dscim1", 256, "opt"),
                                 ("dscim2", 64, "paper"),
                                 ("dscim2", 128, "opt")],
                         ids=lambda k: f"{k[0]}-L{k[1]}-{k[2]}")
def test_dscim_counts_blocked_vs_jax(key):
    """Kernel 5's CPU route == the reference's blocked kernel, bitwise,
    and == kernel 6 (the two compute the same function)."""
    x, w = _int8(11, 16, 128, 16)
    cfg = calibrated_config(*key)
    got = blocked.dscim_counts_blocked(*_t(x, w), cfg).numpy()
    want = np.asarray(jblocked(jnp.asarray(x), jnp.asarray(w), jcalib(*key),
                               bm=16, bn=16, bk=16))
    np.testing.assert_array_equal(got, want)
    all_l = dscim_mvm.dscim_counts(*_t(x, w), *ops.fold_constants(cfg),
                                   k=cfg.k, length=cfg.length).numpy()
    np.testing.assert_array_equal(got, all_l)


def test_dscim_counts_blocked_odd_shape_and_chunking(monkeypatch):
    """Odd M/K/N, and N chunking invisible in the plain version."""
    cfg = calibrated_config("dscim2", 64, "paper")
    x, w = _int8(2, 5, 77, 19)
    want = DSCIMMacro(cfg).counts_lut(*_t(x, w)).numpy()
    got = blocked.dscim_counts_blocked(*_t(x, w), cfg).numpy()
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(dscim_mvm, "BIT_BUDGET", 1)
    monkeypatch.setattr(blocked, "BIT_BUDGET", 1)
    np.testing.assert_array_equal(
        blocked.dscim_counts_blocked(*_t(x, w), cfg).numpy(), want)
    np.testing.assert_array_equal(
        dscim_mvm.dscim_counts(*_t(x, w), *ops.fold_constants(cfg), k=cfg.k,
                               length=cfg.length).numpy(), want)


@pytest.mark.parametrize("key,lead,K,N", [
    (("dscim1", 256, "paper"), (5,), 200, 16),
    (("dscim2", 64, "paper"), (2, 3), 100, 10),
    (("dscim1", 256, "opt"), (4,), 130, 11)],
    ids=["dscim1-odd-window", "dscim2-lead", "dscim1-center"])
def test_staged_vs_jax_and_fused(key, lead, K, N):
    """The staged per-window baseline == the reference's staged path and ==
    the port's fused path (f32 order); the window's float-zero pad rows
    count as real rows on every side."""
    rng = np.random.default_rng(K + N)
    x = rng.normal(0, 1, (*lead, K)).astype(np.float32)
    w = rng.normal(0, 1, (K, N)).astype(np.float32)
    cfg = calibrated_config(*key)
    got = dscim_fused.dscim_windowed_vmap_mvm(*_t(x, w), cfg, group_k=128)
    assert got.shape == (*lead, N) and got.dtype == torch.float32
    want = np.asarray(jstaged(jnp.asarray(x), jnp.asarray(w), jcalib(*key),
                              group_k=128))
    _assert_matches(got.numpy(), want)
    fused = dscim_fused.dscim_fused_mvm(*_t(x, w), cfg, group_k=128)
    _assert_matches(got.numpy(), fused.numpy())


def test_staged_counts_one_blocked_launch_per_window(monkeypatch):
    """The staged path calls the blocked wrapper once per window."""
    calls = []
    real = dscim_fused.dscim_counts_blocked
    monkeypatch.setattr(dscim_fused, "dscim_counts_blocked",
                        lambda x, w, cfg: calls.append(x.shape) or real(
                            x, w, cfg))
    x = torch.randn(3, 300)
    w = torch.randn(300, 7)
    dscim_fused.dscim_windowed_vmap_mvm(x, w, calibrated_config("dscim1", 256),
                                        group_k=128)
    assert calls == [(3, 128)] * 3


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (7, 33, 5), (37, 300, 65),
                                   (16, 256, 32)])
def test_int8_matmul_bitwise(M, K, N):
    x, w = _int8(M * K + N, M, K, N)
    want = np.asarray(jops.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                       bm=16, bn=16, bk=32))
    got = ops.int8_matmul(*_t(x, w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.int8_matmul_ref(jnp.asarray(x), jnp.asarray(w))))
    # int32 operands holding int8 values go through the same cast
    np.testing.assert_array_equal(
        im.int8_matmul(torch.from_numpy(x.astype(np.int32)),
                       torch.from_numpy(w.astype(np.int32))).numpy(), want)


@pytest.mark.parametrize("key", [("dscim1", 256, "paper"),
                                 ("dscim2", 64, "opt")],
                         ids=lambda k: f"{k[0]}-L{k[1]}-{k[2]}")
def test_macro_rmse_equals_jax(key):
    """DSCIMMacro.rmse draws the reference's operands and returns the
    reference's numbers (the counts are exact and the corrections here are
    exact in f32, so the RMSE is equal, not merely close)."""
    want = JMacro(jcalib(*key)).rmse(n_cols=64, n_vec=16, seed=0)
    mac = DSCIMMacro(calibrated_config(*key))
    for backend in ("lut", "kernel"):
        got = mac.rmse(n_cols=64, n_vec=16, seed=0, backend=backend,
                       device="cpu")
        for name in ("rms_abs", "bias", "unsigned_fullscale"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-12)


def test_macro_backends_vs_jax():
    """mvm's lut, bitmatmul and kernel backends: counts_bitmatmul bitwise
    equal to the reference's, the three estimates equal (K = 100 ends in a
    partial dscim2 OR group)."""
    key = ("dscim2", 64, "paper")
    x, w = _int8(13, 4, 100, 6)
    x32, w32 = x.astype(np.int32), w.astype(np.int32)
    jm, m = JMacro(jcalib(*key)), DSCIMMacro(calibrated_config(*key))
    np.testing.assert_array_equal(
        m.counts_bitmatmul(*_t(x32, w32)).numpy(),
        np.asarray(jm.counts_bitmatmul(jnp.asarray(x32), jnp.asarray(w32))))
    want = np.asarray(jm.mvm(jnp.asarray(x32), jnp.asarray(w32), "lut"))
    for backend in ("lut", "bitmatmul", "kernel"):
        np.testing.assert_array_equal(
            m.mvm(*_t(x32, w32), backend=backend).numpy(), want)


def test_macro_cycle_backend_vs_jax():
    """mvm's cycle backend: counts_cycle bitwise equal to the reference's
    and the estimate equal to the reference's lut estimate (K = 128: the
    cycle OR-MAC, the reference's too, takes whole OR groups)."""
    key = ("dscim2", 64, "paper")
    x, w = _int8(13, 4, 128, 6)
    x32, w32 = x.astype(np.int32), w.astype(np.int32)
    jm, m = JMacro(jcalib(*key)), DSCIMMacro(calibrated_config(*key))
    np.testing.assert_array_equal(m.counts_cycle(*_t(x32, w32)).numpy(),
                                  jm.counts_cycle(x32, w32))
    want = np.asarray(jm.mvm(jnp.asarray(x32), jnp.asarray(w32), "lut"))
    np.testing.assert_array_equal(
        m.mvm(*_t(x32, w32), backend="cycle").numpy(), want)


def test_operator_wrappers_take_the_plain_route_on_cpu():
    """On CPU tensors no wrapper launches (no count moves)."""
    from repro_torch.kernels import flash_attention as fa

    counters = (dscim_mvm.LAUNCHES, blocked.LAUNCHES, im.LAUNCHES,
                fa.LAUNCHES)
    before = [c.count for c in counters]
    cfg = calibrated_config("dscim1", 64)
    x, w = _t(*_int8(1, 2, 20, 3))
    ops.dscim_mvm(x, w, cfg)
    blocked.dscim_counts_blocked(x, w, cfg)
    ops.int8_matmul(x, w)
    q = torch.randn(1, 8, 4)
    fa.flash_attention(q, q, q)
    assert [c.count for c in counters] == before
