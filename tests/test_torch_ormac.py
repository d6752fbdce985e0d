"""Port parity, the paper-model core: the cycle-level OR-MAC
(``core/ormac.py``), ``DSCIMMacro``'s ``cycle`` backend, the seed search
(``core/seed_search.py rmse_numpy`` / ``search``) and the 40nm hardware
model (``core/hwmodel.py``), on the same numpy inputs as the reference.
Contracts, all exact (integer counts, and the same float64 arithmetic in
the same order):

* ``sng_bits``, ``dscim_bitstreams``, ``check_disjoint`` and
  ``dscim_group_count`` (total and per-cycle sums) equal the reference's
  on every calibrated preset's points;
* ``counts_cycle`` equals the reference's ``counts_cycle``, the port's
  ``counts_lut``, ``counts_bitmatmul`` and ``counts_kernel`` (its plain
  version here), and ``mvm(backend='cycle')`` equals the reference's, for
  DS-CIM1 and DS-CIM2; the vectorised product equals the per-column one;
* ``naive_or_count`` equals the reference's (same PRNG draws);
* ``rmse_numpy`` and ``search`` over a small grid return the reference's
  numbers and candidates;
* ``HWModel.summary()`` for ``DSCIM1_HW`` / ``DSCIM2_HW`` at several
  lengths, signed and unsigned, equals the reference's.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import hwmodel as jhw  # noqa: E402
from repro.core import ormac as jormac  # noqa: E402
from repro.core import seed_search as jss  # noqa: E402
from repro.core.macro import DSCIMMacro as JMacro  # noqa: E402
from repro_torch.core import hwmodel, ormac, seed_search  # noqa: E402
from repro_torch.core.macro import DSCIMMacro  # noqa: E402

PRESETS = [("dscim1", 256, "paper"), ("dscim2", 64, "paper"),
           ("dscim1", 64, "opt"), ("dscim2", 128, "opt")]


def _macros(key):
    return (JMacro(jss.calibrated_config(*key)),
            DSCIMMacro(seed_search.calibrated_config(*key)))


@pytest.mark.parametrize("key", PRESETS)
def test_group_count_matches_reference(key):
    jm, m = _macros(key)
    k = m.cfg.k
    S = 256 >> k
    rng = np.random.default_rng(1000 * m.cfg.k + m.cfg.length)
    for H in (128, 4 ** k * 3):
        a = rng.integers(0, S, H)
        w = rng.integers(0, S, H)
        ja, jw = jormac.dscim_bitstreams(a, w, jm.u, jm.v, k)
        ta, tw = ormac.dscim_bitstreams(a, w, m.u, m.v, k)
        np.testing.assert_array_equal(ta.numpy(), ja)
        np.testing.assert_array_equal(tw.numpy(), jw)
        assert ormac.check_disjoint(ta & tw, k) is True \
            is jormac.check_disjoint(ja & jw, k)
        jc, jpc = jormac.dscim_group_count(a, w, jm.u, jm.v, k,
                                           assert_disjoint=True)
        tc, tpc = ormac.dscim_group_count(a, w, m.u, m.v, k,
                                          assert_disjoint=True)
        assert tc == jc
        np.testing.assert_array_equal(tpc.numpy(), jpc)
        assert int(tpc.max()) <= H // 4 ** k
    vals = rng.integers(0, 256, (3, 5))
    np.testing.assert_array_equal(ormac.sng_bits(vals, m.u).numpy(),
                                  jormac.sng_bits(vals, jm.u))


def test_check_disjoint_sees_a_collision():
    """Two product bits of one OR group in one cycle break the invariant,
    for both implementations."""
    p = np.zeros((32, 8), np.uint8)
    assert ormac.check_disjoint(p, 2) and jormac.check_disjoint(p, 2)
    p[3, 5] = p[9, 5] = 1                       # rows 3 and 9: group 0
    assert not ormac.check_disjoint(p, 2)
    assert not jormac.check_disjoint(p, 2)
    p[9, 5] = 0
    p[17, 5] = 1                                # row 17: group 1
    assert ormac.check_disjoint(p, 2) and jormac.check_disjoint(p, 2)


@pytest.mark.parametrize("key", PRESETS)
@pytest.mark.parametrize("M,K,N", [(4, 64, 16), (3, 128, 5)])
def test_counts_cycle_matches_reference_and_lut(key, M, K, N, monkeypatch):
    jm, m = _macros(key)
    if K % m.cfg.group:
        K = m.cfg.group * (K // m.cfg.group + 1)
    rng = np.random.default_rng(M * K + N)
    x = rng.integers(-128, 128, (M, K)).astype(np.int32)
    w = rng.integers(-128, 128, (K, N)).astype(np.int32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    want = jm.counts_cycle(x, w)
    got = m.counts_cycle(tx, tw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(m.counts_lut(tx, tw).numpy(), want)
    np.testing.assert_array_equal(m.counts_bitmatmul(tx, tw).numpy(), want)
    np.testing.assert_array_equal(m.counts_kernel(tx.to(torch.int8),
                                                  tw.to(torch.int8)).numpy(),
                                  want)
    # one row at a time: the same counts
    a, b = m._shift(tx, tw)
    monkeypatch.setattr(ormac, "MAX_BITS", 1)
    np.testing.assert_array_equal(
        ormac.dscim_counts_cycle(a, b, m.u, m.v, m.cfg.k).numpy(), want)
    np.testing.assert_array_equal(
        m.mvm(tx, tw, backend="cycle").numpy(),
        np.asarray(jm.mvm(jnp.asarray(x), jnp.asarray(w), "cycle")))


def test_counts_cycle_refuses_partial_groups():
    _, m = _macros(("dscim1", 256, "paper"))
    x = torch.zeros((2, 20), dtype=torch.int32)
    with pytest.raises(ValueError, match="OR groups"):
        m.counts_cycle(x, torch.zeros((20, 3), dtype=torch.int32))


@pytest.mark.parametrize("group,L,kind", [(16, 64, "lfsr"), (64, 128, "lfsr"),
                                          (16, 256, "galois")])
def test_naive_or_count_matches_reference(group, L, kind):
    rng = np.random.default_rng(group + L)
    a = rng.integers(0, 256, 128)
    w = rng.integers(0, 256, 128)
    got = ormac.naive_or_count(a, w, L, group, seed=5, kind=kind)
    assert got == jormac.naive_or_count(a, w, L, group, seed=5, kind=kind)
    assert got[0] <= got[1]                     # the OR saturates


@pytest.mark.parametrize("key", [("dscim1", 64, "paper"),
                                 ("dscim2", 256, "opt")])
@pytest.mark.parametrize("dist", ["uniform", "gaussian"])
def test_rmse_numpy_matches_reference(key, dist):
    jm, m = _macros(key)
    c = m.cfg
    got = seed_search.rmse_numpy(m.lut_np, c.k, c.length, n_vec=16,
                                 n_cols=64, seed=1, trunc=c.trunc,
                                 dist=dist)
    assert got == jss.rmse_numpy(jm.lut_np, c.k, c.length, n_vec=16,
                                 n_cols=64, seed=1, trunc=c.trunc,
                                 dist=dist)


@pytest.mark.parametrize("k,L,trunc", [(2, 64, "floor"), (3, 128, "center")])
def test_search_matches_reference(k, L, trunc):
    kw = dict(trunc=trunc, kinds=("lfsr", "weyl", "sobol"), seeds=(7, 91),
              params=(0, 1), n_vec=8, n_cols=32, top=6)
    want = jss.search(k, L, **kw)
    got = seed_search.search(k, L, **kw)
    assert [dataclasses.asdict(c) for c in got] == \
        [dataclasses.asdict(c) for c in want]
    assert [c.rmse_unsigned for c in got] == sorted(c.rmse_unsigned
                                                    for c in got)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("variant,L", [("DSCIM1_HW", 64), ("DSCIM1_HW", 256),
                                       ("DSCIM2_HW", 64), ("DSCIM2_HW", 256)])
def test_hwmodel_matches_reference(variant, L, signed):
    got = getattr(hwmodel, variant)(L).summary(signed)
    want = getattr(jhw, variant)(L).summary(signed)
    assert got == want
    geo = hwmodel.MacroGeometry(cmr=16, group=16, length=L)
    assert hwmodel.HWModel(geo).summary(signed) == \
        jhw.HWModel(jhw.MacroGeometry(cmr=16, group=16, length=L)).summary(
            signed)
