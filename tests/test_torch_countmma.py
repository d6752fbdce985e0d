"""The count kernel's tensor-core operand layout, emulated on the CPU.

``tile_counts`` walks one output tile of ``csrc/dscim_counts.cu`` as the
source does: int8 slabs of four k256 steps (32/W K-rows, zero-filled past
the edges), each turned into the b1 fragments of its
``mma.sync m16n8k256 .b1 .and.popc`` products by one table lookup a byte
(word slot s of a step holds word s % W of K-row (8/W)*step + s / W;
K-rows past K give zero masks; thread group gid holds columns 2gid and
2gid + 1 of an m16 tile as its rows gid and gid + 8).  The fragments are
then read back as matrices by the PTX fragment layout, ANDed, popcounted
and summed, split over K-slices as the kernel may split them, and written
through the C fragment to the output elements the source's epilogue
names.  The counts must equal the JAX reference's count kernels
(interpret mode) bitwise, so a layout error shows without a card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.seed_search import calibrated_config as jcalib  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.dscim_mvm import dscim_counts_pallas  # noqa: E402
from repro.kernels.dscim_mvm_blocked import (  # noqa: E402
    dscim_counts_blocked as jblocked)
from repro_torch.core.seed_search import calibrated_config  # noqa: E402
from repro_torch.kernels import dscim_mvm  # noqa: E402
from repro_torch.kernels.dscim_mvm_blocked import (  # noqa: E402
    block_point_tables)

STEPS = 4          # kSteps: k256 steps a slab
LANES = np.arange(32)
GID, TIG = LANES >> 2, LANES & 3


def block_shape(M: int, k: int, W: int) -> tuple[int, int]:
    """(columns, rows) a block: the m16 and n8 sides of its tile, as the
    source's ``run_rows`` picks them: 256 x 128 past M = 8 where that
    block's shared memory (tables, two mask buffers, three ring stages)
    fits 227 KB, else 128 x 8."""
    R = 8 * STEPS // W
    smem = (8 * 4 ** k * (256 >> k) * W + 2 * STEPS * 32 * (256 + 128)
            + 3 * (R * (256 + 16) + 128 * (R + 16)))
    return (256, 128) if M > 8 and smem <= 232448 else (128, 8)


def slab_fragments(x, w, ta, tb, k, W, n0, m0, s, BN, BM):
    """The source's ``build`` of slab s of the tile at (n0, m0): A (steps,
    BN/16, 32, 4) uint32, one uint4 a lane of each m16 tile, and B (steps,
    BM/8, 32, 2), one uint2 a lane of each n8 tile."""
    (M, K), N = x.shape, w.shape[1]
    G, S = ta.shape[:2]
    lw = W.bit_length() - 1
    R, rps = 32 >> lw, 8 >> lw
    h0 = s * R
    # the ring stage: R K-rows of w's BN columns, x's BM rows, zero-filled
    ws = np.zeros((R, BN), np.uint8)
    xs = np.zeros((BM, R), np.uint8)
    rk, cn, rm = min(R, K - h0), max(0, min(BN, N - n0)), min(BM, M - m0)
    ws[:rk, :cn] = w[h0:h0 + rk, n0:n0 + cn].view(np.uint8)
    xs[:rm, :rk] = x[m0:m0 + rm, h0:h0 + rk].view(np.uint8)
    A = np.zeros((STEPS, BN // 16, 32, 4), np.uint32)
    B = np.zeros((STEPS, BM // 8, 32, 2), np.uint32)
    for ks in range(STEPS):
        for half in range(2):
            sl = TIG + 4 * half                         # word slot
            rr = ks * rps + (sl >> lw)                  # K-row in the slab
            h = h0 + rr
            j = sl & (W - 1)
            ok = h < K
            for t in range(BN // 16):
                for hi in range(2):
                    byte = ws[np.minimum(rr, R - 1), t * 16 + 2 * GID + hi]
                    v = tb[h % G, (byte ^ 0x80) >> k, j]
                    A[ks, t, :, 2 * half + hi] = np.where(ok, v, 0)
            for q in range(BM // 8):
                byte = xs[q * 8 + GID, np.minimum(rr, R - 1)]
                v = ta[h % G, (byte ^ 0x80) >> k, j]
                B[ks, q, :, half] = np.where(ok, v, 0)
    return A, B


def ptx_a(frag):
    """(..., 32, 4) A fragments -> (..., 16, 8) words of the m16 x k256
    operand: register r of lane (gid, tig) is row gid + 8*(r & 1), bits
    32*(tig + 4*(r >> 1)) onwards."""
    out = np.zeros(frag.shape[:-2] + (16, 8), np.uint32)
    for r in range(4):
        out[..., GID + 8 * (r & 1), TIG + 4 * (r >> 1)] = frag[..., r]
    return out


def ptx_b(frag):
    """(..., 32, 2) B fragments -> (..., 8, 8): column gid, word slot
    tig + 4*r of register r."""
    out = np.zeros(frag.shape[:-2] + (8, 8), np.uint32)
    for r in range(2):
        out[..., GID, TIG + 4 * r] = frag[..., r]
    return out


def popcount(v):
    v = v.astype(np.int64)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def tile_counts(x, w, ta, tb, k, n0, m0, split=1):
    """One output tile as the kernel computes it: per K-slice the products
    of every slab (D = A . B^T by AND and popcount, s32), the slices added
    as integers, and each C fragment element (row gid + 8*(e >> 1), column
    2*tig + (e & 1) of D) written to column n0 + t*16 + 2*gid + (e >> 1),
    row m0 + q*8 + 2*tig + (e & 1).  Returns {(m, n): count}."""
    (M, K), N = x.shape, w.shape[1]
    W = ta.shape[2]
    BN, BM = block_shape(M, k, W)
    ns = -(-K // (32 // W))
    D = np.zeros((BN // 16, BM // 8, 16, 8), np.int64)
    for c in range(split):
        part = np.zeros_like(D)
        for s in range(c * ns // split, (c + 1) * ns // split):
            A, B = slab_fragments(x, w, ta, tb, k, W, n0, m0, s, BN, BM)
            a, b = ptx_a(A), ptx_b(B)             # (steps, T, 16, 8) ...
            both = a[:, :, None, :, None, :] & b[:, None, :, None, :, :]
            part += popcount(both).sum(axis=(0, -1))
        D += part
    got = {}
    for t in range(BN // 16):
        for q in range(BM // 8):
            for e in range(4):
                val = D[t, q, GID + 8 * (e >> 1), 2 * TIG + (e & 1)]
                ns_ = n0 + t * 16 + 2 * GID + (e >> 1)
                ms_ = m0 + q * 8 + 2 * TIG + (e & 1)
                for lane in range(32):
                    if ms_[lane] < M and ns_[lane] < N:
                        got[(int(ms_[lane]), int(ns_[lane]))] = int(val[lane])
    return got


def kernel_counts(x, w, ta, tb, k, split=1):
    """The whole (M, N) count matrix, tile by tile; every element must be
    written exactly once."""
    (M, K), N = x.shape, w.shape[1]
    out = np.full((M, N), -1, np.int64)
    BN, BM = block_shape(M, k, ta.shape[2])
    for m0 in range(0, M, BM):
        for n0 in range(0, N, BN):
            for (m, n), v in tile_counts(x, w, ta, tb, k, n0, m0,
                                         split).items():
                assert out[m, n] == -1
                out[m, n] = v
    assert (out >= 0).all()
    return out


def _int8(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("M", [3, 16, 40])
@pytest.mark.parametrize("key", [("dscim1", 256, "paper"),
                                 ("dscim2", 64, "paper")],
                         ids=lambda k: f"{k[0]}-L{k[1]}-{k[2]}")
def test_operand_layout_vs_jax_presets(key, M):
    """W = 1 (the presets): K = 144 is four and a half slabs, N = 272 a
    ragged column tile past one or two whole ones (128 or 256 columns a
    block); both JAX count kernels agree."""
    K, N = 144, 272
    x, w = _int8(M, M, K), _int8(M + 1, K, N)
    cfg, jcfg = calibrated_config(*key), jcalib(*key)
    tu, tv, _ = block_point_tables(cfg)
    ta, tb = (t.view(np.uint32) for t in
              dscim_mvm.count_mask_tables(tu, tv, cfg.sbits))
    assert ta.shape[2] == 1
    got = kernel_counts(x, w, ta, tb, cfg.k, split=2)
    xp = np.zeros((48, K), np.int8)
    xp[:M] = x
    want = np.asarray(jblocked(jnp.asarray(xp), jnp.asarray(w), jcfg,
                               bm=16, bn=16, bk=16))[:M]
    np.testing.assert_array_equal(got, want.astype(np.int64))
    want6 = np.asarray(dscim_counts_pallas(
        jnp.asarray(xp), jnp.asarray(w), *jops.fold_constants(jcfg),
        k=jcfg.k, length=jcfg.length, bm=16, bn=16, bk=16,
        bl=min(jcfg.length, 64)))[:M]
    np.testing.assert_array_equal(got, want6.astype(np.int64))


def _dense_points(P, seed):
    """L = 256 points at k = 3: P of them in one block (so W words of
    masks, 32*W >= P), the rest spread, some with block codes outside
    [0, 2^k) that belong to no row."""
    rng = np.random.default_rng(seed)
    L = 256
    cu = np.where(np.arange(L) < P, 2, rng.integers(-1, 9, L))
    cv = np.where(np.arange(L) < P, 5, rng.integers(0, 8, L))
    lu, lv = rng.integers(0, 32, L), rng.integers(0, 32, L)
    return [a.astype(np.int32) for a in (cu, lu, cv, lv)]


@pytest.mark.parametrize("P,W", [(40, 2), (100, 4), (200, 8)])
def test_operand_layout_multiword_vs_jax(P, W):
    """W = 2, 4 and 8 words a K-row (8/W K-rows a k256 step): a synthetic
    point set with P points in one block, against the JAX all-L kernel; K
    = 133 ends inside a k256 step (not a multiple of 8/W for W < 8), and
    the K split has unequal slices."""
    k = 3
    pts = _dense_points(P, P)
    tu, tv = dscim_mvm.points_by_block(*pts, k)
    ta, tb = (t.view(np.uint32)
              for t in dscim_mvm.count_mask_tables(tu, tv, 256 >> k))
    assert ta.shape == (64, 32, W)
    M, K, N = 8, 133, 24
    x, w = _int8(W, M, K), _int8(W + 1, K, N)
    got = kernel_counts(x, w, ta, tb, k, split=3)
    want = np.asarray(dscim_counts_pallas(
        jnp.asarray(x), jnp.asarray(w), *(jnp.asarray(p) for p in pts), k=k,
        length=256, bm=8, bn=24, bk=7, bl=64)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    assert want.max() > 32          # more than one word's worth fires


def test_operand_layout_wide_tables_stay_on_8_row_tile():
    """k = 3 with 8-word masks (128 KB of tables): past M = 8 the 256 x 128
    block's shared memory cannot hold them, so 20 rows go through three
    128 x 8 tiles, still equal to the JAX all-L kernel."""
    k, M, K, N = 3, 20, 70, 140
    assert block_shape(M, k, 4) == (256, 128)
    assert block_shape(M, k, 8) == (128, 8)
    pts = _dense_points(200, 7)
    tu, tv = dscim_mvm.points_by_block(*pts, k)
    ta, tb = (t.view(np.uint32)
              for t in dscim_mvm.count_mask_tables(tu, tv, 256 >> k))
    assert ta.shape[2] == 8
    x, w = _int8(20, M, K), _int8(21, K, N)
    got = kernel_counts(x, w, ta, tb, k, split=2)
    xp = np.zeros((24, K), np.int8)
    xp[:M] = x
    want = np.asarray(dscim_counts_pallas(
        jnp.asarray(xp), jnp.asarray(w), *(jnp.asarray(p) for p in pts), k=k,
        length=256, bm=8, bn=28, bk=7, bl=64))[:M].astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_epilogue_map_covers_the_tile():
    """The C fragment elements of a block map one to one onto its
    BN x BM outputs, for each of the two block shapes."""
    for BN, BM in (block_shape(M, 2, 1) for M in (8, 9)):
        seen = set()
        for t in range(BN // 16):
            for q in range(BM // 8):
                for e in range(4):
                    for lane in range(32):
                        seen.add((q * 8 + 2 * (lane & 3) + (e & 1),
                                  t * 16 + 2 * (lane >> 2) + (e >> 1)))
        assert seen == {(m, n) for m in range(BM) for n in range(BN)}
