"""The fused kernel's tensor-core operand layout, emulated on the CPU.

``count_operands`` builds the two operands of the kernel's
``mma.sync m16n8k256 .b1 .and.popc`` products as
``csrc/dscim_fused.cu`` does (one 32-bit point mask per (column or row,
K-row), 8 K-rows per k256 step, zero masks past the window on the
activation side), and ``counts_from_operands`` ANDs, popcounts and sums
them per window.  The counts must equal the JAX reference's blocked count
kernel (interpret mode) window by window, bitwise, so a layout error
shows without a card.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.seed_search import calibrated_config as jcalib  # noqa: E402
from repro.kernels.dscim_mvm_blocked import (  # noqa: E402
    dscim_counts_blocked as jblocked)
from repro_torch.core.seed_search import calibrated_config  # noqa: E402
from repro_torch.kernels import dscim_fused  # noqa: E402
from repro_torch.kernels.dscim_mvm_blocked import (  # noqa: E402
    dscim_counts_blocked_plain)


def mma_column(ta: int, wn: int, t: int, i: int) -> int:
    """The kernel's output column, within its tile, of row i of the m16
    side of mma tile t of warp column wn, when each warp holds ta tiles of
    16 columns (4 at prefill, 1 at decode with split windows, 2 at decode
    without): thread group gid = i % 8 reads the 2*ta neighbouring bytes
    from column wn*16*ta + 2*ta*gid of a weight row, and bytes 2t, 2t + 1
    feed tile t's rows gid, gid + 8."""
    return wn * 16 * ta + 2 * ta * (i % 8) + 2 * t + i // 8


_K_ROWS_PER_STEP = 8      # 32-bit masks per 256-bit operand of one k256 step


def count_operands(xq, wq, cfg):
    """The fused kernel's tensor-core operands, built in plain PyTorch:
    xq (M, nw, g) int8, wq (nw, g, N) int8 -> (A, B) with
    A (nw, steps, 8, N) the weight masks tb[r % G][(w + 128) >> k] and
    B (M, nw, steps, 8) the activation masks ta[r % G][(x + 128) >> k]
    (int64 holding 32-bit words).  Step s of a window is one
    m16n8k256 .b1 operand: the masks of its K-rows 8s .. 8s+7 side by
    side; K-rows past g are zero on the activation side."""
    M, nw, g = xq.shape
    steps = -(-g // _K_ROWS_PER_STEP)
    pad = steps * _K_ROWS_PER_STEP - g
    ta, tb = (torch.as_tensor(t).to(torch.int64) & 0xFFFFFFFF
              for t in dscim_fused.mask_tables(cfg))
    blk = torch.arange(g) % cfg.group
    a = (xq.to(torch.int64) + 128) >> cfg.k                   # (M, nw, g)
    b = (wq.to(torch.int64) + 128) >> cfg.k                   # (nw, g, N)
    A = tb[blk[None, :, None], b]
    B = ta[blk[None, None, :], a]
    A = torch.nn.functional.pad(A, (0, 0, 0, pad))
    B = torch.nn.functional.pad(B, (0, pad))
    return (A.reshape(nw, steps, _K_ROWS_PER_STEP, -1),
            B.reshape(M, nw, steps, _K_ROWS_PER_STEP))


def _popcount32(v):
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101 & 0xFFFFFFFF) >> 24


def counts_from_operands(A, B):
    """What the kernel's b1 ``.and.popc`` products add up, per window:
    C[m, u, n] = sum over steps of popc(A_step & B_step) (M, nw, N) int64."""
    both = A[None] & B[..., None]                 # (M, nw, steps, 8, N)
    return _popcount32(both).sum((2, 3))


def _operands(seed, M, nw, g, N):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (M, nw, g)).astype(np.int8)
    wq = rng.integers(-127, 128, (nw, g, N)).astype(np.int8)
    xq[0, 0] = 0                      # a zero activation window
    wq[0, :, 0] = -127                # a column that never fires
    return xq, wq


@pytest.mark.parametrize("g,nw", [(128, 2), (64, 3)])
@pytest.mark.parametrize("key", [("dscim1", 256, "paper"),
                                 ("dscim2", 64, "paper"),
                                 ("dscim1", 256, "opt")],
                         ids=lambda k: f"{k[0]}-L{k[1]}-{k[2]}")
def test_operand_layout_counts_vs_jax(key, g, nw):
    M, N = 16, 16
    xq, wq = _operands(g + nw, M, nw, g, N)
    A, B = count_operands(torch.from_numpy(xq),
                                      torch.from_numpy(wq),
                                      calibrated_config(*key))
    assert A.shape == (nw, g // 8, 8, N) and B.shape == (M, nw, g // 8, 8)
    assert int(A.max()) < 2 ** 32 and int(B.max()) < 2 ** 32
    got = counts_from_operands(A, B).numpy()
    for u in range(nw):
        want = np.asarray(jblocked(jnp.asarray(xq[:, u]), jnp.asarray(wq[u]),
                                   jcalib(*key), bm=16, bn=16, bk=16))
        np.testing.assert_array_equal(got[:, u], want)


@pytest.mark.parametrize("g", [1, 20, 131])
def test_operand_layout_ragged_window(g):
    """A window that is not a whole number of k256 steps: the zero masks
    past g add nothing (against the port's plain blocked counts, which
    equal the reference's: test_torch_ops.py)."""
    cfg = calibrated_config("dscim1", 256)
    xq, wq = _operands(g, 5, 2, g, 7)
    A, B = count_operands(torch.from_numpy(xq),
                                      torch.from_numpy(wq), cfg)
    got = counts_from_operands(A, B)
    for u in range(2):
        want = dscim_counts_blocked_plain(torch.from_numpy(xq[:, u]).contiguous(),
                                          torch.from_numpy(wq[u]), cfg)
        np.testing.assert_array_equal(got[:, u].numpy(),
                                      want.numpy().astype(np.int64))


@pytest.mark.parametrize("ta,warps", [(1, 4), (2, 4), (4, 1)])
def test_mma_columns_cover_the_tile(ta, warps):
    """The kernel's map from (warp column, mma tile, m16 row) to output
    column is a permutation of the tile (16*ta columns a warp), rows gid
    and gid + 8 of a tile taking the neighbouring bytes 2t, 2t + 1 of
    thread group gid."""
    cols = [mma_column(ta, wn, t, i) for wn in range(warps)
            for t in range(ta) for i in range(16)]
    assert sorted(cols) == list(range(16 * ta * warps))
    for wn in range(warps):
        for t in range(ta):
            for gid in range(8):
                base = wn * 16 * ta + 2 * ta * gid
                assert mma_column(ta, wn, t, gid) == base + 2 * t
                assert mma_column(ta, wn, t, gid + 8) == \
                    base + 2 * t + 1
