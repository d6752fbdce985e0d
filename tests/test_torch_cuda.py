"""The port's CUDA kernels against their plain PyTorch versions on the card,
at odd and test-sized shapes (the full-width serving shapes, and the
reduced config served on the GPU against the CPU, are held by
``chip_smoke.py``); the captured decode step (CUDA graph replays against
the eager loop, bitwise; a capture from a cold process; a failed capture
raising) and the paged flush's C1 case on the card.  Marked ``cuda``: without a GPU every test here skips
(decided inside the fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol):
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= rtol * scale


@pytest.mark.parametrize("key,group_k", [(("dscim1", 256, "paper"), 128),
                                         (("dscim2", 64, "paper"), 64),
                                         (("dscim1", 256, "opt"), None),
                                         (("dscim2", 256, "opt"), 128)])
@pytest.mark.parametrize("M,K,N", [(1, 64, 1), (3, 100, 17), (4, 1024, 96),
                                   (37, 300, 65)])
def test_fused_kernel_vs_plain(cuda, key, group_k, M, K, N):
    from repro_torch.core.qweights import prepare_linear_weight
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_fused

    cfg = calibrated_config(*key)
    rng = np.random.default_rng(M * K + N)
    x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (K, N)).astype(np.float32))
    qw = prepare_linear_weight(w, group_k)
    want = dscim_fused.dscim_fused_mvm_prepared(x, qw, cfg)       # CPU
    qw_c = prepare_linear_weight(w.to(cuda), group_k)
    before = dscim_fused.LAUNCHES.count
    got = dscim_fused.dscim_fused_mvm_prepared(x.to(cuda), qw_c, cfg)
    torch.cuda.synchronize()
    assert dscim_fused.LAUNCHES.count == before + 1
    _close(got.cpu(), want, 2e-5)


@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("KV,R,HD", [(2, 2, 16), (4, 1, 8), (8, 2, 128)])
def test_paged_kernel_vs_plain(cuda, ps, KV, R, HD):
    from repro_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(ps + KV)
    B, MP = 3, 4
    P = B * MP + 2
    args = [
        torch.from_numpy(rng.normal(0, 1, (B, KV, R, HD)).astype(np.float32)),
        torch.from_numpy(rng.integers(-127, 128, (P, ps, KV, HD)).astype(
            np.int8)),
        torch.from_numpy(rng.integers(-127, 128, (P, ps, KV, HD)).astype(
            np.int8)),
        torch.from_numpy(rng.uniform(0.005, 0.02, (P, KV)).astype(
            np.float32)),
        torch.from_numpy(rng.uniform(0.005, 0.02, (P, KV)).astype(
            np.float32)),
        torch.from_numpy(rng.normal(0, 1, (B, ps, KV, HD)).astype(
            np.float32)).to(torch.bfloat16),
        torch.from_numpy(rng.normal(0, 1, (B, ps, KV, HD)).astype(
            np.float32)).to(torch.bfloat16),
        torch.from_numpy(rng.permutation(P)[:B * MP].reshape(B, MP).astype(
            np.int32)),
        torch.from_numpy(np.asarray([0, ps, MP * ps - 1], np.int32)),
    ]
    want = pa.paged_attention_decode(*args)
    got = pa.paged_attention_decode(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    _close(got.cpu(), want, 1e-5)



# (K, N, group_k) per regime-edge row count: ragged N, K not a multiple of
# the window, every window granularity
_FUSED_SHAPES = {1: (300, 65, 128), 4: (1024, 96, None), 8: (200, 131, 64),
                 16: (1000, 17, 128), 17: (130, 200, 64), 64: (513, 64, None),
                 256: (1024, 160, 128), 300: (257, 33, 64)}
_FUSED_PRESETS = [("dscim1", 256, "paper"), ("dscim2", 64, "paper"),
                  ("dscim1", 256, "opt")]


def _fused_pair(cuda, seed, M, K, N, group_k, dtype=torch.float32):
    from repro_torch.core.qweights import prepare_linear_weight

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (K, N)).astype(np.float32))
    return x.to(cuda).to(dtype), prepare_linear_weight(w.to(cuda), group_k)


@pytest.mark.parametrize("key", _FUSED_PRESETS,
                         ids=lambda k: f"{k[0]}-L{k[1]}-{k[2]}")
@pytest.mark.parametrize("M", sorted(_FUSED_SHAPES))
def test_fused_kernel_regimes_vs_plain(cuda, key, M):
    """Both sides of every regime switch (decode M <= 8, <= 16; prefill),
    against the plain version on the same quantized activations."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_fused

    cfg = calibrated_config(*key)
    K, N, group_k = _FUSED_SHAPES[M]
    x, qw = _fused_pair(cuda, M + K, M, K, N, group_k)
    got = dscim_fused.dscim_fused_mvm_prepared(x, qw, cfg)
    xq = dscim_fused.quantize_activations_windowed(x, qw.nw, qw.g)
    want = dscim_fused.dscim_fused_mvm_plain(
        xq.q.contiguous(), xq.scale.reshape(M, qw.nw).contiguous(), qw.q,
        qw.scale, cfg)
    torch.cuda.synchronize()
    _close(got, want, 2e-5)


@pytest.mark.parametrize("key,group_k", [(("dscim1", 256, "paper"), 128),
                                         (("dscim2", 64, "paper"), None),
                                         (("dscim1", 256, "opt"), 64)])
def test_fused_rows_independent_of_batch(cuda, key, group_k):
    """Row i alone (M = 1), in a decode batch and in a prefill batch gives
    the same bits: every output is summed in one fixed order."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_fused

    cfg = calibrated_config(*key)
    x, qw = _fused_pair(cuda, 3, 256, 1000, 200, group_k, torch.bfloat16)
    full = {M: dscim_fused.dscim_fused_mvm_prepared(x[:M], qw, cfg)
            for M in (4, 17, 256)}
    for i in (0, 1, 3):
        alone = dscim_fused.dscim_fused_mvm_prepared(x[i:i + 1], qw, cfg)
        for M, out in full.items():
            assert torch.equal(alone[0], out[i]), (i, M)


@pytest.mark.parametrize("M", [5, 20])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_fused_kernel_quantization_bitwise(cuda, dtype, M):
    """The kernel's own quantization (its quantize kernel, at decode and at
    prefill) equals
    quantize_activations_windowed bitwise: random rows, an all-zero row and
    a window, exact half-way points (x / s = k + 1/2 where s = 1) and
    values past K."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_fused

    dt = getattr(torch, dtype)
    cfg = calibrated_config("dscim1", 256)
    x, qw = _fused_pair(cuda, 5, M, 300, 40, 128, dt)
    x[1] = 0
    x[2, 128:256] = 0
    half = torch.arange(-63, 64, dtype=torch.float32, device=cuda) + 0.5
    x[3, :127] = half.to(dt)
    x[3, 127] = 127
    x[4] *= 1e-6
    out, xq, sx = dscim_fused._launch_kernel(x, qw, cfg)
    want = dscim_fused.quantize_activations_windowed(x, qw.nw, qw.g)
    torch.cuda.synchronize()
    assert torch.equal(xq, want.q)
    assert torch.equal(sx.view(torch.int32),
                       want.scale.reshape(M, qw.nw).view(torch.int32))
    assert torch.equal(out, dscim_fused.dscim_fused_mvm_prepared(x, qw, cfg))


@pytest.mark.parametrize("M", [4, 256])
def test_fused_one_call_device_launches(cuda, M):
    """One wrapper call on the card is at most two device kernels, at
    decode and at prefill (the quantize kernel and the MVM), with no torch
    kernels around them."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_fused

    cfg = calibrated_config("dscim1", 256)
    x, qw = _fused_pair(cuda, 6, M, 1024, 3072, 128, torch.bfloat16)
    dscim_fused.dscim_fused_mvm_prepared(x, qw, cfg)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        dscim_fused.dscim_fused_mvm_prepared(x, qw, cfg)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 1 <= len(names) <= 2, names


def _paged_args(cuda, seed, B, KV, R, HD, ps, MP, pos):
    rng = np.random.default_rng(seed)
    P = B * MP + 2
    args = [
        rng.normal(0, 1, (B, KV, R, HD)).astype(np.float32),
        rng.integers(-127, 128, (P, ps, KV, HD)).astype(np.int8),
        rng.integers(-127, 128, (P, ps, KV, HD)).astype(np.int8),
        rng.uniform(0.005, 0.02, (P, KV)).astype(np.float32),
        rng.uniform(0.005, 0.02, (P, KV)).astype(np.float32),
        rng.normal(0, 1, (B, ps, KV, HD)).astype(np.float32),
        rng.normal(0, 1, (B, ps, KV, HD)).astype(np.float32),
        rng.permutation(P)[:B * MP].reshape(B, MP).astype(np.int32),
        np.asarray(pos, np.int32)]
    out = [torch.from_numpy(a).to(cuda) for a in args]
    out[5], out[6] = out[5].to(torch.bfloat16), out[6].to(torch.bfloat16)
    return out


@pytest.mark.parametrize("ps", [4, 8, 16])
def test_paged_kernel_split_edges(cuda, ps):
    """Positions on page and split-run edges: the tail page alone, a run's
    last and first token (runs are 32 tokens up to 512 tokens of context,
    then 64), several runs, and 2048 tokens of context."""
    from repro_torch.kernels import paged_attention as pa

    pos = [0, ps - 1, ps, 31, 32, 33, 63, 64, 65, 511, 512, 513, 2047]
    args = _paged_args(cuda, ps, len(pos), 2, 2, 128, ps, 2048 // ps, pos)
    got = pa.paged_attention_decode(*args)
    want = pa.paged_read_plain(*args)
    torch.cuda.synchronize()
    _close(got, want, 1e-5)


def test_paged_slot_independent_of_batch(cuda):
    """A slot's output is bitwise the same alone and in a batch of 4."""
    from repro_torch.kernels import paged_attention as pa

    args = _paged_args(cuda, 9, 4, 8, 2, 128, 8, 40, [79, 5, 300, 64])
    full = pa.paged_attention_decode(*args)
    for i in range(4):
        one = [a[i:i + 1] if j in (0, 5, 6, 7, 8) else a
               for j, a in enumerate(args)]
        alone = pa.paged_attention_decode(*[a.contiguous() for a in one])
        assert torch.equal(alone[0], full[i]), i


def _int8_pair(cuda, seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8))
    return x.to(cuda), w.to(cuda)


@pytest.mark.parametrize("key", [("dscim1", 256, "paper"),
                                 ("dscim2", 64, "paper"),
                                 ("dscim1", 64, "opt"),
                                 ("dscim2", 256, "opt")])
@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (3, 100, 17), (9, 300, 65),
                                   (37, 1024, 40)])
def test_count_kernels_vs_plain(cuda, key, M, K, N):
    """Both count wrappers (all-L and blocked) launch the count kernel;
    each is bitwise equal to its plain version and to the other."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_mvm, dscim_mvm_blocked, ops

    cfg = calibrated_config(*key)
    x, w = _int8_pair(cuda, M * K + N, M, K, N)
    pts = ops.fold_constants(cfg)
    before = (dscim_mvm.LAUNCHES.count, dscim_mvm_blocked.LAUNCHES.count)
    c6 = dscim_mvm.dscim_counts(x, w, *pts, k=cfg.k, length=cfg.length)
    c5 = dscim_mvm_blocked.dscim_counts_blocked(x, w, cfg)
    torch.cuda.synchronize()
    assert (dscim_mvm.LAUNCHES.count, dscim_mvm_blocked.LAUNCHES.count) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(c6, dscim_mvm.dscim_counts_plain(x, w, *pts, cfg.k))
    assert torch.equal(c5,
                       dscim_mvm_blocked.dscim_counts_blocked_plain(x, w, cfg))
    assert torch.equal(c5, c6)


def test_count_kernel_all_points_in_one_block(cuda):
    """All L=256 points in one block of k=3 (8-word masks, 128 KB of
    tables): the kernel equals the all-L plain version."""
    from repro_torch.kernels import dscim_mvm

    rng = np.random.default_rng(8)
    L, k = 256, 3
    pts = [torch.full((L,), 3, dtype=torch.int32),
           torch.from_numpy(rng.integers(0, 32, L).astype(np.int32)),
           torch.full((L,), 6, dtype=torch.int32),
           torch.from_numpy(rng.integers(0, 32, L).astype(np.int32))]
    x, w = _int8_pair(cuda, 8, 20, 260, 70)
    got = dscim_mvm.dscim_counts(x, w, *pts, k=k, length=L)
    assert torch.equal(got, dscim_mvm.dscim_counts_plain(x, w, *pts, k))


@pytest.mark.parametrize("M", [1, 4, 16, 17, 64, 256, 300])
def test_count_kernel_rows_and_ragged_edges(cuda, M):
    """Both row-count regimes of the count kernel (8 and 128 rows a
    block) with K = 777 (not a multiple of the 8 K-rows of a k256 step,
    nor of a 32-row slab) and N = 200 (a whole and a ragged 128-column
    tile): both wrappers bitwise equal to their plain versions."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_mvm, dscim_mvm_blocked, ops

    cfg = calibrated_config("dscim1", 256)
    x, w = _int8_pair(cuda, M, M, 777, 200)
    pts = ops.fold_constants(cfg)
    c6 = dscim_mvm.dscim_counts(x, w, *pts, k=cfg.k, length=cfg.length)
    c5 = dscim_mvm_blocked.dscim_counts_blocked(x, w, cfg)
    assert torch.equal(c5, dscim_mvm_blocked.dscim_counts_blocked_plain(
        x, w, cfg))
    assert torch.equal(c6, dscim_mvm.dscim_counts_plain(x, w, *pts, cfg.k))


def _block_points(seed, P, k, L=256):
    """L points at k: P of them in one block (cu = 1, cv = 2), the others
    spread over the blocks; as int32 tensors (cu, lu, cv, lv)."""
    rng = np.random.default_rng(seed)
    n, S = 1 << k, 256 >> k
    cu = np.where(np.arange(L) < P, 1, rng.integers(0, n, L))
    cv = np.where(np.arange(L) < P, 2 % n, rng.integers(0, n, L))
    return [torch.from_numpy(a.astype(np.int32)) for a in
            (cu, rng.integers(0, S, L), cv, rng.integers(0, S, L))]


@pytest.mark.parametrize("M", [9, 64, 300])
def test_count_kernel_wide_tables_past_8_rows(cuda, M):
    """k = 3 with 8-word masks (128 KB of tables, more than the 256 x 128
    block's shared memory leaves them) past M = 8: the kernel takes them
    on its 8-row tile, equal to the all-L plain version."""
    from repro_torch.kernels import dscim_mvm

    pts = _block_points(M, 200, 3)
    x, w = _int8_pair(cuda, 30 + M, M, 300, 260)
    assert dscim_mvm.point_tables(*pts, 3, cuda)[0].shape == (64, 32, 8)
    got = dscim_mvm.dscim_counts(x, w, *pts, k=3, length=256)
    assert torch.equal(got, dscim_mvm.dscim_counts_plain(x, w, *pts, 3))


@pytest.mark.parametrize("M,K,N", [(5, 261, 130), (64, 1030, 300)])
@pytest.mark.parametrize("P,W", [(50, 2), (100, 4)])
def test_count_kernel_multiword_masks(cuda, P, W, M, K, N):
    """W = 2 and 4 words a K-row (33-64 and 65-128 points in one block of
    k = 3; 4 and 2 K-rows a k256 step, K a multiple of neither): the
    all-L wrapper bitwise equal to its plain version."""
    from repro_torch.kernels import dscim_mvm

    k = 3
    pts = _block_points(P, P, k)
    assert dscim_mvm.point_tables(*pts, k, cuda)[0].shape == (64, 32, W)
    x, w = _int8_pair(cuda, P + M, M, K, N)
    got = dscim_mvm.dscim_counts(x, w, *pts, k=k, length=256)
    assert torch.equal(got, dscim_mvm.dscim_counts_plain(x, w, *pts, k))
    assert float(got.max()) > 32


@pytest.mark.parametrize("P", [0, 40])
def test_count_kernel_k1_point_set(cuda, P):
    """A synthetic k = 1 set (4 blocks of 128 local levels, L = 128
    points spread, or 40 of them in one block: 2-word masks)."""
    from repro_torch.kernels import dscim_mvm

    pts = _block_points(11 + P, P, 1, L=128)
    x, w = _int8_pair(cuda, 12 + P, 37, 300, 150)
    got = dscim_mvm.dscim_counts(x, w, *pts, k=1, length=128)
    assert torch.equal(got, dscim_mvm.dscim_counts_plain(x, w, *pts, 1))


def _device_kernels(fn):
    """The names of the device kernels ``fn()`` launches (profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]


def test_count_kernel_split_and_unsplit_plans(cuda):
    """A row's counts are the same bits whether K is split over blocks
    (4 rows: 128 tiles leave block slots idle; the slices add into the
    output that a zero kernel cleared first) or not (300 rows: 192 tiles,
    no zero kernel), equal to the plain version, and the same on repeated
    calls."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_mvm_blocked

    cfg = calibrated_config("dscim1", 256)
    x, w = _int8_pair(cuda, 21, 300, 1024, 16384)
    x4 = x[:4].contiguous()
    dscim_mvm_blocked.dscim_counts_blocked(x4, w, cfg)
    full, unsplit = _device_kernels(
        lambda: dscim_mvm_blocked.dscim_counts_blocked(x, w, cfg))
    _, split = _device_kernels(
        lambda: dscim_mvm_blocked.dscim_counts_blocked(x4, w, cfg))
    assert not any("zero_kernel" in n for n in unsplit), unsplit
    assert any("zero_kernel" in n for n in split), split
    few = [dscim_mvm_blocked.dscim_counts_blocked(x4, w, cfg)
           for _ in range(3)]
    assert torch.equal(full, dscim_mvm_blocked.dscim_counts_blocked_plain(
        x, w, cfg))
    for f in few:
        assert torch.equal(f, full[:4])


def test_count_kernel_refuses_what_it_cannot_take(cuda):
    """Tables past shared memory (k = 4, 8 words: 256 KB) and K*32*W >=
    2^24 (counts where the f32 adds of K-slices are no longer exact) raise
    without a launch, in the wrapper and in the C entry."""
    from repro_torch.kernels import build, dscim_mvm

    counter = build.LaunchCounter("refused")
    x, w = _int8_pair(cuda, 5, 2, 40, 16)
    big = torch.zeros((256, 16, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dscim_mvm.launch_counts(x, w, big, big, 4, counter)
    K = (1 << 24) // (32 * 8)
    x, w = _int8_pair(cuda, 6, 1, K, 1)
    tab = torch.zeros((64, 32, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dscim_mvm.launch_counts(x, w, tab, tab, 3, counter)
    out = torch.empty((1, 1), dtype=torch.float32, device=cuda)
    entry = build.bind("dscim_counts", "dscim_counts_launch",
                       dscim_mvm.ARGTYPES)
    assert entry(x.data_ptr(), w.data_ptr(), tab.data_ptr(), tab.data_ptr(),
                 out.data_ptr(), 1, K, 1, 3, 64, 32, 8,
                 torch.cuda.current_stream(cuda).cuda_stream) == -1
    assert counter.count == 0


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (7, 33, 5), (37, 300, 65),
                                   (65, 129, 130), (4, 1024, 3072)])
def test_int8_matmul_kernel_vs_plain(cuda, M, K, N):
    from repro_torch.kernels import int8_matmul as im

    x, w = _int8_pair(cuda, M + K + N, M, K, N)
    before = im.LAUNCHES.count
    got = im.int8_matmul(x, w)
    torch.cuda.synchronize()
    assert im.LAUNCHES.count == before + 1
    assert torch.equal(got, im.int8_matmul_plain(x, w))


@pytest.mark.parametrize("M,K,N", [(256, 1024, 3072), (256, 3072, 1024),
                                   (4, 1024, 3072), (1536, 256, 1536),
                                   (300, 2048, 4096), (64, 4096, 256)])
def test_int8_matmul_kernel_split_plans(cuda, M, K, N):
    """qwen3-0.6b's MLP shapes and three more cover the kernel's plans on
    a 132-SM card: 64-row tiles unsplit (96 and 160 tiles), split 4 ways
    (32 and 24 tiles) and 64 ways (2 tiles), and 128-row tiles (144); each
    is bitwise equal to the plain version and to ``torch._int_mm``."""
    from repro_torch.kernels import int8_matmul as im

    x, w = _int8_pair(cuda, M * 7 + K + N, M, K, N)
    got = im.int8_matmul(x, w)
    assert torch.equal(got, im.int8_matmul_plain(x, w))
    xp = torch.zeros((max(32, -(-M // 8) * 8), K), dtype=torch.int8,
                     device=cuda)
    xp[:M] = x
    assert torch.equal(got, torch._int_mm(xp, w)[:M])


@pytest.mark.parametrize("K", [1, 31, 33, 4097])
@pytest.mark.parametrize("M,N", [(5, 7), (130, 160)])
def test_int8_matmul_kernel_ragged_k(cuda, M, K, N):
    from repro_torch.kernels import int8_matmul as im

    x, w = _int8_pair(cuda, M + K * 3 + N, M, K, N)
    assert torch.equal(im.int8_matmul(x, w), im.int8_matmul_plain(x, w))


def test_int8_matmul_kernel_wraps_like_int32(cuda):
    """x = w = -128 over K = 2^17: every sum is 2^31, which wraps to -2^31
    in int32 accumulation; the split-K atomics wrap the same way."""
    from repro_torch.kernels import int8_matmul as im

    K = 1 << 17
    x = torch.full((3, K), -128, dtype=torch.int8, device=cuda)
    w = torch.full((K, 5), -128, dtype=torch.int8, device=cuda)
    got = im.int8_matmul(x, w)
    assert torch.equal(got, im.int8_matmul_plain(x, w))
    assert bool((got == -(1 << 31)).all())


def _flash_check(cuda, dtype, BH, S, d, seed):
    """One launch against the plain version: f32 within atol 3e-5 (the
    reference test's own); bf16/f16 against the plain version run in f32
    on the same rounded inputs, per element within 8e-3 * max(1, |plain|)
    in bf16 (the output's rounding, 2^-8 relative, plus what rounding P
    and the f32 summation order add) and 2e-3 * max(1, |plain|) in f16
    (10 bits: about 7e-4, so a rounding at bf16 precision fails)."""
    from repro_torch.kernels import flash_attention as fa

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (BH, S, d)).astype(
        np.float32)).to(cuda).to(dt) for _ in range(3))
    before = fa.LAUNCHES.count
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1 and got.dtype == dt
    want = fa.flash_attention_plain(q.float(), k.float(), v.float())
    if dt == torch.float32:
        assert float((got - want).abs().max()) <= 3e-5
    else:
        err = (got.float() - want).abs() / want.abs().clamp_min(1.0)
        assert float(err.max()) <= (2e-3 if dt == torch.float16 else 8e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("BH,S,d", [(4, 64, 32), (2, 128, 64), (1, 96, 16),
                                    (3, 77, 100), (2, 130, 256)])
def test_flash_kernel_vs_plain(cuda, dtype, BH, S, d):
    _flash_check(cuda, dtype, BH, S, d, BH * S + d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d", [16, 24, 100, 256])
@pytest.mark.parametrize("S", [1, 63, 65, 1024])
def test_flash_kernel_edges(cuda, dtype, S, d):
    """Ragged S (one query; one key tile short of, and one past, a
    64-query tile; 16 tiles) and head dims that leave a zero-filled tail
    in the padded head (16 -> 32, 24 -> 32, 100 -> 128) or take the
    256-wide variant (32-key tiles, Q read from shared memory)."""
    _flash_check(cuda, dtype, 2, S, d, S * 1000 + d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("BH,S,d", [(34, 1000, 96), (40, 1030, 64),
                                    (300, 130, 128)])
def test_flash_kernel_large_grids(cuda, dtype, BH, S, d):
    """Grids of at least two 128-query blocks per SM (on a 132-SM card),
    where 16-bit inputs with the head padded to 128 take two m16 row tiles
    per warp (d = 64 keeps one); S = 130 leaves warps of the last
    128-query tile wholly past S."""
    _flash_check(cuda, dtype, BH, S, d, BH + S + d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_kernel_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same bytes."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (8, 300, 128)).astype(
        np.float32)).to(cuda).to(getattr(torch, dtype)) for _ in range(3))
    a = fa.flash_attention(q, k, v)
    b = fa.flash_attention(q, k, v)
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_staged_path_vs_fused_on_card(cuda):
    """The staged baseline (one blocked launch per window) agrees with the
    fused kernel to f32 order."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_fused, dscim_mvm_blocked

    cfg = calibrated_config("dscim1", 256)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (5, 300)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (300, 33)).astype(np.float32))
    before = dscim_mvm_blocked.LAUNCHES.count
    got = dscim_fused.dscim_windowed_vmap_mvm(x.to(cuda), w.to(cuda), cfg)
    torch.cuda.synchronize()
    assert dscim_mvm_blocked.LAUNCHES.count == before + 3
    _close(got.cpu(), dscim_fused.dscim_fused_mvm(x, w, cfg), 2e-5)


# -- the captured decode step (launch/graph.py, launch/steps.py) ------------

def _reduced(spec="kernel:dscim1:256"):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), dscim=spec)
    params = lm.init_params(cfg, 0, device="cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16))
    return cfg, params, prompts


@pytest.mark.parametrize("spec,kv", [("kernel:dscim1:256", "int8"),
                                     ("off", "float"),
                                     ("lut:dscim1:256", "float"),
                                     ("exact:dscim1:256", "int8"),
                                     ("bitmatmul:dscim1:256", "int8"),
                                     ("statistical:dscim1:256", "float"),
                                     ("paper_inject:dscim2:64", "int8")])
@pytest.mark.parametrize("loop", ["fixed", "eos", "sampled"])
def test_graph_replay_matches_eager_loop_bitwise(cuda, spec, kv, loop):
    """Replays of the captured step give the eager loop's tokens and logit
    trace bit for bit: the fixed-length loop, the EOS loop with per-slot
    budgets (checked on the host every few replays), and a sampled run
    under one seed, for every DSCIMLinear mode served (``lut`` keeps its
    count table on the device and ``bitmatmul`` the count kernel's
    tables, made before capture; the noise modes hash their noise on the
    device).  The fixed loop's launches count over the replays exactly as
    the eager loop's do."""
    from repro_torch.kernels import dscim_fused, dscim_mvm, paged_attention
    from repro_torch.launch.serve import prepare_params, serve_batch

    cfg, params, prompts = _reduced(spec)
    params = prepare_params(cfg, params, cuda)
    kw = dict(kv=kv, page_size=4, device="cuda")
    if loop == "eos":
        eos = int(serve_batch(cfg, params, prompts, 4, **kw)[0][1, 2])
        kw.update(eos_id=eos, max_new=[9, 3, 9, 6])
    else:
        kw.update(trace_logits=True)
    if loop == "sampled":
        kw.update(sample="topk:20:0.9", rng_seed=7)
    counters = (dscim_fused.LAUNCHES, paged_attention.LAUNCHES,
                dscim_mvm.LAUNCHES)
    runs = {}
    for scan in (True, False, True):       # the second graph call replays
        for c in counters:
            c.reset()
        t = {}
        toks, logits = serve_batch(cfg, params, prompts, 9, scan=scan,
                                   timings=t, **kw)
        torch.cuda.synchronize()
        runs.setdefault(scan, []).append(
            (toks, np.stack(logits), [c.count for c in counters], t))
    (g1, g2), (e,) = runs[True], runs[False]
    assert "capture_s" in g1[3] and "capture_s" not in g2[3]
    for g in (g1, g2):
        np.testing.assert_array_equal(g[0], e[0])
        np.testing.assert_array_equal(g[1], e[1])
    if loop != "eos":
        assert g2[2] == e[2]


def test_graph_recaptures_for_other_params(cuda):
    """The graph binds the prepared params it was captured with: the same
    params replay it, other params (same shapes) capture it again and
    serve their own tokens, as the eager loop does; after
    ``clear_graphs`` the same params capture again.  The runner keeps no
    reference to the params between requests."""
    import weakref

    from repro_torch.launch.serve import (clear_graphs, prepare_params,
                                          serve_batch)
    from repro_torch.models import lm

    cfg, params, prompts = _reduced()
    params = prepare_params(cfg, params, cuda)
    other = prepare_params(cfg, lm.init_params(cfg, 1, device="cuda"), cuda)
    kw = dict(kv="int8", page_size=4, device="cuda")

    def captured(p):
        t = {}
        toks, _ = serve_batch(cfg, p, prompts, 6, timings=t, **kw)
        eager, _ = serve_batch(cfg, p, prompts, 6, scan=False, **kw)
        np.testing.assert_array_equal(toks, eager)
        return "capture_s" in t

    captured(params)
    assert [captured(params), captured(other)] == [False, True]
    clear_graphs()
    assert captured(other)
    ref = weakref.ref(other["embed"])
    del other
    assert ref() is None


def test_segment_graph_matches_eager(cuda):
    """The captured segment step and the same step run eagerly, from two
    copies of one admitted serve state: tokens, live and bad planes, the
    first logits and the final state agree bitwise."""
    from repro_torch.launch.serve import prepare_params
    from repro_torch.launch.steps import (init_serve_state, make_admit_fn,
                                          make_segment_fn)

    cfg, params, prompts = _reduced()
    params = prepare_params(cfg, params, cuda)
    admit = make_admit_fn(cfg, eos_id=-1, sample="temp:0.9")
    states = []
    for _ in range(2):
        st = init_serve_state(cfg, 3, 16 + 8, kv="int8", page_size=4,
                              seed=5, device="cuda")
        for b, (r, budget) in enumerate(((0, 8), (1, 3), (2, 6))):
            admit(params, st, torch.as_tensor(prompts[r:r + 1],
                                              device="cuda"), b,
                  list(range(6 * b, 6 * b + 6)), budget)
        states.append(st)
    outs = []
    for st, graph in zip(states, (True, False)):
        seg = make_segment_fn(cfg, 4, eos_id=-1, sample="temp:0.9",
                              graph=graph)
        got = [seg(params, st)[1:] for _ in range(2)]
        torch.cuda.synchronize()
        outs.append(got)
    for (ta, la, aa), (tb, lb, ab) in zip(*outs):
        assert torch.equal(ta, tb) and torch.equal(la, lb)
        assert torch.equal(aa["bad"], ab["bad"])
        assert torch.equal(aa["logits0"], ab["logits0"])
    for name in ("tok", "done", "n_out"):
        assert torch.equal(states[0][name], states[1][name])
    for name, t in states[0]["cache"].items():
        assert torch.equal(t, states[1]["cache"][name]), name


def test_capture_from_a_cold_process(cuda, tmp_path):
    """A fresh process captures the decode step on its first request: the
    kernels' buffers are made by their capture preparation (a buffer made
    lazily during capture would raise), and the graph serves the eager
    loop's tokens."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import dataclasses, numpy as np, torch\n"
        "from repro_torch.configs import get_arch\n"
        "from repro_torch.models import lm\n"
        "from repro_torch.launch.serve import serve_batch\n"
        "cfg = dataclasses.replace(get_arch('qwen3-0.6b').reduced(),"
        " dscim='kernel:dscim1:256')\n"
        "p = lm.init_params(cfg, 0)\n"
        "x = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16))\n"
        "t = {}\n"
        "a = serve_batch(cfg, p, x, 6, kv='int8', page_size=4, timings=t)[0]\n"
        "b = serve_batch(cfg, p, x, 6, kv='int8', page_size=4, scan=False)[0]\n"
        "assert 'capture_s' in t and (a == b).all()\n"
        "print('captured', t['capture_s'])\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert r.returncode == 0 and "captured" in r.stdout, r.stdout + r.stderr


def test_failed_capture_raises(cuda):
    """A step that reads back to the host cannot be captured: the runner
    raises (no eager fallback) and leaves the launch counts as they were."""
    from repro_torch.kernels import build
    from repro_torch.launch.graph import CapturedStep

    x = torch.ones(4, device=cuda)
    c = build.LaunchCounter("test")

    def step():
        c.count += 1
        if bool(x.sum() > 0):               # a host sync
            x.add_(1)

    runner = CapturedStep(step, cuda)
    with pytest.raises(RuntimeError, match="capture"):
        runner.run()
    assert c.count == 0 and runner.graph is None
    torch.cuda.synchronize()


@pytest.mark.parametrize("done_pos", [5, 7])
def test_live_flush_wins_over_stale_done_row_on_card(cuda, done_pos):
    """Fault C1 through the CUDA route (paged attention kernel, the flush
    on CUDA tensors): live slot 0 flushes into page 1 while done slot 1's
    stale row, after it, names page 1 too; page 1 must hold slot 0's
    flush, as where no stale row aliases it."""
    from repro_torch.configs import get_arch
    from repro_torch.core.kvcache import quantize_page
    from repro_torch.kernels import paged_attention
    from repro_torch.layers.attention import decode_attention_paged
    from repro_torch.models import lm

    cfg = get_arch("qwen3-0.6b").reduced()
    attn = lm._layer(lm.init_params(cfg, 0, device="cuda")["layers"],
                     0)["attn"]
    ps, KV, HD = 4, cfg.n_kv, cfg.head_dim
    rng = np.random.default_rng(0)
    base = {"k_pages": rng.integers(-127, 128, (4, ps, KV, HD), np.int8),
            "v_pages": rng.integers(-127, 128, (4, ps, KV, HD), np.int8),
            "k_scale": np.ones((4, KV), np.float32),
            "v_scale": np.ones((4, KV), np.float32),
            "k_tail": rng.normal(0, 1, (2, ps, KV, HD)).astype(np.float32),
            "v_tail": rng.normal(0, 1, (2, ps, KV, HD)).astype(np.float32)}
    x = torch.from_numpy(rng.normal(0, 1, (2, 1, cfg.d_model)).astype(
        np.float32)).to(cuda)
    done = torch.tensor([False, True], device=cuda)
    views = []
    for table in ([[0, 1], [2, 1]], [[0, 1], [2, 3]]):
        view = {k: torch.from_numpy(v).to(cuda) for k, v in base.items()}
        for k in ("k_tail", "v_tail"):
            view[k] = view[k].to(torch.bfloat16)
        view["page_table"] = torch.tensor(table, dtype=torch.int32,
                                          device=cuda)
        view["pos"] = torch.tensor([2 * ps - 1, done_pos],
                                   dtype=torch.int32, device=cuda)
        before = paged_attention.LAUNCHES.count
        decode_attention_paged(attn, x, view, cfg, done=done)
        assert paged_attention.LAUNCHES.count == before + 1
        views.append(view)
    torch.cuda.synchronize()
    alias, alone = views
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        assert torch.equal(alias[name][1], alone[name][1]), name
    want_q, want_s = quantize_page(alone["k_tail"][0])
    assert torch.equal(alias["k_pages"][1], want_q)
    assert torch.equal(alias["k_scale"][1], want_s)


# -- self-speculative decoding (launch/steps.py _make_window) ---------------

def test_fused_rows_invariant_between_decode_and_verify(cuda):
    """The verify forward runs the fused MVM once over B*(k+1) rows where
    the decodes ran it at B: a (B, T, K) window gives position t the bits
    of the decode's (B, 1, K) call, for both estimators and both the
    decode and the larger-M regime."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_fused

    for key in (("dscim1", 256, "paper"), ("dscim2", 64, "paper")):
        cfg = calibrated_config(*key)
        for B, T in ((4, 5), (8, 9)):
            x, qw = _fused_pair(cuda, B * T, B * T, 1024, 3072, 128,
                                torch.bfloat16)
            x = x.reshape(B, T, 1024)
            whole = dscim_fused.dscim_fused_mvm_prepared(x, qw, cfg)
            for t in range(T):
                alone = dscim_fused.dscim_fused_mvm_prepared(
                    x[:, t:t + 1].contiguous(), qw, cfg)
                assert torch.equal(alone, whole[:, t:t + 1]), (key, B, t)


@pytest.mark.parametrize("spec,kv,sample", [
    ("kernel:dscim1:256", "int8", "greedy"),
    ("kernel:dscim1:256", "float", "temp:0.9"),
    ("bitmatmul:dscim1:256", "int8", "greedy")])
def test_spec_window_graph_matches_eager_window(cuda, spec, kv, sample):
    """One draft/verify window is one replay of a captured graph: the
    graph's tokens and spec stats equal the eager windows' and, under
    greedy decoding, the plain loop's tokens; its launches over the
    replays are those of the windows it replayed."""
    from repro_torch.kernels import dscim_fused
    from repro_torch.launch.serve import prepare_params, serve_batch

    cfg, params, prompts = _reduced(spec)
    params = prepare_params(cfg, params, cuda)
    kw = dict(kv=kv, page_size=4, device="cuda", sample=sample, rng_seed=3,
              spec="dscim2:3", spec_stats=True)
    runs = {}
    for scan in (True, False, True):
        t = {}
        dscim_fused.LAUNCHES.reset()
        toks, _, ss = serve_batch(cfg, params, prompts, 9, scan=scan,
                                  timings=t, **kw)
        runs.setdefault(scan, []).append((toks, ss, t))
    (g1, g2), (e,) = runs[True], runs[False]
    assert "capture_s" in g1[2] and "capture_s" not in g2[2]
    for g in (g1, g2):
        np.testing.assert_array_equal(g[0], e[0])
        for n in ("windows", "emitted"):
            np.testing.assert_array_equal(g[1][n], e[1][n])
    kw.pop("spec"), kw.pop("spec_stats")
    plain, _ = serve_batch(cfg, params, prompts, 9, **kw)
    np.testing.assert_array_equal(g1[0], plain)


def test_spec_self_draft_accepts_every_draft_on_card(cuda):
    """kernel:dscim2:64 verified by its own estimator: every greedy draft
    is accepted (the fused MVM gives the verify rows the drafts' bits)."""
    from repro_torch.launch.serve import prepare_params, serve_batch

    cfg, params, prompts = _reduced("kernel:dscim2:64")
    params = prepare_params(cfg, params, cuda)
    kw = dict(kv="int8", page_size=4, device="cuda")
    plain, _ = serve_batch(cfg, params, prompts, 16, **kw)
    toks, _, ss = serve_batch(cfg, params, prompts, 16, spec="dscim2:4",
                              spec_stats=True, **kw)
    np.testing.assert_array_equal(toks, plain)
    assert (ss["windows"] == 3).all() and (ss["emitted"] == 16).all(), ss


def test_spec_continuous_matches_plain_on_card(cuda):
    """Continuous serving under spec: the captured window segments serve
    every request the tokens of the plain captured segments, and return
    every page."""
    from repro_torch.launch.serve import prepare_params, serve_continuous

    cfg, params, prompts = _reduced()
    params = prepare_params(cfg, params, cuda)
    kw = dict(slots=3, seg_len=2, kv="int8", page_size=4, eos_id=-1,
              max_new=[8, 3, 6, 5], device="cuda")
    ref, _ = serve_continuous(cfg, params, prompts, 8, **kw)
    got, st = serve_continuous(cfg, params, prompts, 8, spec="dscim2:3",
                               **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert st["capture_s"] > 0 and st["pages"]["live_pages"] == 0
