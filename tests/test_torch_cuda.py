"""The port's CUDA kernels against their plain PyTorch versions on the card,
at odd and test-sized shapes (the full-width serving shapes, and the
reduced config served on the GPU against the CPU, are held by
``chip_smoke.py``); the captured decode step (CUDA graph replays against
the eager loop, bitwise; a capture from a cold process; a failed capture
raising), the paged flush's C1 case, the prefix cache's extend graph,
the scheduler's restores, the watchdog's probe, the digests and the
integrity drill, the asyncio router's bucket admissions at full width
on the card, the RWKV6 and Zamba2 configs' captured step, and a capture
that a dying graph must not break.  Marked ``cuda``: without a GPU every test
here skips
(decided inside the fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import numpy as np  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="session")
def _built():
    """Every kernel library, built before the first card test (one ``nvcc``
    a source, all at once, as ``chip_smoke.py`` builds them): a child
    process started after a profiler session leaves the later sessions
    blind to some kernels (ROADMAP C12)."""
    from repro_torch.kernels import build

    build.build()


@pytest.fixture
def cuda(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    request.getfixturevalue("_built")
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
                 out.data_ptr(), 1, K, 1, 3, 64, 32, 8, -1,
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
    from repro_torch.launch.steps import clear_graphs

    cfg, params, prompts = _reduced()
    params = prepare_params(cfg, params, cuda)
    kw = dict(slots=3, seg_len=2, kv="int8", page_size=4, eos_id=-1,
              max_new=[8, 3, 6, 5], device="cuda")
    clear_graphs()
    ref, _ = serve_continuous(cfg, params, prompts, 8, **kw)
    got, st = serve_continuous(cfg, params, prompts, 8, spec="dscim2:3",
                               **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert st["capture_s"] > 0 and st["pages"]["live_pages"] == 0


# -- the prefix cache's extend graph and the scheduler's faults -------------

def _chunked(cfg, params, prompt, graph, ps=4):
    """Admit ``prompt`` into slot 1 of a fresh 2-slot serve state as
    chunks of the extend step (logit trace on)."""
    from repro_torch.launch.steps import init_serve_state, make_extend_fn

    st = init_serve_state(cfg, 2, 32, kv="int8", page_size=ps, seed=3,
                          device="cuda")
    st["cache"]["page_table"][1] = torch.arange(8, 16, dtype=torch.int32)
    st["done"][1] = True
    ext = make_extend_fn(cfg, ps, eos_id=-1, sample="temp:0.9",
                         trace_logits=True, graph=graph)
    traces = []
    for fed in range(0, len(prompt), ps):
        part = np.pad(prompt[fed:fed + ps], (0, ps - len(prompt[fed:fed + ps])))
        _, tok0, tr = ext(params, st, part[None], 1,
                          min(ps, len(prompt) - fed),
                          fed + ps >= len(prompt), 6)
        traces.append(tr)
    torch.cuda.synchronize()
    return st, int(tok0), torch.stack(traces), ext


def test_extend_graph_matches_eager_extend(cuda):
    """One admission of 14 tokens (a padded last chunk) through the
    captured extend step and through the same step run eagerly: first
    token, every chunk's logit trace and the whole serve state agree
    bitwise; the graph binds once."""
    from repro_torch.launch.serve import prepare_params

    cfg, params, prompts = _reduced()
    params = prepare_params(cfg, params, cuda)
    got = [_chunked(cfg, params, prompts[0, :14], graph)
           for graph in (True, False)]
    (sg, tg, lg, ext), (se, te, le, _) = got
    assert tg == te and torch.equal(lg, le)
    assert ext.runs["bindings"] == 1 and ext.runs["run"].step.captures == 1
    for name in ("tok", "done", "n_out", "max_new", "stream"):
        assert torch.equal(sg[name], se[name]), name
    for name, t in sg["cache"].items():
        assert torch.equal(t, se["cache"][name]), name


def test_prefix_warm_equals_cold_on_card(cuda):
    """Prefix-cache serving on the card: warm bitwise cold, each leg
    binding its segment and extend steps once, and the extends' fused-MVM
    and paged-attention launches those of the chunks fed."""
    from repro_torch.launch.serve import prepare_params, serve_continuous

    cfg, params, prompts = _reduced()
    params = prepare_params(cfg, params, cuda)
    prompts = np.concatenate([prompts, prompts[:2]])
    prompts[1:5, :8] = prompts[0, :8]
    kw = dict(slots=3, seg_len=2, kv="int8", page_size=4, eos_id=-1,
              max_new=[6, 3, 5, 4, 6, 2], device="cuda")
    legs = {m: serve_continuous(cfg, params, prompts, 6, prefix_cache=m,
                                **kw) for m in ("cold", "on")}
    for a, b in zip(legs["on"][0], legs["cold"][0]):
        np.testing.assert_array_equal(a, b)
    L = cfg.n_layers
    for outs, st in legs.values():
        chunks = st["prefix"]["prefill_positions_computed"] // 4
        assert st["bindings"] == {"segment": 1, "extend": 1}
        assert st["extend_launches"]["dscim_fused_mvm"] == chunks * (3 * L + 1)
        assert st["extend_launches"]["paged_attention_decode"] \
            == chunks * L * 4
        assert st["pages"]["live_pages"] == 0
    assert legs["on"][1]["prefix"]["hits"] == 4


@pytest.mark.parametrize("fault", ["failover", "eviction"])
def test_restores_keep_the_segment_graph(cuda, fault):
    """A failover restore and an eviction's ``insert_slot_pages`` copy
    into the serve state in place: the segment step is bound once (the
    failover run replays the graph the undisturbed run captured, at the
    same options, across the restore; the eviction run's smaller pool is
    another runner set, captured once), and every request's tokens are
    those of the undisturbed run (sampled, so the stream must survive
    too)."""
    from repro_torch.core.kvcache import n_pages_for
    from repro_torch.launch.serve import prepare_params, serve_continuous
    from repro_torch.launch.steps import clear_graphs
    from repro_torch.runtime.failover import FailureInjector

    cfg, params, prompts = _reduced()
    params = prepare_params(cfg, params, cuda)
    prompts = np.concatenate([prompts, prompts[:2, ::-1]])
    kw = dict(slots=3, seg_len=2, kv="int8", page_size=4, eos_id=-1,
              max_new=[6, 8, 8, 6, 6, 6], sample="topk:20:0.9", rng_seed=4,
              device="cuda")
    clear_graphs()
    ref, st_ref = serve_continuous(cfg, params, prompts, 8, **kw)
    assert st_ref["captures"]["segment"] == 1 and st_ref["capture_s"] > 0
    knobs = {"failover": dict(snapshot_every=1,
                              injector=FailureInjector(fail_at=(2,)),
                              log=lambda *_: None),
             "eviction": dict(n_pages=2 * n_pages_for(16 + 8, 4),
                              priority=[0, 0, 5, 0, 0, 0])}[fault]
    outs, st = serve_continuous(cfg, params, prompts, 8, **kw, **knobs)
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)
    assert st["bindings"]["segment"] == 1
    assert st["captures"]["segment"] == (fault == "eviction")
    if fault == "failover":
        assert st["replays"] == 1 and st["snapshots"]["restores"] == 1
    else:
        assert st["evictions"] >= 1 and st["readmissions"] >= 1


def test_digests_on_card_equal_cpu(cuda, monkeypatch):
    """Page and weight-plane digests computed on the card are bitwise the
    CPU's for the same tensors (negative int8, negative f32 scales, bf16,
    sums across chunk boundaries), each sweep one launch of the digest
    kernel."""
    from repro_torch.core import digest, kvcache, qweights
    from repro_torch.kernels import digest as kdigest
    from repro_torch.launch.steps import prepare_serving_params

    monkeypatch.setattr(digest, "CHUNK", 1000)
    rng = np.random.default_rng(11)
    L, P, ps, KV, HD = 3, 7, 8, 2, 64
    pool = [torch.from_numpy(rng.integers(-128, 128, (L, P, ps, KV, HD))
                             .astype(np.int8)) for _ in range(2)]
    pool += [torch.from_numpy(rng.normal(0, 1, (L, P, KV))
                              .astype(np.float32)) for _ in range(2)]
    cpu = kvcache.page_checksums(*pool)
    n0 = kdigest.LAUNCHES.count
    gpu = kvcache.page_checksums(*(t.to(cuda) for t in pool))
    assert kdigest.LAUNCHES.count == n0 + 1
    assert torch.equal(gpu.cpu(), cpu)
    x = torch.from_numpy(rng.normal(0, 1, (5, 999)).astype(np.float32)) \
        .to(torch.bfloat16)
    n0 = kdigest.LAUNCHES.count
    assert int(qweights.plane_digest(x.to(cuda))) \
        == int(qweights.plane_digest(x))
    assert kdigest.LAUNCHES.count == n0 + 1
    cfg, params, _ = _reduced()
    prep = prepare_serving_params(cfg, params)
    prep_cpu = prepare_serving_params(cfg, _cpu_tree(params))
    n0 = kdigest.LAUNCHES.count
    got = qweights.weight_plane_digests(prep)
    assert kdigest.LAUNCHES.count == n0 + 1
    assert torch.equal(got.cpu(), qweights.weight_plane_digests(prep_cpu))


def test_digest_planes_tails_and_offsets_on_card(cuda):
    """Entry (a) over planes whose bytes are no multiple of 16 and planes
    that start off a 16-byte boundary (a view one element in), of every
    dtype the sweeps take, in one launch: bitwise the plain version."""
    from repro_torch.kernels import digest as kdigest

    rng = np.random.default_rng(12)
    base = [torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8))
            for n in (1, 15, 17, 4097, 65537, 200_003)]
    base += [torch.from_numpy(rng.integers(0, 256, 33).astype(np.uint8)),
             torch.from_numpy(rng.integers(-2**15, 2**15, 19)
                              .astype(np.int16)),
             torch.from_numpy(rng.normal(0, 1, 3).astype(np.float32)),
             torch.from_numpy(-np.abs(rng.normal(0, 1, 70_001))
                              .astype(np.float32)),
             torch.from_numpy(rng.normal(0, 1, 7).astype(np.float32))
             .to(torch.bfloat16),
             torch.from_numpy(rng.normal(0, 1, 9).astype(np.float16)),
             torch.from_numpy(rng.integers(-2**31, 2**31, 5)
                              .astype(np.int32)),
             torch.zeros(0, dtype=torch.int8)]
    xs = base + [x[1:] for x in base if x.numel() > 1]
    mults = [2 * i + 1 for i in range(len(xs))]
    want = kdigest.planes_digest_plain(xs, mults)
    gx = [x.to(cuda) for x in base]
    gx += [x[1:] for x in gx if x.numel() > 1]
    n0 = kdigest.LAUNCHES.count
    got = kdigest.planes_digest(gx, mults)
    assert kdigest.LAUNCHES.count == n0 + 1
    assert torch.equal(got.cpu(), want)
    # the same tensors again (the kept table), then a plane moved
    assert torch.equal(kdigest.planes_digest(gx, mults).cpu(), want)
    gx[3] = gx[3].clone()
    assert torch.equal(kdigest.planes_digest(gx, mults).cpu(), want)
    with pytest.raises(ValueError, match="digest kernel"):
        kdigest.planes_digest([torch.zeros(4, dtype=torch.int64,
                                           device=cuda)])
    with pytest.raises(ValueError, match="strided"):
        kdigest.planes_digest([torch.zeros(4, 4, device=cuda).T])


@pytest.mark.parametrize("shape", [(3, 7, 8, 2, 64), (2, 5, 3, 1, 5)])
def test_digest_pages_modes_on_card(cuda, shape):
    """Entry (b): write mode over every page, over listed pages (one named
    twice), over a refresh window (hit pages only, a page two slots'
    candidates name included), and compare mode, each bitwise the plain
    version on the CPU; then the refresh inside a captured CUDA graph
    against an eager launch."""
    from repro_torch.kernels import digest as kdigest

    L, P, ps = shape[:3]
    rng = np.random.default_rng(13)
    pool = [torch.from_numpy(rng.integers(-128, 128, shape)
                             .astype(np.int8)) for _ in range(2)]
    pool += [torch.from_numpy(-np.abs(rng.normal(0, 1, (L, P, shape[3])))
                              .astype(np.float32)) for _ in range(2)]
    gpool = [t.to(cuda) for t in pool]
    full = kdigest.page_digests(*pool)
    assert torch.equal(kdigest.page_digests(*gpool).cpu(), full)
    stale = torch.arange(L * P, dtype=torch.int64).reshape(L, P)
    phys = torch.tensor([P - 1, 0, P - 1], dtype=torch.int64)
    want = kdigest.page_digests(*pool, sums=stale.clone(), phys=phys)
    sums = stale.to(cuda)
    n0 = kdigest.LAUNCHES.count
    kdigest.page_digests(*gpool, sums=sums, phys=phys.to(cuda))
    assert kdigest.LAUNCHES.count == n0 + 1
    assert torch.equal(sums.cpu(), want)
    table = torch.tensor([[0, 1, 2], [3, 4, 0]], dtype=torch.int32) % P
    pos0 = torch.tensor([1, 2 * ps], dtype=torch.int32)
    upper = torch.tensor([3 * ps, 2 * ps + 1], dtype=torch.int32)
    win = (table, pos0, upper, 2 * ps)
    want = kdigest.page_refresh_plain(*pool, stale.clone(), *win)
    assert not torch.equal(want, stale)
    sums = stale.to(cuda)
    gwin = [t.to(cuda) for t in win[:3]] + [win[3]]
    n0 = kdigest.LAUNCHES.count
    kdigest.page_refresh(*gpool, sums, *gwin)
    assert kdigest.LAUNCHES.count == n0 + 1
    assert torch.equal(sums.cpu(), want)
    bad = full.clone()
    bad[0, P - 1] ^= 1
    bad[L - 1, 0] += 3
    want_f = kdigest.page_flags(*pool, bad)
    assert int(want_f.sum()) == 2
    assert torch.equal(kdigest.page_flags(*gpool, bad.to(cuda)).cpu(),
                       want_f)
    # captured: the graph replays the refresh into the same sums
    captured = stale.to(cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        kdigest.page_refresh(*gpool, captured, *gwin)
    captured.copy_(stale.to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured.cpu(), want)


def _cpu_tree(tree):
    return {k: _cpu_tree(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def test_probe_leaves_the_captured_state_unchanged(cuda):
    """A probe between two replayed segments leaves the serve state
    bitwise as it was (a page flush inside the probe included), and a
    monitored run serves the tokens of an unmonitored one with the
    segment step bound once."""
    import dataclasses

    from repro_torch.launch.serve import prepare_params, serve_continuous
    from repro_torch.launch.steps import (init_serve_state, make_admit_fn,
                                          make_probe_fn, make_segment_fn)
    from repro_torch.runtime.serving import (exact_probe_spec,
                                             watchdog_for_spec)

    cfg, params, prompts = _reduced("kernel:dscim2:64")
    params = prepare_params(cfg, params, cuda)
    state = init_serve_state(cfg, 2, 40, kv="int8", page_size=4,
                             integrity=True, device=cuda)
    admit = make_admit_fn(cfg, eos_id=-1)
    for slot, S in ((0, 16), (1, 8)):
        admit(params, state, torch.as_tensor(prompts[slot:slot + 1, :S],
                                             device=cuda),
              slot, list(range(slot * 10, slot * 10 + 10)), 20)
    segment = make_segment_fn(cfg, 3, eos_id=-1)
    probe = make_probe_fn(dataclasses.replace(
        cfg, dscim=exact_probe_spec(cfg.dscim)))
    segment(params, state)                       # pos 19 and 11
    assert int(state["cache"]["pos"][1]) % 4 == 3
    want = make_probe_fn(dataclasses.replace(
        cfg, dscim=exact_probe_spec(cfg.dscim)), graph=False)(params, state)
    before = {k: v.clone() for k, v in state["cache"].items()}
    scalars = {k: state[k].clone() for k in ("tok", "done", "n_out")}
    lgs = [probe(params, state),                 # eager: the first probe
           probe(params, state),                 # captures, then replays
           probe(params, state)]                 # a replay
    torch.cuda.synchronize()
    for lg in lgs:
        assert torch.isfinite(lg).all() and torch.equal(lg, want)
    assert probe.runs["bindings"] == 1
    for k, v in before.items():
        assert torch.equal(state["cache"][k], v), k
    for k, v in scalars.items():
        assert torch.equal(state[k], v), k
    segment(params, state)
    assert segment.runs["bindings"] == 1

    kw = dict(slots=2, seg_len=2, kv="int8", page_size=4, eos_id=-1,
              max_new=[6, 8, 5, 7], device="cuda")
    ref, _ = serve_continuous(cfg, params, prompts, 8, **kw)
    mon = watchdog_for_spec(cfg.dscim, probe_every=1)
    outs, st = serve_continuous(cfg, params, prompts, 8, monitor=mon, **kw)
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)
    assert st["probes"] > 0 and st["bindings"]["segment"] == 1


def test_second_monitored_run_captures_nothing_on_card(cuda):
    """The runners are kept across serving runs at the same options: a
    first monitored run captures the segment step and, at its first
    probe, the probe; a second run captures nothing, replays every probe
    (whose launches the counters see as today: a replay adds the step's
    launches) and serves the first run's tokens bitwise, as does an
    unmonitored run."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import prepare_params, serve_continuous
    from repro_torch.launch.steps import clear_graphs
    from repro_torch.runtime.serving import watchdog_for_spec

    cfg, params, prompts = _reduced("kernel:dscim2:64")
    params = prepare_params(cfg, params, cuda)
    kw = dict(slots=2, seg_len=2, kv="int8", page_size=4, eos_id=-1,
              max_new=[6, 8, 5, 7], device="cuda")
    clear_graphs()
    runs = []
    for _ in range(2):
        before = {c.name: c.count for c in build.COUNTERS}
        outs, st = serve_continuous(
            cfg, params, prompts, 8, snapshot_every=2,
            monitor=watchdog_for_spec(cfg.dscim, probe_every=1), **kw)
        torch.cuda.synchronize()
        runs.append((outs, st, {c.name: c.count - before.get(c.name, 0)
                                for c in build.COUNTERS}))
    (o1, s1, n1), (o2, s2, n2) = runs
    assert s1["probes"] >= 1 and s2["probes"] == s1["probes"]
    assert s1["captures"] == {"segment": 1, "extend": 0, "probe": 1}
    assert s2["captures"] == {"segment": 0, "extend": 0, "probe": 0}
    assert s2["capture_s"] == 0.0 and s2["escalation_captures"] == 0
    assert s1["probe_bindings"] == s2["probe_bindings"] == 1
    assert s2["bindings"] == {"segment": 1, "extend": 0}
    # run 2 launched nothing but its steps: per decode step 3 MLP matmuls
    # a layer and the head, one paged read a layer; per probe one paged
    # read a layer (exact mode: no fused MVM); per admission one forward;
    # run 1 launched those and its captures' preparations
    L, steps = cfg.n_layers, kw["seg_len"] * s2["segments"]
    assert n2["paged_attention_decode"] == L * (steps + s2["probes"])
    assert n2["dscim_fused_mvm"] == (3 * L + 1) * (steps + len(prompts))
    assert all(n1[k] >= n2[k] for k in n2)
    plain, _ = serve_continuous(cfg, params, prompts, 8, **kw)
    for a, b, c in zip(o1, o2, plain):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)


def test_clear_graphs_releases_the_graph_pools_on_card(cuda):
    """``clear_graphs`` frees the kept runner sets' graphs and their
    memory pools with no collection: the card's reserved memory falls
    back to what it was before the run captured them."""
    import gc

    from repro_torch.launch.serve import serve_continuous
    from repro_torch.launch.steps import clear_graphs

    cfg, params, prompts = _reduced()
    kw = dict(slots=2, seg_len=2, kv="int8", page_size=4, eos_id=-1,
              max_new=[6, 8, 5, 7], integrity="scrub:2", device="cuda")
    serve_continuous(cfg, params, prompts, 8, **kw)   # the kernels' buffers
    clear_graphs()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    gc.disable()
    try:
        _, st = serve_continuous(cfg, params, prompts, 8, **kw)
        torch.cuda.synchronize()
        assert st["captures"]["segment"] == 1
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        clear_graphs()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_reserved()
    finally:
        gc.enable()
    assert held > base and after <= base, (base, held, after)


def test_ladder_reports_its_captures_on_card(cuda):
    """A stuck-at fault escalates every request; the stats count the
    decode graphs the ladder's serve_batch runs captured (each rung's
    and, above the bottom, its exact twin's), and none when the same
    runs are served again from the cached runners."""
    from repro_torch.launch.serve import prepare_params, serve_continuous
    from repro_torch.launch.steps import clear_graphs
    from repro_torch.runtime.failover import FailureInjector
    from repro_torch.runtime.serving import (next_ladder_spec,
                                             watchdog_for_spec)

    cfg, params, prompts = _reduced("kernel:dscim2:64")
    params = prepare_params(cfg, params, cuda)
    kw = dict(slots=2, seg_len=2, kv="int8", page_size=4, eos_id=-1,
              max_new=[6, 8, 5, 7], device="cuda")
    clear_graphs()
    got = []
    for _ in range(2):
        inj = FailureInjector(macro_fault_at=0, macro_fault="stuck:3:40.0")
        _, st = serve_continuous(
            cfg, params, prompts, 8, injector=inj,
            monitor=watchdog_for_spec(cfg.dscim, probe_every=1), **kw)
        assert st["quarantined"] and st["status"] == ["ok"] * 4
        got.append(st["escalation_captures"])
    rungs = {e["to"] for e in st["escalations"]}
    assert got == [sum(1 + (next_ladder_spec(s) is not None)
                       for s in rungs), 0]


def test_integrity_drill_on_card_keeps_one_binding(cuda):
    """The integrity drill on the card: flips XOR into the live tensors
    and repairs copy the golden bytes back into them, so each leg binds
    (captures) its segment step once; every request bitwise the
    fault-free run (asserted inside the drill)."""
    from repro_torch.runtime.serving import integrity_drill

    report = integrity_drill(device="cuda", log=lambda *_: None)
    assert report["leg1"]["bindings"]["segment"] == 1
    assert report["leg2"]["bindings"]["segment"] == 1
    assert report["leg2"]["replays"] == 1


def test_integrity_verify_equals_off_on_card(cuda):
    """``integrity='verify'`` serves ``'off'``'s tokens with zero
    mismatches and launches the same counted kernels but the digest
    kernel, which only it launches: with integrity off the cache has no
    digest plane at all.  Each run starts from no kept runners, so each
    captures its segment step (whose preparation launches the kernels
    too)."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import prepare_params, serve_continuous
    from repro_torch.launch.steps import clear_graphs

    cfg, params, prompts = _reduced()
    params = prepare_params(cfg, params, cuda)
    kw = dict(slots=2, seg_len=2, kv="int8", page_size=4, eos_id=-1,
              max_new=[6, 8, 5, 7], device="cuda")
    runs = {}
    for mode in ("off", "verify", "off"):
        clear_graphs()
        before = {c.name: c.count for c in build.COUNTERS}
        outs, st = serve_continuous(cfg, params, prompts, 8,
                                    integrity=mode, **kw)
        runs.setdefault(mode, []).append(
            (outs, {c.name: c.count - before.get(c.name, 0)
                    for c in build.COUNTERS}, st))
    (off, n_off, _), (off2, n_off2, _) = runs["off"]
    verify, n_verify, st = runs["verify"][0]
    for a, b in zip(verify, off):
        np.testing.assert_array_equal(a, b)
    digests = n_verify.pop("digest")
    assert digests >= 2 * st["integrity"]["checks"]
    assert n_off.pop("digest") == n_off2.pop("digest") == 0
    assert n_verify == n_off == n_off2
    assert st["integrity"]["page_mismatches"] == 0
    assert st["integrity"]["checks"] == st["segments"]


def test_chaos_drill_on_card(cuda):
    from repro_torch.runtime.serving import chaos_drill

    report = chaos_drill(device="cuda", log=lambda *_: None)
    assert report["replays"] == 1 and report["probe_trips"] >= 1


def test_fused_kernel_keeps_nan_like_plain(cuda):
    """A NaN activation gives the window a NaN scale and the row a NaN
    output in the kernel, as in the plain version (its max keeps the
    NaN); the other rows are untouched."""
    from repro_torch.core.qweights import prepare_linear_weight
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_fused

    cfg = calibrated_config("dscim1", 256, "paper")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (4, 256)).astype(np.float32))
    x[1, 7] = float("nan")
    w = torch.from_numpy(rng.normal(0, 1, (256, 32)).astype(np.float32))
    want = dscim_fused.dscim_fused_mvm_prepared(
        x, prepare_linear_weight(w, 128), cfg)
    got = dscim_fused.dscim_fused_mvm_prepared(
        x.to(cuda), prepare_linear_weight(w.to(cuda), 128), cfg).cpu()
    assert torch.isnan(want[1]).all() and torch.isnan(got[1]).all()
    keep = [0, 2, 3]
    _close(got[keep], want[keep], 2e-5)


def test_router_buckets_equal_serve_continuous_at_full_width(cuda):
    """The asyncio router at full width (qwen3-0.6b, kernel:dscim1:256,
    int8 KV, page 8): bucket-length requests submitted before start()
    are bitwise what serve_continuous gives them, a chunked one is
    served too, and the router's segment and extend steps are each bound
    (and captured) once."""
    import asyncio
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import prepare_params, serve_continuous
    from repro_torch.models import lm
    from repro_torch.runtime.router import Router

    cfg = dataclasses.replace(get_arch("qwen3-0.6b"),
                              dscim="kernel:dscim1:256")
    params = prepare_params(cfg, lm.init_params(cfg, 0, device=cuda), cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 16) for _ in range(5)]
    budgets = [6, 3, 8, 5, 2]

    async def run():
        r = Router(cfg, params, slots=3, seg_len=4, page_size=8,
                   buckets=(16,), chunk_len=8, max_prompt=32,
                   max_new_cap=8, device=cuda, log=lambda *a: None)
        hs = [r.submit(p, b) for p, b in zip(prompts, budgets)]
        hs.append(r.submit(rng.integers(0, cfg.vocab, 21), 4))
        await r.start()
        res = await asyncio.gather(*[h.result() for h in hs])
        await r.close()
        return res, r.stats()

    res, st = asyncio.run(run())
    assert [x.status for x in res] == ["ok"] * 6 and len(res[5].tokens) == 4
    outs, _ = serve_continuous(cfg, params, np.stack(prompts), 8, slots=2,
                               seg_len=4, kv="int8", page_size=8,
                               max_new=budgets, eos_id=-1, device=cuda,
                               log=lambda *a: None)
    for got, want in zip(res, outs):
        assert got.tokens == want.tolist()
    assert st["bindings"] == {"segment": 1, "extend": 1, "probe": 0}
    assert st["capture_s"]["segment"] > 0 and st["capture_s"]["extend"] > 0
    assert st["pages"]["live_pages"] == 0


# the dense family's shapes: (K, N) of each new config's MLP sites and head
# (olmo-1b, codeqwen1.5-7b, starcoder2-7b, musicgen-large, pixtral-12b)
_DENSE_KN = [(2048, 8192), (8192, 2048), (2048, 50304), (4096, 13440),
             (13440, 4096), (4608, 18432), (18432, 4608), (2048, 2048),
             (5120, 14336), (14336, 5120), (5120, 131072)]


@pytest.mark.parametrize("M", [4, 256])
@pytest.mark.parametrize("K,N", _DENSE_KN)
def test_fused_kernel_dense_family_shapes(cuda, K, N, M):
    """The fused MVM at the new configs' K and N (starcoder2's w_down
    K = 18432: 144 windows; pixtral's head N = 131072) against the plain
    version on 512 columns spread over N."""
    from repro_torch.core.qweights import (QuantizedLinearWeight,
                                           prepare_linear_weight)
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.kernels import dscim_fused

    cfg = calibrated_config("dscim1", 256, "paper")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(K + N + M)
    x = torch.randn((M, K), generator=gen, device=cuda)
    w = torch.randn((K, N), generator=gen, device=cuda) * K ** -0.5
    qw = prepare_linear_weight(w, 128)
    got = dscim_fused.dscim_fused_mvm_prepared(x, qw, cfg)
    cols = torch.arange(0, N, max(1, N // 512), device=cuda)
    xq = dscim_fused.quantize_activations_windowed(x, qw.nw, qw.g)
    sl = QuantizedLinearWeight(qw.q[..., cols].contiguous(),
                               qw.scale[..., cols].contiguous(), K, 128)
    want = dscim_fused.dscim_fused_mvm_plain(
        xq.q.contiguous(), xq.scale.reshape(M, qw.nw).contiguous(), sl.q,
        sl.scale, cfg)
    torch.cuda.synchronize()
    _close(got[:, cols], want, 2e-5)


@pytest.mark.parametrize("pos", [78, 2047])
@pytest.mark.parametrize("KV,R,HD", [(16, 1, 128), (32, 1, 128),
                                     (4, 12, 128), (2, 24, 16), (32, 1, 64),
                                     (8, 4, 128)])
def test_paged_kernel_dense_family_shapes(cuda, KV, R, HD, pos):
    """Paged attention at the new configs' (KV, n_rep, HD): starcoder2's
    padded n_rep 12 (and 24 at ``.reduced()``), musicgen's HD 64, at the
    serving position and at 2048 tokens, pages in random order."""
    from repro_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=cuda)
    gen.manual_seed(KV * R + HD + pos)
    B, ps = 4, 8
    MP = pos // ps + 1
    P = B * MP
    args = (torch.randn((B, KV, R, HD), generator=gen, device=cuda),
            *(torch.randint(-127, 128, (P, ps, KV, HD), generator=gen,
                            device=cuda).to(torch.int8) for _ in range(2)),
            *(torch.rand((P, KV), generator=gen, device=cuda) * 0.02
              for _ in range(2)),
            *(torch.randn((B, ps, KV, HD), generator=gen,
                          device=cuda).to(torch.bfloat16) for _ in range(2)),
            torch.randperm(P, generator=gen, device=cuda).reshape(
                B, MP).to(torch.int32),
            torch.tensor([pos, pos - 9, ps, 0], dtype=torch.int32,
                         device=cuda))
    got = pa.paged_attention_decode(*args)
    want = pa.paged_read_plain(*args)
    torch.cuda.synchronize()
    _close(got, want, 1e-5)


@pytest.mark.parametrize("name", ["olmo-1b", "codeqwen1.5-7b",
                                  "starcoder2-7b"])
def test_dense_family_graph_matches_eager_on_card(cuda, name, monkeypatch):
    """The reduced token configs served through the captured decode step
    at ``kernel:dscim1:256`` with int8 KV: the graph's tokens and logit
    trace bitwise the eager loop's, and the paged kernel's capture
    preparation sized for the n_rep the live launches use (starcoder2:
    q heads padded to 48 over 2 kv heads, 24)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import paged_attention
    from repro_torch.launch.serve import prepare_params, serve_batch
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch(name).reduced(),
                              dscim="kernel:dscim1:256")
    params = prepare_params(cfg, lm.init_params(cfg, 0), cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16))
    seen = {"prepared": set(), "launched": set()}
    prep, launch = paged_attention.prepare_capture, \
        paged_attention._launch_kernel

    def prepare_capture(B, KV, R, *a):
        seen["prepared"].add(R)
        return prep(B, KV, R, *a)

    def launch_kernel(q, *a):
        seen["launched"].add(q.shape[2])
        return launch(q, *a)

    monkeypatch.setattr(paged_attention, "prepare_capture", prepare_capture)
    monkeypatch.setattr(paged_attention, "_launch_kernel", launch_kernel)
    kw = dict(kv="int8", page_size=4, trace_logits=True)
    t = {}
    g = serve_batch(cfg, params, prompts, 6, timings=t, **kw)
    e = serve_batch(cfg, params, prompts, 6, scan=False, **kw)
    torch.cuda.synchronize()
    assert "capture_s" in t
    np.testing.assert_array_equal(g[0], e[0])
    np.testing.assert_array_equal(np.stack(g[1]), np.stack(e[1]))
    assert seen["prepared"] == seen["launched"] == {cfg.q_heads // cfg.n_kv}


@pytest.mark.parametrize("spec", ["off", "kernel:dscim1:256"])
@pytest.mark.parametrize("name", ["musicgen-large", "pixtral-12b"])
def test_stub_config_decodes_on_card(cuda, name, spec, monkeypatch):
    """The reduced stub-frontend configs at model level from seeded
    embeddings: prefill, then 4 paged decode steps through the kernels.
    Every paged-attention call the model makes, and at the kernel spec
    every fused-MVM call, is held against its plain version on the same
    inputs.  At 'off' the logits are also held against the same run on
    the CPU (plain versions): the same argmax at prefill, drift <= 1e-3.
    At the kernel spec the devices are not compared: the estimator
    quantizes its activations, so another f32 sum order moves whole
    quantization levels (on the card the reduced musicgen-large's
    prefill argmax moved in one of 3 rows)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.kvcache import paged_from_dense
    from repro_torch.core.qweights import map_params
    from repro_torch.kernels import dscim_fused
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import logit_drift_rmse
    from repro_torch.layers import attention
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch(name).reduced(), dscim=spec)
    params = lm.init_params(cfg, 0, device="cpu")
    emb = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (3, 20, cfg.d_model)).astype(np.float32))

    def run(dev):
        p = map_params(lambda _, a: a.to(dev), params)
        e = emb.to(dev)
        l0, dense = lm.prefill(p, cfg, None, embeds=e[:, :16])
        cache = paged_from_dense(dense["k"], dense["v"], 4, n_pages=15,
                                 max_pages=5)
        steps = [l0]
        for t in range(4):
            lg, cache = lm.decode(p, cfg, None, cache,
                                  embed=e[:, 16 + t:17 + t])
            steps.append(lg)
        return np.stack([s.cpu().numpy() for s in steps])

    held = {"paged": 0, "fused": 0}

    def paged(*a, **kw):
        got = pa.paged_attention_decode(*a, **kw)
        _close(got, pa.paged_read_plain(*a), 1e-5)
        held["paged"] += 1
        return got

    fused_kernel = dscim_fused.dscim_fused_mvm_prepared

    def fused(x, qw, c, **kw):
        got = fused_kernel(x, qw, c, **kw)
        x2 = x.reshape(-1, x.shape[-1])
        xq = dscim_fused.quantize_activations_windowed(x2, qw.nw, qw.g)
        want = dscim_fused.dscim_fused_mvm_plain(
            xq.q.contiguous(), xq.scale.reshape(-1, qw.nw).contiguous(),
            qw.q, qw.scale, c)
        _close(got.reshape(want.shape), want, 2e-5)
        held["fused"] += 1
        return got

    want = run("cpu") if spec == "off" else None
    monkeypatch.setattr(attention, "paged_attention_decode", paged)
    monkeypatch.setattr(dscim_fused, "dscim_fused_mvm_prepared", fused)
    got = run("cuda")
    torch.cuda.synchronize()
    assert np.isfinite(got).all()
    per_fwd = 2 * cfg.n_layers + 1 + (cfg.mlp_kind == "swiglu") \
        * cfg.n_layers
    assert held == {"paged": 4 * cfg.n_layers,
                    "fused": 0 if spec == "off" else 5 * per_fwd}
    if want is not None:
        toks = {"cpu": want.argmax(-1).T, "cuda": got.argmax(-1).T}
        np.testing.assert_array_equal(toks["cuda"][:, 0], toks["cpu"][:, 0])
        assert logit_drift_rmse(toks["cpu"], toks["cuda"], list(want),
                                list(got)) <= 1e-3


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_moe_graph_matches_eager_on_card(cuda, name):
    """The reduced MoE configs at ``kernel:dscim1:256`` with int8 KV: the
    captured step's tokens and logit trace bitwise the eager loop's, spec
    (``dscim2:2``) bitwise plain, continuous serving bitwise one-shot, and
    the card's tokens those of the CPU's run on the same weights."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import (prepare_params, serve_batch,
                                          serve_continuous)
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch(name).reduced(),
                              dscim="kernel:dscim1:256")
    host = lm.init_params(cfg, 0, device="cpu")
    params = prepare_params(cfg, host, cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16))
    kw = dict(kv="int8", page_size=4)
    t = {}
    g = serve_batch(cfg, params, prompts, 6, timings=t, trace_logits=True,
                    **kw)
    e = serve_batch(cfg, params, prompts, 6, scan=False, trace_logits=True,
                    **kw)
    assert "capture_s" in t
    np.testing.assert_array_equal(g[0], e[0])
    np.testing.assert_array_equal(np.stack(g[1]), np.stack(e[1]))
    s = serve_batch(cfg, params, prompts, 6, spec="dscim2:2", **kw)
    np.testing.assert_array_equal(s[0], g[0])
    c = serve_batch(cfg, host, prompts, 6, device="cpu", **kw)
    np.testing.assert_array_equal(c[0][:, 0], g[0][:, 0])
    budgets = np.asarray([5, 2, 4, 3], np.int32)
    outs, stats = serve_continuous(cfg, params, prompts, 6, slots=2,
                                   seg_len=2, max_new=budgets, eos_id=-1,
                                   **kw)
    for r in range(4):
        ref, _ = serve_batch(cfg, params, np.tile(prompts[r:r + 1], (2, 1)),
                             6, eos_id=-1, max_new=[int(budgets[r])] * 2,
                             **kw)
        np.testing.assert_array_equal(outs[r], ref[0, :budgets[r]])


@pytest.mark.parametrize("key", [("dscim1", 256, "paper"),
                                 ("dscim2", 64, "paper"),
                                 ("dscim1", 64, "opt")])
@pytest.mark.parametrize("M,K,N", [(4, 64, 16), (3, 128, 33)])
def test_count_kernel_equals_cycle_oracle_on_card(cuda, key, M, K, N):
    """The count kernel's counts equal the cycle-level OR-MAC's, run on
    the card, exactly."""
    from repro_torch.core.macro import DSCIMMacro
    from repro_torch.core.seed_search import calibrated_config

    mac = DSCIMMacro(calibrated_config(*key))
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8))
    kern = mac.counts_kernel(x.to(cuda), w.to(cuda))
    cyc = mac.counts_cycle(x.to(cuda), w.to(cuda))
    assert cyc.device.type == "cuda"
    np.testing.assert_array_equal(kern.to(torch.int64).cpu().numpy(),
                                  cyc.cpu().numpy())
    np.testing.assert_array_equal(cyc.cpu().numpy(),
                                  mac.counts_lut(x, w).numpy())


def test_capture_holds_the_collector_off(cuda):
    """A CUDA graph that becomes cyclic garbage while a step is captured
    (the collector's threshold at 1, so the step's next allocation would
    collect it) must not invalidate the capture: a graph that dies resets
    itself, which the driver refuses while a stream captures."""
    import gc

    from repro_torch.launch.graph import CapturedStep

    x = torch.zeros(4, device=cuda)
    dead = torch.cuda.CUDAGraph()
    with torch.cuda.graph(dead):
        x.mul_(2)
    holder = {"graph": dead}
    del dead

    def step():
        graph = holder.pop("graph", None)   # the last outside reference
        if graph is not None:
            cycle = [graph]
            cycle.append(cycle)             # young cyclic garbage
            del graph, cycle
        kept = [[i] for i in range(100)]    # tracked allocations that
        del kept                            # start collections
        x.add_(1)

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        captured = CapturedStep(step, cuda)
        captured.run()
        captured.run()
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*threshold)
    assert x.tolist() == [2.0] * 4


def _all_launch_counters():
    """The six kernels' launch counters (each wrapper counts where it
    launches its kernel)."""
    from repro_torch.kernels import (dscim_fused, dscim_mvm,
                                     dscim_mvm_blocked, flash_attention,
                                     int8_matmul, paged_attention)
    return [m.LAUNCHES for m in (dscim_fused, paged_attention,
                                 flash_attention, int8_matmul,
                                 dscim_mvm_blocked, dscim_mvm)]


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-7b"])
def test_recurrent_family_graph_matches_eager_on_card(cuda, name):
    """The reduced RWKV6 and Zamba2 configs (``dscim="off"``, the float
    cache): the captured step's tokens and logit trace bitwise the eager
    loop's, an ``eos_id`` request with ``max_new`` budgets bitwise its
    eager loop, no launch of the port's kernels, and the card against the
    CPU on the same weights: first tokens equal, logit drift RMSE on the
    teacher-matched prefix <= 1e-3."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import (logit_drift_rmse, prepare_params,
                                          serve_batch)
    from repro_torch.models.registry import get_model

    cfg = get_arch(name).reduced()
    host = get_model(cfg).init_params(cfg, 0, device="cpu")
    params = prepare_params(cfg, host, cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16))
    counters = _all_launch_counters()
    before = [c.count for c in counters]
    t = {}
    g = serve_batch(cfg, params, prompts, 6, timings=t, trace_logits=True)
    e = serve_batch(cfg, params, prompts, 6, scan=False, trace_logits=True)
    assert "capture_s" in t
    np.testing.assert_array_equal(g[0], e[0])
    np.testing.assert_array_equal(np.stack(g[1]), np.stack(e[1]))
    eos, budgets = int(g[0][0, 2]), np.asarray([6, 3, 1, 4], np.int32)
    ge, ee = (serve_batch(cfg, params, prompts, 6, eos_id=eos,
                          max_new=budgets, scan=scan)[0]
              for scan in (True, False))
    np.testing.assert_array_equal(ge, ee)
    assert [c.count for c in counters] == before
    c = serve_batch(cfg, host, prompts, 6, device="cpu", trace_logits=True)
    np.testing.assert_array_equal(c[0][:, 0], g[0][:, 0])
    assert logit_drift_rmse(c[0], g[0], c[1], g[1]) <= 1e-3


def test_checkpoint_restore_onto_the_card_is_bitwise(cuda, tmp_path):
    """A restore onto the card (the staged read through pinned buffers,
    leaves larger than a buffer included) gives the saved tensors
    bitwise, each on the card in its dtype."""
    from repro_torch.checkpoint import checkpointer
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.tree import leaves

    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"big": torch.randn(checkpointer.STAGE_BYTES // 4 * 2 + 7,
                               generator=gen, device=cuda),
            "count": torch.tensor(5, dtype=torch.int64, device=cuda),
            "w": torch.randint(-128, 128, (33, 17), generator=gen,
                               device=cuda).to(torch.int8),
            "empty": torch.zeros((0, 3), device=cuda)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree, blocking=True)
    got, _ = ck.restore(1, {k: torch.empty_like(v, device="meta")
                            for k, v in tree.items()}, device=cuda)
    for want, have in zip(leaves(tree), leaves(got)):
        assert have.device.type == "cuda" and have.dtype == want.dtype
        assert torch.equal(have, want)
