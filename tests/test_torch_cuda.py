"""The port's CUDA kernels against their plain PyTorch versions on the card,
at odd and test-sized shapes (the full-width serving shapes, and the
reduced config served on the GPU against the CPU, are held by
``chip_smoke.py``).  Marked ``cuda``: without a GPU every test here skips
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

