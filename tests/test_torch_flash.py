"""Port parity, causal flash attention: the port's CPU route
(``flash_attention_plain``, what ``flash_attention`` runs on CPU tensors)
against the JAX reference's Pallas kernel in interpret mode and its plain
oracle, at the shapes of the reference's own test (test_kernels.py).
Contract: atol 3e-5, the reference test's own tolerance (f32 softmax,
summation order)."""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("shape", [(4, 64, 32, 16, 16), (2, 128, 64, 32, 64),
                                   (1, 96, 16, 32, 32)])
def test_flash_vs_pallas_interpret(shape):
    BH, S, d, bq, bk = shape
    q, k, v = _qkv((BH, S, d), sum(shape))
    want = np.asarray(flash_attention_pallas(
        *(jnp.asarray(t) for t in (q, k, v)), bq=bq, bk=bk, interpret=True))
    got = fa.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (BH, S, d)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


@pytest.mark.parametrize("S", [1, 7, 100])
def test_flash_ragged_length_vs_oracle(S):
    """Any S is taken (the reference kernel needs S % bq == 0); its plain
    oracle has no such limit and is the comparison here."""
    q, k, v = _qkv((3, S, 24), S)
    want = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(t) for t in (q, k, v))))
    got = fa.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


def test_flash_bf16_output_dtype_vs_oracle():
    """bf16 inputs: computed in f32, returned in bf16 on both sides.
    Both round the same f32 result to bf16, so they may differ by one bf16
    ulp where the f32 values straddle a rounding boundary: held to
    2^-7 * max(1, |ref|) per element."""
    q, k, v = _qkv((2, 64, 32), 5)
    qb, kb, vb = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = fa.flash_attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
          for t in (qb, kb, vb))).astype(jnp.float32))
    g = got.float().numpy()
    assert np.all(np.abs(g - want) <= 2.0 ** -7 * np.maximum(1, np.abs(want)))


def test_flash_first_row_attends_to_itself_only():
    q, k, v = (torch.from_numpy(t) for t in _qkv((2, 9, 8), 1))
    out = fa.flash_attention(q, k, v)
    torch.testing.assert_close(out[:, 0], v[:, 0], rtol=0, atol=1e-6)


def test_flash_rejects_other_layouts():
    with pytest.raises(ValueError, match="BH, S, d"):
        fa.flash_attention(*(torch.zeros(1, 2, 4, 8) for _ in range(3)))
