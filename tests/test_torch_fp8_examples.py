"""The FP8 path of the paper's LLM experiment, the prepared weights'
inverse, per-call weight quantization and the port's two examples, held
on the CPU against the JAX reference.  Contracts:

* ``fp8_cast``, ``fp8_to_int8_aligned`` and ``dequantize_int8`` bitwise
  the reference's (called eagerly, as its tests call them), NaN
  positions included: 19,200 values of both signs spread over 1e-4 to
  1e3 and the boundaries of float8_e4m3fn (448, the tie at 464 that
  rounds to even, the next f32 above it, inf, NaN, zeros, subnormals),
  in f32 and bf16;
* ``dequantize_linear_weight`` bitwise the reference's for a plain, a
  stacked (MoE experts) and a K-padded weight, on the same planes;
* ``serve_batch(prepare=False)`` (weights quantized at every call)
  bitwise ``prepare=True`` on the reduced qwen3-0.6b, and its tokens
  bitwise the reference's ``serve_batch(prepare=False)`` with the
  prefill logits within 1e-5 (f32 summation order, as
  tests/test_torch_model.py holds serving);
* ``examples/quickstart_torch.py`` prints the reference example's lines
  (the estimates, the RMSEs and the hardware model's TOPS/W, TOPS/mm2
  and area) character for character;
* ``examples/serve_dscim_torch.py``: its ``lut`` and ``kernel`` runs'
  tokens bitwise the reference's ``serve_batch`` on the same seeded
  parameters and prompts (float and int8 KV), and its CLI prints the
  reference example's five lines on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import qweights as jqw  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.launch.serve import serve_batch as jserve_batch  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import qweights, quant  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 1e-5


def _example(name: str):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fp8_values() -> np.ndarray:
    rng = np.random.default_rng(0)
    mag = np.exp(rng.uniform(np.log(1e-4), np.log(1e3), 19200))
    x = (mag * rng.choice([-1.0, 1.0], 19200)).astype(np.float32)
    f = np.float32
    edges = [448, 464, np.nextafter(f(464), f(1e9)),
             np.nextafter(f(464), f(0)), 480, 1e4, np.inf, np.nan, 0.0,
             2.0 ** -9, 2.0 ** -10, 1.5 * 2.0 ** -10, 2.0 ** -7]
    edges = np.asarray(edges, np.float32)
    return np.concatenate([x, edges, -edges])


def _assert_bitwise(got: np.ndarray, want: np.ndarray):
    """Same dtype and shape, NaN at the same positions, every other
    element's bits equal."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bits = {4: np.uint32, 2: np.uint16}[got.dtype.itemsize]
    np.testing.assert_array_equal(got[~nan].view(bits), want[~nan].view(bits))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_cast_bitwise_nan_included(dtype):
    x = _fp8_values()
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jquant.fp8_cast(jx))
    got = quant.fp8_cast(tx).numpy()
    _assert_bitwise(got, want)
    assert np.isnan(want).sum() > 900       # 4.8 % of them are > 464
    tie = quant.fp8_cast(torch.tensor([464.0, -464.0]))
    assert tie.tolist() == [448.0, -448.0]


@pytest.mark.parametrize("shape,group", [((64, 300), 128),
                                         ((2, 3, 256), 128),
                                         ((5, 100), 64)])
def test_fp8_to_int8_aligned_bitwise(shape, group):
    v = _fp8_values()
    x = np.resize(v, shape)
    want = jquant.fp8_to_int8_aligned(jnp.asarray(x), group)
    got = quant.fp8_to_int8_aligned(torch.from_numpy(x), group)
    assert got[2] == want[2]
    _assert_bitwise(got[0].numpy(), np.asarray(want[0]))
    _assert_bitwise(got[1].numpy(), np.asarray(want[1]))
    assert np.isnan(np.asarray(want[1])).any()    # NaN groups are held


def test_dequantize_int8_bitwise():
    x = np.random.default_rng(1).normal(0, 3, (16, 40)).astype(np.float32)
    jq = jquant.quantize_int8(jnp.asarray(x), axis=-1)
    tq = quant.QuantizedTensor(torch.from_numpy(np.array(jq.q)),
                               torch.from_numpy(np.array(jq.scale)), -1)
    _assert_bitwise(quant.dequantize_int8(tq).numpy(),
                    np.asarray(jquant.dequantize_int8(jq)))
    tq2 = quant.quantize_int8(torch.from_numpy(x), axis=-1)
    _assert_bitwise(quant.dequantize_int8(tq2).numpy(),
                    np.asarray(jquant.dequantize_int8(jq)))


@pytest.mark.parametrize("shape,group_k", [((256, 48), 128),
                                           ((4, 128, 24), 128),
                                           ((200, 16), 128),
                                           ((3, 70, 8), 32)])
def test_dequantize_linear_weight_bitwise(shape, group_k):
    w = np.random.default_rng(2).normal(0, 0.1, shape).astype(np.float32)
    jw = jqw.prepare_linear_weight(jnp.asarray(w), group_k)
    tw = qweights.QuantizedLinearWeight(
        torch.from_numpy(np.array(jw.q)),
        torch.from_numpy(np.array(jw.scale)), jw.k_orig, jw.group_k)
    want = np.asarray(jqw.dequantize_linear_weight(jw))
    assert want.shape == shape
    _assert_bitwise(qweights.dequantize_linear_weight(tw).numpy(), want)
    own = qweights.prepare_linear_weight(torch.from_numpy(w), group_k)
    _assert_bitwise(qweights.dequantize_linear_weight(own).numpy(), want)


@pytest.fixture(scope="module")
def qwen():
    """The reduced qwen3-0.6b's reference parameters (seed 0) and
    prompts, as the reference example draws them."""
    jcfg = jget_arch("qwen3-0.6b").reduced()
    jparams = jget_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 6), dtype=np.int32)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams), prompts


@pytest.mark.parametrize("spec,kv", [("kernel:dscim1:256", "int8"),
                                     ("lut:dscim1:256", "float")])
def test_serve_batch_no_prepare_bitwise_prepared(qwen, spec, kv):
    jcfg, jparams, np_params, prompts = qwen
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), dscim=spec)
    assert cfg.compute_dtype == "float32"
    params = params_from_jax(np_params, device="cpu")
    kw = dict(kv=kv, device="cpu")
    pt, pl = serve_batch(cfg, params, prompts, 4, **kw)
    ut, ul = serve_batch(cfg, params, prompts, 4, prepare=False, **kw)
    np.testing.assert_array_equal(ut, pt)
    np.testing.assert_array_equal(ul[0], pl[0])
    jt, jl = jserve_batch(dataclasses.replace(jcfg, dscim=spec), jparams,
                          prompts, 4, prepare=False, kv=kv)
    np.testing.assert_array_equal(ut, np.asarray(jt))
    np.testing.assert_allclose(ul[0], np.asarray(jl[0]), atol=LOGIT_ATOL,
                               rtol=0)


def test_quickstart_prints_the_reference_lines():
    out = {}
    for name, args in (("quickstart", ()), ("quickstart_torch",
                                            (["--device", "cpu"],))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _example(name).main(*args)
        out[name] = buf.getvalue().splitlines()
    assert any("RMSE" in ln for ln in out["quickstart"])
    assert any("TOPS/W" in ln for ln in out["quickstart"])
    assert out["quickstart_torch"] == out["quickstart"]


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_serve_example_tokens_equal_reference(qwen, kv):
    jcfg, jparams, np_params, prompts = qwen
    mod = _example("serve_dscim_torch")
    cfg = get_arch("qwen3-0.6b").reduced()
    got = mod.serve_specs(cfg, params_from_jax(np_params, device="cpu"),
                          prompts, 3, device="cpu", kv=kv)
    assert list(got) == [tag for tag, _ in mod.SPECS]
    for tag, spec in mod.SPECS:
        if not spec.startswith(("lut", "kernel")):
            continue
        jt, _ = jserve_batch(dataclasses.replace(jcfg, dscim=spec), jparams,
                             prompts, 3, kv=kv)
        np.testing.assert_array_equal(got[tag][0], np.asarray(jt))


def test_serve_example_cli_prints_five_lines():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _example("serve_dscim_torch").main(
            ["--device", "cpu", "--batch", "2", "--prompt-len", "4",
             "--tokens", "2", "--kv", "int8", "--no-prepare", "--eos", "3",
             "--temp", "0.8", "--top-k", "5"])
    lines = buf.getvalue().splitlines()
    assert len(lines) == 5 and lines[0].startswith("float (scanned): ")
    assert lines[-1].startswith("dscim1/L256/fused-kernel: ")
