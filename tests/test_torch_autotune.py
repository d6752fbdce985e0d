"""The tile autotuner (kernels/autotune.py), ``tune`` on the CPU and the
int8 paged read pin (``paged_attn``).

* The tuner's lookup, with a stub bench and timer (no card here):
  memory, then the file ``REPRO_AUTOTUNE_CACHE`` names, then the packaged
  cache; only the env-named file is written; a key of another card or
  shape never matches; a candidate that raises is skipped; none left
  raises ``ValueError``.
* The packaged cache's schema (the cache half of the reference's
  ``tools/check_artifacts.py``, for the port): ``fused/``, ``mvm/`` or
  ``paged_attn/`` keys with a ``cuda`` segment and a card name, values
  positive-int tuples of the kind's arity that the kernels take; and the
  tile tables equal to the C sources' switches.
* ``tune=True`` and ``REPRO_DSCIM_TUNE=1`` on the CPU: bitwise the
  untuned output (the plain versions have no tiles).
* ``paged_attn``: the port's ``serve_batch(paged_attn=...)`` against the
  reference's on the same inputs (tokens equal, the slice's contract of
  tests/test_torch_model.py: logit drift <= 1e-3), a bad value raising
  ``ValueError`` in both, two pins never sharing a runner, and the CLI's
  ``--paged-attn`` / ``--tune`` reaching ``serve_batch``.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import dataclasses  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.serve import serve_batch as jserve_batch  # noqa: E402
from repro.models.lm import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.dscim_layer import DSCIMLinear, make_linear  # noqa: E402
from repro_torch.core.qweights import prepare_linear_weight  # noqa: E402
from repro_torch.core.seed_search import calibrated_config  # noqa: E402
from repro_torch.kernels import autotune, dscim_fused, ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.dscim_mvm_blocked import (  # noqa: E402
    dscim_counts_blocked)
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch.serve import logit_drift_rmse, serve_batch  # noqa: E402,E501

CSRC = Path(autotune.__file__).resolve().parent / "csrc"
DRIFT_MAX = 1e-3          # tests/test_torch_model.py's kernel-mode contract
CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """An empty memory cache, a packaged cache and an env-named file under
    tmp_path: (packaged path, env path)."""
    packaged, env = tmp_path / "packaged.json", tmp_path / "env.json"
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", packaged)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(env))
    autotune.clear()
    yield packaged, env
    autotune.clear()


def _stub(times, raises=()):
    """(bench, timer, calls): bench(c) -> c unless c raises; timer reads
    ``times``."""
    calls = []

    def bench(c):
        calls.append(c)
        if c in raises:
            raise RuntimeError(f"tile {c} refused")
        return c

    return bench, lambda c: times[c], calls


def test_sweep_writes_env_file_and_memory(caches):
    packaged, env = caches
    bench, timer, calls = _stub({(1,): 3.0, (2,): 1.0, (3,): 2.0})
    assert autotune.best("k/cuda/card", [(1,), (2,), (3,)], bench,
                         timer) == (2,)
    assert calls == [(1,), (2,), (3,)]
    assert json.loads(env.read_text()) == {"k/cuda/card": [2]}
    assert not packaged.exists()            # never written
    # memory first: no bench
    assert autotune.best("k/cuda/card", [(1,)], bench, timer) == (2,)
    assert len(calls) == 3
    # then the env-named file, read back after the memory is cleared
    autotune.clear()
    assert autotune.best("k/cuda/card", [(1,)], bench, timer) == (2,)
    assert len(calls) == 3


def test_lookup_order_env_over_packaged(caches):
    packaged, env = caches
    packaged.write_text(json.dumps({"a/cuda/card": [5], "b/cuda/card": [6]}))
    env.write_text(json.dumps({"a/cuda/card": [7]}))
    bench, timer, calls = _stub({})
    assert autotune.best("a/cuda/card", [(1,)], bench, timer) == (7,)
    assert autotune.best("b/cuda/card", [(1,)], bench, timer) == (6,)
    assert calls == []
    # a winner swept with no env file is kept in memory only
    autotune.clear()
    import os
    del os.environ["REPRO_AUTOTUNE_CACHE"]
    bench, timer, calls = _stub({(1,): 1.0})
    assert autotune.best("c/cuda/card", [(1,)], bench, timer) == (1,)
    assert json.loads(packaged.read_text()) == {"a/cuda/card": [5],
                                                "b/cuda/card": [6]}


def test_raising_candidate_skipped_and_none_viable(caches):
    bench, timer, calls = _stub({(1,): 1.0, (2,): 2.0}, raises={(1,)})
    assert autotune.best("k2/cuda/card", [(1,), (2,)], bench, timer) == (2,)
    bench, timer, _ = _stub({}, raises={(1,), (2,)})
    with pytest.raises(ValueError, match="no viable candidate"):
        autotune.best("k3/cuda/card", [(1,), (2,)], bench, timer)


def test_key_of_another_card_or_shape_never_matches(caches, monkeypatch):
    """The packaged winner of one card and shape is read for exactly that
    key; another card's or another shape's key sweeps (here every
    candidate is refused, so it raises)."""
    packaged, _ = caches
    cfg = calibrated_config("dscim1", 256, "paper")
    qw = prepare_linear_weight(torch.zeros((1024, 3072)), 128)
    key = (f"fused/{cfg.name}/k{cfg.k}L{cfg.length}t{cfg.trunc}/"
           f"4x1024x3072/g128/bfloat16/cuda/{CARD}")
    packaged.write_text(json.dumps({key: [64, 2, 2]}))
    launched = []

    def refuse(x, w, cfg, tile=-1, counter=None):
        launched.append(tile)
        raise RuntimeError("refused")
    monkeypatch.setattr(dscim_fused, "_launch_kernel", refuse)
    monkeypatch.setattr(autotune, "card_name", lambda dev: CARD)
    # the sweep's weight copies fill twice the L2: none here
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(L2_cache_size=1))
    assert autotune.fused_tiles(4, qw, cfg, torch.bfloat16) == (64, 2, 2)
    assert launched == []
    for card, M, dt in (("Another card", 4, torch.bfloat16),
                        (CARD, 8, torch.bfloat16), (CARD, 4, torch.float32)):
        monkeypatch.setattr(autotune, "card_name", lambda dev, c=card: c)
        with pytest.raises(ValueError, match="no viable"):
            autotune.fused_tiles(M, qw, cfg, dt)
    assert len(launched) == 3 * len(autotune.FUSED_DECODE_TILES)


def _tile_ok(kind, key, val) -> bool:
    if kind == "fused":
        M = int(re.search(r"/(\d+)x\d+x\d+/", key).group(1))
        return val in (autotune.FUSED_DECODE_TILES if M <= 16
                       else autotune.FUSED_PREFILL_TILES)
    if kind == "mvm":
        return val in autotune.MVM_TILES
    kv, r = map(int, re.search(r"/kv(\d+)r(\d+)hd", key).groups())
    return val in autotune.paged_attn_candidates(kv, r)


def test_packaged_cache_schema():
    """Every key of the shipped cache parses as a port key, every value is
    a tile the kernels take; the reference's TPU cache is not the one
    read."""
    path = autotune.DEFAULT_CACHE
    assert path.parent.name == "kernels" and "repro_torch" in path.parts
    data = json.loads(path.read_text())
    assert data
    for key, val in data.items():
        seg = key.split("/")
        kind = seg[0]
        assert kind in autotune.ARITY, key
        assert seg[-2] == "cuda" and seg[-1].strip(), key
        assert isinstance(val, list) and len(val) == autotune.ARITY[kind]
        assert all(isinstance(v, int) and v > 0 for v in val), key
        assert _tile_ok(kind, key, tuple(val)), key
    # the main path's decode shapes are there (qwen3-0.6b, B = 4)
    keys = "\n".join(data)
    for shape in ("4x1024x3072", "4x3072x1024", "4x1024x152064"):
        assert f"/{shape}/g128/bfloat16/cuda/" in keys, shape
    assert "paged_attn/B4/kv8r2hd128/ps8/cuda/" in keys


def _cases(src: str, fn: str):
    """The template arguments of each ``case`` of ``fn``'s switch."""
    body = re.search(rf"\n\w[^\n]*\b{fn}\(const Params& p, int tile, "
                     rf"cudaStream_t st\) \{{(.*?)\n\}}", src, re.S).group(1)
    return [[a.strip() for a in m.split(",")] for m in
            re.findall(r"case \d+: return launch\w*<([^>]*)>", body)]


def test_tile_tables_match_the_sources():
    """autotune's tables are the C switches, case by case: kernel 1's
    (columns 16*TA*WN, stages, split), kernels 5/6's (columns 16*TA*WN,
    rows 8*NT*WM, warps WN*WM)."""
    fused = (CSRC / "dscim_fused.cu").read_text()

    def fused_tile(a):
        TA, _, WN, _, split, stages = a
        return (16 * int(TA) * int(WN), int(stages),
                2 if split == "true" else 1)
    assert tuple(fused_tile(a) for a in _cases(fused, "decode")) == \
        autotune.FUSED_DECODE_TILES
    assert tuple(fused_tile(a) for a in _cases(fused, "prefill")) == \
        autotune.FUSED_PREFILL_TILES
    counts = (CSRC / "dscim_counts.cu").read_text()
    assert tuple((16 * int(a[0]) * int(a[2]), 8 * int(a[1]) * int(a[3]),
                  int(a[2]) * int(a[3]))
                 for a in _cases(counts, "run_tile")) == autotune.MVM_TILES


def test_split_candidates_need_more_than_one_chunk():
    assert all(t[2] == 1 for t in autotune.fused_candidates(4, 1))
    assert autotune.fused_candidates(4, 8) == \
        list(autotune.FUSED_DECODE_TILES)
    assert autotune.fused_candidates(256, 24) == \
        list(autotune.FUSED_PREFILL_TILES)
    assert autotune.paged_attn_candidates(8, 2) == [
        (g, q) for g in (1, 2, 4, 8) for q in (2, 8)]
    assert autotune.paged_attn_candidates(6, 8) == [(1, 8), (2, 8), (6, 8)]


def test_tune_is_bitwise_untuned_on_cpu(monkeypatch):
    """``tune`` on the CPU is a no-op: ``DSCIMLinear(tune=True)``,
    ``make_linear(tune=True)``, ``REPRO_DSCIM_TUNE=1`` and every wrapper's
    ``tune`` give the untuned bits."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (3, 200)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.1, (200, 24)).astype(np.float32))
    qw = prepare_linear_weight(w, 128)
    cfg = calibrated_config("dscim1", 256, "paper")
    monkeypatch.delenv("REPRO_DSCIM_TUNE", raising=False)
    for mode in ("kernel", "bitmatmul"):
        base = DSCIMLinear(cfg, mode)
        want = base(x, qw)
        assert torch.equal(DSCIMLinear(cfg, mode, tune=True)(x, qw), want)
        assert torch.equal(DSCIMLinear(cfg, mode, tune=True)(x, w),
                           base(x, w))
        assert torch.equal(make_linear("dscim1", 256, mode, tune=True)(x, qw),
                           want)
        monkeypatch.setenv("REPRO_DSCIM_TUNE", "1")
        assert torch.equal(base(x, qw), want)
        monkeypatch.delenv("REPRO_DSCIM_TUNE")
    xi = torch.from_numpy(rng.integers(-128, 128, (3, 64)).astype(np.int8))
    wi = torch.from_numpy(rng.integers(-128, 128, (64, 24)).astype(np.int8))
    assert torch.equal(ops.dscim_mvm(xi, wi, cfg, tune=True),
                       ops.dscim_mvm(xi, wi, cfg))
    assert torch.equal(dscim_counts_blocked(xi, wi, cfg, tune=True),
                       dscim_counts_blocked(xi, wi, cfg))
    args = (torch.from_numpy(rng.normal(0, 1, (2, 2, 2, 16)).astype(
                np.float32)),
            *(torch.from_numpy(rng.integers(-127, 128, (4, 4, 2, 16)).astype(
                np.int8)) for _ in range(2)),
            *(torch.full((4, 2), 0.01) for _ in range(2)),
            *(torch.zeros((2, 4, 2, 16), dtype=torch.bfloat16)
              for _ in range(2)),
            torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
            torch.tensor([5, 6], dtype=torch.int32))
    assert torch.equal(pa.paged_attention_decode(*args, tune=True),
                       pa.paged_attention_decode(*args))


# -- the paged read pin ------------------------------------------------------

SPEC = "kernel:dscim1:256"


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = dataclasses.replace(jget_arch("qwen3-0.6b").reduced(), dscim=SPEC)
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), dscim=SPEC)
    jp = jinit_params(jget_arch("qwen3-0.6b").reduced(),
                      jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)
    return jcfg, cfg, jp, tp, prompts


@pytest.mark.parametrize("pin", ["kernel", "jnp"])
def test_paged_attn_pin_matches_reference(slice_setup, pin):
    """The port's pinned read against the reference's same pin: tokens
    equal, logit drift within the slice's contract; on the CPU both pins
    run the plain read, so the port's two are bitwise equal."""
    jcfg, cfg, jp, tp, prompts = slice_setup
    kw = dict(kv="int8", page_size=4, trace_logits=True)
    jt, jl = jserve_batch(jcfg, jp, prompts, 4, paged_attn=pin, **kw)
    tt, tl = serve_batch(cfg, tp, prompts, 4, device="cpu", paged_attn=pin,
                         **kw)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert logit_drift_rmse(np.asarray(jt), tt, jl, tl) <= DRIFT_MAX
    at, al = serve_batch(cfg, tp, prompts, 4, device="cpu", **kw)
    np.testing.assert_array_equal(tt, at)
    np.testing.assert_array_equal(np.stack(tl), np.stack(al))


def test_paged_attn_bad_value_raises(slice_setup):
    jcfg, cfg, jp, tp, prompts = slice_setup
    with pytest.raises(ValueError, match="paged_attn"):
        serve_batch(cfg, tp, prompts, 2, kv="int8", device="cpu",
                    paged_attn="gather")
    with pytest.raises(ValueError, match="paged_attn"):
        jserve_batch(jcfg, jp, prompts, 2, kv="int8", paged_attn="gather")
    with pytest.raises(ValueError, match="paged_attn"):
        pa.use_paged_kernel("gather")


def test_two_pins_never_share_a_runner(slice_setup, monkeypatch):
    """Each pin is part of the config, so of the runner's key: serving
    'kernel' then 'jnp' makes two runners, whose configs carry the pin;
    'auto' follows REPRO_PAGED_ATTN, a pin does not."""
    _, cfg, _, tp, prompts = slice_setup
    steps.clear_graphs()
    for pin in ("kernel", "jnp", "kernel"):
        serve_batch(cfg, tp, prompts, 2, kv="int8", device="cpu",
                    paged_attn=pin)
    assert steps._generate_runner.cache_info().currsize == 2
    assert steps.pin_paged_attn(cfg, "jnp").paged_attn == "jnp"
    assert steps.pin_paged_attn(cfg, "auto") is cfg
    monkeypatch.setenv("REPRO_PAGED_ATTN", "jnp")
    assert not pa.use_paged_kernel("auto")
    assert pa.use_paged_kernel("kernel")
    monkeypatch.setenv("REPRO_PAGED_ATTN", "kernel")
    assert pa.use_paged_kernel("auto") and not pa.use_paged_kernel("jnp")
    steps.clear_graphs()


def test_cli_paged_attn_and_tune_reach_serve_batch(monkeypatch, capsys):
    """``launch/serve.py --paged-attn jnp --tune`` serves the pinned read
    with ``REPRO_DSCIM_TUNE`` set, for every run of the CLI."""
    monkeypatch.setenv("REPRO_DSCIM_TUNE", "0")   # restored after the test
    seen = []
    real = serve.serve_batch

    def spy(cfg, *a, **kw):
        import os
        seen.append((cfg.dscim, kw.get("paged_attn"),
                     os.environ["REPRO_DSCIM_TUNE"]))
        return real(cfg, *a, **kw)
    monkeypatch.setattr(serve, "serve_batch", spy)
    assert serve.main(["--reduced", "--device", "cpu", "--dscim", SPEC,
                       "--kv", "int8", "--paged-attn", "jnp", "--tune",
                       "--batch", "2", "--prompt-len", "8", "--tokens",
                       "3"]) == 0
    assert seen == [("off", "jnp", "1"), (SPEC, "jnp", "1")]
    assert "[serve] dscim=kernel:dscim1:256 kv=int8" in capsys.readouterr().out
