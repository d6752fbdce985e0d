"""Self-speculative decoding in the port (``launch/steps.py`` ``_parse_spec``,
``_draft_cfg``, ``_make_window``; ``models/lm.py decode_multi``;
``core/kvcache.py spec_rollback``), on the CPU at the reduced qwen3-0.6b.

The contracts mirror the reference's ``tests/test_spec.py``, within the
port:

* greedy spec serving is bitwise plain greedy serving, for every
  deterministic mode and both KV layouts (page size 4 makes windows cross
  page boundaries, exercising the tail restore and the rollback); the port
  holds the noise modes to it too, since its verify forward runs their
  calls at the decode's shape and their noise is keyed by call site and
  element, not by the batch;
* k = 0 is the plain path in all 8 modes and 4 samplers; EOS and budgets
  stop where the plain loop stops; sampled spec equals plain sampling row
  by row (a draw is keyed by the row's emitted count, so rejected drafts
  consume nothing) and replays deterministically;
* ``decode_multi`` is bitwise T successive port decodes and matches the
  reference's ``decode_multi`` to 1e-4 max-abs logits with the float
  cache (the slice parity bar of ``test_torch_model.py``) and 1e-3 with
  the int8 cache (an f32 ulp between the frameworks can flip a bf16 tail
  or int8 page rounding, which moves a row's logits by up to 2e-4 here);
  ``spec_rollback`` is bitwise the reference's gather;
* continuous spec serving is bitwise one-shot continuous serving with no
  page leaked, and a dscim2 verifier drafting through itself accepts
  every draft;
* across frameworks, ``spec_stats`` (windows, emitted) equal the
  reference's for ``lut:dscim1:256`` and ``exact:dscim1:256``.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.kvcache import (paged_from_dense as jpaged_from_dense,  # noqa: E402
                                spec_rollback as jspec_rollback)
from repro.launch.serve import serve_batch as jserve_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.kvcache import paged_from_dense, spec_rollback  # noqa: E402
from repro_torch.launch.serve import serve_batch, serve_continuous  # noqa: E402
from repro_torch.launch.steps import (_draft_cfg, _parse_spec,  # noqa: E402
                                      init_serve_state, make_admit_fn,
                                      make_segment_fn)
from repro_torch.models import lm  # noqa: E402

ARCH = "qwen3-0.6b"
MODES = ["off", "exact:dscim2:64", "lut:dscim2:64", "bitmatmul:dscim2:64",
         "kernel:dscim2:64", "kernel+attn:dscim2:64",
         "statistical:dscim2:64", "paper_inject:dscim2:64"]
DET_MODES = ["off", "exact:dscim1:256", "lut:dscim1:256",
             "bitmatmul:dscim1:256", "kernel+attn:dscim1:256"]
NOISE_MODES = ["statistical:dscim1:256", "paper_inject:dscim1:256"]


@pytest.fixture(scope="module")
def reduced():
    cfg = get_arch(ARCH).reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))
    return cfg, params, prompts


def _with(cfg, dscim):
    return dataclasses.replace(cfg, dscim=dscim)


def _serve(cfg, params, prompts, n, **kw):
    return serve_batch(cfg, params, prompts, n, device="cpu", **kw)


def test_parse_spec():
    assert _parse_spec(None) is None
    assert _parse_spec("") is None
    assert _parse_spec("dscim2:0") is None          # k=0: plain loop
    assert _parse_spec("dscim2:4") == ("dscim2", 4)
    assert _parse_spec("dscim1:2") == ("dscim1", 2)
    for bad in ["dscim2", "dscim3:4", "dscim2:-1", "dscim2:x", "4"]:
        with pytest.raises(ValueError):
            _parse_spec(bad)


def test_draft_cfg_rewrites_operating_point_only():
    cfg = _with(get_arch(ARCH).reduced(), "kernel+attn:dscim1:256:opt")
    assert _draft_cfg(cfg, "dscim2").dscim == "kernel+attn:dscim2:64:opt"
    assert cfg.dscim == "kernel+attn:dscim1:256:opt"
    for spec in ["off", "float:dscim1:256"]:
        c = _with(cfg, spec)
        assert _draft_cfg(c, "dscim2").dscim == spec


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_spec_greedy_bitwise_kv_layouts(reduced, kv):
    """dscim2 drafts against a dscim1 verifier reject often enough to
    leave windows page-misaligned at page size 4."""
    cfg, params, prompts = reduced
    cfg = _with(cfg, "kernel:dscim1:256")
    ref, _ = _serve(cfg, params, prompts, 8, kv=kv, page_size=4)
    got, _, ss = _serve(cfg, params, prompts, 8, kv=kv, page_size=4,
                        spec="dscim2:3", spec_stats=True)
    np.testing.assert_array_equal(got, ref)
    assert (ss["emitted"] >= ss["windows"]).all()
    assert (ss["emitted"] == 8).all()


@pytest.mark.parametrize("dscim", DET_MODES + NOISE_MODES)
def test_spec_greedy_bitwise_modes(reduced, dscim):
    cfg, params, prompts = reduced
    cfg = _with(cfg, dscim)
    for kv in ("float", "int8"):
        ref, _ = _serve(cfg, params, prompts, 6, kv=kv, page_size=4)
        got, _ = _serve(cfg, params, prompts, 6, kv=kv, page_size=4,
                        spec="dscim2:2")
        np.testing.assert_array_equal(got, ref, err_msg=kv)


def test_spec_composes_with_eos_and_budget(reduced):
    cfg, params, prompts = reduced
    cfg = _with(cfg, "kernel:dscim1:256")
    kw = dict(kv="int8", page_size=4)
    eos = int(_serve(cfg, params, prompts, 4, **kw)[0][0, 1])
    kw.update(eos_id=eos, max_new=[6, 4])
    ref, _ = _serve(cfg, params, prompts, 8, **kw)
    got, _ = _serve(cfg, params, prompts, 8, spec="dscim2:3", **kw)
    np.testing.assert_array_equal(got, ref)
    assert (ref[0, 2:] == 0).all()           # EOS really stopped a row


@pytest.mark.parametrize("dscim", MODES)
def test_spec_k0_matches_plain_loop(reduced, dscim):
    cfg, params, prompts = reduced
    cfg = _with(cfg, dscim)
    for sample in ["greedy", "temp:0.8", "topk:8:0.9", "topp:0.9"]:
        kw = dict(eos_id=7, sample=sample, rng_seed=3)
        ref, _ = _serve(cfg, params, prompts, 4, **kw)
        got, _ = _serve(cfg, params, prompts, 4, spec="dscim2:0", **kw)
        np.testing.assert_array_equal(got, ref, err_msg=f"{dscim} {sample}")


def test_spec_rejected_drafts_leave_rng_stream_aligned(reduced):
    """Sampled serving: a row's draw is keyed by the tokens it has emitted,
    so rejected draft positions consume nothing and spec draws what the
    plain loop draws, row by row (one row and two)."""
    cfg, params, prompts = reduced
    cfg = _with(cfg, "kernel:dscim1:256")
    for rows in (1, 2):
        for kv in ("float", "int8"):
            kw = dict(kv=kv, page_size=4, sample="temp:0.8", rng_seed=5)
            ref, _ = _serve(cfg, params, prompts[:rows], 8, **kw)
            got, _, ss = _serve(cfg, params, prompts[:rows], 8,
                                spec="dscim2:3", spec_stats=True, **kw)
            np.testing.assert_array_equal(got, ref, err_msg=f"{rows} {kv}")
            # greedy drafts against sampling must have been rejected, or
            # this pinned nothing
            assert int(ss["windows"][0]) > (8 - 1 + 3) // 4, ss


def test_spec_sampled_replay_deterministic(reduced):
    cfg, params, prompts = reduced
    cfg = _with(cfg, "kernel:dscim1:256")
    kw = dict(kv="int8", page_size=4, sample="temp:0.8", spec="dscim2:3")
    a, _ = _serve(cfg, params, prompts, 8, rng_seed=3, **kw)
    b, _ = _serve(cfg, params, prompts, 8, rng_seed=3, **kw)
    c, _ = _serve(cfg, params, prompts, 8, rng_seed=4, **kw)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_spec_rejects_trace_logits_and_other_families(reduced):
    cfg, params, prompts = reduced
    cfg = _with(cfg, "kernel:dscim1:256")
    with pytest.raises(ValueError):
        _serve(cfg, params, prompts, 4, trace_logits=True, spec="dscim2:3")
    with pytest.raises(ValueError):
        _serve(dataclasses.replace(cfg, family="ssm"), params, prompts, 4,
               spec="dscim2:3")


def test_spec_self_draft_accepts_every_draft(reduced):
    """A dscim2 verifier drafting through dscim2 at the same weights: the
    verify forward at B*(k+1) rows gives the draft decodes' bits, so every
    greedy draft is accepted (emitted = windows * (k+1) + 1 up to the
    budget)."""
    cfg, params, prompts = reduced
    cfg = _with(cfg, "kernel:dscim2:64")
    n, k = 16, 4
    ref, _ = _serve(cfg, params, prompts, n, kv="int8", page_size=4)
    got, _, ss = _serve(cfg, params, prompts, n, kv="int8", page_size=4,
                        spec=f"dscim2:{k}", spec_stats=True)
    np.testing.assert_array_equal(got, ref)
    assert (ss["windows"] == -(-(n - 1) // (k + 1))).all(), ss
    assert (ss["emitted"] == n).all()


# -- decode_multi and the rollback ------------------------------------------

@pytest.fixture(scope="module")
def ref_setup():
    jcfg = jget_arch(ARCH).reduced()
    cfg = get_arch(ARCH).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _caches(ref_setup, dscim, kv, prompts, cap):
    """(reference cache, port cache, reference params/cfg, port
    params/cfg) after prefilling ``prompts``."""
    jcfg, cfg, jp, tp = ref_setup
    jcfg, cfg = _with(jcfg, dscim), _with(cfg, dscim)
    _, jd = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(prompts)})
    _, td = lm.prefill(tp, cfg, torch.as_tensor(prompts))
    B, S = prompts.shape
    if kv == "float":
        pad = [(0, 0), (0, 0), (0, cap - S), (0, 0), (0, 0)]
        jc = {"k": jnp.pad(jd["k"], pad), "v": jnp.pad(jd["v"], pad),
              "pos": jnp.full((B,), S, jnp.int32)}
        tpad = (0, 0, 0, 0, 0, cap - S)
        tc = {"k": torch.nn.functional.pad(td["k"], tpad),
              "v": torch.nn.functional.pad(td["v"], tpad),
              "pos": torch.full((B,), S, dtype=torch.int32)}
    else:
        mp = -(-cap // 4)
        jc = jpaged_from_dense(jd["k"], jd["v"], 4, n_pages=B * mp,
                               max_pages=mp)
        jc["pos"] = jnp.full((B,), S, jnp.int32)
        tc = paged_from_dense(td["k"], td["v"], 4, n_pages=B * mp,
                              max_pages=mp)
    return jc, tc, jcfg, cfg


@pytest.mark.parametrize("dscim,kv", [("off", "float"),
                                      ("kernel:dscim1:256", "int8"),
                                      ("exact+attn:dscim1:256", "float")])
def test_decode_multi_vs_reference_and_stepwise(ref_setup, dscim, kv):
    jcfg, cfg, jp, tp = ref_setup
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (2, 6))
    window = np.random.default_rng(5).integers(0, cfg.vocab, (2, 5))
    jc, tc, jcfg, cfg = _caches(ref_setup, dscim, kv, prompts, 16)
    want, _, _ = jlm.decode_multi(jp, jcfg,
                                  {"tokens": jnp.asarray(window,
                                                         jnp.int32)}, jc)
    step_cache = {k: v.clone() for k, v in tc.items()}
    got, tc, win_kv = lm.decode_multi(tp, cfg, torch.as_tensor(window), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4 if kv == "float" else 1e-3, rtol=0)
    assert (win_kv is None) == (kv == "float")
    for t in range(window.shape[1]):
        lg, _ = lm.decode(tp, cfg, torch.as_tensor(window[:, t],
                                                   dtype=torch.int32),
                          step_cache)
        assert torch.equal(lg, got[:, t]), t
    for name, v in tc.items():
        assert torch.equal(v, step_cache[name]), name


def test_spec_rollback_bitwise_vs_reference():
    rng = np.random.default_rng(0)
    L, B, ps, KV, HD, T = 2, 3, 4, 2, 5, 3
    pos0 = np.asarray([6, 5, 4], np.int32)
    new_pos = np.asarray([9, 5, 6], np.int32)     # cross / reject-all / mid
    planes = {n: rng.normal(size=(L, B, ps, KV, HD)).astype(np.float32)
              for n in ("k_tail", "v_tail", "k0", "v0")}
    win = tuple(rng.normal(size=(L, B, T, KV, HD)).astype(np.float32)
                for _ in range(2))
    jc = {"k_pages": jnp.zeros((L, 8, ps, KV, HD), jnp.int8),
          "k_tail": jnp.asarray(planes["k_tail"]),
          "v_tail": jnp.asarray(planes["v_tail"]), "pos": jnp.asarray(pos0)}
    want = jspec_rollback(jc, jnp.asarray(pos0), jnp.asarray(new_pos),
                          (jnp.asarray(planes["k0"]),
                           jnp.asarray(planes["v0"])),
                          tuple(jnp.asarray(w) for w in win))
    tcache = {"k_pages": torch.zeros((L, 8, ps, KV, HD), dtype=torch.int8),
              "k_tail": torch.from_numpy(planes["k_tail"].copy()),
              "v_tail": torch.from_numpy(planes["v_tail"].copy()),
              "pos": torch.from_numpy(pos0.copy())}
    got = spec_rollback(tcache, torch.from_numpy(pos0),
                        torch.from_numpy(new_pos),
                        (torch.from_numpy(planes["k0"]),
                         torch.from_numpy(planes["v0"])),
                        tuple(torch.from_numpy(w) for w in win))
    assert got is tcache
    for name in ("k_tail", "v_tail", "pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    dense = {"pos": torch.from_numpy(pos0.copy())}
    assert spec_rollback(dense, torch.from_numpy(pos0),
                         torch.from_numpy(new_pos))["pos"].tolist() \
        == new_pos.tolist()


# -- continuous serving ------------------------------------------------------

def test_spec_continuous_bitwise_and_no_page_leak(reduced):
    cfg, params, _ = reduced
    cfg = _with(cfg, "kernel:dscim1:256")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (5, 8))
    kw = dict(slots=2, seg_len=2, kv="int8", page_size=4, eos_id=14,
              device="cpu")
    ref, _ = serve_continuous(cfg, params, prompts, 8, **kw)
    got, st = serve_continuous(cfg, params, prompts, 8, spec="dscim2:3",
                               **kw)
    for r, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {r}")
    assert st["pages"]["live_pages"] == 0
    assert 1 <= st["pages"]["high_water"] <= st["pages"]["n_pages"]


def test_spec_segment_rows_are_windows(reduced):
    """A spec segment returns seg_len * (k+1) chronological rows per slot,
    live exactly where a token was emitted; a self-drafting verifier fills
    every row of a live slot."""
    cfg, params, prompts = reduced
    cfg = _with(cfg, "kernel:dscim2:64")
    state = init_serve_state(cfg, 2, 8 + 16 + 3, kv="int8", page_size=4,
                             device="cpu")
    admit = make_admit_fn(cfg, eos_id=-1)
    for b in range(2):
        admit(params, state, torch.as_tensor(prompts[b:b + 1]), b,
              list(range(7 * b, 7 * b + 7)), 16)
    seg = make_segment_fn(cfg, 2, eos_id=-1, spec="dscim2:3")
    _, toks, live, aux = seg(params, state)
    assert toks.shape == live.shape == aux["bad"].shape == (8, 2)
    assert bool(live.all()) and not bool(aux["bad"].any())
    assert state["n_out"].tolist() == [9, 9]


@pytest.mark.parametrize("dscim", ["lut:dscim1:256", "exact:dscim1:256"])
def test_spec_stats_match_reference(ref_setup, dscim):
    jcfg, cfg, jp, tp = ref_setup
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))
    jt, _, js = jserve_batch(_with(jcfg, dscim), jp,
                             prompts.astype(np.int32), 6, spec="dscim2:2",
                             spec_stats=True)
    tt, _, ts = serve_batch(_with(cfg, dscim), tp, prompts, 6,
                            spec="dscim2:2", spec_stats=True, device="cpu")
    np.testing.assert_array_equal(tt, np.asarray(jt))
    for key in ("windows", "emitted"):
        np.testing.assert_array_equal(ts[key], np.asarray(js[key]))
