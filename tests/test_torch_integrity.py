"""The integrity layer in the port (``runtime/integrity.py``, the digests
of ``core/digest.py`` / ``core/kvcache.py`` / ``core/qweights.py``, the
injector's flips in ``runtime/failover.py``, the integrity path of
``runtime/serving.py``), on the CPU, against the JAX reference:

* ``parse_integrity``, ``flip_bits`` (int8, f32, bf16, sign bits
  included, and the mask-width guard), ``FailureInjector.sampled`` and
  the injector's cache and weight flips are the reference's, bit for bit;
* page digests and weight-plane digests, index and path strings equal the
  reference's bitwise (negative int8 and negative f32 scales included,
  with chunked sums), and a single-bit flip moves exactly its digest;
* the digest plane stays current on every write path of the port
  (admission, segments plain and speculative, extend chunks, cow_fork,
  insert_slot_pages) and equals the reference's after the same
  admissions;
* ``integrity='verify'`` with no fault is bitwise ``'off'`` with zero
  mismatches, as the reference's; golden-copy repair restores the live
  tensors in place; the drill's statuses, counters and coordinates
  equal the reference's, and every request is bitwise the fault-free run.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.runtime.serving as jserving  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import kvcache as jkv  # noqa: E402
from repro.core import qweights as jqw  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.serve import serve_continuous as jserve_continuous  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import failover as jfailover  # noqa: E402
from repro.runtime import integrity as jintegrity  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import digest, kvcache, qweights  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import prepare_params, serve_continuous  # noqa: E402
from repro_torch.runtime import failover, serving  # noqa: E402
from repro_torch.runtime.integrity import (IntegrityEngine,  # noqa: E402
                                           parse_integrity)

ARCH = "qwen3-0.6b"
SPEC = "kernel:dscim2:64"


def _quiet(*_):
    pass


def _u32(x):
    return np.asarray(x).astype(np.int64)


def _to_torch(a):
    """A JAX array as a torch tensor of the same bits (bf16 included)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32)).copy()) \
            .to(torch.bfloat16)
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), dscim=SPEC)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dscim=SPEC)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


# -- specs and flips ----------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "off", "verify", "scrub:4",
                                  "scrub:0", "scrub:-2", "scrub:x",
                                  "sometimes"])
def test_parse_integrity_matches_reference(spec):
    try:
        want = jintegrity.parse_integrity(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match="integrity spec") as ours:
            parse_integrity(spec)
        assert str(ours.value) == str(e)
        return
    assert parse_integrity(spec) == want


FLIPS = [("int8", (1, 2), 0x01), ("int8", (0, 3), 0x80),
         ("int8", (2, 0), 0x7f), ("float32", (1, 1), 0x7f000000),
         ("float32", (0, 0), 1 << 31), ("float32", (2, 3), 1 << 23),
         ("bfloat16", (1, 3), 1 << 15), ("bfloat16", (0, 2), 0x4000)]


def _bits(x):
    """The raw bits of a JAX array or a torch tensor, as unsigned numpy."""
    if isinstance(x, torch.Tensor):
        width = x.element_size()
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[width]
        return x.view(ints).numpy().view({1: np.uint8, 2: np.uint16,
                                          4: np.uint32}[width])
    uints = {1: jnp.uint8, 2: jnp.uint16, 4: jnp.uint32}[x.dtype.itemsize]
    return np.asarray(jax.lax.bitcast_convert_type(x, uints))


@pytest.mark.parametrize("dtype,index,mask", FLIPS)
def test_flip_bits_matches_reference(dtype, index, mask):
    rng = np.random.default_rng(sum(index) + mask % 97)
    if dtype == "int8":
        j = jnp.asarray(rng.integers(-128, 128, (3, 4)), jnp.int8)
    else:
        j = jnp.asarray(rng.normal(0, 1, (3, 4)), dtype)
    t = _to_torch(j)
    np.testing.assert_array_equal(_bits(t), _bits(j))
    assert failover.flip_bits(t, index, mask) is t          # in place
    want = _bits(jfailover.flip_bits(j, index, mask))
    np.testing.assert_array_equal(_bits(t), want)
    assert np.argwhere(want != _bits(j)).tolist() == [list(index)]


@pytest.mark.parametrize("dtype,mask", [("int8", 0x100), ("int8", 0),
                                        ("int8", -1), ("float32", 1 << 32),
                                        ("bfloat16", 1 << 16)])
def test_flip_bits_mask_width_guard(dtype, mask):
    t = torch.zeros(3, dtype=getattr(torch, dtype))
    with pytest.raises(ValueError, match="mask"):
        failover.flip_bits(t, (0,), mask)
    with pytest.raises(ValueError, match="mask"):
        jfailover.flip_bits(jnp.zeros(3, dtype), (0,), mask)


@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_sampled_schedule_matches_reference(seed):
    kw = dict(segments=12, slots=3, n_layers=2, page_size=4, n_kv=2,
              head_dim=16, device_losses=2, flips=5,
              macro_fault="stuck:3:40.0",
              weight_paths=("layers/mlp/w_up", "lm_head"),
              weight_flip_count=3)
    a = failover.FailureInjector.sampled(seed, **kw)
    b = jfailover.FailureInjector.sampled(seed, **kw)
    for name in ("fail_at", "page_flips", "weight_flips", "macro_fault_at",
                 "macro_fault"):
        assert getattr(a, name) == getattr(b, name), name


def test_serving_fault_from_macro_fault_at():
    inj = failover.FailureInjector(macro_fault_at=3,
                                   macro_fault="stuck:3:40.0")
    ref = jfailover.FailureInjector(macro_fault_at=3,
                                    macro_fault="stuck:3:40.0")
    got = [inj.serving_fault(s) for s in range(6)]
    assert got == [ref.serving_fault(s) for s in range(6)]
    assert got == ["", "", "", "stuck:3:40.0", "stuck:3:40.0",
                   "stuck:3:40.0"]


# -- page digests -------------------------------------------------------------

def _ref_pool(rng, L=2, P=5, ps=4, KV=2, HD=8):
    return (jnp.asarray(rng.integers(-128, 128, (L, P, ps, KV, HD)),
                        jnp.int8),
            jnp.asarray(rng.integers(-128, 128, (L, P, ps, KV, HD)),
                        jnp.int8),
            jnp.asarray(rng.normal(0, 1, (L, P, KV)), jnp.float32),
            jnp.asarray(-np.abs(rng.normal(1, .1, (L, P, KV))), jnp.float32))


@pytest.mark.parametrize("chunk", [digest.CHUNK, 7])
def test_page_checksums_match_reference(monkeypatch, chunk):
    monkeypatch.setattr(digest, "CHUNK", chunk)
    jpool = _ref_pool(np.random.default_rng(1))
    tpool = [_to_torch(a) for a in jpool]
    ref = _u32(jkv.page_checksums(*jpool))
    np.testing.assert_array_equal(kvcache.page_checksums(*tpool).numpy(),
                                  ref)
    for plane, index, mask in ((0, (1, 3, 0, 1, 7), 0x01),
                               (1, (0, 4, 2, 0, 0), 0x80),
                               (2, (1, 0, 1), 1 << 31),
                               (3, (0, 2, 0), 1 << 23)):
        t = [x.clone() for x in tpool]
        failover.flip_bits(t[plane], index, mask)
        j = list(jpool)
        j[plane] = jfailover.flip_bits(j[plane], index, mask)
        cur = kvcache.page_checksums(*t).numpy()
        np.testing.assert_array_equal(cur, _u32(jkv.page_checksums(*j)))
        assert np.argwhere(cur != ref).tolist() == [list(index[:2])]


def test_u32_widening_matches_numpy():
    x = torch.tensor([-1, -128, 5, 127], dtype=torch.int8)
    np.testing.assert_array_equal(
        digest.u32(x).numpy(), x.numpy().astype(np.uint32).astype(np.int64))
    f = torch.tensor([-0.0, -1.5, float("inf"), 2.0])
    np.testing.assert_array_equal(
        digest.u32(f).numpy(), f.numpy().view(np.uint32).astype(np.int64))
    b = torch.tensor([-1.0, 3.0], dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        digest.u32(b).numpy(),
        b.view(torch.int16).numpy().view(np.uint16).astype(np.int64))


def test_init_and_refresh_match_reference():
    L, B, P, ps, mp, KV, HD = 2, 3, 12, 4, 4, 2, 8
    ref = jkv.init_paged_cache(L, B, P, ps, mp, KV, HD, integrity=True)
    ours = kvcache.init_paged_cache(L, B, P, ps, mp, KV, HD, integrity=True)
    np.testing.assert_array_equal(ours["page_sum"].numpy(),
                                  _u32(ref["page_sum"]))
    assert "page_sum" not in kvcache.init_paged_cache(L, B, P, ps, mp, KV,
                                                      HD)
    rng = np.random.default_rng(3)
    kp, vp, ks, vs = _ref_pool(rng, L, P, ps, KV, HD)
    table = jnp.asarray(rng.permutation(P)[:B * mp].reshape(B, mp),
                        jnp.int32)
    ref = dict(ref, k_pages=kp, v_pages=vp, k_scale=ks, v_scale=vs,
               page_table=table)
    ours.update({k: _to_torch(v) for k, v in ref.items()
                 if k != "page_sum"})
    pos0 = jnp.asarray([1, 5, 9], jnp.int32)
    upper = jnp.asarray([9, 5, 14], jnp.int32)
    want = jkv.refresh_page_checksums(ref, pos0, upper, 8)["page_sum"]
    kvcache.refresh_page_checksums(ours, _to_torch(pos0), _to_torch(upper),
                                   8)
    np.testing.assert_array_equal(ours["page_sum"].numpy(), _u32(want))


# -- weight digests -----------------------------------------------------------

@pytest.mark.parametrize("spec", [SPEC, "kernel+attn:dscim1:256"])
def test_weight_digests_match_reference(setup, monkeypatch, spec):
    monkeypatch.setattr(digest, "CHUNK", 1000)
    jcfg, cfg, jp, tp = setup
    jprep = jsteps.prepare_serving_params(
        dataclasses.replace(jcfg, dscim=spec), jp)
    prep, golden = steps.prepare_serving_params(
        dataclasses.replace(cfg, dscim=spec), tp, golden=True)
    index = qweights.weight_plane_index(prep)
    assert index == jqw.weight_plane_index(jprep) == golden["index"]
    assert any(w == "scale" for _, w in index)
    np.testing.assert_array_equal(
        qweights.weight_plane_digests(prep).numpy(),
        _u32(jqw.weight_plane_digests(jprep)))
    np.testing.assert_array_equal(golden["digests"],
                                  _u32(jqw.weight_plane_digests(jprep)))


def test_weight_flips_detected_and_repaired_in_place(setup):
    jcfg, cfg, jp, tp = setup
    prep, golden = steps.prepare_serving_params(cfg, tp, golden=True)
    jprep, jgolden = jsteps.prepare_serving_params(jcfg, jp, golden=True)
    index = golden["index"]
    qpath = next(p for p, w in index if w == "q")
    spath = next(p for p, w in index if w == "scale")
    flips = {0: ((qpath, "q", 1234, 0x20), (spath, "scale", 7, 1 << 22))}
    eng = IntegrityEngine(golden, period=2)
    jeng = jintegrity.IntegrityEngine(jgolden, period=2)
    assert eng.due(0) and not eng.due(1) and eng.due(2)
    assert eng.check_weights(prep) == []
    addrs = [t.data_ptr() for _, _, t in qweights.iter_qweight_planes(prep)]
    _, hits = failover.FailureInjector(weight_flips=flips) \
        .corrupt_weights(0, prep)
    jbad, jhits = jfailover.FailureInjector(weight_flips=flips) \
        .corrupt_weights(0, jprep)
    assert hits == jhits
    np.testing.assert_array_equal(
        qweights.weight_plane_digests(prep).numpy(),
        _u32(jqw.weight_plane_digests(jbad)))
    found = eng.check_weights(prep)
    assert found == jeng.check_weights(jbad) and sorted(found) == \
        sorted(hits)
    eng.repair_weights(prep, found)
    assert eng.check_weights(prep) == []
    assert [t.data_ptr() for _, _, t in
            qweights.iter_qweight_planes(prep)] == addrs
    for p, w, t in qweights.iter_qweight_planes(prep):
        assert torch.equal(t, golden["planes"][(p, w)]), (p, w)
    assert eng.counters["weight_mismatches"] == 2
    assert eng.counters["weight_repairs"] == 2
    assert eng.counters["checks"] == 0
    assert eng.detections[0]["kind"] == "weight"


def test_corrupt_cache_matches_reference():
    L, B, P, ps, mp, KV, HD = 2, 2, 8, 4, 3, 2, 8
    rng = np.random.default_rng(4)
    kp, vp, ks, vs = _ref_pool(rng, L, P, ps, KV, HD)
    ref = dict(jkv.init_paged_cache(L, B, P, ps, mp, KV, HD),
               k_pages=kp, v_pages=vp, k_scale=ks, v_scale=vs,
               k_tail=jnp.asarray(rng.normal(0, 1, (L, B, ps, KV, HD)),
                                  jnp.bfloat16))
    ours = {k: _to_torch(v) for k, v in ref.items()}
    flips = {2: ((0, "k_pages", (1, 1, 2, 0, 3), 0x41),
                 (1, "v_scale", (0, 0, 1), 0x7f000000),
                 (1, "k_tail", (1, 3, 1, 5), 1 << 14),
                 (0, "k_scale", (0, 0, 0), 1 << 31))}
    slot_pages = [[5, 2, 7], [1, 0, 4]]
    inj = failover.FailureInjector(page_flips=flips)
    _, hit = inj.corrupt_cache(2, ours, slot_pages)
    ref2, jhit = jfailover.FailureInjector(page_flips=flips).corrupt_cache(
        2, ref, slot_pages)
    assert hit == jhit
    for k in ours:
        np.testing.assert_array_equal(_bits(ours[k]), _bits(ref2[k]),
                                      err_msg=k)
    assert [h[2][:2] for h in inj.hits] == [(1, 2), (0, 1), (1, 1), (0, 5)]
    assert inj.corrupt_cache(2, ours, slot_pages)[1] == []   # once each


# -- upkeep on the write paths ------------------------------------------------

def _live_consistent(cache, slot_pages, ps):
    """Every granted, fully flushed page digests as stored."""
    cur = kvcache.page_checksums(cache["k_pages"], cache["v_pages"],
                                 cache["k_scale"], cache["v_scale"])
    pos = cache["pos"].tolist()
    for b, ids in enumerate(slot_pages):
        for p in (ids or [])[:pos[b] // ps]:
            assert torch.equal(cur[:, p], cache["page_sum"][:, p]), (b, p)


def test_admission_sums_match_reference():
    """An admission's quantized pages and their digests, on the same dense
    prefill KV, equal the (jitted) reference's."""
    L, B, P, ps, mp, KV, HD, S = 2, 2, 10, 4, 4, 2, 8, 13
    rng = np.random.default_rng(8)
    ks, vs = (rng.normal(0, 1, (L, 1, S, KV, HD)).astype(np.float32)
              for _ in range(2))
    pages = [3, 5, 6, 9]
    ref = jax.jit(jkv.admit_request)(
        jkv.init_paged_cache(L, B, P, ps, mp, KV, HD, integrity=True),
        jnp.asarray(ks), jnp.asarray(vs), jnp.int32(1),
        jnp.asarray(pages, jnp.int32))
    ours = kvcache.init_paged_cache(L, B, P, ps, mp, KV, HD, integrity=True)
    kvcache.admit_request(ours, torch.from_numpy(ks), torch.from_numpy(vs),
                          1, pages)
    for name in ("k_pages", "v_pages", "k_scale", "v_scale", "k_tail"):
        np.testing.assert_array_equal(_bits(ours[name]), _bits(ref[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(ours["page_sum"].numpy(),
                                  _u32(ref["page_sum"]))


@pytest.mark.parametrize("spec,prefix", [(None, False), ("dscim2:2", False),
                                         (None, True)])
def test_digests_stay_current_while_serving(setup, spec, prefix):
    """Every check of ``integrity='verify'`` finds the digests current
    (zero mismatches) through admissions, plain or speculative segments
    and extend chunks, and the tokens are bitwise ``'off'``'s."""
    _, cfg, _, tp = setup
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (5, 8))
    prompts[1:4, :4] = prompts[0, :4]
    budgets = np.array([2, 7, 3, 5, 6], np.int32)
    kw = dict(slots=2, seg_len=2, max_new=budgets, eos_id=-1, kv="int8",
              page_size=4, spec=spec, prefix_cache=prefix, device="cpu",
              log=_quiet)
    out_off, _ = serve_continuous(cfg, tp, prompts, 7, **kw)
    out_v, st = serve_continuous(cfg, tp, prompts, 7, integrity="verify",
                                 **kw)
    for a, b in zip(out_v, out_off):
        np.testing.assert_array_equal(a, b)
    gi = st["integrity"]
    assert gi["page_mismatches"] == 0 and gi["weight_mismatches"] == 0
    assert gi["checks"] == st["segments"] and gi["pages_verified"] > 0


def test_cow_fork_and_insert_keep_sums():
    L, B, P, ps, mp, KV, HD = 2, 2, 8, 4, 3, 2, 8
    rng = np.random.default_rng(6)
    cache = kvcache.init_paged_cache(L, B, P, ps, mp, KV, HD,
                                     integrity=True)
    for name, t in zip(("k_pages", "v_pages", "k_scale", "v_scale"),
                       _ref_pool(rng, L, P, ps, KV, HD)):
        cache[name].copy_(_to_torch(t))
    cache["page_sum"].copy_(kvcache.page_checksums(
        cache["k_pages"], cache["v_pages"], cache["k_scale"],
        cache["v_scale"]))
    alloc = kvcache.PageAllocator(P)
    ids = alloc.alloc(3)
    alloc.share(ids[:1])
    _, new_ids, forked = kvcache.cow_fork(cache, alloc, ids)
    assert forked == 1
    cache["pos"][0] = 8
    _live_consistent(cache, [new_ids, None], ps)
    blob = kvcache.extract_slot_pages(cache, 0, new_ids)
    other = alloc.alloc(3)
    kvcache.insert_slot_pages(cache, 1, other, blob)
    _live_consistent(cache, [new_ids, other], ps)


# -- the scheduler ------------------------------------------------------------

def test_integrity_verify_fault_free_bitwise(setup):
    jcfg, cfg, jp, tp = setup
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (4, 8))
    budgets = np.array([2, 4, 3, 5], np.int32)
    kw = dict(slots=2, seg_len=2, max_new=budgets, eos_id=-1, kv="int8",
              page_size=4, log=_quiet)
    out_off, st_off = serve_continuous(cfg, tp, prompts, 5, device="cpu",
                                       **kw)
    out_v, st_v = serve_continuous(cfg, tp, prompts, 5, device="cpu",
                                   integrity="verify", **kw)
    jout, jst = jserve_continuous(jcfg, jp, prompts.astype(np.int32), 5,
                                  integrity="verify", **kw)
    for r in range(4):
        np.testing.assert_array_equal(out_v[r], out_off[r], err_msg=str(r))
        np.testing.assert_array_equal(out_v[r], np.asarray(jout[r]))
    gi, jgi = st_v["integrity"], jst["integrity"]
    for key in ("checks", "pages_verified", "weight_planes_verified",
                "page_mismatches", "weight_mismatches", "replays",
                "period"):
        assert gi[key] == jgi[key], key
    assert gi["checks"] > 0 and gi["pages_verified"] > 0
    assert gi["page_mismatches"] == 0 and st_off["integrity"] is None
    assert st_v["bindings"]["segment"] == 1


@pytest.fixture(scope="module")
def ref_drill():
    return jserving.integrity_drill(log=_quiet)


def test_integrity_drill_matches_reference(setup, ref_drill):
    _, _, _, tp = setup
    report = serving.integrity_drill(params=tp, device="cpu", log=_quiet)
    for key in ("seed", "requests", "weight_plane", "scrub_period",
                "statuses"):
        assert report[key] == ref_drill[key], key
    for leg in ("leg1", "leg2"):
        for key, want in ref_drill[leg].items():
            if key != "scrub_time_s":
                assert report[leg][key] == want, (leg, key)
    assert report["leg1"]["weight_coords"] == [[("layers/mlp/w_up", "q")]]
    assert [c[0][0] for c in report["leg1"]["page_coords"]] == [0, 1]
    assert report["leg1"]["bindings"]["segment"] == 1


def test_integrity_drill_on_port_weights():
    report = serving.integrity_drill(device="cpu", log=_quiet)
    assert report["leg1"]["page_repairs"] == 2
    assert report["leg2"]["replays"] == 1
