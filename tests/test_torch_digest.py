"""The digest kernel's plain versions (``kernels/digest.py``: what the CPU
runs, and what the card holds the kernel against) against the JAX
reference, on the CPU:

* entry (a), many tensors in one launch: ``planes_digest`` against the
  reference's ``plane_digest`` and ``_csum_fold`` (negative int8, negative
  f32, bf16, odd lengths, sums across a chunk boundary), and
  ``weight_plane_digests`` / ``golden_weight_copy`` against the
  reference's on the same prepared planes;
* entry (b), the page pool: write mode (every page, listed pages, a
  refresh window) against ``page_checksums``, ``_update_page_sums`` and
  ``refresh_page_checksums``; compare mode
  against ``integrity._page_bad`` with its live mask applied;
* the one-read check: a drill leg's engine counters and detections equal
  the reference's, and each boundary's sweeps reach the host once.
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
from repro.core import kvcache as jkv  # noqa: E402
from repro.core import qweights as jqw  # noqa: E402
from repro.launch.serve import serve_continuous as jserve_continuous  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import failover as jfailover  # noqa: E402
from repro.runtime import integrity as jintegrity  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import digest, kvcache, qweights  # noqa: E402
from repro_torch.kernels import digest as kdigest  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import serve_continuous  # noqa: E402
from repro_torch.runtime import failover  # noqa: E402
from repro_torch.runtime.integrity import IntegrityEngine  # noqa: E402

SPEC = "kernel:dscim2:64"


def _u32(x):
    return np.asarray(x).astype(np.int64)


def _to_torch(a):
    a = np.array(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _planes(rng):
    """Seeded planes of every dtype the sweeps meet, odd lengths included:
    (numpy array, multiplier)."""
    return [
        (rng.integers(-128, 128, (3, 1001)).astype(np.int8), 1),
        (rng.integers(-128, 128, (17,)).astype(np.int8), 3),
        (-np.abs(rng.normal(1, .5, (5, 7, 33))).astype(np.float32), 5),
        (rng.normal(0, 1, (2, 999)).astype(np.float32), 7),
        (np.asarray(jnp.asarray(rng.normal(0, 3, (4, 251)), jnp.bfloat16)),
         1),
        (np.zeros((0,), np.int8), 1),
    ]


# -- entry (a) ----------------------------------------------------------------

@pytest.mark.parametrize("chunk", [digest.CHUNK, 1000, 7])
def test_planes_digest_matches_reference(monkeypatch, chunk):
    monkeypatch.setattr(digest, "CHUNK", chunk)
    planes = _planes(np.random.default_rng(5))
    got = kdigest.planes_digest([_to_torch(a) for a, _ in planes],
                                [m for _, m in planes])
    assert got.dtype == torch.int64 and got.shape == (len(planes),)
    want = [_u32(jkv._csum_fold(jnp.asarray(a), 0, m)) for a, m in planes]
    np.testing.assert_array_equal(got.numpy(), want)
    for a, m in planes:
        if m == 1:
            assert int(qweights.plane_digest(_to_torch(a))) \
                == int(_u32(jqw.plane_digest(jnp.asarray(a))))
    assert kdigest.planes_digest([]).shape == (0,)


def _qweights(rng, mod):
    """A prepared tree (two stacked weights and a head) of seeded planes
    for the reference (``mod`` jqw, jnp arrays) or the port."""
    def qw(stack, nw, g, n, k):
        q = rng.integers(-127, 128, (*stack, nw, g, n)).astype(np.int8)
        s = (rng.normal(0, 1, (*stack, nw, n)) * 1e-2).astype(np.float32)
        wrap = jnp.asarray if mod is jqw else _to_torch
        return mod.QuantizedLinearWeight(wrap(q), wrap(s), k, g)
    return {"layers": {"mlp": {"w_up": qw((2,), 3, 16, 33, 40),
                               "w_down": qw((2,), 2, 16, 7, 32)}},
            "lm_head": qw((), 1, 64, 129, 64),
            "norm": (_to_torch if mod is not jqw else jnp.asarray)(
                np.ones(8, np.float32))}


@pytest.mark.parametrize("chunk", [digest.CHUNK, 100])
def test_weight_sweep_and_golden_copy_match_reference(monkeypatch, chunk):
    monkeypatch.setattr(digest, "CHUNK", chunk)
    ours = _qweights(np.random.default_rng(9), qweights)
    ref = _qweights(np.random.default_rng(9), jqw)
    assert qweights.weight_plane_index(ours) == jqw.weight_plane_index(ref)
    want = _u32(jqw.weight_plane_digests(ref))
    np.testing.assert_array_equal(
        qweights.weight_plane_digests(ours).numpy(), want)
    golden = qweights.golden_weight_copy(ours)
    np.testing.assert_array_equal(golden["digests"], want)
    for p, which, x in qweights.iter_qweight_planes(ours):
        copy = golden["planes"][(p, which)]
        assert copy.dtype == x.dtype and torch.equal(copy, x)
        assert copy.data_ptr() != x.data_ptr()


# -- entry (b) ----------------------------------------------------------------

def _ref_pool(rng, L=2, P=6, ps=4, KV=2, HD=5):
    return (jnp.asarray(rng.integers(-128, 128, (L, P, ps, KV, HD)),
                        jnp.int8),
            jnp.asarray(rng.integers(-128, 128, (L, P, ps, KV, HD)),
                        jnp.int8),
            jnp.asarray(rng.normal(0, 1, (L, P, KV)), jnp.float32),
            jnp.asarray(-np.abs(rng.normal(1, .1, (L, P, KV))), jnp.float32))


@pytest.mark.parametrize("chunk", [digest.CHUNK, 7])
def test_page_write_mode_matches_reference(monkeypatch, chunk):
    monkeypatch.setattr(digest, "CHUNK", chunk)
    jpool = _ref_pool(np.random.default_rng(2))
    pool = [_to_torch(a) for a in jpool]
    want = _u32(jkv.page_checksums(*jpool))
    np.testing.assert_array_equal(kdigest.page_digests(*pool).numpy(), want)
    np.testing.assert_array_equal(kvcache.page_checksums(*pool).numpy(),
                                  want)
    # listed pages (one named twice) into a stale digest plane, as the
    # write paths refresh them
    L, P = want.shape
    stale = np.arange(L * P, dtype=np.int64).reshape(L, P)
    cache = {"k_pages": pool[0], "v_pages": pool[1], "k_scale": pool[2],
             "v_scale": pool[3], "page_sum": _to_torch(stale),
             "pos": torch.zeros(2, dtype=torch.int32)}
    jcache = {"k_pages": jpool[0], "v_pages": jpool[1], "k_scale": jpool[2],
              "v_scale": jpool[3],
              "page_sum": jnp.asarray(stale.astype(np.uint32))}
    phys = [4, 1, 4]
    kvcache._update_page_sums(cache, phys)
    jout = jkv._update_page_sums(jcache, np.asarray(phys))
    np.testing.assert_array_equal(cache["page_sum"].numpy(),
                                  _u32(jout["page_sum"]))
    assert (cache["page_sum"].numpy()[:, [0, 2, 3, 5]]
            == stale[:, [0, 2, 3, 5]]).all()


def test_page_refresh_matches_reference():
    """The refresh window (the kernel's third write mode): only the pages
    whose last token lies in each slot's range are written, a page named
    by two slots' candidates included."""
    L, B, P, ps, mp, KV, HD = 2, 3, 12, 4, 4, 2, 3
    ref = jkv.init_paged_cache(L, B, P, ps, mp, KV, HD, integrity=True)
    ours = kvcache.init_paged_cache(L, B, P, ps, mp, KV, HD, integrity=True)
    rng = np.random.default_rng(4)
    kp, vp, ks, vs = _ref_pool(rng, L, P, ps, KV, HD)
    table = rng.permutation(P)[:B * mp].reshape(B, mp)
    table[2, 3] = table[0, 1]
    table = jnp.asarray(table, jnp.int32)
    ref = dict(ref, k_pages=kp, v_pages=vp, k_scale=ks, v_scale=vs,
               page_table=table)
    ours.update({k: _to_torch(v) for k, v in ref.items()
                 if k != "page_sum"})
    for pos0, upper, span in (([0, 3, 7], [7, 3, 16], 9),
                              ([2, 11, 4], [6, 13, 5], 4)):
        pos0 = jnp.asarray(pos0, jnp.int32)
        upper = jnp.asarray(upper, jnp.int32)
        before = ours["page_sum"].clone()
        ref = jkv.refresh_page_checksums(ref, pos0, upper, span)
        kvcache.refresh_page_checksums(ours, _to_torch(pos0),
                                       _to_torch(upper), span)
        np.testing.assert_array_equal(ours["page_sum"].numpy(),
                                      _u32(ref["page_sum"]))
        assert not torch.equal(ours["page_sum"], before)


def test_page_compare_mode_matches_reference():
    jpool = _ref_pool(np.random.default_rng(6), L=3, P=7)
    pool = [_to_torch(a) for a in jpool]
    sums = _u32(jkv.page_checksums(*jpool))
    sums[0, 2] ^= 1                          # a stale digest
    sums[2, 6] = (sums[2, 6] + 12345) & 0xFFFFFFFF
    jpool = list(jpool)
    jpool[1] = jfailover.flip_bits(jpool[1], (1, 4, 3, 1, 2), 0x40)
    failover.flip_bits(pool[1], (1, 4, 3, 1, 2), 0x40)
    jpool[3] = jfailover.flip_bits(jpool[3], (2, 0, 1), 1 << 31)
    failover.flip_bits(pool[3], (2, 0, 1), 1 << 31)
    mask = np.asarray([1, 0, 1, 1, 1, 1, 1], bool)
    jcache = dict(zip(("k_pages", "v_pages", "k_scale", "v_scale"), jpool),
                  page_sum=jnp.asarray(sums.astype(np.uint32)))
    want = np.asarray(jintegrity._page_bad(jcache, jnp.asarray(mask)))
    flags = kdigest.page_flags(*pool, _to_torch(sums))
    assert flags.dtype == torch.bool
    got = flags.numpy() & mask[None, :]
    np.testing.assert_array_equal(got, want)
    assert np.argwhere(got).tolist() == [[0, 2], [1, 4], [2, 0], [2, 6]]


def test_meta_tensors_give_the_plain_shape():
    """Specs (``paged_cache_specs``, the dry run) digest ``meta`` tensors:
    the plain version's shape and dtype, no kernel and no data."""
    pool = [torch.empty((2, 5, 4, 2, 8), dtype=torch.int8, device="meta")
            for _ in range(2)]
    pool += [torch.empty((2, 5, 2), device="meta") for _ in range(2)]
    for got in (kdigest.page_digests(*pool),
                kdigest.planes_digest(pool, [1, 3, 5, 7])):
        assert got.device.type == "meta" and got.dtype == torch.int64
    assert kdigest.page_digests(*pool).shape == (2, 5)
    assert kdigest.page_flags(*pool, torch.empty(
        (2, 5), dtype=torch.int64, device="meta")).dtype == torch.bool


# -- the one-read check -------------------------------------------------------

@pytest.fixture(scope="module")
def drill_leg():
    """Leg 1 of the reduced integrity drill (a q-plane flip at segment 0,
    a scale flip at 1 and a page flip at 3; scrub:2, a snapshot every
    segment, no monitor) served by the reference and by the port on the
    same weights.  The port's sweeps and checks are wrapped to count their
    host reads (``Tensor.cpu`` / ``item`` / ``tolist``)."""
    jcfg = dataclasses.replace(jget_arch("qwen3-0.6b").reduced(), dscim=SPEC)
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), dscim=SPEC)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    widx = qweights.weight_plane_index(steps.prepare_serving_params(cfg, tp))
    wpath = next(p for p, w in widx if "w_up" in p and w == "q")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (6, 8),
                                                dtype=np.int32)
    budgets = np.asarray([8, 6, 8, 5, 8, 6], np.int32)
    knobs = dict(slots=3, seg_len=2, max_new=budgets, eos_id=-1, kv="int8",
                 page_size=4, snapshot_every=1, max_replays=2,
                 integrity="scrub:2")
    flips = dict(page_flips={1: ((0, "v_scale", (0, 0, 0), 0x7f000000),),
                             3: ((1, "k_pages", (1, 0, 0, 0, 0), 0x41),)},
                 weight_flips={0: ((wpath, "q", 2026, 0x10),)})
    _, jst = jserve_continuous(jcfg, jp, prompts, 8,
                               injector=jfailover.FailureInjector(**flips),
                               log=lambda *_: None, **knobs)
    reads = {"sweep": [], "check": []}
    box = {"on": False, "n": 0}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("cpu", "item", "tolist"):
            orig = getattr(torch.Tensor, name)

            def counted(self, *a, _orig=orig, **k):
                box["n"] += box["on"]
                return _orig(self, *a, **k)
            mp.setattr(torch.Tensor, name, counted)
        for name, kind in (("sweep", "sweep"), ("check_weights", "check"),
                           ("check_pages", "check")):
            orig = getattr(IntegrityEngine, name)

            def reading(self, *a, _orig=orig, _kind=kind, **k):
                box["on"], box["n"] = True, 0
                try:
                    return _orig(self, *a, **k)
                finally:
                    box["on"] = False
                    reads[_kind].append(box["n"])
            mp.setattr(IntegrityEngine, name, reading)
        _, st = serve_continuous(cfg, tp, prompts, 8, device="cpu",
                                 injector=failover.FailureInjector(**flips),
                                 log=lambda *_: None, **knobs)
    return st, jst, reads


def _detections(ig):
    return [(d["kind"], [tuple(c) for c in d["coords"]])
            for d in ig["detections"]]


@pytest.mark.parametrize("key", ["checks", "pages_verified",
                                 "weight_planes_verified", "page_mismatches",
                                 "weight_mismatches", "page_repairs",
                                 "weight_repairs", "replays", "period",
                                 "detections"])
def test_one_read_check_matches_reference(drill_leg, key):
    st, jst, _ = drill_leg
    gi, jgi = st["integrity"], jst["integrity"]
    if key == "detections":
        assert _detections(gi) == _detections(jgi)
        assert [k for k, _ in _detections(gi)] == ["weight", "page", "page"]
    else:
        assert gi[key] == jgi[key], key
    assert st["replays"] == jst["replays"] == 0
    assert st["corrupted_requests"] == jst["corrupted_requests"]


def test_check_reads_the_host_once(drill_leg):
    st, _, reads = drill_leg
    checks = st["integrity"]["checks"]
    assert checks >= 3
    assert reads["sweep"] == [1] * checks
    assert reads["check"] and not any(reads["check"])
