"""Continuous batching in the port (``repro_torch.launch.serve
serve_continuous``, ``runtime/serving.py``, ``core/kvcache.py``
``PageAllocator`` and the admission helpers), on the CPU.

* The allocator and admission guards behave as the reference's
  (``tests/test_kvcache.py``), and one script of alloc / share / retain /
  free / reclaim / snapshot leaves the port's allocator and the
  reference's in the same state.
* A done slot never overwrites a pool page (fault C1): neither a page it
  no longer owns, nor the page a live slot flushes into in the same step
  when the done slot's stale table row names it too.
* Within the port, every request served through recycled slots equals
  a one-shot early-exit ``serve_batch`` of its prompt tiled to the slot
  count, bitwise, for the float and the int8 cache, with the
  occupancy identities of the reference; EOS completion and a small pool
  (backpressure) work.
* Across frameworks, the port's scheduler emits the reference's tokens
  and slot-step accounting on the reduced qwen3-0.6b with the
  reference's parameters (``dscim=off`` with both caches,
  ``kernel:dscim1:256`` with the int8 cache).
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import kvcache as jkvcache  # noqa: E402
from repro.launch.serve import serve_continuous as jserve_continuous  # noqa: E402
from repro.models.lm import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.kvcache import (PageAllocator, admission_pages,  # noqa: E402
                                      n_pages_for, quantize_page)
from repro_torch.launch.serve import serve_batch, serve_continuous  # noqa: E402
from repro_torch.layers.attention import decode_attention_paged  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARCH = "qwen3-0.6b"
BUDGETS = np.array([2, 5, 3, 4, 6, 1], np.int32)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_arch(ARCH).reduced()
    cfg = get_arch(ARCH).reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


# -- allocator -------------------------------------------------------------

def test_page_allocator_recycles():
    a = PageAllocator(8)
    p1 = a.alloc(3)
    p2 = a.alloc(4)
    assert len(set(p1) | set(p2)) == 7 and a.free_pages == 1
    assert a.alloc(2) is None and a.free_pages == 1   # refusal, no leak
    a.free(p1)
    p3 = a.alloc(4)   # the freed pages + the one never handed out
    assert set(p3) == set(range(8)) - set(p2)
    assert a.free_pages == 0


def test_page_allocator_exhaustion_backpressure_reuse():
    a = PageAllocator(6)
    g1, g2 = a.alloc(2), a.alloc(4)
    assert a.free_pages == 0
    for _ in range(3):                       # polling while full is safe
        assert a.alloc(1) is None
    assert a.free_pages == 0
    a.free(g2)
    g3 = a.alloc(4)                          # admit-after-recycle
    assert set(g3) == set(g2)                # reuses exactly the freed ids
    a.free(g1)
    a.free(g3)
    assert a.free_pages == 6
    assert set(a.alloc(6)) == set(range(6))  # nothing leaked or duplicated
    assert a.alloc(1) is None


def test_allocator_and_admission_guards():
    a = PageAllocator(4)
    for n in (0, -2):
        with pytest.raises(ValueError, match="positive"):
            a.alloc(n)
    assert a.free_pages == 4                  # guard left the pool intact
    ids = a.alloc(4)
    with pytest.raises(ValueError, match="out of range"):
        a.free([4])
    a.free(ids[:1])
    with pytest.raises(ValueError, match="double free"):
        a.free(ids[:1])
    with pytest.raises(ValueError, match="double free"):
        a.free([ids[1], ids[1]])
    assert a.stats()["live_pages"] == 3       # failed frees changed nothing
    for ps in (0, -4):
        with pytest.raises(ValueError, match="page_size"):
            admission_pages(8, 4, ps)
    for budget in (0, -1):
        with pytest.raises(ValueError, match="budget"):
            admission_pages(8, budget, 4)
    with pytest.raises(ValueError, match="prompt_len/headroom"):
        admission_pages(-1, 4, 4)
    with pytest.raises(ValueError, match="prompt_len/headroom"):
        admission_pages(8, 4, 4, headroom=-1)
    assert admission_pages(7, 4, 4, headroom=2) == n_pages_for(13, 4)


def _allocator_script(cls):
    """One lifecycle through every method; returns what it observed."""
    a = cls(6)
    dropped = []
    a.on_reclaim(dropped.append)
    seen = []
    g1 = a.alloc(3)
    a.share(g1[:2])
    seen.append((a.refcount(g1[0]), a.stats()))
    a.set_retainable(g1[0])
    a.set_retainable(g1[1])
    a.free(g1)                              # g1[0..1] still shared
    a.free(g1[:2])                          # now retained at ref 0
    seen.append((a.free_pages, a.available_pages, a.stats()))
    with pytest.raises(ValueError):
        a.share([g1[2]])                    # free: its bytes are gone
    a.share([g1[1]])                        # revive a retained page
    g2 = a.alloc(5)                         # reclaims g1[0]
    seen.append((sorted(g2), list(dropped), a.stats()))
    a.set_retainable(g1[1], False)
    snap = a.snapshot()
    b = cls.from_snapshot(snap)
    b.free(g2)
    seen.append((snap, b.stats(), b.snapshot()))
    return seen


def test_allocator_lifecycle_matches_reference():
    assert _allocator_script(PageAllocator) == \
        _allocator_script(jkvcache.PageAllocator)


# -- C1: a done slot never overwrites a pool page ------------------------

def _flush_view(cfg, table, pos, seed=0):
    B, ps = len(table), 4
    KV, HD = cfg.n_kv, cfg.head_dim
    P = 2 * B
    rng = np.random.default_rng(seed)
    return {
        "k_pages": torch.from_numpy(rng.integers(-127, 128, (P, ps, KV, HD),
                                                 dtype=np.int8)),
        "v_pages": torch.from_numpy(rng.integers(-127, 128, (P, ps, KV, HD),
                                                 dtype=np.int8)),
        "k_scale": torch.ones((P, KV)), "v_scale": torch.ones((P, KV)),
        "k_tail": torch.from_numpy(rng.normal(0, 1, (B, ps, KV, HD)).astype(
            np.float32)).to(torch.bfloat16),
        "v_tail": torch.from_numpy(rng.normal(0, 1, (B, ps, KV, HD)).astype(
            np.float32)).to(torch.bfloat16),
        "page_table": torch.tensor(table, dtype=torch.int32),
        "pos": torch.tensor(pos, dtype=torch.int32),
    }


def flush_case(cfg, table, pos, done, device="cpu"):
    """One paged decode step of layer 0's attention on a random pool;
    returns (pool before, view after)."""
    params = lm.init_params(cfg, 0, device="cpu")
    attn = lm._layer(params["layers"], 0)["attn"]
    attn = {k: (v.to(device) if isinstance(v, torch.Tensor) else
                {kk: vv.to(device) for kk, vv in v.items()})
            for k, v in attn.items()}
    view = {k: v.to(device) for k, v in _flush_view(cfg, table, pos).items()}
    before = {k: v.clone() for k, v in view.items()}
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (len(table), 1, cfg.d_model)).astype(np.float32)).to(device)
    decode_attention_paged(attn, x, view, cfg,
                           done=torch.tensor(done, device=device))
    return before, view


def test_done_slot_flush_never_writes_recycled_page():
    """The port of the reference's test: done slot 0 sits at a would-flush
    position and still names page 1, which slot 1 now owns; it must not
    touch it (nor any page: slot 1 is mid-page)."""
    cfg = get_arch(ARCH).reduced()
    ps = 4
    table, pos = [[0, 1], [2, 1]], [2 * ps - 1, ps + 1]
    before, after = flush_case(cfg, table, pos, [True, False])
    torch.testing.assert_close(after["k_pages"], before["k_pages"],
                               rtol=0, atol=0)
    torch.testing.assert_close(after["v_scale"], before["v_scale"],
                               rtol=0, atol=0)
    # control: with slot 0 live, the same state does flush page 1
    _, live = flush_case(cfg, table, pos, [False, False])
    assert (live["k_pages"][1] != before["k_pages"][1]).any()


def check_live_flush_lands(cfg, done_pos, device="cpu"):
    """Live slot 0 flushes into page 1 while done slot 1, whose stale row
    comes after it, names page 1 too: page 1 must hold slot 0's flush,
    exactly as where no stale row aliases it."""
    ps = 4
    pos = [2 * ps - 1, done_pos]
    _, alias = flush_case(cfg, [[0, 1], [2, 1]], pos, [False, True], device)
    _, alone = flush_case(cfg, [[0, 1], [2, 3]], pos, [False, True], device)
    want_q, want_s = quantize_page(alone["k_tail"][0])
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        torch.testing.assert_close(alias[name][1], alone[name][1], rtol=0,
                                   atol=0, msg=name)
    torch.testing.assert_close(alias["k_pages"][1], want_q, rtol=0, atol=0)
    torch.testing.assert_close(alias["k_scale"][1], want_s, rtol=0, atol=0)


@pytest.mark.parametrize("done_pos", [5, 7])
def test_live_flush_wins_over_stale_done_row(done_pos):
    check_live_flush_lands(get_arch(ARCH).reduced(), done_pos)


# -- continuous vs one-shot within the port ------------------------------

@pytest.mark.parametrize("kv", ["float", "int8"])
def test_continuous_matches_oneshot_per_request(setup, kv):
    """6 requests through 3 recycled slots (admissions between 2-step
    segments) reproduce, per request, the one-shot early-exit loop at
    the same slot count, bit for bit."""
    _, cfg, _, params = setup
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (6, 8))
    outs, stats = serve_continuous(cfg, params, prompts, 6, slots=3,
                                   seg_len=2, max_new=BUDGETS, eos_id=-1,
                                   kv=kv, page_size=4, device="cpu")
    assert [len(o) for o in outs] == BUDGETS.tolist()
    for r in range(6):
        ref, _ = serve_batch(cfg, params, np.tile(prompts[r:r + 1], (3, 1)),
                             6, eos_id=-1, max_new=[int(BUDGETS[r])] * 3,
                             kv=kv, page_size=4, device="cpu")
        np.testing.assert_array_equal(outs[r], ref[0, :BUDGETS[r]],
                                      err_msg=str(r))
    # 21 useful tokens, 6 of them prefill-sampled: 15 live decode
    # slot-steps over however many segments ran
    assert stats["useful_tokens"] == int(BUDGETS.sum())
    assert stats["live_slot_steps"] == int(BUDGETS.sum()) - 6
    assert 0 < stats["occupancy"] < 1
    assert stats["slot_steps"] == stats["segments"] * 2 * 3
    assert stats["status"] == ["ok"] * 6
    assert stats["capture_s"] == 0.0                  # no graph on the CPU
    if kv == "int8":
        assert stats["pages"]["live_pages"] == 0      # all pages returned
        assert stats["pages"]["high_water"] <= stats["pages"]["n_pages"]


def test_prepared_params_pass_through_and_runners_release(setup):
    """``prepare_params`` hands prepared params back as the same tensors
    (so a captured graph stays bound to them across requests); a one-shot
    runner holds no reference to the params after a request, and
    ``clear_graphs`` drops the runners."""
    import weakref

    from repro_torch.launch.serve import clear_graphs, prepare_params
    from repro_torch.launch.steps import _generate_runner, _leaves

    _, cfg, _, params = setup
    cfg = dataclasses.replace(cfg, dscim="kernel:dscim1:256")
    prep = prepare_params(cfg, params, "cpu")
    again = prepare_params(cfg, prep, "cpu")
    assert len(_leaves(prep)) == len(_leaves(again))
    assert all(a is b for a, b in zip(_leaves(prep), _leaves(again)))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, 8))
    serve_batch(cfg, prep, prompts, 3, kv="int8", page_size=4, device="cpu")
    assert _generate_runner.cache_info().currsize > 0
    ref = weakref.ref(prep["lm_head"].q)
    del prep, again
    assert ref() is None
    clear_graphs()
    assert _generate_runner.cache_info().currsize == 0


RUN_KINDS = {"plain": {}, "monitored": {"snapshot_every": 2},
             "scrub": {"integrity": "scrub:2"}, "spec": {"spec": "dscim2:4"},
             "prefix": {"prefix_cache": "on"}}


def _kept_steps():
    """Every ``CapturedStep`` the kept continuous runner sets hold."""
    from repro_torch.launch import steps
    return [s for r in steps._RUNNERS.values() for s in r.captured_steps()]


def _last_runners():
    """The runner set the last serving run took."""
    from repro_torch.launch import steps
    return next(reversed(steps._RUNNERS.values()))


def _kind_kw(kind, spec):
    from repro_torch.runtime.serving import watchdog_for_spec
    kw = dict(RUN_KINDS[kind])
    if kind == "monitored":
        kw["monitor"] = watchdog_for_spec(spec, probe_every=1)
    return kw


def _kind_prompts(cfg, kind, seed):
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (4, 8))
    if kind == "prefix":
        prompts[:, :6] = prompts[0, :6]
    return prompts


@pytest.mark.parametrize("kind", list(RUN_KINDS))
def test_continuous_runners_die_with_the_run(setup, monkeypatch, kind):
    """No reference cycle holds a serving run's step runners: with the
    collector off, every ``CapturedStep`` still alive after a run is one
    a kept runner set holds (launch/steps.py ``continuous_runners``: the
    reference's cached step functions), and ``clear_graphs`` frees every
    one of them (on the card, their graphs and the graphs' memory pools),
    as ``launch/graph.py`` captures without collecting first."""
    import gc
    import weakref

    from repro_torch.launch import graph
    from repro_torch.launch.steps import clear_graphs

    made = []
    init = graph.CapturedStep.__init__

    def counted(self, *a, **k):
        init(self, *a, **k)
        made.append(weakref.ref(self))

    monkeypatch.setattr(graph.CapturedStep, "__init__", counted)
    _, cfg, _, params = setup
    spec = "kernel:dscim1:256"
    cfg = dataclasses.replace(cfg, dscim=spec)
    clear_graphs()
    gc.collect()
    gc.disable()
    try:
        serve_continuous(cfg, params, _kind_prompts(cfg, kind, 0), 6,
                         slots=2, seg_len=2, kv="int8", page_size=4,
                         eos_id=-1, device="cpu", **_kind_kw(kind, spec))
        assert made
        kept = {id(s) for s in _kept_steps()}
        alive = [r() for r in made if r() is not None]
        assert alive and all(id(s) in kept for s in alive)
        del alive
        clear_graphs()
        assert [r() for r in made if r() is not None] == []
    finally:
        gc.enable()


# -- runners kept across runs ----------------------------------------------

REF_SPEC, REF_KV = "kernel:dscim1:256", "int8"
REF_BUDGETS = np.array([3, 6, 2, 5, 4, 6], np.int32)
REF_KW = dict(slots=3, seg_len=2, max_new=REF_BUDGETS, eos_id=-1,
              kv=REF_KV, page_size=4)
# the stats a run's clock sets (and ``captures``, 0 on the CPU): every
# other key is held bitwise
TIMED = {"tok_s", "snapshots", "captures", "admit_lat_hit",
         "admit_lat_miss"}


def _untimed(stats):
    return {k: _untimed(v) if isinstance(v, dict) else v
            for k, v in stats.items()
            if k not in TIMED and not k.endswith("_s")}


@pytest.fixture(scope="module")
def reference_outs(setup):
    """``test_continuous_matches_reference``'s reference outputs at
    ``kernel:dscim1:256`` on the int8 cache."""
    jcfg, cfg, jp, _ = setup
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (6, 8))
    jouts, _ = jserve_continuous(
        dataclasses.replace(jcfg, dscim=REF_SPEC), jp,
        prompts.astype(np.int32), 6, log=lambda *_: None, **REF_KW)
    return prompts, [np.asarray(o) for o in jouts]


@pytest.mark.parametrize("given", ["raw", "prepared"])
def test_second_run_replays_the_kept_runners(setup, reference_outs, given):
    """Two runs at the same options, handed raw params (quantized afresh
    into the kept planes) or prepared ones: outputs and stats bitwise
    each other's and the reference's outputs; the second run takes the
    first run's runner set, whose segment step binds no more."""
    from repro_torch.launch.serve import prepare_params
    from repro_torch.launch.steps import clear_graphs

    _, cfg, _, params = setup
    cfg = dataclasses.replace(cfg, dscim=REF_SPEC)
    if given == "prepared":
        params = prepare_params(cfg, params, "cpu")
    prompts, want = reference_outs
    clear_graphs()
    runs = []
    for _ in range(2):
        runs.append(serve_continuous(cfg, params, prompts, 6, device="cpu",
                                     **REF_KW))
        seg = _last_runners().steps("", False)[2]
        runs[-1] += (seg, seg.runs["bindings"])
    (o1, s1, seg1, b1), (o2, s2, seg2, b2) = runs
    assert seg1 is seg2 and b1 == b2 == 1
    for r, (a, b, w) in enumerate(zip(o1, o2, want)):
        np.testing.assert_array_equal(a, w, err_msg=str(r))
        np.testing.assert_array_equal(b, w, err_msg=str(r))
    assert _untimed(s1) == _untimed(s2)
    assert s1["bindings"] == s2["bindings"] == {"segment": 1, "extend": 0}
    assert s1["captures"] == s2["captures"] == \
        {"segment": 0, "extend": 0, "probe": 0}          # no graph on the CPU


@pytest.mark.parametrize("kind", list(RUN_KINDS))
def test_run_after_another_equals_a_fresh_one(setup, kind):
    """A run of other prompts of the same shape and shorter budgets,
    after a run at the same options, serves what it serves in a fresh
    runner set, stats and the whole serve state after it too: the kept
    state carries nothing from the earlier run (pages and digests, tails
    and positions, the probe's saved rows, the extend's inputs)."""
    from repro_torch.launch.steps import clear_graphs

    _, cfg, _, params = setup
    spec = "kernel:dscim1:256"
    cfg = dataclasses.replace(cfg, dscim=spec)

    def run(seed):
        budgets = [6] * 4 if seed == 1 else [6, 2, 3, 1]
        return serve_continuous(cfg, params, _kind_prompts(cfg, kind, seed),
                                6, slots=2, seg_len=2, kv="int8",
                                page_size=4, eos_id=-1, max_new=budgets,
                                device="cpu", log=lambda *_: None,
                                **_kind_kw(kind, spec))

    def state():
        st = _last_runners().state
        return {k: v.clone() for k, v in
                list(st["cache"].items()) + list(st.items())
                if isinstance(v, torch.Tensor)}

    clear_graphs()
    run(1)
    kept = _last_runners()
    outs, st = run(2)
    assert _last_runners() is kept
    after = state()
    clear_graphs()
    fresh, st_f = run(2)
    for r, (a, b) in enumerate(zip(outs, fresh)):
        np.testing.assert_array_equal(a, b, err_msg=str(r))
    assert _untimed(st) == _untimed(st_f)
    for name, t in state().items():              # the whole state, bitwise
        assert torch.equal(after[name], t), name


@pytest.mark.parametrize("fault", ["weight_flip", "failover"])
def test_run_after_a_faulted_run_equals_a_fresh_one(setup, fault):
    """After a run with an injected weight-plane flip (integrity off: the
    flip is never repaired) or with a failover replay, the next clean run
    at the same options serves what a fresh one does: raw params are
    quantized afresh into the kept planes, and the restore left nothing
    behind."""
    from repro_torch.core.qweights import weight_plane_index
    from repro_torch.launch.serve import prepare_params
    from repro_torch.launch.steps import clear_graphs
    from repro_torch.runtime.failover import FailureInjector

    _, cfg, _, params = setup
    cfg = dataclasses.replace(cfg, dscim="kernel:dscim1:256")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (4, 8))
    kw = dict(slots=2, seg_len=2, kv="int8", page_size=4, eos_id=-1,
              device="cpu", log=lambda *_: None)
    if fault == "weight_flip":
        path = next(p for p, w in weight_plane_index(
            prepare_params(cfg, params, "cpu")) if "w_up" in p)
        knobs = dict(injector=FailureInjector(
            weight_flips={0: ((path, "q", 7, 0x40),)}))
    else:
        knobs = dict(snapshot_every=1,
                     injector=FailureInjector(fail_at=(1,)))
    clear_graphs()
    fresh, _ = serve_continuous(cfg, params, prompts, 6, **kw)
    clear_graphs()
    faulted, st = serve_continuous(cfg, params, prompts, 6, **kw, **knobs)
    if fault == "weight_flip":
        assert any(not np.array_equal(a, b) for a, b in zip(faulted, fresh))
    else:
        assert st["replays"] == 1
    after, _ = serve_continuous(cfg, params, prompts, 6, **kw)
    for r, (a, b) in enumerate(zip(after, fresh)):
        np.testing.assert_array_equal(a, b, err_msg=str(r))


def test_clear_graphs_empties_the_runner_cache(setup):
    """``clear_graphs`` drops every kept runner set and kept plane."""
    from repro_torch.launch import steps

    _, cfg, _, params = setup
    cfg = dataclasses.replace(cfg, dscim="kernel:dscim1:256")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (2, 8))
    serve_continuous(cfg, params, prompts, 3, slots=2, kv="int8",
                     page_size=4, device="cpu")
    assert steps._RUNNERS and steps._PLANES
    assert any(steps._PLANES.values())
    steps.clear_graphs()
    assert not steps._RUNNERS and not steps._PLANES


def test_continuous_eos_completion(setup):
    """Requests stop at their first EOS and release the slot."""
    _, cfg, _, params = setup
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (4, 8))
    n = 6
    ref, _ = serve_batch(cfg, params, np.tile(prompts[0:1], (2, 1)), n,
                         device="cpu")
    eos = int(ref[0, 2])
    stop0 = int(np.nonzero(ref[0] == eos)[0][0])
    outs, _ = serve_continuous(cfg, params, prompts, n, slots=2, seg_len=2,
                               eos_id=eos, device="cpu")
    assert len(outs[0]) == stop0 + 1 and outs[0][-1] == eos
    for o in outs:
        hits = np.nonzero(o == eos)[0]
        if len(hits):
            assert hits[0] == len(o) - 1
        else:
            assert len(o) == n


def test_continuous_small_page_pool_backpressure(setup):
    """A pool with pages for about two sequences delays admissions (slots
    idle while it is full) and serves every request as the full pool does;
    a pool too small for one request raises."""
    _, cfg, _, params = setup
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (4, 8))
    budgets = np.array([3, 4, 2, 3], np.int32)
    mp = n_pages_for(8 + 4, 4)
    kw = dict(slots=3, seg_len=2, max_new=budgets, eos_id=-1, kv="int8",
              page_size=4, device="cpu")
    outs, stats = serve_continuous(cfg, params, prompts, 4, n_pages=2 * mp,
                                   **kw)
    assert [len(o) for o in outs] == budgets.tolist()
    assert stats["pages"]["refusals"] > 0
    ref_outs, _ = serve_continuous(cfg, params, prompts, 4, **kw)
    for a, b in zip(outs, ref_outs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="page pool too small"):
        serve_continuous(cfg, params, prompts, 4, n_pages=mp - 1, **kw)


def test_integrity_needs_int8_kv(setup):
    """``integrity='verify'`` over the float cache raises the reference's
    ValueError."""
    jcfg, cfg, jp, params = setup
    prompts = np.zeros((2, 8), np.int64)
    with pytest.raises(ValueError, match="int8 paged cache") as ours:
        serve_continuous(cfg, params, prompts, 4, device="cpu",
                         integrity="verify")
    with pytest.raises(ValueError) as ref:
        jserve_continuous(jcfg, jp, prompts.astype(np.int32), 4,
                          integrity="verify")
    assert str(ours.value) == str(ref.value)


# -- across frameworks ----------------------------------------------------

@pytest.mark.parametrize("spec,kv", [("off", "float"), ("off", "int8"),
                                     ("kernel:dscim1:256", "int8")])
def test_continuous_matches_reference(setup, spec, kv):
    jcfg, cfg, jp, tp = setup
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (6, 8))
    budgets = np.array([3, 6, 2, 5, 4, 6], np.int32)
    kw = dict(slots=3, seg_len=2, max_new=budgets, eos_id=-1, kv=kv,
              page_size=4)
    jouts, jstats = jserve_continuous(
        dataclasses.replace(jcfg, dscim=spec), jp,
        prompts.astype(np.int32), 6, log=lambda *_: None, **kw)
    touts, tstats = serve_continuous(dataclasses.replace(cfg, dscim=spec),
                                     tp, prompts, 6, device="cpu", **kw)
    for r, (a, b) in enumerate(zip(touts, jouts)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(r))
    for key in ("useful_tokens", "live_slot_steps", "slot_steps",
                "segments", "occupancy", "status"):
        assert tstats[key] == jstats[key], key
    if kv == "int8":
        for key in ("n_pages", "live_pages", "high_water", "refusals"):
            assert tstats["pages"][key] == jstats["pages"][key], key
