"""The prefix cache in the port (``repro_torch.core.kvcache``
``prefix_chunk_keys`` / ``PrefixCache`` / ``cow_fork``,
``launch/steps.py make_extend_fn`` and the prefix-mode admission of
``runtime/serving.py``), on the CPU, against the JAX reference:

* the rolling chunk keys equal the reference's exactly (random tokens,
  zero tokens, partial pages);
* one random acquire / register / free / reclaim schedule leaves the
  port's index and allocator in the reference's state (``stats()`` and
  snapshots equal at every step);
* ``cow_fork`` copies a shared page's planes and scales bitwise onto a
  fresh page in place, and raises when the pool is exhausted;
* a prefix-hit admission's chunk logits are bitwise the cold
  admission's within the port, and within 1e-4 (max abs, f32 logits of
  order 1) of the reference's ``make_extend_fn(trace_logits=True)``;
* prefix serving ``on`` equals ``cold`` bitwise (greedy and sampled, a
  padded last chunk included), never rebinds the segment graph, and
  equals the reference's ``serve_continuous(prefix_cache='on')`` in
  tokens and prefix counters; ``prefix_drill`` passes; float KV raises.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import kvcache as jkv  # noqa: E402
from repro.launch.serve import serve_continuous as jserve_continuous  # noqa: E402
from repro.launch.steps import init_serve_state as jinit_serve_state  # noqa: E402
from repro.launch.steps import make_extend_fn as jmake_extend_fn  # noqa: E402
from repro.launch.steps import \
    prepare_serving_params as jprepare_serving_params  # noqa: E402
from repro.models.lm import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import kvcache  # noqa: E402
from repro_torch.launch.serve import prepare_params, serve_continuous  # noqa: E402
from repro_torch.launch.steps import init_serve_state, make_extend_fn  # noqa: E402
from repro_torch.runtime.serving import prefix_drill  # noqa: E402

ARCH = "qwen3-0.6b"
SPEC = "kernel:dscim1:256"
EXTEND_ATOL = 1e-4          # f32 logits across frameworks, order 1


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), dscim=SPEC)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dscim=SPEC)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


# -- chunk keys, index, allocator -------------------------------------------

@pytest.mark.parametrize("tokens,ps", [
    (np.random.default_rng(0).integers(0, 151936, 40), 8),
    (np.zeros(12, np.int64), 4),
    (np.random.default_rng(1).integers(0, 7, 13), 4),     # partial page
    (np.arange(3), 4)])                                   # no full page
def test_chunk_keys_equal_reference(tokens, ps):
    keys = kvcache.prefix_chunk_keys(tokens, ps)
    assert keys == jkv.prefix_chunk_keys(tokens.astype(np.int32), ps)
    assert len(keys) == len(tokens) // ps
    if len(keys) > 1:
        assert len(set(keys)) == len(keys)   # zeros are not absorbed
        other = tokens.copy()
        other[ps + 1] += 1                   # diverge inside page 1
        k2 = kvcache.prefix_chunk_keys(other, ps)
        assert k2[0] == keys[0] and k2[1:] != keys[1:]


def _index_schedule(mod, seed=0):
    """Random admissions (acquire a prefix, grant the rest), releases
    (some register first), retain/reclaim pressure and a snapshot round
    trip midway, over one module's ``PageAllocator`` / ``PrefixCache``;
    returns what it observed after every step."""
    rng = np.random.default_rng(seed)
    ps, pool = 4, 24
    alloc = mod.PageAllocator(pool)
    pc = mod.PrefixCache(alloc, ps)
    live, seen = [], []
    for step in range(150):
        op = int(rng.integers(0, 3))
        if op == 0 and len(live) < 5:
            S = int(rng.integers(ps, 4 * ps + 1))
            toks = rng.integers(0, 5, S).astype(np.int32)
            n, shared = pc.acquire(toks, (S - 1) // ps)
            fresh = alloc.alloc(mod.admission_pages(S, 2, ps, ps - 1)
                                - len(shared))
            if fresh is None:
                if shared:
                    alloc.free(shared)
            else:
                live.append((shared + fresh, toks))
            seen.append(("acquire", n, shared, fresh))
        elif op == 1 and live:
            ids, toks = live.pop(int(rng.integers(len(live))))
            added = pc.register(toks, ids[:len(toks) // ps]) \
                if rng.integers(2) else None
            alloc.free(ids)
            seen.append(("release", added))
        elif op == 2:
            got = alloc.alloc(int(rng.integers(1, 6)))
            if got is not None:
                alloc.free(got)
            seen.append(("pressure", got))
        if step == 75:
            alloc = mod.PageAllocator.from_snapshot(alloc.snapshot())
            pc = mod.PrefixCache.from_snapshot(pc.snapshot(), alloc)
        seen.append((pc.stats(), alloc.stats(), pc.snapshot(),
                     alloc.snapshot()))
    return seen


@pytest.mark.parametrize("seed", [0, 1])
def test_index_schedule_matches_reference(seed):
    assert _index_schedule(kvcache, seed) == _index_schedule(jkv, seed)


def _pool(seed=0):
    cache = kvcache.init_paged_cache(2, 1, 6, 4, 4, 2, 4)
    rng = np.random.default_rng(seed)
    cache["k_pages"].copy_(torch.from_numpy(rng.integers(
        -127, 128, cache["k_pages"].shape).astype(np.int8)))
    cache["v_scale"].copy_(torch.from_numpy(rng.uniform(
        0.01, 1, cache["v_scale"].shape).astype(np.float32)))
    return cache


def test_cow_fork_copies_shared_pages_in_place():
    a = kvcache.PageAllocator(6)
    cache = _pool()
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    ids = a.alloc(3)
    a.share(ids[:1])                        # page 0 shared, the rest private
    c2, ids2, nf = kvcache.cow_fork(cache, a, ids, start_idx=0)
    assert c2 is cache and {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert nf == 1 and ids2[1:] == ids[1:] and ids2[0] != ids[0]
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        assert torch.equal(cache[name][:, ids2[0]], before[name][:, ids[0]])
        assert torch.equal(cache[name][:, ids[0]], before[name][:, ids[0]])
    assert a.refcount(ids[0]) == 1 and a.refcount(ids2[0]) == 1
    a.share(ids2[:1])                       # start_idx leaves the prefix
    _, ids3, nf = kvcache.cow_fork(cache, a, ids2, start_idx=1)
    assert nf == 0 and ids3 == ids2


def test_cow_fork_pool_exhausted_raises():
    a = kvcache.PageAllocator(2)
    cache = kvcache.init_paged_cache(1, 1, 2, 4, 2, 1, 4)
    ids = a.alloc(2)
    a.share(ids)
    with pytest.raises(RuntimeError, match="exhausted while forking"):
        kvcache.cow_fork(cache, a, ids, start_idx=0)


# -- the extend step: hit vs cold, port vs reference -------------------------

def _admit_chunked(extend, state, alloc, pfx, b, toks, S, ps, need, budget,
                   use_prefix, put):
    """One chunked admission of ``toks`` into slot ``b`` (either
    framework: ``put(state, b, row, pos)`` writes the slot's page-table
    row, pos and done flag); returns (state, tok0, chunk logit traces)."""
    shared = []
    if use_prefix:
        _, shared = pfx.acquire(toks, (S - 1) // ps)
    ids = shared + alloc.alloc(need - len(shared))
    fed = len(shared) * ps
    state = put(state, b, ids, fed)
    traces = []
    while fed < S:
        part = toks[fed:fed + ps]
        state, tok0, lg = extend(state, part[None], b, len(part),
                                 fed + len(part) >= S, budget)
        traces.append(np.asarray(lg))
        fed += len(part)
    pfx.register(toks, ids[:S // ps])
    return state, int(tok0), traces


def _extend_legs(setup, use_prefix):
    """A donor and a hitter whose prompts share 2 pages, admitted into two
    slots, in the port and in the reference."""
    jcfg, cfg, jp, tp = setup
    ps, S, budget = 4, 12, 3
    rng = np.random.default_rng(0)
    donor = rng.integers(1, 100, S).astype(np.int32)
    hitter = donor.copy()
    hitter[8:] = rng.integers(1, 100, S - 8)  # diverge at page 2
    need = kvcache.admission_pages(S, budget, ps, ps - 1)
    cap = S + budget + ps - 1

    params = prepare_params(cfg, tp, "cpu")
    ext = make_extend_fn(cfg, ps, eos_id=-1, trace_logits=True)

    def tput(state, b, ids, pos):
        mp = state["cache"]["page_table"].shape[1]
        state["cache"]["page_table"][b] = torch.tensor(
            ids + [ids[-1]] * (mp - len(ids)), dtype=torch.int32)
        state["cache"]["pos"][b] = pos
        state["done"][b] = True
        return state

    jext = jmake_extend_fn(jcfg, None, ps, eos_id=-1, trace_logits=True)
    jparams = jprepare_serving_params(jcfg, jp)

    def jput(state, b, ids, pos):
        mp = state["cache"]["page_table"].shape[1]
        row = jax.numpy.asarray(ids + [ids[-1]] * (mp - len(ids)),
                                jax.numpy.int32)
        cache = dict(state["cache"],
                     page_table=state["cache"]["page_table"].at[b].set(row),
                     pos=state["cache"]["pos"].at[b].set(pos))
        return dict(state, cache=cache, done=state["done"].at[b].set(True))

    out = {}
    for name, mod, put, init, call in (
            ("port", kvcache, tput,
             lambda: init_serve_state(cfg, 2, cap, kv="int8", page_size=ps,
                                      n_pages=4 * need, device="cpu"),
             lambda st, *a: ext(params, st, *a)),
            ("ref", jkv, jput,
             lambda: jinit_serve_state(jcfg, 2, cap, kv="int8",
                                       page_size=ps, n_pages=4 * need),
             lambda st, t, b, n, e, m: jext(
                 jparams, st, jax.numpy.asarray(t), jax.numpy.int32(b),
                 jax.numpy.int32(n), jax.numpy.bool_(e),
                 jax.numpy.int32(m)))):
        alloc = mod.PageAllocator(4 * need)
        pfx = mod.PrefixCache(alloc, ps)
        state = init()
        state, _, _ = _admit_chunked(call, state, alloc, pfx, 0, donor, S,
                                     ps, need, budget, False, put)
        _, tok0, traces = _admit_chunked(call, state, alloc, pfx, 1, hitter,
                                         S, ps, need, budget, use_prefix,
                                         put)
        out[name] = (tok0, traces, pfx.stats())
    return out, ext


def test_extend_logit_trace_hit_vs_cold(setup):
    """A prefix hit skips the two shared chunks; its remaining chunk's
    logits are bitwise the cold admission's third chunk's, in the port,
    and the port's chunk logits stay within EXTEND_ATOL of the
    reference's in both legs; the extend step binds once per state."""
    cold, _ = _extend_legs(setup, False)
    warm, ext = _extend_legs(setup, True)
    (tok_c, tr_c, st_c), (tok_w, tr_w, st_w) = cold["port"], warm["port"]
    assert st_c["hits"] == 0 and st_w["hits"] == 1
    assert st_w["pages_deduped"] == 2
    assert len(tr_c) == 3 and len(tr_w) == 1
    assert tok_w == tok_c
    np.testing.assert_array_equal(tr_w[0], tr_c[2])
    assert ext.runs["bindings"] == 1
    for leg in (cold, warm):
        (tok, tr, st), (jtok, jtr, jst) = leg["port"], leg["ref"]
        assert st == jst and tok == jtok
        for a, b in zip(tr, jtr):
            np.testing.assert_allclose(a, b, rtol=0, atol=EXTEND_ATOL)


def test_extend_emits_and_arms_the_slot(setup):
    """The emitting chunk gives the slot the admission number as its
    stream, arms it (tok, done, n_out = 1, max_new) and bumps
    ``admitted``; a non-emitting chunk leaves it done-masked and the
    other slot untouched."""
    _, cfg, _, tp = setup
    params = prepare_params(cfg, tp, "cpu")
    ext = make_extend_fn(cfg, 4, eos_id=-1, sample="temp:0.8")
    st = init_serve_state(cfg, 2, 16, kv="int8", page_size=4, seed=3,
                          device="cpu")
    st["admitted"] = 5
    st["cache"]["page_table"][1] = torch.arange(4, 8, dtype=torch.int32)
    st["cache"]["pos"][1] = 0
    other = {k: st[k][0].clone() for k in ("tok", "done", "n_out",
                                           "max_new", "stream")}
    toks = np.arange(1, 9)
    ext(params, st, toks[None, :4], 1, 4, False, 6)
    assert bool(st["done"][1]) and st["admitted"] == 5
    assert int(st["cache"]["pos"][1]) == 4 and int(st["cache"]["pos"][0]) == 0
    _, tok0 = ext(params, st, np.pad(toks[4:7], (0, 1))[None], 1, 3, True, 6)
    assert st["admitted"] == 6 and int(st["stream"][1]) == 5
    assert int(st["cache"]["pos"][1]) == 7
    assert int(st["tok"][1]) == int(tok0) and not bool(st["done"][1])
    assert int(st["n_out"][1]) == 1 and int(st["max_new"][1]) == 6
    for k, v in other.items():
        assert torch.equal(st[k][0], v), k


# -- prefix serving -----------------------------------------------------------

def _queue(cfg, S, shared):
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, (5, S))
    prompts[1:4, :shared] = prompts[0, :shared]
    return prompts, np.asarray([4, 3, 5, 2, 4], np.int32)


@pytest.mark.parametrize("S,sample,spec,dscim", [
    (12, "greedy", None, SPEC), (14, "greedy", None, "off"),
    (14, "topk:20:0.9", None, "off"), (12, "greedy", "dscim2:2", "off")])
def test_prefix_serving_on_equals_cold(setup, S, sample, spec, dscim):
    """Warm serving (3 requests hit the first's 2 shared pages) emits the
    cold leg's tokens bitwise, on the main path's DS-CIM kernel mode and,
    with the estimator off, with a padded last chunk at S = 14, under
    sampling and with speculative segments; the segment and extend steps
    bind once; every page returns and the shared prefix stays
    retained."""
    _, cfg, _, tp = setup
    cfg = dataclasses.replace(cfg, dscim=dscim)
    prompts, budgets = _queue(cfg, S, 8)
    kw = dict(slots=2, seg_len=2, max_new=budgets, eos_id=-1, kv="int8",
              page_size=4, sample=sample, rng_seed=2, spec=spec,
              device="cpu")
    cold, st_c = serve_continuous(cfg, tp, prompts, 5, prefix_cache="cold",
                                  **kw)
    warm, st_w = serve_continuous(cfg, tp, prompts, 5, prefix_cache="on",
                                  **kw)
    for r, (a, b) in enumerate(zip(warm, cold)):
        np.testing.assert_array_equal(a, b, err_msg=str(r))
    assert [len(o) for o in warm] == budgets.tolist()
    pw = st_w["prefix"]
    assert st_c["prefix"]["hits"] == 0 and pw["hits"] == 3
    assert pw["pages_deduped"] == 6 and pw["hit_tokens"] == 24
    assert pw["prefill_positions_total"] == 5 * S
    assert pw["prefill_positions_computed"] == 5 * S - 24
    assert len(pw["admit_lat_hit"]) == 3 and len(pw["admit_lat_miss"]) == 2
    for st in (st_c, st_w):
        assert st["bindings"] == {"segment": 1, "extend": 1}
        assert st["pages"]["live_pages"] == 0
    assert st_w["pages"]["retained_pages"] > 0


def test_prefix_serving_independent_of_schedule(setup):
    """A request's tokens do not depend on which other admissions' extend
    chunks ran between its segments: prefix serving through 1, 2 or 3
    slots (other admission orders and interleavings) gives every request
    the same tokens (the estimator off: the scheduler is under test)."""
    _, cfg, _, tp = setup
    cfg = dataclasses.replace(cfg, dscim="off")
    prompts, budgets = _queue(cfg, 12, 8)
    runs = [serve_continuous(cfg, tp, prompts, 5, slots=slots, seg_len=2,
                             max_new=budgets, eos_id=-1, kv="int8",
                             page_size=4, prefix_cache="on",
                             device="cpu")[0] for slots in (1, 2, 3)]
    for outs in runs[1:]:
        for r, (a, b) in enumerate(zip(outs, runs[0])):
            np.testing.assert_array_equal(a, b, err_msg=str(r))


def test_prefix_serving_matches_reference(setup):
    jcfg, cfg, jp, tp = setup
    prompts, budgets = _queue(cfg, 12, 8)
    kw = dict(slots=2, seg_len=2, max_new=budgets, eos_id=-1, kv="int8",
              page_size=4, prefix_cache="on")
    jouts, jst = jserve_continuous(jcfg, jp, prompts.astype(np.int32), 5,
                                   log=lambda *_: None, **kw)
    touts, tst = serve_continuous(cfg, tp, prompts, 5, device="cpu", **kw)
    for r, (a, b) in enumerate(zip(touts, jouts)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(r))
    keys = ("entries", "lookups", "hits", "hit_tokens", "pages_deduped",
            "prefill_positions_computed", "prefill_positions_total")
    assert {k: tst["prefix"][k] for k in keys} == \
        {k: jst["prefix"][k] for k in keys}
    for key in ("useful_tokens", "live_slot_steps", "slot_steps",
                "segments", "status"):
        assert tst[key] == jst[key], key
    assert tst["pages"] == jst["pages"]


def test_prefix_drill_passes_on_port():
    report = prefix_drill(device="cpu", log=lambda *_: None)
    assert report["hits"] == 4 and report["pages_deduped"] == 12
    assert report["prefill_removed_frac"] > 0.4


def test_prefix_requires_int8_kv(setup):
    _, cfg, _, tp = setup
    with pytest.raises(ValueError, match="int8"):
        serve_continuous(cfg, tp, np.zeros((1, 8), np.int64), 2, slots=1,
                         kv="float", prefix_cache=True, eos_id=-1,
                         device="cpu")
    with pytest.raises(ValueError, match="prefix_cache must be"):
        serve_continuous(cfg, tp, np.zeros((1, 8), np.int64), 2, slots=1,
                         kv="int8", prefix_cache="warm", device="cpu")
