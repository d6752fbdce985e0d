"""The port's asyncio serving router (``repro_torch/runtime/router.py``)
on the CPU, at the reduced qwen3-0.6b with the reference's weights
(``convert.params_from_jax`` of ``init_params(PRNGKey(0))``):

* against the JAX ``repro.runtime.router.Router`` on the same traffic,
  submitted before ``start()`` (mixed bucket and odd lengths, a priority,
  a step deadline, pool pressure, an id past the vocabulary): each
  request's status and tokens and the deterministic stats (statuses,
  refusals, counters, segments, replays, useful tokens, occupancy, pages)
  are equal, plain and under failover, integrity replay and the prefix
  cache, for ``dscim='off'`` and ``'kernel:dscim1:256'``; spec greedy
  tokens equal the plain router's;
* within the port, the reference's own router tests: bucket admissions
  bitwise ``serve_continuous``, chunk-size invariance, typed refusals,
  cancellation, ``deadline_s`` anchored at submission, invisible
  failover, quarantine -> restart -> ``degraded``, drain-snapshot-resume,
  zero live pages after every drain; and the captured steps bound once
  for a whole run (the state is written in place, restores copy into
  it).
"""
import pytest

torch = pytest.importorskip("torch")

import asyncio  # noqa: E402
import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models.lm import init_params as jinit_params  # noqa: E402
from repro.runtime.failover import FailureInjector as JFailureInjector  # noqa: E402
from repro.runtime.router import Router as JRouter  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import serve_continuous  # noqa: E402
from repro_torch.runtime.failover import FailureInjector  # noqa: E402
from repro_torch.runtime.router import Refused, Router  # noqa: E402
from repro_torch.runtime.watchdog import AccuracyWatchdog  # noqa: E402

ARCH = "qwen3-0.6b"
V = 120                    # prompt ids below the reduced vocabulary (128)
KN = dict(seg_len=2, kv="int8", page_size=4, buckets=(4, 8), chunk_len=4,
          max_prompt=24, max_new_cap=8, log=lambda *a: None)
STAT_KEYS = ("statuses", "refusals", "counters", "segments", "replays",
             "useful_tokens", "occupancy", "pages")


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_arch(ARCH).reduced()
    cfg = get_arch(ARCH).reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _router(cfg, params, **kw):
    return Router(cfg, params, **{**KN, "device": "cpu", **kw})


async def _drained(router):
    await router.close()
    assert router.stats()["pages"]["live_pages"] == 0, router.stats()


def _serve(make, reqs):
    """Submit every request before ``start()`` (a deterministic first
    round), collect the results, drain; returns (results, stats)."""
    async def run():
        r = make()
        hs = [r.submit(p, b, **x) for p, b, x in reqs]
        await r.start()
        res = await asyncio.gather(*[h.result() for h in hs])
        await _drained(r)
        return res, r.stats()
    return asyncio.run(run())


def _traffic(seed=0, shared=False):
    """Bucket and odd lengths, a priority, a step deadline; request 2
    carries an id past the vocabulary and request 5 two negative ids,
    which the reference's gather wraps and clamps (ROADMAP C8).  ``shared``: requests 1-4 share request 0's
    first 8 tokens (two pages), every prompt longer than 8."""
    rng = np.random.default_rng(seed)
    lens = (12, 9, 13, 11, 10, 6) if shared else (4, 8, 11, 4, 6, 8, 13, 3)
    budgets = (5, 3, 6, 8, 2, 7, 4, 6)
    prompts = [rng.integers(1, V, s).astype(np.int32) for s in lens]
    if shared:
        for p in prompts[1:5]:
            p[:8] = prompts[0][:8]
    prompts[2][0] = 300
    prompts[5][0], prompts[5][2] = -3, -200
    extra = [{} for _ in prompts]
    extra[3] = {"deadline_steps": 3}
    extra[4] = {"priority": 1}
    return [(p, budgets[i], extra[i]) for i, p in enumerate(prompts)]


def _held_to_reference(setup, dscim, reqs, knobs=None, injector=None):
    """The port's and the reference's routers on the same traffic: the
    statuses, tokens and deterministic stats must agree.  ``injector``
    builds a fresh injector per framework from its class.  Returns the
    port's (results, stats)."""
    jcfg, cfg, jp, tp = setup
    if dscim != "off":
        jcfg = dataclasses.replace(jcfg, dscim=dscim)
        cfg = dataclasses.replace(cfg, dscim=dscim)
    knobs = dict(slots=3, n_pages=10, **(knobs or {}))
    jres, jst = _serve(lambda: JRouter(
        jcfg, jp, **KN, **knobs,
        injector=injector(JFailureInjector) if injector else None), reqs)
    tres, tst = _serve(lambda: _router(
        cfg, tp, **knobs,
        injector=injector(FailureInjector) if injector else None), reqs)
    assert [r.status for r in tres] == [r.status for r in jres]
    for i, (a, b) in enumerate(zip(tres, jres)):
        assert a.tokens == b.tokens, i
    for key in STAT_KEYS:
        assert tst[key] == jst[key], key
    assert tst["bindings"] == {"segment": 1, "extend": 1, "probe": 0}
    return tres, tst, jst


@pytest.mark.parametrize("dscim", ["off", "kernel:dscim1:256"])
def test_same_traffic_same_results(setup, dscim):
    res, st, _ = _held_to_reference(setup, dscim, _traffic())
    statuses = [r.status for r in res]
    assert statuses.count("ok") == 7 and statuses[3] == "deadline"
    assert st["pages"]["refusals"] > 0          # the pool held some back


FAULTS = {
    # a device loss at segment 2, a snapshot every round
    "failover": (dict(snapshot_every=1),
                 lambda cls: cls(fail_at=(2,))),
    # an int8 flip in slot 0's first (flushed) page at boundary 2, where
    # the scrub finds it and replays from the verified snapshot
    "integrity": (dict(integrity="scrub:2"),
                  lambda cls: cls(page_flips={
                      2: ((0, "k_pages", (0, 0, 0, 0, 0), 0x41),)})),
    "prefix": (dict(prefix_cache=True), None),
}


@pytest.mark.parametrize("dscim", ["off", "kernel:dscim1:256"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_same_as_reference(setup, fault, dscim):
    knobs, injector = FAULTS[fault]
    reqs = _traffic(1, shared=fault == "prefix")
    res, st, jst = _held_to_reference(setup, dscim, reqs, knobs, injector)
    clean, _ = _serve(lambda: _router(
        dataclasses.replace(setup[1], dscim=dscim), setup[3], slots=3,
        n_pages=10, prefix_cache=fault == "prefix"), reqs)
    for a, b in zip(res, clean):          # the faults are invisible
        assert (a.status, a.tokens) == (b.status, b.tokens)
    if fault == "failover":
        assert st["replays"] == 1 and st["snapshots"]["restores"] == 1
    elif fault == "integrity":
        ig, jig = st["integrity"], jst["integrity"]
        assert st["replays"] == 1 and ig["replays"] == 1
        assert ig["page_mismatches"] == 1
        for key in jig:
            if key not in ("scrub_time_s", "detections"):
                assert ig[key] == jig[key], key
        assert ig["detections"] == [
            {"kind": d["kind"], "coords": [tuple(int(v) for v in c)
                                           for c in d["coords"]]}
            for d in jig["detections"]]
    else:
        assert st["prefix"] == jst["prefix"]
        assert st["prefix"]["hits"] > 0


def test_spec_router_equals_plain(setup):
    """Self-speculative segments (``spec='dscim2:2'``) give every request
    the plain router's greedy tokens, at the same statuses."""
    _, cfg, _, tp = setup
    cfg = dataclasses.replace(cfg, dscim="kernel:dscim1:256")
    reqs = [(p, b, {}) for p, b, _ in _traffic(2)]
    plain, _ = _serve(lambda: _router(cfg, tp, slots=3), reqs)
    spec, st = _serve(lambda: _router(cfg, tp, slots=3, spec="dscim2:2"),
                      reqs)
    for a, b in zip(spec, plain):
        assert (a.status, a.tokens) == (b.status, b.tokens)
    assert st["bindings"]["segment"] == 1


# -- the reference's router tests, within the port ----------------------------

def test_bucket_admission_bitwise_vs_serve_continuous(setup):
    """Bucket-length admissions through the router emit bitwise the
    tokens serve_continuous gives the same prompts."""
    _, cfg, _, params = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, V, s).astype(np.int32)
               for s in (4, 8, 4, 8, 4)]
    budgets = [5, 3, 6, 4, 2]

    async def run():
        r = _router(cfg, params, slots=3)
        await r.start()
        res = await asyncio.gather(*[r.submit(p, b).result()
                                     for p, b in zip(prompts, budgets)])
        await _drained(r)
        return res

    res = asyncio.run(run())
    assert [x.status for x in res] == ["ok"] * 5
    for length in (4, 8):
        rows = [i for i, p in enumerate(prompts) if len(p) == length]
        outs, _ = serve_continuous(
            cfg, params, np.stack([prompts[i] for i in rows]),
            max(budgets[i] for i in rows), slots=2, seg_len=2, kv="int8",
            page_size=4, max_new=[budgets[i] for i in rows], eos_id=-1,
            device="cpu", log=lambda *a: None)
        for j, i in enumerate(rows):
            assert res[i].tokens == outs[j].tolist(), (i, length)


_CHUNKED: dict = {}


def _chunked(setup, chunk_len):
    if chunk_len not in _CHUNKED:
        _, cfg, _, params = setup
        rng = np.random.default_rng(1)
        prompts = [rng.integers(1, V, s).astype(np.int32) for s in (11, 6)]

        async def run():
            r = _router(cfg, params, slots=2, buckets=(64,),
                        chunk_len=chunk_len)
            await r.start()
            res = await asyncio.gather(*[r.submit(p, 5).result()
                                         for p in prompts])
            await _drained(r)
            return [x.tokens for x in res]
        _CHUNKED[chunk_len] = asyncio.run(run())
    return _CHUNKED[chunk_len]


@pytest.mark.parametrize("chunk_len", [3, 4, 6])
def test_chunked_prefill_chunk_size_invariance(setup, chunk_len):
    """chunk_len=1 is sequential decode; every other chunking, a padded
    and rolled-back last chunk included, gives bitwise its stream."""
    ref = _chunked(setup, 1)
    assert all(len(t) == 5 for t in ref)
    assert _chunked(setup, chunk_len) == ref


def test_refusals_typed(setup):
    """Backpressure is typed, not a hang: too_large is permanent, queue
    transient with a retry hint, draining the shutdown surface; none of
    them makes a request."""
    _, cfg, _, params = setup
    rng = np.random.default_rng(2)

    async def run():
        r = _router(cfg, params, slots=1, max_queue=2)
        await r.start()
        for prompt, budget in ((30, 4), (4, 99)):  # > max_prompt, > cap
            with pytest.raises(Refused) as e:
                r.submit(rng.integers(1, V, prompt), budget)
            assert e.value.reason == "too_large"
        hs = [r.submit(rng.integers(1, V, 4), 4) for _ in range(2)]
        with pytest.raises(Refused) as e:
            r.submit(rng.integers(1, V, 4), 4)       # queue full
        assert e.value.reason == "queue"
        assert e.value.retry_after is not None and e.value.retry_after > 0
        res = await asyncio.gather(*[h.result() for h in hs])
        assert [x.status for x in res] == ["ok", "ok"]
        await _drained(r)
        with pytest.raises(Refused) as e:
            r.submit(rng.integers(1, V, 4), 4)
        assert e.value.reason == "draining"
        assert r.stats()["refusals"] == {"queue": 1, "too_large": 2,
                                         "draining": 1}
        assert r.stats()["submitted"] == 2

    asyncio.run(run())


def test_cancel_mid_stream_recycles_pages(setup):
    """cancel() ends the stream 'cancelled' at the next round, frees the
    slot and its pages while the other request keeps streaming."""
    _, cfg, _, params = setup
    rng = np.random.default_rng(3)

    async def run():
        r = _router(cfg, params, slots=2)
        await r.start()
        h_other = r.submit(rng.integers(1, V, 4), 8)
        h = r.submit(rng.integers(1, V, 4), 8)
        got, status = [], None
        async for kind, val in h.events():
            if kind == "token":
                got.append(val)
                if len(got) == 2:
                    h.cancel()
            else:
                status = val
        assert status == "cancelled" and len(got) < 8
        other = await h_other.result()
        assert other.status == "ok" and len(other.tokens) == 8
        assert r.stats()["counters"]["cancelled"] == 1
        await _drained(r)

    asyncio.run(run())


def test_deadline_s_anchored_at_submission(setup):
    """Wall deadlines start at submit(): a request queued behind a long
    stream expires with no token; an admitted request past its step
    budget ends 'deadline' with its partial tokens."""
    _, cfg, _, params = setup
    rng = np.random.default_rng(4)

    async def run():
        r = _router(cfg, params, slots=1)
        await r.start()
        h0 = r.submit(rng.integers(1, V, 4), 8)          # hog the slot
        hq = r.submit(rng.integers(1, V, 4), 2, deadline_s=1e-3)
        res0, resq = await asyncio.gather(h0.result(), hq.result())
        assert res0.status == "ok"
        assert resq.status == "deadline" and resq.tokens == []
        res1 = await r.submit(rng.integers(1, V, 4), 8,
                              deadline_steps=2).result()
        assert res1.status == "deadline" and 1 <= len(res1.tokens) < 8
        await _drained(r)

    asyncio.run(run())


def test_failover_replay_is_invisible(setup):
    """A device loss mid-serve restores the latest snapshot and replays:
    the streams see no duplicate or missing token, and the outputs are
    bitwise the unfaulted run's."""
    _, cfg, _, params = setup
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, V, 4).astype(np.int32), 6, {})
            for _ in range(3)]
    faulted, st = _serve(lambda: _router(
        cfg, params, slots=2, snapshot_every=1,
        injector=FailureInjector(fail_at=(2,))), reqs)
    clean, _ = _serve(lambda: _router(cfg, params, slots=2), reqs)
    assert st["replays"] == 1
    for a, b in zip(faulted, clean):
        assert a.status == b.status == "ok" and a.tokens == b.tokens


def test_flip_before_a_restore_stays_counted(setup):
    """A page flip whose segment a device loss later rolls back: the
    restore predates the flip, so the replay decodes clean tokens, but
    the tokens streamed from the flipped page before the loss stay
    streamed, and the request stays in ``corrupted_requests`` (the load
    test's chaos check skips it on that record)."""
    _, cfg, _, params = setup
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, V, 8).astype(np.int32), 8, {})
            for _ in range(2)]
    inj = FailureInjector(
        fail_at=(3,), page_flips={1: ((0, "k_scale", (0, 0, 0), 1 << 30),)})
    _, st = _serve(lambda: _router(cfg, params, slots=2, snapshot_every=4,
                                   injector=inj), reqs)
    assert st["replays"] == 1 and len(inj.hits) == 1
    assert st["corrupted_requests"] == [0]


class _InfScaleInjector(FailureInjector):
    """A NaN source: one live dequant scale of slot 0's first page set
    to +inf at segment 1, in place."""

    def corrupt_cache(self, segment, cache, slot_pages):
        key = ("inf", 1)
        if segment != 1 or key in self.fired or slot_pages[0] is None:
            return cache, []
        self.fired.add(key)
        cache["v_scale"][0, int(slot_pages[0][0]), 0] = float("inf")
        return cache, [0]


def test_quarantine_streams_restart_and_degraded(setup):
    """A NaN-quarantined request is served again down the ladder at once:
    the stream sees a restart voiding its tokens, the full re-served
    output and a terminal 'degraded'."""
    _, cfg, _, params = setup
    cfg = dataclasses.replace(cfg, dscim="kernel:dscim2:64")
    rng = np.random.default_rng(6)

    async def run():
        r = _router(cfg, params, slots=2, injector=_InfScaleInjector(),
                    monitor=AccuracyWatchdog(None), snapshot_every=1)
        await r.start()
        events = [ev async for ev in r.submit(rng.integers(1, V, 4),
                                              6).events()]
        stats = r.stats()
        await _drained(r)
        return events, stats

    events, stats = asyncio.run(run())
    kinds = [k for k, _ in events]
    assert events[-1] == ("end", "degraded")
    tail = kinds[kinds.index("restart") + 1:]
    assert tail.count("token") == 6
    assert stats["counters"]["quarantined"] == 1
    assert stats["counters"]["degraded"] == 1


def test_drain_snapshot_resume_completes(setup):
    """close('snapshot') parks live and queued requests (streams end
    'cancelled', pages freed); Router(resume=blob) serves them to
    completion, bitwise an uninterrupted run."""
    _, cfg, _, params = setup
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, V, 4).astype(np.int32) for _ in range(3)]

    async def interrupted():
        r = _router(cfg, params, slots=2)
        await r.start()
        hs = [r.submit(p, 6) for p in prompts]
        await asyncio.sleep(0)                   # let a round or two run
        blob = await r.close("snapshot")
        assert r.stats()["pages"]["live_pages"] == 0
        res = await asyncio.gather(*[h.result() for h in hs])
        assert {x.status for x in res} == {"cancelled"}
        assert blob is not None and blob["requests"]
        r2 = _router(cfg, params, slots=2, resume=blob)
        await r2.start()
        handles = r2.resume_handles()
        assert set(handles) == {d["rid"] for d in blob["requests"]}
        out = {rid: await h.result() for rid, h in handles.items()}
        await _drained(r2)
        assert r2.stats()["bindings"]["segment"] == 1
        return out

    out = asyncio.run(interrupted())
    ref, _ = _serve(lambda: _router(cfg, params, slots=2),
                    [(p, 6, {}) for p in prompts])
    for rid, got in out.items():
        assert got.status == "ok" and got.tokens == ref[rid].tokens, rid


def test_steps_bound_once_through_a_whole_run(setup):
    """One router through bucket and chunked admissions, a cancellation,
    a step deadline, a failover restore and a NaN quarantine: the segment
    and extend steps are bound once (the state is written in place and
    restored into), and every stream ends in a terminal status."""
    _, cfg, _, params = setup
    cfg = dataclasses.replace(cfg, dscim="kernel:dscim2:64")
    rng = np.random.default_rng(8)

    async def run():
        r = _router(cfg, params, slots=3, snapshot_every=1,
                    monitor=AccuracyWatchdog(None),
                    injector=_InfScaleInjector(fail_at=(3,)))
        hs = [r.submit(rng.integers(1, V, s), b, **x) for s, b, x in (
            (4, 6, {}), (11, 5, {}), (8, 8, {"deadline_steps": 2}),
            (6, 8, {}), (4, 4, {}))]
        await r.start()
        cancel = hs[3]
        results = []
        for h in hs:
            if h is cancel:
                async for kind, _ in h.events():
                    if kind == "token":
                        h.cancel()
                    else:
                        break
                results.append(None)
            else:
                results.append(await h.result())
        await _drained(r)
        return results, r.stats()

    results, st = asyncio.run(run())
    assert st["bindings"] == {"segment": 1, "extend": 1, "probe": 0}
    assert st["replays"] == 1 and st["counters"]["quarantined"] == 1
    assert st["counters"]["cancelled"] == 1
    assert st["counters"]["deadline_cancelled"] == 1
    assert sum(st["statuses"].values()) == 5


def test_prompt_ids_past_the_vocabulary_read_the_last_row(setup):
    """ROADMAP C8: a caller's id outside the embedding table reads the row
    the reference's gather reads: a negative id wraps once, then the id
    is clamped into the table (indexing raised on the CPU and traps on
    the card), in prefill and in an extend chunk alike."""
    from repro_torch.models import lm

    _, cfg, jp, params = setup
    last = cfg.vocab_padded - 1
    ids = np.array([[5, 300, 7, 10 ** 6, -1, -3, -200, -10 ** 6]], np.int32)
    rows = np.array([[5, last, 7, last, last, last - 2, 0, 0]])
    np.testing.assert_array_equal(np.asarray(jp["embed"][ids]),
                                  np.asarray(jp["embed"])[rows])
    want, _ = lm.prefill(params, cfg, torch.from_numpy(rows))
    got, _ = lm.prefill(params, cfg, torch.from_numpy(ids))
    assert torch.equal(got, want)
    assert torch.equal(lm._embed_prompt(params, torch.from_numpy(ids)),
                       params["embed"][torch.from_numpy(rows)])
