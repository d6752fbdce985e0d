"""The scheduler's fault handling in the port (``runtime/serving.py``
deadlines, priority eviction, snapshots and failover replay;
``runtime/failover.py``; ``core/kvcache.py extract_slot_pages`` /
``insert_slot_pages``), on the CPU, against the JAX reference:

* a slot's blob is bitwise the reference's on a cache converted from the
  reference's arrays, and writing it back onto other pages restores the
  slot bitwise, as the reference's does; an evictee's shared pages stay
  with their other sharers and come back private;
* failover replay is bitwise the undisturbed run for float KV, int8 KV,
  int8 with ``spec='dscim2:2'`` and int8 with the prefix cache (the
  snapshot carries the index), restores copy back without rebinding
  the captured steps, and exhausted replays raise;
* eviction and re-admission are bitwise the big-pool run, greedy and
  sampled and with an evictee that holds shared prefix pages; equal
  priorities never evict;
* deadlines: step budgets, expiry while waiting, and ``deadline_s``
  anchored at admission (a fake clock);
* each scenario's tokens and stats (``status``, ``replays``,
  ``evictions``, ``readmissions``, ``evicted_requests``,
  ``deadline_cancelled``) equal the reference's.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.runtime.serving as jserving  # noqa: E402
import repro_torch.runtime.serving as serving  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import kvcache as jkv  # noqa: E402
from repro.launch.serve import serve_continuous as jserve_continuous  # noqa: E402
from repro.models.lm import init_params as jinit_params  # noqa: E402
from repro.runtime.failover import FailureInjector as JFailureInjector  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import kvcache  # noqa: E402
from repro_torch.launch.serve import serve_continuous  # noqa: E402
from repro_torch.runtime.failover import (FailureInjector,  # noqa: E402
                                          SimulatedHardwareFailure)

ARCH = "qwen3-0.6b"
BUDGETS = np.array([2, 5, 3, 4, 6, 1], np.int32)
FT_KEYS = ("status", "replays", "evictions", "readmissions",
           "evicted_requests", "deadline_cancelled", "useful_tokens",
           "segments")


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_arch(ARCH).reduced()
    cfg = get_arch(ARCH).reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _quiet(*_):
    pass


def _both(setup, prompts, n, injector=None, **kw):
    """The port's and the reference's ``serve_continuous`` on one queue
    (dscim off, the reference's own fault-test setting); the tokens and
    the fault stats must agree.  Returns the port's (outputs, stats)."""
    jcfg, cfg, jp, tp = setup
    jinj = tinj = None
    if injector is not None:
        jinj = JFailureInjector(fail_at=injector)
        tinj = FailureInjector(fail_at=injector)
    jouts, jst = jserve_continuous(jcfg, jp, prompts.astype(np.int32), n,
                                   injector=jinj, log=_quiet, **kw)
    touts, tst = serve_continuous(cfg, tp, prompts, n, injector=tinj,
                                  device="cpu", log=_quiet, **kw)
    for r, (a, b) in enumerate(zip(touts, jouts)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(r))
    for key in FT_KEYS:
        assert tst[key] == jst[key], key
    return touts, tst


def _prompts(cfg, R, seed=0, S=8):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (R, S))


# -- slot blobs ---------------------------------------------------------------

def _ref_cache(rng):
    L, B, P, ps, KV, HD, mp = 2, 2, 8, 4, 2, 8, 3
    cache = jkv.init_paged_cache(L, B, P, ps, mp, KV, HD)
    return {
        **cache,
        "k_pages": jnp.asarray(rng.integers(-127, 128, (L, P, ps, KV, HD)),
                               jnp.int8),
        "v_pages": jnp.asarray(rng.integers(-127, 128, (L, P, ps, KV, HD)),
                               jnp.int8),
        "k_scale": jnp.asarray(rng.normal(1, .1, (L, P, KV)), jnp.float32),
        "v_scale": jnp.asarray(rng.normal(1, .1, (L, P, KV)), jnp.float32),
        "k_tail": jnp.asarray(rng.normal(0, 1, (L, B, ps, KV, HD)),
                              jnp.bfloat16),
        "v_tail": jnp.asarray(rng.normal(0, 1, (L, B, ps, KV, HD)),
                              jnp.bfloat16),
        "page_table": jnp.asarray([[0, 1, 1], [2, 3, 3]], jnp.int32),
        "pos": jnp.asarray([7, 6], jnp.int32),
    }


def test_slot_blob_matches_reference_and_round_trips():
    jc = _ref_cache(np.random.default_rng(0))
    tc = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32)
                                         if v.dtype == jnp.bfloat16 else v)
                              .copy()) for k, v in jc.items()}
    for name in ("k_tail", "v_tail"):
        tc[name] = tc[name].to(torch.bfloat16)
    before = {k: v.clone() for k, v in tc.items()}
    jblob = jkv.extract_slot_pages(jc, 0, [0, 1])
    blob = kvcache.extract_slot_pages(tc, 0, [0, 1])
    assert blob.keys() == jblob.keys()
    assert (blob["page_count"], blob["pos"]) == (2, 7) \
        == (jblob["page_count"], jblob["pos"])
    for name in ("k_pages", "v_pages", "k_scale", "v_scale", "k_tail",
                 "v_tail"):
        np.testing.assert_array_equal(blob[name].float().numpy(),
                                      np.asarray(jblob[name], np.float32),
                                      err_msg=name)
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    kvcache.insert_slot_pages(tc, 0, [5, 6], blob)
    jout = jkv.insert_slot_pages(jc, 0, [5, 6], jblob)
    assert {k: v.data_ptr() for k, v in tc.items()} == ptrs   # in place
    for name, t in tc.items():
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(jout[name], np.float32),
                                      err_msg=name)
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        assert torch.equal(tc[name][:, [5, 6]], before[name][:, [0, 1]])
    assert tc["page_table"][0].tolist() == [5, 6, 6]
    assert torch.equal(tc["page_table"][1], before["page_table"][1])
    with pytest.raises(ValueError, match="parked but"):
        kvcache.insert_slot_pages(tc, 0, [5], blob)


def test_evicted_sharer_restores_onto_private_pages():
    """A slot whose first page is shared with another: extracting and
    freeing it leaves the sharer the page (refcount 1, bytes intact);
    writing it back onto fresh pages makes it private again."""
    a = kvcache.PageAllocator(8)
    cache = kvcache.init_paged_cache(1, 2, 8, 4, 3, 1, 4)
    cache["k_pages"].copy_(torch.from_numpy(np.random.default_rng(1)
                                            .integers(-127, 128, (1, 8, 4, 1,
                                                                  4))
                                            .astype(np.int8)))
    donor = a.alloc(3)
    mine = donor[:1] + a.alloc(2)
    a.share(donor[:1])
    kvcache.insert_slot_pages(cache, 1, mine, kvcache.extract_slot_pages(
        cache, 0, donor))
    blob = kvcache.extract_slot_pages(cache, 1, mine)
    a.free(mine)
    assert a.refcount(donor[0]) == 1 and a.stats()["shared_pages"] == 0
    fresh = a.alloc(3)
    assert donor[0] not in fresh
    kvcache.insert_slot_pages(cache, 1, fresh, blob)
    assert all(a.refcount(p) == 1 for p in fresh + donor)
    assert torch.equal(cache["k_pages"][:, fresh], cache["k_pages"][:, donor])


# -- failover -----------------------------------------------------------------

@pytest.mark.parametrize("kv,spec,prefix,dscim", [
    ("float", None, False, "off"), ("int8", None, False, "kernel:dscim1:256"),
    ("int8", "dscim2:2", False, "off"), ("int8", None, "on", "off")])
def test_failover_replay_bitwise(setup, kv, spec, prefix, dscim):
    """A device loss at segment 2 restores the last snapshot and replays
    to the undisturbed run's tokens, bit for bit (the main path's DS-CIM
    kernel mode; the snapshot carries the prefix index); the restores
    copy back into the state's tensors, so the segment and extend steps
    bind once."""
    _, cfg, _, tp = setup
    cfg = dataclasses.replace(cfg, dscim=dscim)
    prompts = _prompts(cfg, 6)
    if prefix:
        prompts[1:4, :4] = prompts[0, :4]
    kw = dict(slots=3, seg_len=2, max_new=BUDGETS, eos_id=-1, kv=kv,
              page_size=4, spec=spec, prefix_cache=prefix, device="cpu")
    ref, _ = serve_continuous(cfg, tp, prompts, 6, **kw)
    lines = []
    outs, st = serve_continuous(cfg, tp, prompts, 6, snapshot_every=1,
                                injector=FailureInjector(fail_at=(2,)),
                                log=lines.append, **kw)
    assert st["replays"] == 1 and len(lines) == 1
    assert st["status"] == ["ok"] * 6
    for r, (a, b) in enumerate(zip(outs, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {r}")
    assert st["snapshots"]["restores"] == 1          # the loss only
    assert st["snapshots"]["count"] > st["segments"]
    assert st["bindings"] == {"segment": 1, "extend": 1 if prefix else 0}
    if prefix:
        assert st["prefix"]["hits"] == 3


def test_failover_matches_reference(setup):
    _, cfg, _, _ = setup
    _both(setup, _prompts(cfg, 6), 6, injector=(2,), slots=3, seg_len=2,
          max_new=BUDGETS, eos_id=-1, kv="int8", page_size=4,
          snapshot_every=1)


def test_failover_exhausts_replays(setup):
    _, cfg, _, tp = setup
    with pytest.raises(SimulatedHardwareFailure):
        serve_continuous(cfg, tp, _prompts(cfg, 2), 4, slots=2, seg_len=2,
                         eos_id=-1, max_new=[4, 4], device="cpu",
                         injector=FailureInjector(fail_at=(0, 1, 2, 3)),
                         snapshot_every=1, max_replays=2, log=_quiet)


def test_injector_takes_the_watchdog_and_integrity_faults():
    """The injector takes page flips, weight flips and the macro fault,
    and arms the fault spec at and after ``macro_fault_at``, as the
    reference's does."""
    inj = FailureInjector(
        page_flips={1: ((0, "k_pages", (0,) * 5, 1),)},
        weight_flips={0: (("layers/mlp/w_up", "q", 0, 1),)},
        macro_fault_at=2, macro_fault="stuck:3:40.0")
    ref = JFailureInjector(macro_fault_at=2, macro_fault="stuck:3:40.0")
    assert [inj.serving_fault(s) for s in range(5)] \
        == [ref.serving_fault(s) for s in range(5)] \
        == ["", "", "stuck:3:40.0", "stuck:3:40.0", "stuck:3:40.0"]
    assert FailureInjector(fail_at=(1,)).serving_fault(5) == ""


# -- eviction -----------------------------------------------------------------

EVICT_BUDGETS = np.array([6, 8, 8, 6, 6, 6], np.int32)
EVICT_PRIO = np.array([0, 0, 5, 0, 0, 0], np.int64)


@pytest.mark.parametrize("sample", ["greedy", "topk:20:0.9"])
def test_eviction_readmission_bitwise(setup, sample):
    """A high-priority admission preempts the youngest lower-priority
    slot; its pages, tail and sampler stream round-trip on the host and
    it resumes mid-stream: every request's tokens are bitwise those of a
    pool big enough never to evict (greedy and sampled), and the
    restores never rebind the segment step."""
    _, cfg, _, tp = setup
    prompts = _prompts(cfg, 6)
    kw = dict(slots=3, seg_len=2, max_new=EVICT_BUDGETS, eos_id=-1,
              kv="int8", page_size=4, sample=sample, rng_seed=4,
              device="cpu")
    big, _ = serve_continuous(cfg, tp, prompts, 8, **kw)
    outs, st = serve_continuous(cfg, tp, prompts, 8, priority=EVICT_PRIO,
                                n_pages=2 * kvcache.n_pages_for(16, 4), **kw)
    assert st["evictions"] >= 1 and st["readmissions"] >= 1
    assert st["evicted_requests"] and st["status"] == ["ok"] * 6
    for r, (a, b) in enumerate(zip(outs, big)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {r}")
    assert st["bindings"]["segment"] == 1
    assert st["pages"]["live_pages"] == 0


def test_eviction_matches_reference(setup):
    _, cfg, _, _ = setup
    _, st = _both(setup, _prompts(cfg, 6), 8, slots=3, seg_len=2,
                  max_new=EVICT_BUDGETS, eos_id=-1, kv="int8", page_size=4,
                  n_pages=2 * kvcache.n_pages_for(16, 4), priority=EVICT_PRIO)
    assert st["evictions"] >= 1


def test_eviction_of_a_prefix_sharer(setup):
    """Under the prefix cache, the evictee holds a page shared with the
    live donor: it is parked, the donor keeps the page, and the evictee
    comes back on private pages with its tokens those of the big pool
    run, as in the reference (tokens, fault stats, prefix counters)."""
    jcfg, cfg, jp, tp = setup
    prompts = _prompts(cfg, 4, seed=3)
    prompts[1:, :4] = prompts[0, :4]
    kw = dict(slots=3, seg_len=2, max_new=[6, 6, 6, 6], eos_id=-1,
              kv="int8", page_size=4, prefix_cache="on")
    big, _ = serve_continuous(cfg, tp, prompts, 6, device="cpu", **kw)
    outs, st = _both(setup, prompts, 6, n_pages=10,
                     priority=[0, 0, 5, 0], **kw)
    assert st["evicted_requests"] == [1] and st["readmissions"] == 1
    assert st["prefix"]["hits"] >= 2
    for r, (a, b) in enumerate(zip(outs, big)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {r}")
    assert st["pages"]["live_pages"] == 0


def test_eviction_requires_strictly_higher_priority(setup):
    _, cfg, _, _ = setup
    budgets = np.array([3, 4, 2, 3], np.int32)
    outs, st = _both(setup, _prompts(cfg, 4, seed=2), 4, slots=3, seg_len=2,
                     max_new=budgets, eos_id=-1, kv="int8", page_size=4,
                     n_pages=2 * kvcache.n_pages_for(12, 4),
                     priority=np.zeros(4, np.int64))
    assert st["evictions"] == 0
    assert [len(o) for o in outs] == budgets.tolist()


def test_priority_needs_int8_kv(setup):
    _, cfg, _, tp = setup
    with pytest.raises(ValueError, match="kv='int8'"):
        serve_continuous(cfg, tp, _prompts(cfg, 2), 4, priority=[0, 1],
                         device="cpu")


# -- deadlines ----------------------------------------------------------------

def test_deadline_step_cancellation(setup):
    """A step budget expires between segments: 'deadline', partial
    tokens kept, slot and pages recycled for the queue."""
    _, cfg, _, _ = setup
    outs, st = _both(setup, _prompts(cfg, 6), 6, slots=3, seg_len=2,
                     max_new=BUDGETS, eos_id=-1, kv="int8", page_size=4,
                     deadline_steps=[-1, 2, -1, -1, -1, -1])
    assert st["status"][1] == "deadline" and st["deadline_cancelled"] == 1
    assert 0 < len(outs[1]) < int(BUDGETS[1])
    for r in (0, 2, 3, 4, 5):
        assert st["status"][r] == "ok" and len(outs[r]) == int(BUDGETS[r])
    assert st["pages"]["live_pages"] == 0


def test_deadline_expired_while_waiting(setup):
    _, cfg, _, _ = setup
    outs, st = _both(setup, _prompts(cfg, 4), 6, slots=2, seg_len=2,
                     max_new=[6, 6, 6, 4], eos_id=-1,
                     deadline_steps=[-1, -1, -1, 2])
    assert st["status"][3] == "deadline" and len(outs[3]) == 0
    assert st["status"][:3] == ["ok"] * 3


class _FakeClock:
    """Every ``perf_counter()`` call advances one fake second."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 1.0
        return self.t


def test_deadline_s_anchors_at_admission(setup, monkeypatch):
    """With one slot, request 1 queues behind request 0's 16 tokens for
    over 6 fake seconds; its 6-second budget anchors at its admission,
    so it completes; a 0.5-second budget expires in service with partial
    tokens.  Both schedulers read the clock at the same points, so each
    leg's outcome is the reference's."""
    _, cfg, _, _ = setup
    prompts = _prompts(cfg, 2)
    budgets = np.array([16, 6], np.int32)

    def run(dl1):
        monkeypatch.setattr(serving, "time", _FakeClock())
        monkeypatch.setattr(jserving, "time", _FakeClock())
        return _both(setup, prompts, 16, slots=1, seg_len=2,
                     max_new=budgets, eos_id=-1, kv="int8", page_size=4,
                     deadline_s=[-1.0, dl1])

    outs, st = run(6.0)
    assert st["status"] == ["ok", "ok"] and st["deadline_cancelled"] == 0
    assert [len(o) for o in outs] == budgets.tolist()
    outs, st = run(0.5)
    assert st["status"] == ["ok", "deadline"]
    assert 0 < len(outs[1]) < int(budgets[1])
