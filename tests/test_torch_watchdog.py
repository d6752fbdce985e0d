"""The accuracy watchdog, its degradation ladder and the stuck-at macro
fault in the port (``runtime/watchdog.py``, ``runtime/serving.py``
``exact_probe_spec`` / ``next_ladder_spec`` / ``watchdog_for_spec`` /
``_escalate`` / ``chaos_drill``, ``models/lm.py _parse_fault``,
``launch/steps.py make_probe_fn``), on the CPU, against the JAX
reference with the reference's parameters converted:

* ``AccuracyWatchdog.check`` trips and rels equal the reference's, in
  float64, bit for bit; the ladder's spec algebra equals the reference's
  over its spec list; ``watchdog_for_spec`` thresholds agree to 1e-12
  relative;
* ``_parse_fault`` and the faulted operator: every stride-th column reads
  the value, the others are the clean operator's bitwise, and both equal
  the reference's within f32 rounding;
* the probe's logits equal the reference's within ``PROBE_RTOL`` on one
  serve state (built by the reference, converted), and the state is
  bitwise what it was after a probe, a page flush included;
* the scheduler's NaN quarantine, drift trip and escalation, the float
  serving guard and the chaos drill: statuses, quarantined sets,
  escalation hops and counters equal the reference's, and within the
  port the requests no fault touched are bitwise the fault-free run.
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
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.serve import serve_continuous as jserve_continuous  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime.failover import FailureInjector as JFailureInjector  # noqa: E402
from repro.runtime.watchdog import AccuracyWatchdog as JAccuracyWatchdog  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import prepare_params, serve_continuous  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.failover import FailureInjector  # noqa: E402
from repro_torch.runtime.watchdog import (AccuracyWatchdog,  # noqa: E402
                                          StepHang, Watchdog)

ARCH = "qwen3-0.6b"
SPEC = "kernel:dscim2:64"
# probe logits, port vs reference on one state: f32 summation order of
# the float ops around exact int8 products, relative to max |logit|
PROBE_RTOL = 1e-5
# the faulted operator's clean columns, port vs reference
OP_RTOL = 1e-5
LADDER_SPECS = ("kernel:dscim2:64", "kernel:dscim1:256", "exact:dscim1:256",
                "lut+attn:dscim2:64:opt", "kernel+attn:dscim2:64",
                "bitmatmul:dscim2:128", "statistical:dscim1:64:opt",
                "exact+attn:dscim2:64", "off", "float")


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), dscim=SPEC)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dscim=SPEC)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


# -- the watchdog and the ladder's algebra -----------------------------------

@pytest.mark.parametrize("threshold", [0.05, 0.5, 3.0])
def test_check_matches_reference(threshold):
    rng = np.random.default_rng(int(threshold * 100))
    exact = rng.normal(0, 1, (5, 40))
    serving_ = exact + rng.normal(0, 1, (5, 1)) * rng.normal(0, 1, (5, 40))
    serving_[3, 7] = np.nan
    serving_[4, 0] = np.inf
    live = np.array([True, True, False, True, True])
    mine, ref = AccuracyWatchdog(threshold), JAccuracyWatchdog(threshold)
    for _ in range(2):
        t1, r1 = mine.check(serving_.astype(np.float32), exact, live)
        t2, r2 = ref.check(serving_.astype(np.float32), exact, live)
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(r1, r2)
        assert r1.dtype == np.float64
    assert (mine.n_probes, mine.n_trips) == (ref.n_probes, ref.n_trips)
    assert len(mine.history) == 2 and mine.n_trips >= 2
    np.testing.assert_array_equal(mine.live_rels(), np.concatenate(
        [r1[live], r1[live]]))
    np.testing.assert_array_equal(mine.live_rels(1), r1[live])


def test_probe_cadence_and_guard():
    wd = AccuracyWatchdog(0.5, probe_every=3)
    assert [wd.should_probe(s) for s in range(7)] == \
        [JAccuracyWatchdog(0.5, 3).should_probe(s) for s in range(7)]
    assert not AccuracyWatchdog(None).should_probe(0)
    with pytest.raises(ValueError, match="probe_every"):
        AccuracyWatchdog(0.5, probe_every=0)


def test_step_watchdog_counts_stragglers_and_hangs():
    seen = []
    wd = Watchdog(straggler_factor=2.0, hang_timeout=0.05,
                  on_straggler=seen.append)
    try:
        with wd.step():
            pass
        wd.ema = 1e-6                       # the next step is a straggler
        with wd.step():
            sum(range(20000))
        assert wd.n_stragglers == 1 and seen
        with wd.step():
            import time
            time.sleep(0.3)                 # past hang_timeout while armed
        with pytest.raises(StepHang):
            wd.check_hang()
        wd.reset()
        wd.check_hang()
    finally:
        wd.close()


@pytest.mark.parametrize("spec", LADDER_SPECS)
def test_ladder_specs_match_reference(spec):
    assert serving.next_ladder_spec(spec) == jserving.next_ladder_spec(spec)
    assert serving.exact_probe_spec(spec) == jserving.exact_probe_spec(spec)


@pytest.mark.parametrize("spec", ["kernel:dscim2:64", "kernel:dscim1:256",
                                  "lut:dscim1:128:opt"])
def test_watchdog_for_spec_threshold(spec):
    mine = serving.watchdog_for_spec(spec, margin=2.5, probe_every=3)
    ref = jserving.watchdog_for_spec(spec, margin=2.5, probe_every=3)
    assert mine.probe_every == 3
    assert abs(mine.rel_threshold - ref.rel_threshold) \
        <= 1e-12 * ref.rel_threshold


# -- the stuck-at macro fault -------------------------------------------------

@pytest.mark.parametrize("fault", ["stuck:5:24.0", "stuck:1:-3.5",
                                   "stuck:5", "stuck:0:1.0", "open:2:1.0"])
def test_parse_fault_matches_reference(fault):
    try:
        want = jlm._parse_fault(fault)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            lm._parse_fault(fault)
        return
    assert lm._parse_fault(fault) == want


@pytest.mark.parametrize("spec", ["lut:dscim1:256", "kernel:dscim2:64",
                                  "exact:dscim1:256"])
def test_faulted_operator_columns(spec):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (3, 200)).astype(np.float32)
    w = rng.normal(0, 1, (200, 12)).astype(np.float32)
    op = lm._linear_for(spec, "stuck:4:7.5")
    clean = lm._linear_for(spec)
    assert op.group_k == clean.group_k and op.mode == clean.mode
    assert op.batch_invariant == clean.batch_invariant
    y = op(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    yc = clean(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert (y[:, ::4] == 7.5).all()
    keep = np.arange(12) % 4 != 0
    np.testing.assert_array_equal(y[:, keep], yc[:, keep])
    ref = np.asarray(jlm._linear_for(spec, None, "stuck:4:7.5")(
        jnp.asarray(x), jnp.asarray(w)))
    assert (ref[:, ::4] == 7.5).all()
    np.testing.assert_allclose(y, ref, rtol=OP_RTOL,
                               atol=OP_RTOL * np.abs(ref).max())


def test_fault_reaches_every_linear(setup):
    """The faulted config's decode differs from the healthy one (the
    head's stuck columns read the value) and leaves the params alone."""
    _, cfg, _, tp = setup
    served = prepare_params(cfg, tp, "cpu")
    before = [t.clone() for t in steps._leaves(served)]
    cfg_f = dataclasses.replace(cfg, dscim_fault="stuck:3:40.0")
    tokens = torch.as_tensor([[1, 2, 3, 4, 5, 6, 7]])
    lg, _ = lm.prefill(served, cfg_f, tokens)
    lg0, _ = lm.prefill(served, cfg, tokens)
    assert (lg[0, ::3] == 40.0).all() and not torch.equal(lg, lg0)
    for a, b in zip(before, steps._leaves(served)):
        assert torch.equal(a, b)


# -- the probe ----------------------------------------------------------------

def _ref_state(jcfg, jp, kv):
    """A reference serve state with two admitted slots (prompt 7: the
    next decode flushes a page at page size 4; prompt 5) and one idle
    slot, and its conversion to the port's layout."""
    jprep = jsteps.prepare_serving_params(jcfg, jp)
    st = jsteps.init_serve_state(jcfg, 3, 16, kv=kv, page_size=4)
    admit = jsteps.make_admit_fn(jcfg, eos_id=-1, jit=False)
    rng = np.random.default_rng(5)
    for slot, S in ((0, 7), (1, 5)):
        prompt = jnp.asarray(rng.integers(0, jcfg.vocab, (1, S)), jnp.int32)
        st, _ = admit(jprep, st, prompt, jnp.int32(slot),
                      jnp.arange(slot * 4, slot * 4 + 4, dtype=jnp.int32),
                      jnp.int32(6))
    cache = {}
    for k, v in st["cache"].items():
        a = np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                       else v)
        t = torch.from_numpy(a.copy())
        cache[k] = t.to(torch.bfloat16) if v.dtype == jnp.bfloat16 else t
    tstate = {"tok": torch.from_numpy(np.asarray(st["tok"]).copy()),
              "done": torch.from_numpy(np.asarray(st["done"]).copy()),
              "cache": cache}
    return jprep, st, tstate


@pytest.mark.parametrize("kv", ["int8", "float"])
def test_probe_matches_reference_and_leaves_state(setup, kv):
    jcfg, cfg, jp, tp = setup
    jprep, jst, tst = _ref_state(jcfg, jp, kv)
    jcfg_ex = dataclasses.replace(jcfg, dscim=jserving.exact_probe_spec(SPEC))
    cfg_ex = dataclasses.replace(cfg, dscim=serving.exact_probe_spec(SPEC))
    ref = np.asarray(jsteps.make_probe_fn(jcfg_ex, jit=False)(jprep, jst))
    served = prepare_params(cfg, tp, "cpu")
    before = {k: v.clone() for k, v in tst["cache"].items()}
    got = steps.make_probe_fn(cfg_ex)(served, tst).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=PROBE_RTOL * np.abs(ref).max())
    for k, v in before.items():
        assert torch.equal(tst["cache"][k], v), k
    if kv == "int8":       # the slot at pos 7 flushed a page in the probe
        assert int(tst["cache"]["pos"][0]) % 4 == 3


# -- the scheduler ------------------------------------------------------------

class _InfScale(FailureInjector):
    """Sets one live v scale of slot 0 to +inf at segment 1, in place."""

    def corrupt_cache(self, segment, cache, slot_pages):
        if segment != 1 or ("inf", 1) in self.fired or slot_pages[0] is None:
            return cache, []
        self.fired.add(("inf", 1))
        cache["v_scale"][0, int(slot_pages[0][0]), 0] = float("inf")
        return cache, [0]


class _JInfScale(JFailureInjector):
    def corrupt_cache(self, segment, cache, slot_pages):
        if segment != 1 or ("inf", 1) in self.fired or slot_pages[0] is None:
            return cache, []
        self.fired.add(("inf", 1))
        pid = int(slot_pages[0][0])
        return dict(cache, v_scale=cache["v_scale"].at[0, pid, 0]
                    .set(np.inf)), [0]


def _hops(st):
    return [(e["request"], e["frm"], e["to"], e["reason"], e["accepted"])
            for e in st["escalations"]]


def _agree(st, jst):
    for key in ("status", "quarantined", "corrupted_requests", "probes",
                "probe_trips", "replays", "segments"):
        assert st[key] == jst[key], key
    assert _hops(st) == _hops(jst)


def test_nonfinite_quarantine_escalates(setup):
    jcfg, cfg, jp, tp = setup
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 8))
    budgets = np.asarray([8, 6, 8, 5], np.int32)
    kw = dict(slots=2, seg_len=2, max_new=budgets, eos_id=-1, kv="int8",
              page_size=4, snapshot_every=1, log=_quiet)
    outs, st = serve_continuous(cfg, tp, prompts, 8, device="cpu",
                                monitor=AccuracyWatchdog(None),
                                injector=_InfScale(), **kw)
    _, jst = jserve_continuous(jcfg, jp, prompts.astype(np.int32), 8,
                               monitor=JAccuracyWatchdog(None),
                               injector=_JInfScale(), **kw)
    _agree(st, jst)
    assert st["quarantined"] == [0] and st["probes"] == 0
    assert _hops(st)[0] == (0, SPEC, "kernel:dscim1:256", "nonfinite", True)
    assert [len(o) for o in outs] == budgets.tolist()
    ref, _ = serve_continuous(cfg, tp, prompts, 8, device="cpu", **kw)
    for r in (1, 2, 3):
        np.testing.assert_array_equal(outs[r], ref[r], err_msg=str(r))


def test_macro_fault_drift_trips_and_escalates(setup):
    jcfg, cfg, jp, tp = setup
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 8))
    budgets = np.asarray([6, 5, 6, 5], np.int32)
    kw = dict(slots=2, seg_len=2, max_new=budgets, eos_id=-1, kv="int8",
              page_size=4, log=_quiet)
    healthy = serving.watchdog_for_spec(SPEC, probe_every=1)
    outs_h, st_h = serve_continuous(cfg, tp, prompts, 6, device="cpu",
                                    monitor=healthy, **kw)
    jhealthy = jserving.watchdog_for_spec(SPEC, probe_every=1)
    _, jst_h = jserve_continuous(jcfg, jp, prompts.astype(np.int32), 6,
                                 monitor=jhealthy, **kw)
    _agree(st_h, jst_h)
    assert st_h["probe_trips"] == 0 and not st_h["quarantined"]
    rels = np.concatenate([h[np.isfinite(h)] for h in healthy.history])
    jrels = np.concatenate([h[np.isfinite(h)] for h in jhealthy.history])
    assert rels.max() < healthy.rel_threshold
    np.testing.assert_allclose(rels, jrels, rtol=1e-3)
    plain, _ = serve_continuous(cfg, tp, prompts, 6, device="cpu", **kw)
    for a, b in zip(outs_h, plain):             # probing changes nothing
        np.testing.assert_array_equal(a, b)

    faulted = serving.watchdog_for_spec(SPEC, probe_every=1)
    inj = FailureInjector(macro_fault_at=0, macro_fault="stuck:3:40.0")
    outs_f, st_f = serve_continuous(cfg, tp, prompts, 6, device="cpu",
                                    monitor=faulted, injector=inj, **kw)
    _, jst_f = jserve_continuous(
        jcfg, jp, prompts.astype(np.int32), 6,
        monitor=jserving.watchdog_for_spec(SPEC, probe_every=1),
        injector=JFailureInjector(macro_fault_at=0,
                                  macro_fault="stuck:3:40.0"), **kw)
    _agree(st_f, jst_f)
    assert st_f["probe_trips"] >= 2 and st_f["quarantined"]
    assert (SPEC, "kernel:dscim1:256") in {h[1:3] for h in _hops(st_f)}
    assert st_f["status"] == ["ok"] * 4
    assert [len(o) for o in outs_f] == budgets.tolist()
    # faulted from segment 0: only the faulted runner ever binds; the
    # ladder's serve_batch runs capture nothing on the CPU
    assert st_f["bindings"]["segment"] == 1
    assert st_f["escalation_captures"] == 0
    faulted_rels = np.concatenate(faulted.history)
    assert faulted_rels.min() > rels.max()


def test_monitor_rejects_float_serving(setup):
    jcfg, cfg, jp, tp = setup
    prompts = np.zeros((2, 8), np.int64)
    kw = dict(slots=2, seg_len=2, eos_id=-1)
    with pytest.raises(ValueError, match="exact-mode twin") as ours:
        serve_continuous(dataclasses.replace(cfg, dscim="off"), tp, prompts,
                         4, device="cpu", monitor=AccuracyWatchdog(0.5), **kw)
    with pytest.raises(ValueError) as ref:
        jserve_continuous(dataclasses.replace(jcfg, dscim="off"), jp,
                          prompts.astype(np.int32), 4,
                          monitor=JAccuracyWatchdog(0.5), **kw)
    assert str(ours.value) == str(ref.value)


def test_straggler_watchdog_in_the_scheduler(setup):
    """A ``Watchdog`` around every segment: no hang, the tokens those of
    the run without one."""
    _, cfg, _, tp = setup
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (3, 8))
    kw = dict(slots=2, seg_len=2, eos_id=-1, kv="int8", page_size=4,
              device="cpu", log=_quiet)
    wd = Watchdog(hang_timeout=60.0)
    try:
        outs, st = serve_continuous(cfg, tp, prompts, 5, watchdog=wd, **kw)
    finally:
        wd.close()
    ref, _ = serve_continuous(cfg, tp, prompts, 5, **kw)
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)
    assert st["stragglers"] == wd.n_stragglers and st["replays"] == 0


@pytest.fixture(scope="module")
def ref_chaos():
    return jserving.chaos_drill(log=_quiet)


def test_chaos_drill_matches_reference(setup, ref_chaos):
    _, _, _, tp = setup
    report = serving.chaos_drill(params=tp, device="cpu", log=_quiet)
    assert report == ref_chaos
    assert report["replays"] == 1 and report["deadline_cancelled"] == 1
    assert report["clean"] and report["escalations"] >= 1


def test_chaos_drill_on_port_weights():
    report = serving.chaos_drill(device="cpu", log=_quiet)
    assert report["replays"] == 1 and report["probe_trips"] >= 1
