"""Port parity, training's host side: AdamW and its schedules, the int8
gradient compression, the synthetic data and its pipeline, checkpoints,
and the port's ``TrainLoop`` on the CPU.  The reference and the port get
the same numpy inputs.  Contracts, each with the error measured on the
CPU:

* ``AdamW.update`` from equal parameters and gradients, three steps (the
  gradient norm clipped in one case, not in the other): every parameter
  and moment within 1e-6 of its max (measured 6e-8), ``count`` equal, the
  gradient norm within 1e-6 relative; ``cosine_schedule``,
  ``linear_warmup`` and ``global_norm`` within f32 rounding (2e-7
  relative; measured 0 and 6e-8);
* ``compress``: the int8 payload bitwise, the scale within 2e-7
  relative; ``decompress`` and ``init_error`` likewise;
* ``SyntheticLM`` (rows computed on demand) bitwise the reference's dense
  tables at vocab 512 and 4096: every cumulative row, batches of several
  steps and of each host of two, and ``unigram_entropy``;
  ``DataPipeline``'s batches and their order bitwise the reference's;
* checkpoints: a round trip bitwise (f32, int32, a 0-d leaf, empty
  dicts), keep-N and ``LATEST``, a leaf-count or shape mismatch raising,
  and the two packages restoring each other's checkpoints of a reduced
  model's parameters and AdamW state, every leaf bitwise;
* ``TrainLoop`` on the CPU (reduced olmo-1b, 20 steps of 8 x 64): the
  loss falls; a failure injected after the step-10 checkpoint replays
  every loss bitwise the clean run's; a second loop resumes at the saved
  step; through ``statistical:dscim1:256`` (4 steps of 4 x 16) a failure
  after the step-2 checkpoint replays every loss and the final
  parameters bitwise; a mesh without a joined process group raises, and
  the train CLI's ``--mesh`` takes the recurrent families on to ``torchrun``'s
  group (training under a mesh: tests/test_torch_train_mesh.py and
  tests/test_torch_mesh_recurrent.py).
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402,E501
from repro.data.pipeline import DataPipeline as JDataPipeline  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax, tree_to_numpy  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.runtime.elastic import mesh_from_spec  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

F32_RTOL = 2e-7


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(0, scale, s)).astype(np.float32)  # noqa: E731
    return {"layers": {"w": f(3, 8, 16), "ln": {"scale": f(3, 8)},
                       "empty": {}},
            "embed": f(32, 8), "head": f(8, 32)}


def _close(want, got, tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert want.shape == got.shape
    assert np.abs(want - got).max() <= tol * max(np.abs(want).max(), 1e-30)


# ---------------- optimizer ----------------

@pytest.mark.parametrize("gscale", [1e-3, 10.0])   # clip off / on
def test_adamw_update_matches_reference(gscale):
    params = _np_tree(0)
    grads = _np_tree(1, gscale)
    sched = (0.01, 2, 10)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(*sched))
    opt = adamw.AdamW(lr=adamw.cosine_schedule(*sched))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = params_from_jax(params, device="cpu")
    ts = opt.init(tp)
    jupdate = jax.jit(jopt.update)
    for _ in range(3):
        jp, js, jn = jupdate(jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts, tn = opt.update(tp, params_from_jax(grads, device="cpu"),
                                ts)
        _close(jn, tn, 1e-6)
    for want, got in zip(jax.tree.leaves((jp, js["m"], js["v"])),
                         leaves({"p": tp, "q_m": ts["m"], "r_v": ts["v"]})):
        _close(want, got, 1e-6)
    assert int(js["count"]) == int(ts["count"]) == 3
    assert ts["count"].dtype == torch.int32


def test_schedules_and_global_norm_match_reference():
    for jfn, fn in ((jadamw.cosine_schedule(3e-4, 5, 40),
                     adamw.cosine_schedule(3e-4, 5, 40)),
                    (jadamw.linear_warmup(1e-3, 7),
                     adamw.linear_warmup(1e-3, 7))):
        for step in range(0, 45, 3):
            _close(jfn(step), fn(step).numpy(), F32_RTOL)
    tree = _np_tree(2)
    _close(jadamw.global_norm(jax.tree.map(jnp.asarray, tree)),
           adamw.global_norm(params_from_jax(tree, device="cpu")).numpy(),
           F32_RTOL)


@pytest.mark.parametrize("scale", [0.0, 1e-3, 40.0])
def test_compression_matches_reference(scale):
    g = np.random.default_rng(3).normal(0, 1, (17, 33)).astype(np.float32)
    g *= scale
    jq, js = jcomp.compress(jnp.asarray(g))
    q, s = compression.compress(torch.from_numpy(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _close(js, s.numpy(), F32_RTOL)
    _close(jcomp.decompress(jq, js), compression.decompress(q, s).numpy(),
           F32_RTOL)
    err = compression.init_error(params_from_jax(_np_tree(0), device="cpu"))
    jerr = jcomp.init_error(_np_tree(0))
    for want, got in zip(jax.tree.leaves(jerr), leaves(err)):
        assert got.dtype == torch.float32 and not got.any()
        assert tuple(got.shape) == want.shape


# ---------------- data ----------------

@pytest.mark.parametrize("vocab", [512, 4096])
def test_synthetic_lm_bitwise_reference(vocab):
    ref, port = JSyntheticLM(vocab, seed=3), SyntheticLM(vocab, seed=3)
    rows = range(vocab) if vocab <= 512 else range(0, vocab, 7)
    for t in rows:
        np.testing.assert_array_equal(port.cum_row(t), ref.cum[t])
    for step in range(3):
        for host in range(2):
            want = ref.batch(4, 48, step=step, host=host, n_hosts=2)
            got = port.batch(4, 48, step=step, host=host, n_hosts=2)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])
    assert port.unigram_entropy() == ref.unigram_entropy()
    assert 0 < port.hit_rate() < 1


def test_pipeline_order_bitwise_reference():
    for n_hosts, host in ((1, 0), (2, 1)):
        ref = JDataPipeline(JSyntheticLM(64, seed=1), global_batch=4,
                            seq=8, host=host, n_hosts=n_hosts, start_step=7)
        port = DataPipeline(SyntheticLM(64, seed=1), global_batch=4, seq=8,
                            host=host, n_hosts=n_hosts, start_step=7)
        try:
            for want_step in range(7, 11):
                want, got = next(ref), next(port)
                assert got["step"] == want["step"] == want_step
                for k in ("tokens", "labels"):
                    np.testing.assert_array_equal(got[k], want[k])
        finally:
            ref.close()
            port.close()
        assert not port._thread.is_alive()
    with pytest.raises(ValueError):
        DataPipeline(SyntheticLM(64), global_batch=3, seq=8, n_hosts=2)


# ---------------- checkpoints ----------------

def _ckpt_tree(seed):
    tree = params_from_jax(_np_tree(seed), device="cpu")
    tree["count"] = torch.tensor(7, dtype=torch.int32)
    tree["ids"] = torch.arange(5, dtype=torch.int32)
    return tree


def test_checkpoint_round_trip_keep_n_and_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    trees = {s: _ckpt_tree(s) for s in (1, 2, 3)}
    for s, t in trees.items():
        ck.save(s, t, extras={"loss": float(s)})
    ck.wait()
    assert ck.latest_step() == 3
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_000000002",
                                                "step_000000003"]
    target = {k: v for k, v in _ckpt_tree(0).items()}
    got, extras = ck.restore(2, target)
    assert extras == {"loss": 2.0}
    for want, have in zip(leaves(trees[2]), leaves(got)):
        assert have.dtype == want.dtype and torch.equal(have, want)
    step, got, _ = ck.restore_latest(target)
    assert step == 3 and torch.equal(got["count"], trees[3]["count"])
    with open(tmp_path / "step_000000003" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["n_leaves"] == len(leaves(trees[3]))
    assert set(manifest) == {"step", "n_leaves", "treedef", "extras", "time"}
    bad = dict(target, extra=torch.zeros(2))
    with pytest.raises(ValueError, match="structure"):
        ck.restore(3, bad)
    bad = dict(target, embed=torch.zeros(31, 8))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(3, bad)


def test_checkpoint_copies_before_in_place_updates(tmp_path):
    """The tensors are copied to the host inside ``save``: an in-place
    update right after it does not reach the file."""
    ck = Checkpointer(str(tmp_path))
    tree = _ckpt_tree(4)
    want = {k: v.clone() for k, v in tree.items() if k != "layers"}
    ck.save(1, tree)
    tree["embed"].add_(1.0)
    ck.wait()
    got, _ = ck.restore(1, _ckpt_tree(0))
    assert torch.equal(got["embed"], want["embed"])


def test_checkpoints_cross_both_ways(tmp_path):
    """Parameters and AdamW state: the reference restores the port's
    checkpoint and the port the reference's, leaves bitwise."""
    jparams = jax.tree.map(jnp.asarray, _np_tree(5))
    jopt = jadamw.AdamW()
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    opt = adamw.AdamW()
    tparams = params_from_jax(_np_tree(5), device="cpu")
    tstate = {"params": tparams, "opt": opt.init(tparams)}
    tstate["opt"]["count"].fill_(5)
    for leaf in leaves(tstate["opt"]["m"]):
        leaf.normal_()
    Checkpointer(str(tmp_path / "port")).save(5, tstate, blocking=True)
    got, _ = JCheckpointer(str(tmp_path / "port")).restore(5, jstate)
    want = tree_to_numpy(tstate)
    assert len(jax.tree.leaves(got)) == len(leaves(want))
    for w, g in zip(leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), w)
        assert np.asarray(g).dtype == w.dtype

    jstate["opt"]["count"] = jnp.asarray(9, jnp.int32)
    jstate["opt"]["v"] = jax.tree.map(lambda a: a + 0.5, jstate["opt"]["v"])
    jck = JCheckpointer(str(tmp_path / "ref"))
    jck.save(9, jstate, blocking=True)
    step, got, _ = Checkpointer(str(tmp_path / "ref")).restore_latest(tstate)
    assert step == 9
    for w, g in zip(jax.tree.leaves(jstate), leaves(got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got["opt"]["count"]) == 9


# ---------------- the loop ----------------

def _loop(tmp, cfg=None, **kw):
    cfg = cfg or get_arch("olmo-1b").reduced()
    args = dict(steps=20, batch=8, seq=64, ckpt_dir=str(tmp), lr=1e-3,
                ckpt_every=10, log=lambda *a: None, device="cpu")
    args.update(kw)
    return train.TrainLoop(cfg, **args)


def test_train_loop_learns_replays_and_resumes(tmp_path):
    clean = _loop(tmp_path / "clean")
    clean.run()
    losses = [h["loss"] for h in clean.history]
    assert [h["step"] for h in clean.history] == list(range(20))
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])
    faulty = _loop(tmp_path / "faulty", fail_at=(13,))
    faulty.run()
    steps = [h["step"] for h in faulty.history]
    assert steps == list(range(13)) + list(range(10, 20))
    for h in faulty.history:
        assert h["loss"] == losses[h["step"]]           # bitwise
    resumed = _loop(tmp_path / "clean", steps=30)
    state = resumed.restore_or_init()
    assert state["step"] == 20
    assert int(state["opt"]["count"]) == 20


def test_train_loop_replays_a_noise_mode_bitwise(tmp_path):
    """Through ``statistical:dscim1:256``: the noise is keyed per call
    site, so a failure after the step-2 checkpoint replays step 2's loss
    bitwise, and the run's last state is the clean run's."""
    cfg = dataclasses.replace(get_arch("olmo-1b").reduced(),
                              dscim="statistical:dscim1:256")
    kw = dict(cfg=cfg, steps=4, batch=4, seq=16, ckpt_every=2)
    clean = _loop(tmp_path / "clean", **kw)
    want = clean.run()
    losses = [h["loss"] for h in clean.history]
    assert all(np.isfinite(losses))
    faulty = _loop(tmp_path / "faulty", fail_at=(3,), **kw)
    got = faulty.run()
    assert [h["step"] for h in faulty.history] == [0, 1, 2, 2, 3]
    for h in faulty.history:
        assert h["loss"] == losses[h["step"]]           # bitwise
    for a, b in zip(leaves(want["params"]), leaves(got["params"])):
        assert torch.equal(a, b)


def test_train_refuses_a_mesh():
    cfg = get_arch("olmo-1b").reduced()
    with pytest.raises(ValueError, match="no process group"):
        train.TrainLoop(cfg, steps=2, batch=2, seq=8,
                        mesh=mesh_from_spec("d1x1"), device="cpu")
    # a recurrent family under a mesh goes on to join the group torchrun
    # describes (tests/test_torch_mesh_recurrent.py trains it there)
    with pytest.raises(RuntimeError, match="RANK is not set"):
        train.main(["--arch", "zamba2-7b", "--reduced", "--steps", "1",
                    "--mesh", "d1x1", "--device", "cpu"])
