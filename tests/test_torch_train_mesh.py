"""Training under a mesh (the port's ``torch.distributed`` SPMD), held on
the CPU over gloo against one device and against the JAX reference.

Two groups of ranks run at once (``tests/_torch_train_rank.py``, a
``file://`` store under the test's temporary directory, a timeout each):
four ranks (``data=2,model=2``: the train step, ``TrainLoop`` with a
failure, checkpoint round trips, ``mesh_from_env``) and two (``pod=2``:
``compressed_psum_tree``, the pipeline; ``model=2``: the train step).
The reference's values come from one JAX subprocess with 8 fake host
devices (``tests/_jax_train_mesh_ref.py``).  Both packages start from
the reference's ``init_params`` of the reduced configs and one batch of
4 x 16.  Contracts:

* ``make_train_step`` under ``model=2`` (no DP split): loss, gradient
  norm, parameters and AdamW state after two steps bitwise the port's
  one-device step, for reduced olmo-1b; granite-moe-1b-a400m trains with
  expert parallelism (each rank routes its half of the sequence, as the
  reference's mesh step does, so its aux is the mean of the halves'):
  its first loss within ``DP_RTOL`` of the reference's step on a 1x2
  mesh and its gradient norm within ``EP_REF_RTOL``, and with the aux's
  weight 0 its losses and gradient norms within ``DP_RTOL`` of one
  device (measured bitwise) and its parameters within ``PARAM_ATOL``;
* ``make_train_step`` under ``model=2`` through ``lut:dscim1:256``
  (olmo-1b): losses, gradient norms, parameters and AdamW state after two
  steps bitwise the one-device steps at the same spec;
* under ``data=2,model=2`` (each rank's half of the batch, the gradients
  averaged over ``data``): each step's loss and gradient norm within
  ``DP_RTOL`` of one device for olmo-1b (f32 sums in another order;
  measured 0 at the first step, 1.3e-6 at the second), within
  ``MOE_DP_RTOL`` for granite (the load-balance aux is the mean of each
  half's aux, as the reference averages it over its mesh, whose own 2x2
  loss is 5.6e-4 off its one device; measured 3.1e-4 and 1.2e-3); the
  parameters after two steps within ``PARAM_ATOL`` (measured 4.7e-5 for
  olmo-1b).  Granite's parameters, which differ by 2.5e-3 with the aux
  on (two steps at lr 1e-3 reach 2e-3, so that bound would pass no
  update), are held on a run with the aux's weight 0 in both
  (``steps.AUX_WEIGHT`` patched): only f32 order is left, its losses and
  gradient norms within ``DP_RTOL`` (measured 2.9e-6) and its
  parameters within ``PARAM_ATOL`` (measured 4.2e-6); the first
  loss within the reference test's ``rtol=2e-3`` of the reference's 2x2
  mesh loss and of its one-device loss; granite's first loss within
  ``DP_RTOL`` of the reference's 2x2 step (measured 1.5e-6) and its
  gradient norm within ``EP_REF_RTOL`` (measured 3.1e-5);
* the autograd collectives (``parallel.py``) over gloo: ``all_gather``
  (replicated consumers), ``split`` and ``all_to_all`` give the
  gradients of the one-process composition they stand for, bitwise;
* ``TrainLoop(mesh=)``: a failure injected on rank 0 alone at step 3
  makes every rank restore the step-2 checkpoint and replay, every loss
  bitwise the failure-free mesh run's;
* checkpoints: the mesh run's last checkpoint restores on one device in
  the port and in the reference bitwise its final state; a one-device
  checkpoint written by either package restores under the mesh into
  placed pieces that gather back to it bitwise;
* ``compressed_psum_tree`` over pod=2 bitwise the reference's under
  ``shard_map``; ``pipeline_forward`` over pod=2 within 1e-6 of the
  reference's last-pod result (XLA's and torch's GELU and matmul round
  differently; measured 1e-7), on every rank; ``pp_dryrun``'s record and
  its result bitwise the stages applied in turn;
* ``opt_state_specs`` the reference's on a JAX ``AbstractMesh`` of the
  same sizes (a bare axis name read as a 1-tuple), and ``to_shardings``
  of the params and the AdamW state by those specs the same pieces as
  ``shard_params`` and ``AdamW.init`` of the placed params;
* ``mesh_from_env``: the reference test's cases on 8 devices through
  ``resolve_mesh_spec(spec, 8)``, and on the 4-rank group with the world
  size standing in for the device count;
* the train CLI (``--mesh d2x2``) and ``examples/serve_dscim_torch.py``
  (``--mesh model=2``) under ``torchrun`` on the CPU: each exits 0 and
  rank 0 alone prints;
* the collective payload by kind (launch/cost.py ``CostMode``) of one
  olmo-1b train step on the ``data=2,model=2`` group equal to what
  launch/dryrun.py's stand-in 2x2 mesh counts for it on meta tensors;
* ``ParallelCtx.sp`` under ``model=2``: olmo-1b's and rwkv6-7b's train
  step and prefill bitwise ``sp`` off, with more all-gather payload (the
  residual stream's slices gathered).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402,E501
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax, tree_to_numpy  # noqa: E402
from repro_torch.launch import sharding, steps  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel import ParallelCtx, Sharded  # noqa: E402
from repro_torch.runtime.elastic import resolve_mesh_spec  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_train_rank.py"
JAX_REF = ROOT / "tests" / "_jax_train_mesh_ref.py"
SPAWN_TIMEOUT_S = 240
GROUPS = {"data=2,model=2": (4, "train_2x2,train_2x2_no_aux,loop,elastic,"
                                 "collectives,payload_2x2"),
          "pod=2": (2, "psum,pipe,train_tp,train_tp_no_aux,sp_tp,"
                       "train_tp_lut")}
ARCHS = ("olmo-1b", "granite-moe-1b-a400m")
TRAIN_STEPS = 2
DP_RTOL = 1e-5           # loss and gradient norm, f32 order of the sums
MOE_DP_RTOL = 3e-3       # the aux over each half's tokens
MOE = "granite-moe-1b-a400m"
PARAM_ATOL = 1e-4        # parameters after two steps at lr 1e-3
REF_RTOL = 2e-3          # tests/test_launch_dist.py's own bound
# the granite gradient norm against the reference's mesh step: its own
# mesh reorders f32 sums (with the aux off, where the math is one
# device's, its 2x2 norm is 6.6e-5 off its one device); the port's
# measured 1.3e-4 (model=2) and 3.1e-5 (data=2,model=2) off it
EP_REF_RTOL = 3e-4
PIPE_ATOL = 1e-6
DSCIM_LUT = "lut:dscim1:256"     # the model=2 job through a DS-CIM mode


def _inputs(tmp: Path) -> dict:
    rng = np.random.default_rng(0)
    params = {}
    for arch in ARCHS:
        cfg = JARCHS[arch].reduced()
        params[arch] = jax.tree.map(
            np.asarray, jget_model(cfg).init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    vocab = JARCHS["olmo-1b"].reduced().vocab
    batch = {k: rng.integers(0, vocab, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}

    def f(*shape, s=1.0):
        return rng.normal(0, s, shape).astype(np.float32)
    return {"params": params, "batch": batch,
            "psum_g": {"a": f(2, 8, 16), "b": {"c": f(2, 5, s=3.0)}},
            "psum_e": {"a": f(2, 8, 16, s=0.01), "b": {"c": f(2, 5, s=0.01)}},
            "pipe": (f(2, 2, 64, 128, s=0.125), f(2, 2, 128, 64, s=0.09),
                     f(4, 2, 8, 64)),
            "ckpts": _one_device_ckpts(tmp, params["olmo-1b"]),
            "tmp": str(tmp)}


def _one_device_ckpts(tmp: Path, params) -> dict:
    """One-device checkpoints of the reduced olmo-1b's params and a
    non-zero AdamW state, written by each package: {name: directory}."""
    t = params_from_jax(params, device="cpu")
    state = {"params": t, "opt": AdamW().init(t)}
    state["opt"]["count"].fill_(7)
    g = torch.Generator().manual_seed(1)
    for leaf in leaves(state["opt"]["m"]) + leaves(state["opt"]["v"]):
        leaf.copy_(torch.rand(leaf.shape, generator=g))
    Checkpointer(str(tmp / "one_port")).save(7, state, blocking=True)
    jstate = jax.tree.map(jnp.asarray, tree_to_numpy(state))
    jstate["opt"]["count"] = jnp.asarray(9, jnp.int32)
    JCheckpointer(str(tmp / "one_ref")).save(9, jstate, blocking=True)
    return {"port": str(tmp / "one_port"), "ref": str(tmp / "one_ref")}


def _spawn(tmp: Path, inp: dict):
    src = tmp / "inputs.pkl"
    with open(src, "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {}
    for i, (name, (world, jobs)) in enumerate(GROUPS.items()):
        d = tmp / f"group{i}"
        d.mkdir()
        procs[name] = [(subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world),
             str(d / "store"), jobs, str(src), str(d / f"r{r}.pkl")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), d / f"r{r}.pkl") for r in range(world)]
    jenv = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs["jax"] = [(subprocess.Popen(
        [sys.executable, str(JAX_REF), str(src), str(tmp / "ref.pkl"),
         "train,train12,psum,pipe,elastic"],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), tmp / "ref.pkl")]
    return procs, time.monotonic() + SPAWN_TIMEOUT_S


def _collect(procs, deadline) -> dict:
    """{group: [rank results]} (the reference's under 'jax').  A process
    that fails or outlives its deadline fails the fixture, with its
    output."""
    failed = []
    for name, ranks in procs.items():
        for p, _ in ranks:
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failed.append(f"{name}: timed out\n{out[-3000:]}")
                continue
            if p.returncode:
                failed.append(f"{name}: rc {p.returncode}\n{out[-3000:]}")
    if failed:
        for ranks in procs.values():
            for p, _ in ranks:
                if p.poll() is None:
                    p.kill()
        pytest.fail("\n".join(failed))
    res = {}
    for name, ranks in procs.items():
        res[name] = []
        for _, path in ranks:
            with open(path, "rb") as f:
                res[name].append(pickle.load(f))
    return res


def _one_device(inp, archs=ARCHS, dscim="off") -> dict:
    """The port's one-device train steps at ``dscim``: {arch: (metrics,
    params, state)}, as the ranks report theirs."""
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(get_arch(arch).reduced(), dscim=dscim)
        params = params_from_jax(inp["params"][arch], device="cpu")
        opt = AdamW(lr=1e-3)
        state = opt.init(params)
        step = make_train_step(cfg, opt, "cpu")
        metrics = []
        for _ in range(TRAIN_STEPS):
            params, state, m = step(params, state, inp["batch"])
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[arch] = (metrics, tree_to_numpy(params), tree_to_numpy(state))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the groups' and the reference's results, the port's
    one-device steps)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    inp = _inputs(tmp)
    procs, deadline = _spawn(tmp, inp)
    one = _one_device(inp)
    with mock.patch.object(steps, "AUX_WEIGHT", 0.0):
        one["no_aux"] = _one_device(inp, archs=(MOE,))
    one["lut"] = _one_device(inp, archs=("olmo-1b",), dscim=DSCIM_LUT)
    res = _collect(procs, deadline)
    return inp, res, res.pop("jax")[0], one


def _same_on_every_rank(ranks, job):
    first = pickle.dumps(ranks[0][job])
    for r, res in enumerate(ranks[1:], 1):
        assert pickle.dumps(res[job]) == first, f"rank {r} differs on {job}"
    return ranks[0][job]


def _assert_trees_equal(got, want):
    assert len(leaves(got)) == len(leaves(want))
    for g, w in zip(leaves(got), leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_model2_bitwise_one_device(runs, arch):
    _, res, ref, one = runs
    metrics, params, state = _same_on_every_rank(res["pod=2"],
                                                 "train_tp")[arch]
    want_m, want_p, want_s = one[arch]
    if arch != MOE:
        assert metrics == want_m
        _assert_trees_equal(params, want_p)
        _assert_trees_equal(state, want_s)
        return
    # expert parallelism: the aux is the mean of each sequence slice's,
    # as the reference's on the same mesh shape
    ref_mesh = ref["train12"][arch][1]
    np.testing.assert_allclose(metrics[0][0], ref_mesh[0], rtol=DP_RTOL)
    np.testing.assert_allclose(metrics[0][1], ref_mesh[1], rtol=EP_REF_RTOL)
    # with the aux's weight 0 only f32 order is left against one device
    no_aux, params, _ = _same_on_every_rank(res["pod=2"],
                                            "train_tp_no_aux")[arch]
    want_m, want_p, _ = one["no_aux"][arch]
    np.testing.assert_allclose(np.asarray(no_aux), np.asarray(want_m),
                               rtol=DP_RTOL, atol=0)
    for g, w in zip(leaves(params), leaves(want_p)):
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0)


def test_train_step_model2_through_dscim_bitwise_one_device(runs):
    """olmo-1b through ``DSCIM_LUT`` under model=2: each rank runs the
    DS-CIM linear on whole gathered weights and its own rows' scales, so
    two steps are the one-device steps bitwise."""
    _, res, _, one = runs
    metrics, params, state = _same_on_every_rank(res["pod=2"],
                                                 "train_tp_lut")["olmo-1b"]
    want_m, want_p, want_s = one["lut"]["olmo-1b"]
    assert metrics == want_m
    assert metrics != one["olmo-1b"][0]          # the spec was read
    _assert_trees_equal(params, want_p)
    _assert_trees_equal(state, want_s)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_2x2_close_to_one_device_and_reference(runs, arch):
    _, res, ref, one = runs
    metrics, params, state = _same_on_every_rank(res["data=2,model=2"],
                                                 "train_2x2")[arch]
    want_m, want_p, _ = one[arch]
    rtol = MOE_DP_RTOL if arch.startswith("granite") else DP_RTOL
    np.testing.assert_allclose(np.asarray(metrics), np.asarray(want_m),
                               rtol=rtol, atol=0)
    ref_one, ref_mesh = ref["train"][arch]
    if arch == MOE:          # the parameters held with the aux's weight 0
        # expert parallelism splits the sequence over model as the
        # reference's 2x2 step does
        np.testing.assert_allclose(metrics[0][0], ref_mesh[0], rtol=DP_RTOL)
        np.testing.assert_allclose(metrics[0][1], ref_mesh[1],
                                   rtol=EP_REF_RTOL)
        no_aux, params, _ = _same_on_every_rank(
            res["data=2,model=2"], "train_2x2_no_aux")[arch]
        want_m, want_p, _ = one["no_aux"][arch]
        np.testing.assert_allclose(np.asarray(no_aux), np.asarray(want_m),
                                   rtol=DP_RTOL, atol=0)
    for g, w in zip(leaves(params), leaves(want_p)):
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0)
    assert int(state["count"]) == TRAIN_STEPS
    np.testing.assert_allclose(metrics[0][0], ref_mesh[0], rtol=REF_RTOL)
    np.testing.assert_allclose(metrics[0][0], ref_one[0], rtol=REF_RTOL)


@pytest.mark.parametrize("op", ["all_gather", "split", "all_to_all"])
def test_autograd_collectives_match_one_process(runs, op):
    _, res, _, _ = runs
    for r in res["data=2,model=2"]:
        got, want = r["collectives"][op]
        np.testing.assert_array_equal(got, want)


def test_collective_payload_matches_the_dry_run(runs):
    """The dry run's stand-in data=2,model=2 mesh (launch/dryrun.py, meta
    tensors, one process) counts, for the same reduced olmo-1b train
    step, the collective payload by kind that a real gloo run of the step
    moves (launch/cost.py ``CostMode`` in rank 0 of the 4-rank group)."""
    from repro_torch.configs.base import Shape
    from repro_torch.launch import dryrun
    _, res, _, _ = runs
    got, ops = res["data=2,model=2"][0]["payload_2x2"]
    B, S = 4, 16
    cfg = dataclasses.replace(get_arch("olmo-1b").reduced(),
                              shapes=(Shape("t", S, B, "train"),))
    _, _, cm = dryrun.run_cell(cfg, "t", dryrun.stand_in(
        (2, 2), ("data", "model")))
    assert set(got) == {"all-gather", "all-reduce"}
    assert cm.cost.coll_by_kind == got
    assert cm.cost.coll_ops == ops


def test_sequence_parallel_is_bitwise_sp_off(runs):
    """``ParallelCtx.sp`` under model=2 (tests/_torch_train_rank.py
    ``job_sp_tp``): olmo-1b's and rwkv6-7b's train step (loss, norm, the
    params and AdamW state after it) and prefill bitwise sp off, on both
    ranks; the residual stream's slices are really gathered (more
    all-gather payload)."""
    _, res, _, _ = runs
    for rank in res["pod=2"]:
        got = rank["sp_tp"]
        assert pickle.dumps(got[True]) == pickle.dumps(got[False])
        on, off = got["payload", True], got["payload", False]
        assert on["all-gather"] > off["all-gather"]


def test_train_loop_replays_a_one_rank_failure_bitwise(runs):
    _, res, _, _ = runs
    got = _same_on_every_rank(res["data=2,model=2"], "loop")
    clean = dict(got["clean"])
    assert sorted(clean) == list(range(6))
    steps = [s for s, _ in got["faulty"]]
    assert steps == [0, 1, 2, 2, 3, 4, 5]
    for s, loss in got["faulty"]:
        assert loss == clean[s]                          # bitwise


def test_mesh_checkpoint_restores_on_one_device(runs):
    inp, res, _, _ = runs
    state = _same_on_every_rank(res["data=2,model=2"], "loop")["state"]
    d = os.path.join(inp["tmp"], "clean")
    cfg = get_arch("olmo-1b").reduced()
    meta = get_model(cfg).init_params(cfg, 0, device="meta")
    step, got, _ = Checkpointer(d).restore_latest(
        {"params": meta, "opt": AdamW().init(meta)}, device="cpu")
    assert step == 6
    _assert_trees_equal(tree_to_numpy(got), state)
    jparams = jax.tree.map(jnp.asarray, inp["params"]["olmo-1b"])
    jtarget = {"params": jparams, "opt": JAdamW().init(jparams)}
    jgot, _ = JCheckpointer(d).restore(6, jtarget)
    for g, w in zip(jax.tree.leaves(jgot), leaves(state)):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_one_device_checkpoint_restores_under_the_mesh(runs, writer):
    inp, res, _, _ = runs
    step, placed, tree = _same_on_every_rank(res["data=2,model=2"],
                                             "loop")["restored"][writer]
    assert step == {"port": 7, "ref": 9}[writer]
    assert placed > 0
    d = inp["ckpts"][writer]
    cfg = get_arch("olmo-1b").reduced()
    meta = get_model(cfg).init_params(cfg, 0, device="meta")
    want, _ = Checkpointer(d).restore(step, {"params": meta,
                                             "opt": AdamW().init(meta)},
                                      device="cpu")
    _assert_trees_equal(tree, tree_to_numpy(want))


def test_compressed_psum_tree_bitwise_reference(runs):
    _, res, ref, _ = runs
    ranks = res["pod=2"]
    want_g, want_e = ref["psum"]
    for i, r in enumerate(ranks):
        g, e = r["psum"]
        for a, b in zip(g, want_g):
            np.testing.assert_array_equal(a, b[i])
        for a, b in zip(e, want_e):
            np.testing.assert_array_equal(a, b[i])


def test_pipeline_forward_matches_reference(runs):
    inp, res, ref, _ = runs
    shards, in_turn = ref["pipe"]
    M, P = inp["pipe"][2].shape[0], 2
    for r in res["pod=2"]:
        out, sends, rec = r["pipe"]
        np.testing.assert_allclose(out, shards[-1], atol=PIPE_ATOL, rtol=0)
        np.testing.assert_allclose(out, in_turn, atol=PIPE_ATOL, rtol=0)
        assert sends == M + P - 1
        assert rec == {"ok": True, "stages": 2, "microbatches": 4,
                       "bubble_fraction": 1 / 5, "peak_memory_bytes": None,
                       "sends": 5, "bitwise_stages_in_turn": True}


def test_mesh_from_env_cases(runs):
    _, res, ref, _ = runs
    for spec, (want, warned) in ref["elastic"].items():
        name = "pod16x16" if spec is None else spec
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            try:
                dims, axes = resolve_mesh_spec(name, 8)
                got = dict(zip(axes, dims))
            except ValueError:
                got = "ValueError"
        assert got == want, spec
        assert any(issubclass(x.category, RuntimeWarning)
                   for x in w) == warned, spec
    got = _same_on_every_rank(res["data=2,model=2"], "elastic")
    assert got["d2x2"] == ({"data": 2, "model": 2}, [])
    for spec in ("pod16x16", None, "pod2x16x16"):
        sizes, msgs = got[spec]
        assert sizes == {"data": 1, "model": 4}, spec
        assert len(msgs) == 1 and "degrading" in msgs[0], msgs
    for spec in ("d4x4", "d2x4"):
        assert got[spec][0].startswith("ValueError") and not got[spec][1]


def test_cli_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone"]
    cmds = {"train": run + [
        "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
        "--device", "cpu", "--reduced", "--mesh", "d2x2", "--steps", "3",
        "--batch", "4", "--seq", "16", "--ckpt", str(tmp_path / "ck"),
        "--fail-at", "2"],
        "serve": run + [
        "--nproc-per-node", "2", str(ROOT / "examples" /
                                     "serve_dscim_torch.py"),
        "--mesh", "model=2", "--device", "cpu", "--batch", "2",
        "--prompt-len", "4", "--tokens", "2", "--kv", "int8"]}
    procs = {k: subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    out = {}
    for k, p in procs.items():
        try:
            out[k] = p.communicate(timeout=SPAWN_TIMEOUT_S)
        finally:
            if p.poll() is None:
                p.kill()
                p.communicate()
        assert p.returncode == 0, out[k][0][-3000:] + out[k][1][-3000:]
    train_out = out["train"][0].splitlines()
    assert sum(ln.startswith("[train] first-10") for ln in train_out) == 1
    assert sum(ln.startswith("[failover]") for ln in train_out) == 1
    serve_out = out["serve"][0].splitlines()
    assert len(serve_out) == 5
    assert serve_out[0].startswith("float (scanned, mesh model=2): ")


class _Mesh:
    """The ``DeviceMesh`` surface a ``ParallelCtx`` reads, at one rank's
    coordinate, without a process group."""

    def __init__(self, names, shape, coord):
        self.mesh_dim_names, self.shape, self.coord = names, shape, coord

    def get_coordinate(self):
        return self.coord


def _spec(entry):
    return tuple(e if e is None or isinstance(e, tuple) else (e,)
                 for e in entry)


@pytest.mark.parametrize("names,shape", [(("data", "model"), (2, 2)),
                                         (("pod", "data", "model"),
                                          (2, 2, 2))])
def test_opt_state_specs_and_to_shardings(names, shape):
    from jax.sharding import AbstractMesh

    from repro.launch import sharding as jsharding
    from repro.parallel import ParallelCtx as JParallelCtx
    dp = tuple(a for a in names if a != "model")
    cfg = get_arch("olmo-1b").reduced()
    params = get_model(cfg).init_params(cfg, 0, device="cpu")
    jpar = JParallelCtx(mesh=AbstractMesh(shape, names), dp_axes=dp)
    jparams = jax.tree.map(np.asarray, tree_to_numpy(params))
    want = jsharding.opt_state_specs(jsharding.param_specs(
        JARCHS["olmo-1b"].reduced(), jpar, jparams))
    for coord in np.ndindex(*shape):
        par = ParallelCtx(mesh=_Mesh(names, shape, coord), dp_axes=dp)
        pspecs = sharding.param_specs(cfg, par, params)
        ospecs = sharding.opt_state_specs(pspecs)
        assert leaves(ospecs) == [_spec(w) for w in jax.tree.leaves(
            want, is_leaf=lambda x: isinstance(x, tuple))]
        state = {"params": params, "opt": AdamW().init(params)}
        got = sharding.to_shardings(par, {"params": pspecs, "opt": ospecs},
                                    state)
        placed = sharding.shard_params(params, par)
        mirror = AdamW().init(placed)
        n_split = 0
        for a, b in zip(leaves(got["params"]) + leaves(got["opt"]),
                        leaves(placed) + leaves(mirror)):
            assert type(a) is type(b)
            if isinstance(a, Sharded):
                assert a.spec == b.spec and a.shape == b.shape
                a, b = a.local, b.local
                n_split += 1
            assert torch.equal(a, b)
        assert n_split > 0
