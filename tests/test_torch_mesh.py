"""Serving under a mesh (the port's ``torch.distributed`` SPMD), held on
the CPU over gloo against one device and against the JAX reference.

Every rank of a mesh is a subprocess (``tests/_torch_mesh_rank.py``)
joined through a ``file://`` store under ``tmp_path`` (no TCP port: the
suite runs in parallel workers), each with its own timeout, so a hung
rendezvous fails its test.  Two groups run at once: two ranks serve
``model=2``, four ranks ``data=2,model=2`` and, for the fused MVM,
``model=4``.  Contracts:

* the N-sharded fused MVM, with and without batch axes, at the shapes of
  ``tests/test_launch_dist.py::test_dscim_nsharded_prepared_mvm_matches_
  single_device``, and the DP-sharded paged read: bitwise one device;
* ``serve_batch`` of the reduced qwen3-0.6b at ``kernel:dscim1:256``,
  float and int8 KV, on seeded parameters both packages take (placed by
  ``params_from_jax(par=)`` on the ranks): tokens bitwise the reference's and the
  port's one-device run, prefill logits within 1e-5 of the reference,
  and under ``model=2`` bitwise the port's one device;
* the MoE layer with expert parallelism within 2e-5 of the local layer
  (``test_launch_dist.py::test_moe_ep_shard_map_numerics``), and the
  reduced deepseek-moe at ``exact:dscim2:64`` under ``data=2,model=2``:
  tokens bitwise one device;
* ``serve_continuous`` and the ``Router`` under ``model=2``: every
  request's tokens bitwise their one-device runs; greedy spec decoding
  (``spec='dscim2:2'``) under a mesh bitwise the plain tokens;
* the scheduler's knobs under ``model=2`` (``tests/_torch_mesh_rank.py
  knob_run``): ``serve_continuous`` with integrity 'verify', a
  ``deadline_s`` per request (one expires at its first boundary), the
  hang watchdog (a hang flagged on rank 1 alone, replayed on every
  rank) and a sampled injector whose weight flip lands on one rank's
  piece and whose page flip lands in a live page: outputs, statuses,
  replays and the integrity record equal the port's one-device run (its
  one device hanging at the same step) and the reference's run on its
  2x2 mesh (one JAX subprocess with 8 fake host devices,
  ``tests/_jax_train_mesh_ref.py``); the ``Router`` with integrity
  'verify' and a weight flip: statuses, tokens, replays and record equal
  one device's;
* every rank returns the same results.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.serve import serve_batch as jserve_batch  # noqa: E402
from repro.layers.moe import moe_local  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax, tree_to_numpy  # noqa: E402
from repro_torch.launch.serve import serve_batch, serve_continuous  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_mesh_rank.py"
JAX_REF = ROOT / "tests" / "_jax_train_mesh_ref.py"
SPAWN_TIMEOUT_S = 150
MESHES = {"model=2": (2, "mvm,serve,continuous,router,knobs,router_knobs"),
          "data=2,model=2": (4, "mvm,mvm4,paged,serve,moe,ep")}
# the fused MVM's meshes: (the group that runs it, its job)
MVM_MESHES = {"model=2": ("model=2", "mvm"),
              "model=4": ("data=2,model=2", "mvm4"),
              "data=2,model=2": ("data=2,model=2", "mvm")}
QWEN_SPEC = "kernel:dscim1:256"
MOE_SPEC = "exact:dscim2:64"


def _worker_module():
    spec = importlib.util.spec_from_file_location("_torch_mesh_rank", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _params(arch: str):
    """Seeded parameters of a reduced config in the two packages' shared
    layout, as numpy (both take them)."""
    cfg = get_arch(arch).reduced()
    return tree_to_numpy(lm.init_params(cfg, 0, device="cpu"))


def _ep_params(rng, D=16, F=32, E=4):
    """The MoE layer of ``test_launch_dist.py``'s EP test: 4 experts of
    width 32 on d_model 16, top-2, one shared expert, scaled as
    ``init_moe``."""
    def n(*shape, std):
        return (rng.normal(0, 1, shape) * std).astype(np.float32)
    return {"router": n(D, E, std=D ** -0.5),
            "experts": {"w_gate": n(E, D, F, std=D ** -0.5),
                        "w_up": n(E, D, F, std=D ** -0.5),
                        "w_down": n(E, F, D, std=F ** -0.5)},
            "shared": {"w_gate": n(D, F, std=D ** -0.5),
                       "w_up": n(D, F, std=D ** -0.5),
                       "w_down": n(F, D, std=F ** -0.5)}}


def _inputs():
    rng = np.random.default_rng(0)
    mvm = []
    for shape, gk in (((3, 130), 64), ((2, 5, 100), 128)):
        x = rng.normal(0, 1, shape).astype(np.float32)
        w = rng.normal(0, 1, (shape[-1], 32)).astype(np.float32)
        mvm.append((x, w, gk))
    lens = (4, 8, 11, 4, 6, 8)
    reqs = [(rng.integers(1, 120, n).astype(np.int32), b)
            for n, b in zip(lens, (5, 3, 6, 8, 2, 7))]
    vocab = get_arch("qwen3-0.6b").reduced().vocab
    return {
        "mvm": mvm,
        "qwen_params": _params("qwen3-0.6b"),
        "moe_params": _params("deepseek-moe-16b"),
        "prompts": rng.integers(0, vocab, (4, 8)).astype(np.int32),
        "ep_params": _ep_params(rng),
        "ep_x": rng.normal(0, 1, (4, 8, 16)).astype(np.float32),
        "cb_prompts": rng.integers(0, vocab, (6, 8)).astype(np.int32),
        "cb_budgets": np.asarray((6, 2, 5, 3, 6, 4), np.int32),
        "router_reqs": reqs,
        # the knobs' queue: request 3's wall budget expires at the first
        # boundary after its admission; seed 27's schedule flips a scale
        # element of layers/mlp/w_up at segment 3 and an int8 v page of
        # slot 2 at segment 1
        "knob_prompts": rng.integers(0, vocab, (6, 8)).astype(np.int32),
        "knob_budgets": np.asarray((6, 3, 5, 6, 4, 6), np.int32),
        "knob_deadlines": np.asarray((1e6, 1e6, 1e6, 1e-6, 1e6, 1e6)),
        "knob_seed": 27,
    }


def _spawn(tmp: Path, inp: dict):
    """Start every rank of every mesh of ``MESHES`` at once; ``_collect``
    waits for them."""
    src = tmp / "inputs.pkl"
    with open(src, "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {}
    for i, (spec, (world, jobs)) in enumerate(MESHES.items()):
        d = tmp / f"mesh{i}"
        d.mkdir()
        procs[spec] = [(subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world),
             str(d / "store"), spec, jobs, str(src), str(d / f"r{r}.pkl")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), d / f"r{r}.pkl") for r in range(world)]
    jenv = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs["jax"] = [(subprocess.Popen(
        [sys.executable, str(JAX_REF), str(src), str(tmp / "ref.pkl"),
         "knobs"], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), tmp / "ref.pkl")]
    return procs, time.monotonic() + SPAWN_TIMEOUT_S


def _collect(procs, deadline) -> dict:
    """{spec: [rank results]}.  A rank that fails or outlives its
    deadline fails the fixture, with its output."""
    failed = []
    for spec, ranks in procs.items():
        for p, _ in ranks:
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failed.append(f"{spec}: timed out\n{out[-3000:]}")
                continue
            if p.returncode:
                failed.append(f"{spec}: rc {p.returncode}\n{out[-3000:]}")
    if failed:
        for ranks in procs.values():
            for p, _ in ranks:
                if p.poll() is None:
                    p.kill()
        pytest.fail("\n".join(failed))
    res = {}
    for spec, ranks in procs.items():
        res[spec] = []
        for _, path in ranks:
            with open(path, "rb") as f:
                res[spec].append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """(inputs, the ranks' results, one-device results of the port and
    the reference, the reference's 2x2 results)."""
    inp = _inputs()
    procs, deadline = _spawn(tmp_path_factory.mktemp("mesh"), inp)
    jcfg = dataclasses.replace(jget_arch("qwen3-0.6b").reduced(),
                               dscim=QWEN_SPEC)
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(),
                              dscim=QWEN_SPEC)
    tp = params_from_jax(inp["qwen_params"], device="cpu")
    one = {}
    for kv in ("float", "int8"):
        jt, jl = jserve_batch(jcfg, inp["qwen_params"], inp["prompts"], 6,
                              kv=kv)
        tt, tl = serve_batch(cfg, tp, inp["prompts"], 6, kv=kv,
                             device="cpu")
        one[kv] = (np.asarray(jt), np.asarray(jl[0]), tt, tl[0])
    mcfg = dataclasses.replace(get_arch("deepseek-moe-16b").reduced(),
                               dscim=MOE_SPEC)
    one["moe"] = serve_batch(mcfg, params_from_jax(inp["moe_params"],
                                                   device="cpu"),
                             inp["prompts"], 5, device="cpu")[0]
    one["continuous"], _ = serve_continuous(
        cfg, tp, inp["cb_prompts"], 6, slots=4, seg_len=2,
        max_new=inp["cb_budgets"], kv="int8", page_size=4, device="cpu",
        log=lambda *a: None)
    worker = _worker_module()
    one["router"] = worker.run_router(cfg, tp, inp["router_reqs"])
    one["knobs"] = worker.knob_run(cfg, tp, inp)
    one["router_knobs"] = worker.run_router(
        cfg, tp, inp["router_reqs"], record=True, **worker.router_knobs())
    ref_ep, _ = moe_local(inp["ep_params"], inp["ep_x"], top_k=2,
                          capacity_factor=8.0, has_shared=True)
    one["ep"] = np.asarray(ref_ep)
    runs = _collect(procs, deadline)
    return inp, runs, one, runs.pop("jax")[0]


def _same_on_every_rank(ranks, job):
    first = pickle.dumps(ranks[0][job])
    for r, res in enumerate(ranks[1:], 1):
        assert pickle.dumps(res[job]) == first, f"rank {r} differs on {job}"
    return ranks[0][job]


@pytest.mark.parametrize("spec", list(MVM_MESHES))
def test_sharded_fused_mvm_bitwise(mesh, spec):
    _, runs, _, _ = mesh
    group, job = MVM_MESHES[spec]
    for ref, got, got_b in _same_on_every_rank(runs[group], job):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_b, ref)


def test_sharded_paged_read_bitwise(mesh):
    _, runs, _, _ = mesh
    ref, got = _same_on_every_rank(runs["data=2,model=2"], "paged")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("spec", ["model=2", "data=2,model=2"])
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_serve_batch_under_mesh(mesh, spec, kv):
    _, runs, one, _ = mesh
    jt, jl, tt, tl = one[kv]
    toks, logits, graph = _same_on_every_rank(runs[spec], "serve")[kv]
    assert graph is False                  # no CUDA graph on the CPU
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(toks, jt)
    np.testing.assert_allclose(logits, jl, atol=1e-5, rtol=0)
    if spec == "model=2":
        np.testing.assert_array_equal(logits, tl)


@pytest.mark.parametrize("spec", ["model=2", "data=2,model=2"])
def test_spec_under_mesh_bitwise_plain(mesh, spec):
    _, runs, _, _ = mesh
    res = _same_on_every_rank(runs[spec], "serve")
    np.testing.assert_array_equal(res["spec"], res["int8"][0])


def test_moe_expert_parallel_matches_local(mesh):
    _, runs, one, _ = mesh
    ref, got, ref_aux, aux = _same_on_every_rank(runs["data=2,model=2"],
                                                 "ep")
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(ref, one["ep"], atol=2e-5, rtol=0)
    assert np.isfinite(aux) and abs(aux - ref_aux) < 0.5 * ref_aux


def test_moe_serve_under_mesh(mesh):
    _, runs, one, _ = mesh
    toks, _, spec = _same_on_every_rank(runs["data=2,model=2"], "moe")
    np.testing.assert_array_equal(toks, one["moe"])
    np.testing.assert_array_equal(spec, toks)


def test_continuous_under_mesh(mesh):
    _, runs, one, _ = mesh
    outs = _same_on_every_rank(runs["model=2"], "continuous")
    assert len(outs) == len(one["continuous"])
    for a, b in zip(outs, one["continuous"]):
        np.testing.assert_array_equal(a, b)


def test_router_under_mesh(mesh):
    _, runs, one, _ = mesh
    got = _same_on_every_rank(runs["model=2"], "router")
    assert got == one["router"]
    assert all(status == "ok" for status, _ in got)


def test_knobs_under_mesh(mesh):
    _, runs, one, ref = mesh
    outs, status, replays, ig = _same_on_every_rank(runs["model=2"], "knobs")
    want_o, want_s, want_r, want_ig = one["knobs"]
    ref_o, ref_s, ref_r, ref_ig = ref["knobs"]
    assert status == want_s == ref_s
    assert status.count("deadline") == 1 and status[3] == "deadline"
    # the hang on rank 1 alone replayed every rank once, the weight flip
    # once more (a decode ran since the last sweep)
    assert replays == want_r == ref_r == 2
    for a, b, c in zip(outs, want_o, ref_o):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert ig == want_ig
    assert ig["page_mismatches"] == ig["weight_mismatches"] == 1
    for key in ref_ig:
        assert ig[key] == ref_ig[key], key


def test_router_integrity_under_mesh(mesh):
    _, runs, one, _ = mesh
    got = _same_on_every_rank(runs["model=2"], "router_knobs")
    res, replays, ig = got
    assert got == one["router_knobs"]
    assert all(status == "ok" for status, _ in res)
    assert res == one["router"]             # the flip is invisible
    assert replays == ig["replays"] == 1
    assert ig["weight_mismatches"] == ig["weight_repairs"] == 1
