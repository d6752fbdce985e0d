"""The recurrent families under a mesh (the port's ``torch.distributed``
SPMD), held on the CPU over gloo against one device and against the JAX
reference.

Two groups of ranks run at once (``tests/_torch_train_rank.py``, jobs
``rec_tp`` and ``rec_2x2``, a ``file://`` store under the test's
temporary directory, a timeout each): two ranks (``model=2``) and four
(``data=2,model=2``).  The reference's values come from one JAX
subprocess with 8 fake host devices (``tests/_jax_train_mesh_ref.py``,
parts ``train_mesh`` and ``serve``).  Both packages start from the
reference's ``init_params`` of the reduced rwkv6-7b and zamba2-7b, one
batch of 4 x 16 and 4 prompts of 8.  Contracts:

* ``serve_batch`` (float): tokens and prefill logits bitwise the port's
  one-device run under both meshes (the WKV scan runs on each rank's
  heads and rows, the SSD scan on its rows: every head and row is
  independent), and the tokens equal the reference's ``serve_batch``
  under ``make_debug_mesh(2, 2)`` (whose logits XLA's mesh moves off its
  one device, so they are not held);
* ``make_train_step`` under ``model=2``: loss, gradient norm,
  parameters and AdamW state after two steps bitwise the port's
  one-device step; under ``data=2,model=2`` each step's loss and the
  first step's gradient norm within ``DP_RTOL`` of one device (the f32
  order of the DP mean), the second step's gradient norm within
  ``STEP2_RTOL`` (AdamW's first update is near lr * sign(g) where |g| is
  small, so that order moves some parameters, and the WKV's bf16
  operand rounding passes it on to the next gradient: rwkv6-7b's
  measured 2.9e-5) and the parameters within ``PARAM_ATOL``; the first
  loss within ``REF_RTOL`` of the reference's 2x2 step;
* every rank returns the same results.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import os  # noqa: E402
import pickle  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax, tree_to_numpy  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_train_rank.py"
JAX_REF = ROOT / "tests" / "_jax_train_mesh_ref.py"
SPAWN_TIMEOUT_S = 150
GROUPS = {"model=2": (2, "rec_tp"), "data=2,model=2": (4, "rec_2x2")}
ARCHS = ("rwkv6-7b", "zamba2-7b")
TRAIN_STEPS = 2
SERVE_TOKENS = 5
DP_RTOL = 1e-5           # loss and gradient norm, f32 order of the sums
STEP2_RTOL = 1e-4        # the second step's gradient norm (docstring)
PARAM_ATOL = 1e-4        # parameters after two steps at lr 1e-3
REF_RTOL = 2e-3          # tests/test_launch_dist.py's own bound


def _inputs(tmp: Path) -> dict:
    rng = np.random.default_rng(0)
    params = {}
    for arch in ARCHS:
        cfg = JARCHS[arch].reduced()
        params[arch] = jax.tree.map(
            np.asarray, jget_model(cfg).init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    vocab = JARCHS[ARCHS[0]].reduced().vocab
    return {"params": params, "serve_params": params,
            "batch": {k: rng.integers(0, vocab, (4, 16)).astype(np.int32)
                      for k in ("tokens", "labels")},
            "prompts": rng.integers(0, vocab, (4, 8)).astype(np.int64),
            "serve_tokens": SERVE_TOKENS, "tmp": str(tmp)}


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
         "train_mesh,serve"], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), tmp / "ref.pkl")]
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


def _one_device(inp) -> dict:
    """The port's one-device runs: {arch: (tokens, prefill logits,
    train metrics, params, state)}."""
    out = {}
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        toks, logits = serve_batch(cfg, params_from_jax(inp["params"][arch],
                                                        device="cpu"),
                                   inp["prompts"], SERVE_TOKENS,
                                   device="cpu")
        params = params_from_jax(inp["params"][arch], device="cpu")
        opt = AdamW(lr=1e-3)
        state = opt.init(params)
        step = make_train_step(cfg, opt, "cpu")
        metrics = []
        for _ in range(TRAIN_STEPS):
            params, state, m = step(params, state, inp["batch"])
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[arch] = (toks, logits[0], metrics, tree_to_numpy(params),
                     tree_to_numpy(state))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the groups' results, the reference's, the port's one device)."""
    tmp = tmp_path_factory.mktemp("mesh_recurrent")
    inp = _inputs(tmp)
    procs, deadline = _spawn(tmp, inp)
    one = _one_device(inp)
    res = _collect(procs, deadline)
    return res, res.pop("jax")[0], one


def _same_on_every_rank(ranks, job):
    first = pickle.dumps(ranks[0][job])
    for r, res in enumerate(ranks[1:], 1):
        assert pickle.dumps(res[job]) == first, f"rank {r} differs on {job}"
    return ranks[0][job]


def _job(spec):
    return GROUPS[spec][1]


@pytest.mark.parametrize("spec", list(GROUPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_bitwise_one_device(runs, arch, spec):
    res, _, one = runs
    toks, logits = _same_on_every_rank(res[spec], _job(spec))[arch]
    np.testing.assert_array_equal(toks, one[arch][0])
    np.testing.assert_array_equal(logits, one[arch][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_tokens_match_reference_mesh(runs, arch):
    res, ref, one = runs
    want, _ = ref["serve"][arch]
    np.testing.assert_array_equal(one[arch][0], want)
    for spec in GROUPS:
        toks, _ = _same_on_every_rank(res[spec], _job(spec))[arch]
        np.testing.assert_array_equal(toks, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_model2_bitwise_one_device(runs, arch):
    res, _, one = runs
    metrics, params, state = _same_on_every_rank(
        res["model=2"], "rec_tp")["train"][arch]
    _, _, want_m, want_p, want_s = one[arch]
    assert metrics == want_m
    for got, want in ((params, want_p), (state, want_s)):
        assert len(leaves(got)) == len(leaves(want))
        for g, w in zip(leaves(got), leaves(want)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_2x2_close_to_one_device_and_reference(runs, arch):
    res, ref, one = runs
    metrics, params, state = _same_on_every_rank(
        res["data=2,model=2"], "rec_2x2")["train"][arch]
    _, _, want_m, want_p, _ = one[arch]
    got, want = np.asarray(metrics), np.asarray(want_m)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=DP_RTOL, atol=0)
    np.testing.assert_allclose(got[0, 1], want[0, 1], rtol=DP_RTOL, atol=0)
    np.testing.assert_allclose(got[1, 1], want[1, 1], rtol=STEP2_RTOL,
                               atol=0)
    for g, w in zip(leaves(params), leaves(want_p)):
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0)
    assert int(state["count"]) == TRAIN_STEPS
    ref_mesh = ref["train_mesh"][arch][1]
    np.testing.assert_allclose(metrics[0][0], ref_mesh[0], rtol=REF_RTOL)
