"""The CI regression gate on the port (``repro_torch.launch.bench_regression``)
against the reference's ``tools/bench_regression.py``, on the CPU:

* the deterministic legs, each run once a module through the reference's
  own leg functions and the port's on the reference's weights (seed 0,
  converted), at ``--smoke``: leg 1's two paths (the port's kernel route
  is its plain read on the CPU) each give the reference's tokens and its
  logit trace within 1e-4, and the port's plain read lies within the
  logit-RMSE and token-agreement bounds of its kernel route; leg 4's spec
  tokens bitwise the plain driver's in both, and the acceptance rate (a
  ratio of integer counts) equal to the reference's, which is below the
  gate's own 0.4 bound at this seed (ROADMAP C17); leg 5's prefix-cached
  outputs bitwise the cold ones in both, and the prefill-removed fraction
  equal to the reference's (0.5).  Leg 5's admission latency ratio and
  the timed legs 2, 3 and 6 are not timed on the CPU;
* the gate's verdict: ``main`` with the legs replaced by fixed values
  returns 0 inside every bound and at every bound (the reference's ``>`` /
  ``<`` comparisons), and 1 with the leg named on stderr when any one of
  the nine bounds is crossed or either bitwise flag is false;
* the port's ``ci_thresholds.json`` is the reference's, key for key.
"""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import bench_regression as br  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _reference_gate():
    spec = importlib.util.spec_from_file_location(
        "reference_bench_regression", ROOT / "tools" / "bench_regression.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbr = _reference_gate()


@pytest.fixture(scope="module")
def weights():
    """A fresh copy of the reference's seed-0 weights of the reduced
    qwen3-0.6b, as the port's tensors, for each call."""
    jcfg = jget_arch(br.ARCH).reduced()
    jp = jax.tree.map(np.asarray, jget_model(jcfg).init_params(
        jcfg, jax.random.PRNGKey(0)))
    return lambda: params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def spec_legs(weights):
    return jbr._spec_acceptance(True), \
        br._spec_acceptance(True, "cpu", weights())


@pytest.fixture(scope="module")
def prefix_legs(weights):
    return jbr._prefix_leg(True), br._prefix_leg(True, "cpu", weights())


@pytest.fixture(scope="module")
def paged_legs(weights):
    return jbr._serve_both_paths(True), \
        br._serve_both_paths(True, "cpu", weights())


@pytest.mark.parametrize("path", ["kernel", "jnp"])
def test_leg1_path_matches_reference(paged_legs, path):
    (jt, jl), (tt, tl) = paged_legs[0][path], paged_legs[1][path]
    np.testing.assert_array_equal(np.asarray(tt), np.asarray(jt))
    jl, tl = np.stack([np.asarray(x) for x in jl]), np.stack(tl)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def test_leg1_plain_read_within_bounds_of_the_kernel_route(
        monkeypatch, paged_legs):
    th = br.load_thresholds()
    monkeypatch.setattr(br, "_serve_both_paths",
                        lambda *a, **k: paged_legs[1])
    rmse, agreement = br._paged_drift(True, "cpu")
    assert rmse <= th["paged_kernel_vs_gather_logit_rmse"]
    assert agreement == th["paged_kernel_vs_gather_token_agreement"] == 1.0


def test_leg4_spec_bitwise_and_acceptance_rate_equal_reference(spec_legs):
    (jmatch, jrate), (match, rate) = spec_legs
    assert jmatch and match
    assert rate == jrate
    # ROADMAP C17: the reference's own rate at this seed is below the
    # gate's bound (chip_smoke.py's phase records the crossing)
    assert rate < br.load_thresholds()["spec_greedy_acceptance_rate_min"]


def test_leg5_prefix_bitwise_and_removed_fraction_equal_reference(
        prefix_legs):
    (jmatch, jremoved, _), (match, removed, _) = prefix_legs
    assert jmatch and match
    assert removed == jremoved == 0.5


def test_thresholds_are_the_reference_s():
    mine = br.load_thresholds()
    with open(ROOT / "tools" / "ci_thresholds.json") as f:
        ref = json.load(f)
    assert list(mine) == list(ref) and len(mine) == 9
    for key, value in ref.items():
        assert mine[key] == value and type(mine[key]) is type(value), key


INSIDE = {"paged": (1e-8, 1.0), "monitor": 1.0, "scrub": 1.0,
          "spec": (True, 0.5), "prefix": (True, 0.5, 0.3),
          "router": (2.0, 0.1)}
AT_BOUND = {"paged": (1e-5, 1.0), "monitor": 1.25, "scrub": 1.15,
            "spec": (True, 0.4), "prefix": (True, 0.4, 0.9),
            "router": (64.0, 0.5)}
# (case, leg a failure names, the values that differ from INSIDE)
CROSSED = [
    ("rmse", "paged_kernel_vs_gather", {"paged": (2e-5, 1.0)}),
    ("agreement", "paged_kernel_vs_gather", {"paged": (1e-8, 0.99)}),
    ("monitor_ratio", "chaos_monitor_overhead", {"monitor": 1.26}),
    ("scrub_ratio", "integrity_overhead", {"scrub": 1.16}),
    ("spec_match", "spec_acceptance", {"spec": (False, 0.5)}),
    ("spec_rate", "spec_acceptance", {"spec": (True, 0.39)}),
    ("prefix_match", "prefix_cache", {"prefix": (False, 0.5, 0.3)}),
    ("prefix_removed", "prefix_cache", {"prefix": (True, 0.39, 0.3)}),
    ("prefix_admit", "prefix_cache", {"prefix": (True, 0.5, 0.91)}),
    ("router_tail", "router_loadtest", {"router": (64.5, 0.1)}),
    ("router_refusal", "router_loadtest", {"router": (2.0, 0.51)}),
]


def _fixed(monkeypatch, vals):
    legs = {"plain": {"refusal_rate": vals["router"][1]},
            "chaos": {"refusal_rate": vals["router"][1]}}
    monkeypatch.setattr(br, "_paged_drift", lambda *a, **k: vals["paged"])
    monkeypatch.setattr(br, "_chaos_monitor_overhead",
                        lambda *a, **k: vals["monitor"])
    monkeypatch.setattr(br, "_integrity_overhead",
                        lambda *a, **k: vals["scrub"])
    monkeypatch.setattr(br, "_spec_acceptance", lambda *a, **k: vals["spec"])
    monkeypatch.setattr(br, "_prefix_leg", lambda *a, **k: vals["prefix"])
    monkeypatch.setattr(br, "_router_loadtest",
                        lambda *a, **k: (*vals["router"], legs))


CASES = [("inside", None, {}), ("at_bound", None, AT_BOUND)] + CROSSED


@pytest.mark.parametrize("case, leg, change", CASES,
                         ids=[c[0] for c in CASES])
def test_gate_verdict(monkeypatch, case, leg, change):
    _fixed(monkeypatch, {**INSIDE, **change})
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = br.main(["--smoke", "--device", "cpu"])
    assert len(out.getvalue().splitlines()) == 6
    if leg is None:
        assert rc == 0 and "BENCH REGRESSION" not in err.getvalue()
        return
    lines = err.getvalue().splitlines()
    assert rc == 1 and len(lines) == 1, lines
    assert lines[0].startswith("BENCH REGRESSION:") and f"[{leg}:" in lines[0]
