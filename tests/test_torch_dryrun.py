"""The dry run (launch/dryrun.py), its cost counter (launch/cost.py) and
the profile (launch/profile.py), at reduced sizes on the CPU:

* ``model_flops`` is exactly the reference's for every cell;
* the dot FLOPs ``CostMode`` counts in a one-device reduced qwen3 train
  step equal the reference's ``analyze_hlo(...).flops`` of the same step,
  exactly (read: equal FLOPs and equal dot counts at two shapes): both
  count 2*M*N*K a dot, the eager step's unrolled ops against XLA's dots
  with its loops corrected;
* at reduced qwen3, granite-moe, rwkv6 and zamba2, on both production
  meshes (stand-ins), every kind of cell runs on meta tensors: argument
  bytes equal the rank's ``Sharded`` pieces as the placement rules cut
  them (computed here from the whole shapes), and no op of the run makes
  a tensor off ``meta``;
* the CLI writes an ``ok`` record and a skipped one;
* ``profile`` writes every section, and its delta against a baseline it
  wrote itself is zero.

(The collective payload against a real gloo mesh and ``sp`` are held in
tests/test_torch_train_mesh.py, whose rank script counts them.)
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
from unittest import mock  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402,E501
from repro.models.lm import init_params as jinit_params  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import Shape  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import dryrun, profile  # noqa: E402
from repro_torch.launch.cost import CostMode  # noqa: E402
from repro_torch.launch.mesh import PRODUCTION_MESHES  # noqa: E402
from repro_torch.launch.sharding import placement  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

# the reference's dry-run module sets XLA_FLAGS when imported: import it
# with the environment restored afterwards
with mock.patch.dict(os.environ):
    from repro.launch import dryrun as jdryrun  # noqa: E402

ARCH4 = ("qwen3-0.6b", "granite-moe-1b-a400m", "rwkv6-7b", "zamba2-7b")
# small shapes that divide over both production meshes' DP ranks
SMALL = (Shape("train_s", 16, 32, "train"), Shape("prefill_s", 32, 16,
                                                  "prefill"),
         Shape("decode_s", 32, 16, "decode"),
         Shape("long_s", 64, 1, "decode", subquadratic_only=True))


def _small(name):
    """The reduced config at the small shapes; an MoE one with 16 experts,
    so that they split over the production meshes' model=16."""
    cfg = ARCHS[name].reduced()
    return dataclasses.replace(cfg, shapes=SMALL, moe_experts=16
                               if cfg.family == "moe" else 0)


def test_model_flops_equals_reference():
    for name, cfg in ARCHS.items():
        for ours, ref in ((cfg, JARCHS[name]),
                          (cfg.reduced(), JARCHS[name].reduced())):
            for s in ours.shapes:
                jshape = ref.shape(s.name)
                assert dryrun.model_flops(ours, s, s.kind) == \
                    jdryrun.model_flops(ref, jshape, jshape.kind), \
                    (name, s.name)


@pytest.mark.parametrize("B,S", [(2, 16), (4, 32)])
def test_dot_flops_equal_reference_hlo(B, S):
    jcfg = JARCHS["qwen3-0.6b"].reduced()
    cfg = ARCHS["qwen3-0.6b"].reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    jopt = JAdamW()
    hlo = jax.jit(jmake_train_step(jcfg, None, jopt)).lower(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()}
    ).compile().as_text()
    want = analyze_hlo(hlo)
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    opt = AdamW()
    with CostMode() as cm:
        make_train_step(cfg, opt, "cpu")(params, opt.init(params), batch)
    assert cm.cost.flops == want.flops
    assert cm.cost.dots == want.dots


class _Devices(TorchDispatchMode):
    """Every device an op's output lands on."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.add(t.device.type)
        return out


def _piece_bytes(tree, par, path=""):
    """Bytes of the rank's pieces of a whole tree, from the placement
    rules (launch/sharding.py ``placement``) and the mesh sizes."""
    if isinstance(tree, dict):
        return sum(_piece_bytes(v, par, f"{path}/{k}" if path else k)
                   for k, v in tree.items())
    spec = placement(path, tree, par)
    n = tree.numel()
    for axes in spec or ():
        n //= math.prod(par.sizes[a] for a in axes or ())
    return n * tree.element_size()


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("name", ARCH4)
def test_cells_run_on_meta(name, multi_pod):
    cfg = _small(name)
    par = dryrun.stand_in(*PRODUCTION_MESHES[multi_pod])
    whole = get_model(cfg).init_params(cfg, 0, device="meta")
    params_b = _piece_bytes(whole, par)
    for s in SMALL:
        if not cfg.runnable(s.name):
            continue
        devices = _Devices()
        with devices:
            kind, arg_bytes, cm = dryrun.run_cell(cfg, s.name, par)
        assert devices.seen == {"meta"}, (s.name, devices.seen)
        _, batch = cfg.input_specs(s.name)
        want = params_b + dryrun.argument_bytes(batch)
        if kind == "train":
            want += 2 * params_b + 4               # AdamW m, v and count
        elif kind == "decode":
            cache = dryrun._decode_cache(cfg, get_model(cfg), s.batch,
                                         s.seq, par)
            want += dryrun.argument_bytes(cache)
        assert arg_bytes == want, s.name
        assert cm.cost.flops > 0 and cm.cost.peak_bytes > 0
        rec = dryrun.build_cell(cfg, s.name, multi_pod, sp=False)
        assert rec["ok"] and rec["chips"] == (512 if multi_pod else 256)
        assert rec["model_flops_global"] == dryrun.model_flops(cfg, s, kind)
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        if kind == "train":
            assert set(rec["collective_bytes_per_device"]) == {
                "all-gather", "all-reduce", "total"} | (
                {"all-to-all"} if cfg.family == "moe" else set())


def test_cli_writes_records(tmp_path):
    out = tmp_path / "dr"
    assert dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape",
                        "decode_32k", "--singlepod", "--out", str(out)]) == 0
    rec = json.loads((out / "granite-moe-1b-a400m_decode_32k_sp.json")
                     .read_text())
    assert rec["ok"] and rec["mesh"] == "pod16x16"
    assert rec["memory"]["argument_bytes"] > 0
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    for tag in ("sp", "mp"):
        skip = json.loads((out / f"qwen3-0.6b_long_500k_{tag}.json")
                          .read_text())
        assert skip["ok"] is False and skip["skipped"]


def test_profile_sections_and_zero_delta(tmp_path):
    cfg = _small("qwen3-0.6b")
    lines = []
    out = profile.profile(None, "train_s", sp=True, cfg=cfg, top=5,
                          log=lines.append)
    for section in ("roofline", "memory", "delta", "top_buffers",
                    "by_layer", "bytes_by_kind", "collectives"):
        assert section in out
    assert out["top_buffers"] and out["by_layer"]["flops"]
    assert out["bytes_by_kind"] and out["collectives"]["total"] > 0
    assert any("attention" in k for k in out["by_layer"]["flops"])
    base = tmp_path / "base.json"
    base.write_text(json.dumps(out))
    again = profile.profile(None, "train_s", sp=True, cfg=cfg, top=5,
                            baseline=str(base), log=lines.append)
    for term in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert again["delta"][term] == 0.0
    assert any(line.startswith("vs baseline") for line in lines)
