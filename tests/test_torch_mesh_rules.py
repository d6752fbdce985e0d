"""The port's mesh machinery beside the reference's: the sharding rules
(``repro_torch/launch/sharding.py`` against ``repro/launch/sharding.py``
on a JAX ``AbstractMesh`` of the same sizes, a bare axis name of a
``PartitionSpec`` read as a 1-tuple), the cut of a rank's piece and
``params_from_jax(par=)``, ``parallel_ctx_from_spec``'s errors, the
refusals of the families and knobs a mesh does not serve (ROADMAP
A13c), and the serving CLI under ``torchrun --nproc-per-node 2 --mesh
model=2`` on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.kvcache import paged_cache_specs  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch.steps import (  # noqa: E402
    prepare_serving_params as jprepare)
from repro.models import get_model as jget_model  # noqa: E402
from repro.parallel import ParallelCtx as JParallelCtx  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax, tree_to_numpy  # noqa: E402
from repro_torch.core.qweights import QuantizedLinearWeight  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import (parallel_ctx_from_spec,  # noqa: E402
                                     parse_mesh_spec)
from repro_torch.launch.steps import prepare_serving_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel import ParallelCtx, Sharded  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((("data", "model"), (2, 2)), (("data", "model"), (1, 4)),
          (("pod", "data", "model"), (2, 2, 2)))
CONFIGS = (("qwen3-0.6b", "off"), ("qwen3-0.6b", "kernel:dscim1:256"),
           ("deepseek-moe-16b", "exact:dscim2:64"))


class _Mesh:
    """The ``DeviceMesh`` surface a ``ParallelCtx`` reads, at one rank's
    coordinate, without a process group."""

    def __init__(self, names, shape, coord=None):
        self.mesh_dim_names, self.shape = names, shape
        self.coord = coord or (0,) * len(shape)

    def get_coordinate(self):
        return self.coord


def _ctxs(names, shape, coord=None):
    dp = tuple(a for a in names if a != "model")
    return (ParallelCtx(mesh=_Mesh(names, shape, coord), dp_axes=dp),
            JParallelCtx(mesh=AbstractMesh(shape, names), dp_axes=dp))


def _norm(entry):
    """A reference spec entry as the port writes it: None or a tuple."""
    if entry is None or isinstance(entry, tuple):
        return entry
    return (entry,)


def _jspec(p):
    return tuple(_norm(e) for e in p)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _same_specs(port, ref):
    ref = dict(_flat(ref))
    port = dict(_flat(port))
    assert sorted(port) == sorted(ref)
    for path, spec in port.items():
        r = ref[path]
        if isinstance(spec, QuantizedLinearWeight):
            assert (spec.q, spec.scale) == (_jspec(r.q), _jspec(r.scale)), \
                path
        else:
            assert spec == _jspec(r), path


@pytest.fixture(scope="module")
def trees():
    """Per config: (port cfg, port params, reference cfg, reference
    params), the same seeded values, prepared where the spec asks."""
    out = {}
    for arch, spec in CONFIGS:
        cfg = dataclasses.replace(get_arch(arch).reduced(), dscim=spec)
        jcfg = dataclasses.replace(jget_arch(arch).reduced(), dscim=spec)
        tp = lm.init_params(cfg, 0, device="cpu")
        jp = tree_to_numpy(tp)
        out[(arch, spec)] = (cfg, prepare_serving_params(cfg, tp), jcfg,
                             jax.tree.map(np.asarray, jprepare(jcfg, jp)))
    return out


@pytest.mark.parametrize("names,shape", MESHES, ids=lambda v: str(v))
@pytest.mark.parametrize("arch,spec", CONFIGS)
def test_param_specs_match_reference(trees, names, shape, arch, spec):
    cfg, tp, jcfg, jp = trees[(arch, spec)]
    par, jpar = _ctxs(names, shape)
    _same_specs(sharding.param_specs(cfg, par, tp),
                jsharding.param_specs(jcfg, jpar, jp))


def _meta(tree):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


@pytest.mark.parametrize("names,shape", MESHES, ids=lambda v: str(v))
def test_cache_and_batch_specs_match_reference(names, shape):
    par, jpar = _ctxs(names, shape)
    for arch in ("qwen3-0.6b", "starcoder2-7b"):
        jcfg = jget_arch(arch).reduced()
        cfg = get_arch(arch).reduced()
        for cs in (jget_model(jcfg).cache_specs(jcfg, 8, 64),
                   jget_model(jcfg).cache_specs(jcfg, 3, 64),
                   paged_cache_specs(jcfg, 4, 32, 4),
                   paged_cache_specs(jcfg, 3, 32, 4)):
            _same_specs(sharding.cache_partition(cfg, par, _meta(cs)),
                        jsharding.cache_partition(jcfg, jpar, cs))
        batch = {"tokens": np.zeros((8, 16), np.int32),
                 "labels": np.zeros((3, 16), np.int32)}
        _same_specs(sharding.batch_specs(cfg, par, batch),
                    jsharding.batch_specs(jcfg, jpar, batch))


def test_pieces_tile_the_leaf(trees):
    """Every rank's pieces of a split leaf are views of the leaf at
    their offsets and together cover it; ``params_from_jax(par=)`` (a reference
    ``QuantizedLinearWeight`` of arrays included) gives the same pieces
    as placing the whole tree."""
    cfg, tp, jcfg, jp = trees[("deepseek-moe-16b", "exact:dscim2:64")]
    names, shape = ("data", "model"), (2, 2)
    cover = {}
    for coord in np.ndindex(*shape):
        par, _ = _ctxs(names, shape, coord)
        placed = sharding.shard_params(tp, par)
        conv = params_from_jax(jp, device="cpu", par=par)
        for (path, a), (_, b) in zip(_flat(placed), _flat(conv)):
            assert type(a) is type(b), path
            if isinstance(a, Sharded):
                la, lb = a.local, b.local
                if isinstance(la, QuantizedLinearWeight):
                    la, lb = la.q, lb.q
                assert torch.equal(la, lb), path
                assert a.spec == b.spec and a.shape == b.shape, path
                cover.setdefault(path, []).append((par.rank_coords, la,
                                                   a.spec))
    assert "layers/moe/experts/w_gate" in cover
    assert "layers/mlp/w_up" not in cover     # MoE: no MLP
    for path, pieces in cover.items():
        whole = dict(_flat(tp))[path]
        whole = whole.q if isinstance(whole, QuantizedLinearWeight) else whole
        count = torch.zeros(whole.shape, dtype=torch.int32)
        for rc, piece, spec in pieces:
            idx = torch.arange(whole.numel()).reshape(whole.shape)
            cut = sharding.shard_for(rc, spec, idx)
            assert torch.equal(whole.reshape(-1)[cut.reshape(-1)],
                               piece.reshape(-1)), path
            count.view(-1)[cut.reshape(-1)] += 1
        # a dim split over 'model' only is whole on both 'data' ranks
        assert int(count.min()) >= 1 and int(count.max()) <= 2, path


def test_prepared_shared_expert_whole_routed_experts_split(trees):
    cfg, tp, _, _ = trees[("deepseek-moe-16b", "exact:dscim2:64")]
    par, _ = _ctxs(("data", "model"), (2, 2))
    placed = prepare_serving_params(cfg, tp, par)
    shared = placed["layers"]["moe"]["shared"]["w_gate"]
    assert isinstance(shared, QuantizedLinearWeight)       # whole
    ex = placed["layers"]["moe"]["experts"]["w_gate"]
    assert isinstance(ex, Sharded)
    assert ex.spec == (None, ("model",), None, ("data",))


def test_mesh_spec_errors(tmp_path):
    for bad in ("model", "model=0", "model=x", "tp=2", "data=2;model=2"):
        with pytest.raises(ValueError, match="bad mesh spec"):
            parse_mesh_spec(bad)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        parallel_ctx_from_spec("model=2")          # no group joined
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match=r"needs data\*model = 4 "
                           r"ranks, the process group has 1"):
            parallel_ctx_from_spec("data=2,model=2")
        par = parallel_ctx_from_spec("model=1")
        assert par.sizes == {"data": 1, "model": 1}
        assert par.dp_axes == ("data",) and par.tp_axis == "model"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_recurrent_families_refuse_a_mesh(arch):
    from repro_torch.launch.serve import main
    from repro_torch.launch.steps import make_generate_fn, make_train_step
    from repro_torch.optim.adamw import AdamW
    par, _ = _ctxs(("data", "model"), (1, 2))
    cfg = get_arch(arch).reduced()
    with pytest.raises(ValueError, match="A13c"):
        make_generate_fn(cfg, 4, par=par)
    with pytest.raises(ValueError, match="A13c"):
        make_train_step(cfg, AdamW(), "cpu", par)
    with pytest.raises(ValueError, match="A13c"):
        main(["--arch", arch, "--reduced", "--device", "cpu", "--mesh",
              "model=2"])


def test_knobs_refused_under_a_mesh():
    from repro_torch.runtime.serving import mesh_refusals
    with pytest.raises(ValueError, match="deadline_s, integrity"):
        mesh_refusals(deadline_s=[1.0], integrity="verify")
    mesh_refusals()


def test_cli_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--mesh", "model=2", "--device", "cpu", "--reduced", "--dscim",
         "kernel:dscim1:256", "--kv", "int8", "--batch", "2",
         "--prompt-len", "4", "--tokens", "3"],
        env=env, capture_output=True, text=True, timeout=150)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[serve]")]
    # rank 0 alone prints: one line for 'off', one for the DS-CIM run
    assert len(lines) == 2, r.stdout
    assert all("under mesh model=2" in ln for ln in lines), lines
