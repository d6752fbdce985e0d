"""The JAX reference's side of the port's mesh tests, run once a test
module in a subprocess with 8 fake host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_jax_train_mesh_ref.py IN OUT [PARTS]

reads the inputs pickled in IN and pickles to OUT a dict of the PARTS
asked for (comma-separated; default ``train,psum,pipe,elastic``, those
of tests/test_torch_train_mesh.py):

* ``train``: the 2x2 mesh train step's metrics
  (``tests/test_launch_dist.py::test_tiny_distributed_train_step_
  compiles_and_runs``, on the shared params and batch, for each reduced
  config) and the single-device step's; ``train_mesh``: the mesh step's
  alone; ``train12``: the mesh step's under a 1x2 mesh (``model=2``);
* ``psum`` / ``pipe``: ``compressed_psum_tree`` and ``pipeline_forward``
  under ``shard_map`` over pod=2; ``elastic``: ``mesh_from_env`` for the
  reference test's specs;
* ``serve``: ``serve_batch`` of each config of ``inp['serve_params']``
  under the 2x2 mesh (tests/test_torch_mesh_recurrent.py);
* ``knobs``: ``serve_continuous`` of the reduced qwen3 at
  ``kernel:dscim1:256``, int8 KV, under the 2x2 mesh with integrity
  'verify', a ``deadline_s`` per request, a hang before the third step
  and the sampled injector of tests/_torch_mesh_rank.py
  (tests/test_torch_mesh.py).
"""
import os
import pickle
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import ARCHS
from repro.launch.mesh import make_debug_mesh, make_parallel_ctx
from repro.launch.pipeline import pipeline_forward
from repro.launch.sharding import (batch_specs, opt_state_specs, param_specs,
                                   to_shardings)
from repro.launch.steps import make_train_step
from repro.optim.adamw import AdamW
from repro.optim.compression import compressed_psum_tree
from repro.parallel import shard_map
from repro.runtime.elastic import mesh_from_env


def train(inp, shape=(2, 2), one=True):
    """{arch: (one-device metrics, mesh metrics)}, each (loss, grad norm)
    of one step; the mesh ``make_debug_mesh(*shape)``; the one-device
    metrics None unless ``one``."""
    out = {}
    for arch, p in inp["params"].items():
        cfg = ARCHS[arch].reduced()
        opt = AdamW(lr=1e-3)
        params = jax.tree.map(jnp.asarray, p)
        batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
        m_ref = None
        if one:
            ref_step = jax.jit(make_train_step(cfg, None, opt))
            _, _, m_ref = ref_step(params, opt.init(params), batch)
        mesh = make_debug_mesh(*shape)
        par = make_parallel_ctx(mesh)
        specs = param_specs(cfg, par, params)
        psh = to_shardings(mesh, specs)
        osh = to_shardings(mesh, opt_state_specs(specs))
        bsh = to_shardings(mesh, batch_specs(cfg, par, batch))
        step = jax.jit(make_train_step(cfg, par, opt),
                       in_shardings=(psh, osh, bsh),
                       out_shardings=(psh, osh, None))
        _, _, m = step(jax.device_put(params, psh),
                       jax.device_put(opt.init(params), osh),
                       jax.device_put(batch, bsh))
        out[arch] = tuple(None if x is None else
                          (float(x["loss"]), float(x["grad_norm"]))
                          for x in (m_ref, m))
    return out


def compressed(inp):
    """``compressed_psum_tree`` under shard_map over pod=2: gradients and
    errors stacked over the pods on dim 0, one pod's slice each."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pod",))
    g = jax.tree.map(jnp.asarray, inp["psum_g"])
    e = jax.tree.map(jnp.asarray, inp["psum_e"])

    def body(gs, es):
        one = lambda t: jax.tree.map(lambda a: a[0], t)      # noqa: E731
        ng, ne = compressed_psum_tree(one(gs), one(es), "pod")
        return (jax.tree.map(lambda a: a[None], ng),
                jax.tree.map(lambda a: a[None], ne))

    spec = jax.tree.map(lambda _: P("pod"), g)
    ng, ne = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                       out_specs=(spec, spec))(g, e)
    return ([np.asarray(a) for a in jax.tree.leaves(ng)],
            [np.asarray(a) for a in jax.tree.leaves(ne)])


def pipeline(inp):
    """``pipeline_forward`` over pod=2 of the GELU-MLP stages, each pod's
    result (the reference's is valid on the last pod), and the stages
    applied in turn on one device."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pod",))
    w1, w2, x = (jnp.asarray(a) for a in inp["pipe"])

    def stage_fn(p, h):
        def layer(hh, ws):
            return jax.nn.gelu(hh @ ws[0]) @ ws[1], None
        return jax.lax.scan(layer, h, p)[0]

    out = pipeline_forward((w1, w2), x, stage_fn=stage_fn, mesh=mesh)
    shards = [np.asarray(s.data) for s in out.addressable_shards]
    in_turn = jax.vmap(lambda xm: stage_fn((w1[1], w2[1]),
                                           stage_fn((w1[0], w2[0]), xm)))(x)
    return shards, np.asarray(in_turn)


def elastic():
    """The mesh ``mesh_from_env`` gives for each spec of the reference's
    tests on 8 devices (shape, degraded or not), or that it raised."""
    out = {}
    for spec in ("d2x4", "pod16x16", None, "d4x4"):
        if spec is None:
            os.environ.pop("REPRO_MESH", None)
        else:
            os.environ["REPRO_MESH"] = spec
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            try:
                got = dict(mesh_from_env().shape)
            except Exception as e:              # the reference raises
                got = f"{type(e).__name__}"
        out[spec] = (got, any(issubclass(x.category, RuntimeWarning)
                              for x in w))
    return out


def serve(inp):
    """{arch: (tokens, prefill logits)} of ``serve_batch`` under the 2x2
    mesh."""
    from repro.launch.serve import serve_batch
    par = make_parallel_ctx(make_debug_mesh(2, 2))
    out = {}
    for arch, p in inp["serve_params"].items():
        toks, logits = serve_batch(ARCHS[arch].reduced(), p,
                                   inp["prompts"].astype(np.int32),
                                   inp["serve_tokens"], par=par)
        out[arch] = (np.asarray(toks), np.asarray(logits[0]))
    return out


def knobs(inp):
    """(outputs, statuses, replays, integrity record) of the knobs' run
    under the 2x2 mesh (tests/_torch_mesh_rank.py ``knob_run``)."""
    import dataclasses

    from repro.launch.serve import serve_continuous
    from repro.runtime.failover import FailureInjector
    from repro.runtime.watchdog import Watchdog

    class HangAt(Watchdog):
        def __init__(self, at):
            super().__init__(hang_timeout=600.0)
            self.at, self.n = at, 0

        def step(self):
            self.n += 1
            if self.n == self.at:
                self._hang.set()
            return super().step()

    cfg = dataclasses.replace(ARCHS["qwen3-0.6b"].reduced(),
                              dscim="kernel:dscim1:256")
    inj = FailureInjector.sampled(
        inp["knob_seed"], segments=6, slots=4, n_layers=2, page_size=4,
        n_kv=2, head_dim=16, device_losses=0, flips=1,
        weight_paths=("layers/mlp/w_up",), weight_flip_count=1)
    wd = HangAt(3)
    try:
        outs, st = serve_continuous(
            cfg, inp["qwen_params"], inp["knob_prompts"], 6, slots=4,
            seg_len=2, max_new=inp["knob_budgets"], eos_id=-1, kv="int8",
            page_size=4, deadline_s=inp["knob_deadlines"], watchdog=wd,
            injector=inj, snapshot_every=1, integrity="verify",
            par=make_parallel_ctx(make_debug_mesh(2, 2)),
            log=lambda *a: None)
    finally:
        wd.close()
    ig = {k: v for k, v in st["integrity"].items() if k != "scrub_time_s"}
    ig["detections"] = [{"kind": d["kind"], "coords": [
        tuple(int(v) if not isinstance(v, str) else v for v in c)
        for c in d["coords"]]} for d in ig["detections"]]
    return ([np.asarray(o) for o in outs], list(st["status"]),
            st["replays"], ig)


PARTS = {"train": train,
         "train12": lambda inp: train(inp, (1, 2), one=False),
         "train_mesh": lambda inp: train(inp, one=False),
         "psum": compressed, "pipe": pipeline,
         "elastic": lambda inp: elastic(), "serve": serve, "knobs": knobs}


def main(argv):
    src, dst = argv[:2]
    parts = argv[2] if len(argv) > 2 else "train,psum,pipe,elastic"
    with open(src, "rb") as f:
        inp = pickle.load(f)
    res = {name: PARTS[name](inp) for name in parts.split(",")}
    with open(dst, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1:])
