"""One rank of the port's mesh tests (tests/test_torch_mesh.py spawns
every rank of a mesh as this script, over gloo with a ``file://`` store).

    python tests/_torch_mesh_rank.py RANK WORLD STORE SPEC JOBS IN OUT

joins the group, builds ``parallel_ctx_from_spec(SPEC)``, runs each job
of the comma-separated JOBS on the inputs pickled in IN and pickles this
rank's results (a dict, job -> numpy results) to OUT.  Only the port is
imported here: the parent holds the results against the reference and
against one device.
"""
import asyncio
import dataclasses
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.qweights import prepare_linear_weight
from repro_torch.core.seed_search import calibrated_config
from repro_torch.kernels.dscim_fused import (dscim_fused_mvm_prepared,
                                             dscim_fused_mvm_sharded)
from repro_torch.kernels.paged_attention import (
    paged_attention_decode, paged_attention_decode_sharded)
from repro_torch.launch.mesh import parallel_ctx_from_spec
from repro_torch.launch.serve import serve_batch, serve_continuous
from repro_torch.launch.sharding import place_leaf
from repro_torch.runtime.failover import FailureInjector
from repro_torch.runtime.watchdog import Watchdog


def job_mvm(par, inp):
    """The N-sharded fused MVM, without and with batch axes, beside the
    one-device call on the same inputs."""
    cfg = calibrated_config("dscim2", 64, "paper")
    out = []
    for x, w, gk in inp["mvm"]:
        qw = prepare_linear_weight(torch.from_numpy(w), gk)
        x = torch.from_numpy(x)
        ref = dscim_fused_mvm_prepared(x, qw, cfg)
        got = dscim_fused_mvm_sharded(x, qw, cfg, par)
        got_b = dscim_fused_mvm_sharded(x, qw, cfg, par,
                                        batch_axes=par.dp_axes)
        out.append((ref.numpy(), got.numpy(), got_b.numpy()))
    return out


def job_mvm4(par, inp):
    """``job_mvm`` on a 'model=4' mesh over the same four ranks."""
    return job_mvm(parallel_ctx_from_spec("model=4"), inp)


def job_paged(par, inp):
    """The DP-sharded paged read beside the one-device read, on a seeded
    pool: B=4 slots, 2 kv heads of 2 queries, head 16, pages of 4, 3
    pages a slot, any slot on any page, ragged positions."""
    g = torch.Generator().manual_seed(0)
    B, KV, R, HD, ps, MP, P = 4, 2, 2, 16, 4, 3, 12

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8)

    args = [torch.randn((B, KV, R, HD), generator=g), ints(P, ps, KV, HD),
            ints(P, ps, KV, HD), torch.rand((P, KV), generator=g) / 64,
            torch.rand((P, KV), generator=g) / 64,
            torch.randn((B, ps, KV, HD), generator=g).to(torch.bfloat16),
            torch.randn((B, ps, KV, HD), generator=g).to(torch.bfloat16),
            torch.randperm(P, generator=g)[:B * MP].reshape(B, MP).to(
                torch.int32),
            torch.tensor([11, 3, 6, 9], dtype=torch.int32)]
    ref = paged_attention_decode(*args)
    got = paged_attention_decode_sharded(*args, par=par,
                                         dp_axes=par.dp_axes)
    return ref.numpy(), got.numpy()


def _qwen(inp, spec="kernel:dscim1:256"):
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), dscim=spec)
    return cfg


def job_serve(par, inp):
    """serve_batch of the reduced qwen3 at kernel:dscim1:256, float and
    int8 KV, from the seeded params placed by params_from_jax; and int8
    with spec='dscim2:2' (greedy: bitwise the plain tokens)."""
    cfg = _qwen(inp)
    params = params_from_jax(inp["qwen_params"], device="cpu", par=par)
    res = {}
    for kv in ("float", "int8"):
        t = {}
        toks, logits = serve_batch(cfg, params, inp["prompts"], 6, kv=kv,
                                   device="cpu", par=par, timings=t)
        res[kv] = (toks, logits[0], t["graph"])
    res["spec"] = serve_batch(cfg, params, inp["prompts"], 6, kv="int8",
                              device="cpu", par=par, spec="dscim2:2")[0]
    return res


def job_moe(par, inp):
    """serve_batch of the reduced deepseek-moe at exact:dscim2:64, plain
    and with spec='dscim2:2' (the windows' per-position expert
    parallelism)."""
    cfg = dataclasses.replace(get_arch("deepseek-moe-16b").reduced(),
                              dscim="exact:dscim2:64")
    params = params_from_jax(inp["moe_params"], device="cpu", par=par)
    toks, logits = serve_batch(cfg, params, inp["prompts"], 5, device="cpu",
                               par=par)
    spec = serve_batch(cfg, params, inp["prompts"], 5, device="cpu",
                       par=par, spec="dscim2:2")[0]
    return toks, logits[0], spec


def job_ep(par, inp):
    """The MoE layer with expert parallelism beside the local layer."""
    from repro_torch.layers.moe import moe, moe_with_aux
    p = params_from_jax(inp["ep_params"], device="cpu")
    x = torch.from_numpy(inp["ep_x"])
    kw = dict(top_k=2, capacity_factor=8.0, has_shared=True)
    ref, ref_aux = moe_with_aux(p, x, **kw)
    placed = {"router": p["router"], "shared": p["shared"],
              "experts": {k: place_leaf(f"moe/experts/{k}", v, par)
                          for k, v in p["experts"].items()}}
    got = moe(placed, x, par=par, **kw)
    _, aux = moe_with_aux(placed, x, par=par, **kw)
    return ref.numpy(), got.numpy(), float(ref_aux), float(aux)


def job_continuous(par, inp):
    """serve_continuous of the reduced qwen3, int8 KV, 4 slots."""
    cfg = _qwen(inp)
    params = params_from_jax(inp["qwen_params"], device="cpu", par=par)
    outs, _ = serve_continuous(cfg, params, inp["cb_prompts"], 6, slots=4,
                               seg_len=2, max_new=inp["cb_budgets"],
                               kv="int8", page_size=4, device="cpu",
                               log=lambda *a: None, par=par)
    return [np.asarray(o) for o in outs]


def run_router(cfg, params, reqs, record=False, **kw):
    """Every request submitted before ``start()``, drained: the statuses
    and tokens, and with ``record`` the replays and the integrity
    record."""
    from repro_torch.runtime.router import Router

    async def run():
        r = Router(cfg, params, slots=3, seg_len=2, kv="int8", page_size=4,
                   buckets=(4, 8), chunk_len=4, max_prompt=24,
                   max_new_cap=8, device="cpu", log=lambda *a: None, **kw)
        hs = [r.submit(p, b) for p, b in reqs]
        await r.start()
        res = await asyncio.gather(*[h.result() for h in hs])
        await r.close()
        out = [(x.status, list(x.tokens)) for x in res]
        if not record:
            return out
        st = r.stats()
        ig = {k: v for k, v in st["integrity"].items()
              if k != "scrub_time_s"}
        return out, st["replays"], ig
    return asyncio.run(run())


def job_router(par, inp):
    cfg = _qwen(inp)
    params = params_from_jax(inp["qwen_params"], device="cpu", par=par)
    return run_router(cfg, params, inp["router_reqs"], par=par)


class HangAt(Watchdog):
    """A hang watchdog that flags a hang before its ``at``-th step, once,
    where ``hangs`` (one rank of a mesh, or the one device)."""

    def __init__(self, at: int, hangs: bool):
        super().__init__(hang_timeout=600.0)
        self.at, self.hangs, self.n = at, hangs, 0

    def step(self, par=None):
        self.n += 1
        if self.hangs and self.n == self.at:
            self._hang.set()
        return super().step(par)


def knob_injector(cls, inp):
    """The knobs' sampled fault schedule (one weight flip, one page flip,
    no device loss) from ``cls`` (either package's ``FailureInjector``)."""
    return cls.sampled(inp["knob_seed"], segments=6, slots=4, n_layers=2,
                       page_size=4, n_kv=2, head_dim=16, device_losses=0,
                       flips=1, weight_paths=("layers/mlp/w_up",),
                       weight_flip_count=1)


def knob_run(cfg, params, inp, par=None, hangs=True):
    """serve_continuous of the knobs' queue: integrity 'verify', a
    deadline_s per request, the hang watchdog (a hang before its 3rd
    step where ``hangs``) and the sampled injector, a snapshot every
    segment: (outputs, statuses, replays, integrity record)."""
    wd = HangAt(3, hangs)
    try:
        outs, st = serve_continuous(
            cfg, params, inp["knob_prompts"], 6, slots=4, seg_len=2,
            max_new=inp["knob_budgets"], eos_id=-1, kv="int8", page_size=4,
            deadline_s=inp["knob_deadlines"], watchdog=wd,
            injector=knob_injector(FailureInjector, inp), snapshot_every=1,
            integrity="verify", device="cpu", log=lambda *a: None, par=par)
    finally:
        wd.close()
    ig = dict(st["integrity"])
    ig.pop("scrub_time_s")
    ig["detections"] = [{"kind": d["kind"], "coords": [
        tuple(int(v) if not isinstance(v, str) else v for v in c)
        for c in d["coords"]]} for d in ig["detections"]]
    return ([np.asarray(o) for o in outs], st["status"], st["replays"], ig)


def job_knobs(par, inp):
    """``knob_run`` under the mesh, the hang on rank 1 alone."""
    cfg = _qwen(inp)
    params = params_from_jax(inp["qwen_params"], device="cpu", par=par)
    return knob_run(cfg, params, inp, par, hangs=dist.get_rank() == 1)


def job_router_knobs(par, inp):
    """The router with integrity 'verify' and a weight flip at segment 1
    (repaired, then replayed from the verified snapshot)."""
    cfg = _qwen(inp)
    params = params_from_jax(inp["qwen_params"], device="cpu", par=par)
    return run_router(cfg, params, inp["router_reqs"], record=True, par=par,
                      **router_knobs())


def router_knobs() -> dict:
    return dict(integrity="verify", injector=FailureInjector(
        weight_flips={1: (("layers/mlp/w_up", "q", 4099, 0x10),)}))


JOBS = {"mvm": job_mvm, "mvm4": job_mvm4, "paged": job_paged,
        "serve": job_serve,
        "moe": job_moe, "ep": job_ep, "continuous": job_continuous,
        "router": job_router, "knobs": job_knobs,
        "router_knobs": job_router_knobs}


def main(argv):
    rank, world, store, spec, jobs, src, dst = argv
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=int(rank), world_size=int(world))
    try:
        par = parallel_ctx_from_spec(spec)
        with open(src, "rb") as f:
            inp = pickle.load(f)
        out = {job: JOBS[job](par, inp) for job in jobs.split(",")}
        with open(dst, "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
