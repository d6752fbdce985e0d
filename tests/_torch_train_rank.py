"""One rank of the port's training-under-a-mesh tests
(tests/test_torch_train_mesh.py spawns every rank of a group as this
script, over gloo with a ``file://`` store).

    python tests/_torch_train_rank.py RANK WORLD STORE JOBS IN OUT

joins the group, runs each job of the comma-separated JOBS on the inputs
pickled in IN (each job builds the mesh it needs over the group) and
pickles this rank's results (a dict, job -> numpy results) to OUT.  Only
the port is imported here: the parent holds the results against one
device and against the reference.
"""
import os
import pickle
import sys
import warnings
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_debug_mesh, make_parallel_ctx
from repro_torch.launch.pipeline import (gelu_mlp_stage, pipeline_forward,
                                         pp_dryrun)
from repro_torch.launch import steps
from repro_torch.launch.sharding import shard_params
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TrainLoop
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compression import compressed_psum_tree
from repro_torch.parallel import Sharded
from repro_torch.runtime.elastic import mesh_from_env
from repro_torch.tree import leaves

ARCHS = ("olmo-1b", "granite-moe-1b-a400m")
TRAIN_STEPS = 2


def _whole(par, tree):
    """A placed tree gathered whole, as numpy (every rank)."""
    if isinstance(tree, dict):
        return {k: _whole(par, v) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        tree = par.whole(tree)
    return tree.detach().numpy().copy()


def _train(par, inp, archs=ARCHS):
    """TRAIN_STEPS steps of each of ``archs`` from the shared params on the
    shared batch: each step's loss and gradient norm, and the params and
    AdamW state after the steps, whole."""
    out = {}
    for arch in archs:
        cfg = get_arch(arch).reduced()
        params = params_from_jax(inp["params"][arch], device="cpu", par=par)
        opt = AdamW(lr=1e-3)
        state = opt.init(params)
        step = make_train_step(cfg, opt, "cpu", par)
        metrics = []
        for _ in range(TRAIN_STEPS):
            params, state, m = step(params, state, inp["batch"])
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[arch] = (metrics, _whole(par, params), _whole(par, state))
    return out


def job_train_tp(inp):
    """The train steps under model=2 (no DP split)."""
    return _train(make_parallel_ctx(make_debug_mesh(1, 2)), inp)


def job_train_2x2(inp):
    """The train steps under data=2,model=2."""
    return _train(make_parallel_ctx(make_debug_mesh(2, 2)), inp)


def job_train_2x2_no_aux(inp):
    """The granite train steps under data=2,model=2 with the MoE aux's
    weight 0."""
    with mock.patch.object(steps, "AUX_WEIGHT", 0.0):
        return _train(make_parallel_ctx(make_debug_mesh(2, 2)), inp,
                      archs=("granite-moe-1b-a400m",))


def job_train_tp_no_aux(inp):
    """The granite train steps under model=2 with the MoE aux's weight
    0."""
    with mock.patch.object(steps, "AUX_WEIGHT", 0.0):
        return _train(make_parallel_ctx(make_debug_mesh(1, 2)), inp,
                      archs=("granite-moe-1b-a400m",))


RECURRENT = ("rwkv6-7b", "zamba2-7b")


def job_rec_tp(inp):
    """The recurrent families under model=2: serve_batch (tokens and
    prefill logits) and the train steps."""
    return _recurrent(make_parallel_ctx(make_debug_mesh(1, 2)), inp)


def job_rec_2x2(inp):
    """``job_rec_tp`` under data=2,model=2."""
    return _recurrent(make_parallel_ctx(make_debug_mesh(2, 2)), inp)


def _recurrent(par, inp):
    from repro_torch.launch.serve import serve_batch
    out = {"train": _train(par, inp, archs=RECURRENT)}
    for arch in RECURRENT:
        cfg = get_arch(arch).reduced()
        params = params_from_jax(inp["params"][arch], device="cpu", par=par)
        toks, logits = serve_batch(cfg, params, inp["prompts"],
                                   inp["serve_tokens"], device="cpu",
                                   par=par)
        out[arch] = (toks, logits[0])
    return out


def job_collectives(inp):
    """The autograd collectives over ``model`` (data=2,model=2), each
    beside the one-process composition it stands for, on the same
    seeded inputs: (gradients under the mesh, the composition's)."""
    par = make_parallel_ctx(make_debug_mesh(2, 2))
    i, n = par.coords["model"], par.sizes["model"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn((n * 3, 5), generator=g)
    w = torch.randn((n * 3, 5), generator=g)
    ts = torch.randn((n, n * 2, 3), generator=g)     # every rank's input
    ws = torch.randn((n, 2, n * 3), generator=g)     # every rank's weight
    out = {}
    # all_gather, consumers replicated: the loss of the whole
    piece = x[i * 3:(i + 1) * 3].clone().requires_grad_(True)
    (par.all_gather(piece, "model", 0) * w).sum().backward()
    whole = x.clone().requires_grad_(True)
    (whole * w).sum().backward()
    out["all_gather"] = (piece.grad.numpy(),
                         whole.grad[i * 3:(i + 1) * 3].numpy())
    # split: each rank's slice of a whole tensor
    xs = x.clone().requires_grad_(True)
    (par.split(xs, "model", 0) * w[i * 3:(i + 1) * 3]).sum().backward()
    out["split"] = (xs.grad.numpy(), whole.grad.numpy())
    # all_to_all: each rank's loss of what it received, summed
    t = ts[i].clone().requires_grad_(True)
    (par.all_to_all(t, "model", 0, 1) * ws[i]).sum().backward()
    tt = ts.clone().requires_grad_(True)
    loss = sum((torch.cat([tt[j][r * 2:(r + 1) * 2] for j in range(n)], 1)
                * ws[r]).sum() for r in range(n))
    loss.backward()
    out["all_to_all"] = (t.grad.numpy(), tt.grad[i].numpy())
    return out


def _loop(mesh, ckpt, fail_at=()):
    cfg = get_arch("olmo-1b").reduced()
    return TrainLoop(cfg, steps=6, batch=4, seq=16, ckpt_dir=ckpt, lr=1e-3,
                     ckpt_every=2, mesh=mesh, fail_at=fail_at,
                     log=lambda *a: None, device="cpu")


def job_loop(inp):
    """TrainLoop under data=2,model=2: a failure-free run, then a run
    whose failure at step 3 is injected on rank 0 alone; both histories,
    the clean run's final state whole (its last checkpoint is the
    parent's to restore on one device), and the one-device checkpoints
    of ``inp['ckpts']`` restored under the mesh and gathered whole."""
    mesh = make_debug_mesh(2, 2)
    clean = _loop(mesh, os.path.join(inp["tmp"], "clean"))
    state = clean.run()
    fail_at = (3,) if dist.get_rank() == 0 else ()
    faulty = _loop(mesh, os.path.join(inp["tmp"], "faulty"), fail_at)
    faulty.run()
    par = clean.par
    restored = {}
    for name, d in inp["ckpts"].items():
        cfg = get_arch("olmo-1b").reduced()
        meta = shard_params(get_model(cfg).init_params(cfg, 0,
                                                       device="meta"), par)
        target = {"params": meta, "opt": AdamW().init(meta)}
        step, tree, _ = Checkpointer(d, par=par).restore_latest(
            target, device="cpu")
        placed = sum(isinstance(x, Sharded) for x in leaves(tree))
        restored[name] = (step, placed, _whole(par, tree))
    return {"clean": [(h["step"], h["loss"]) for h in clean.history],
            "faulty": [(h["step"], h["loss"]) for h in faulty.history],
            "state": _whole(par, {"params": state["params"],
                                  "opt": state["opt"]}),
            "restored": restored}


def job_elastic(inp):
    """``mesh_from_env`` on this group: the mesh each REPRO_MESH gives
    (sizes), the RuntimeWarnings it raised, or the error it raised."""
    out = {}
    for spec in ("d2x2", "pod16x16", None, "d4x4", "d2x4", "pod2x16x16"):
        if spec is None:
            os.environ.pop("REPRO_MESH", None)
        else:
            os.environ["REPRO_MESH"] = spec
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            try:
                m = mesh_from_env()
                got = dict(zip(m.mesh_dim_names, m.shape))
            except ValueError as e:
                got = f"ValueError: {e}"
        out[spec] = (got, [str(x.message) for x in w
                           if issubclass(x.category, RuntimeWarning)])
    return out


def job_psum(inp):
    """``compressed_psum_tree`` over pod=2: this rank's slice of the
    stacked gradients and errors in, the mean and the new error out."""
    par = make_parallel_ctx(make_debug_mesh(1, 1, pod=2))
    i = par.coords["pod"]

    def mine(t):
        if isinstance(t, dict):
            return {k: mine(v) for k, v in t.items()}
        return torch.from_numpy(np.ascontiguousarray(t[i]))
    g, e = compressed_psum_tree(mine(inp["psum_g"]), mine(inp["psum_e"]),
                                "pod", par)
    return ([x.numpy() for x in leaves(g)], [x.numpy() for x in leaves(e)])


def job_pipe(inp):
    """``pipeline_forward`` over pod=2 on the shared stages and
    microbatches (f32), and ``pp_dryrun`` at a small size."""
    par = make_parallel_ctx(make_debug_mesh(1, 1, pod=2))
    w1, w2, x = (torch.from_numpy(a) for a in inp["pipe"])
    counter = {}
    out = pipeline_forward((w1, w2), x, stage_fn=gelu_mlp_stage, par=par,
                           counter=counter)
    rec = pp_dryrun(d_model=64, d_ff=128, layers_per_stage=2,
                    microbatches=4, mb_size=2, seq=8, par=par,
                    device="cpu")
    w1d, w2d, xd = rec.pop("inputs")
    seq_out = torch.stack([gelu_mlp_stage((w1d[1], w2d[1]),
                                          gelu_mlp_stage((w1d[0], w2d[0]),
                                                         xm))
                           for xm in xd])
    rec["bitwise_stages_in_turn"] = bool(torch.equal(rec.pop("out"),
                                                     seq_out))
    return out.numpy(), counter["sends"], rec


JOBS = {"train_tp": job_train_tp, "train_2x2": job_train_2x2,
        "train_2x2_no_aux": job_train_2x2_no_aux,
        "train_tp_no_aux": job_train_tp_no_aux, "rec_tp": job_rec_tp,
        "rec_2x2": job_rec_2x2, "collectives": job_collectives,
        "loop": job_loop, "elastic": job_elastic, "psum": job_psum,
        "pipe": job_pipe}


def main(argv):
    rank, world, store, jobs, src, dst = argv
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=int(rank), world_size=int(world))
    try:
        with open(src, "rb") as f:
            inp = pickle.load(f)
        out = {job: JOBS[job](inp) for job in jobs.split(",")}
        with open(dst, "wb") as f:
            pickle.dump(out, f)
        # every rank done with its last collective before any tears its
        # connections down (a gloo peer cut off mid-transfer aborts)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
