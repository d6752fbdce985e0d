"""Training driver (port of ``repro/launch/train.py``): data pipeline ->
train step -> checkpoints, with the step watchdog and failover replay.

    python -m repro_torch.launch.train --arch olmo-1b --steps 8 --batch 8 \\
        --seq 512 --ckpt /tmp/ck

trains ``--arch`` at its published width on the GPU (``--reduced`` cuts it
to the smoke-test size, ``--device cpu`` runs on the CPU) on the
synthetic bigram corpus (data/synthetic.py), keyed by step, so a restart
from a checkpoint replays the same batches.  ``--fail-at`` injects a
simulated hardware failure before those steps: the loop restores the
latest checkpoint and replays.  Every step is one eager forward and
backward (``launch/steps.py make_train_step``) at the config's
``dscim``: the CLI trains at 'off', as the reference's; a ``TrainLoop``
given a config with a DS-CIM spec trains through that mode (every mode
but 'kernel', which has no gradient; the RWKV and hybrid families do not
read the spec).

``--mesh pod16x16|pod2x16x16|dNxM`` trains under that mesh, one process
a device (runtime/elastic.py ``mesh_from_env``; NCCL on CUDA, gloo with
``--device cpu``):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --reduced --mesh d2x2

Every rank draws the same global batch and trains its DP slice; params
and AdamW state are placed by launch/sharding.py's rules, checkpoints
are written whole by rank 0 and placed again on restore, and every rank
takes the same failover decision (``TrainLoop._maybe_fail``).  Only
rank 0 prints.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..checkpoint.checkpointer import Checkpointer
from ..configs import TOKEN_ARCHS, get_arch
from ..data.pipeline import DataPipeline
from ..data.synthetic import SyntheticLM
from ..device import resolve_device
from ..models.registry import get_model
from ..optim.adamw import AdamW, cosine_schedule
from ..runtime.failover import (FailureInjector, SimulatedHardwareFailure,
                                run_with_failover)
from ..runtime.watchdog import StepHang, Watchdog
from .mesh import make_parallel_ctx
from .sharding import shard_params
from .steps import make_train_step

__all__ = ["TrainLoop", "main"]


class TrainLoop:
    """``steps`` steps of ``batch`` x ``seq`` tokens at a cosine learning
    rate peaking at ``lr``, a checkpoint every ``ckpt_every`` steps and
    at the end when ``ckpt_dir`` is given, on ``device`` (CUDA unless the
    caller asks for another).  ``mesh``: None or 'off' (one device), or a
    ``DeviceMesh`` over the joined process group (e.g. runtime/elastic.py
    ``mesh_from_env``); every rank then runs this loop
    (``make_train_step(par=)``).  ``history`` records each step's loss,
    wall seconds (``time``) and seconds waited for its batch
    (``data_s``), replayed steps again."""

    def __init__(self, cfg, *, steps: int, batch: int, seq: int,
                 ckpt_dir: str | None = None, lr: float = 3e-4,
                 mesh=None, ckpt_every: int = 20, seed: int = 0,
                 fail_at: tuple = (), log=print, device=None):
        self.par = None
        if mesh is not None and not (isinstance(mesh, str)
                                     and mesh == "off"):
            self.par = make_parallel_ctx(mesh)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.steps, self.batch, self.seq = steps, batch, seq
        self.log = log
        self.model = get_model(cfg)
        self.opt = AdamW(lr=cosine_schedule(lr, warmup=max(steps // 20, 5),
                                            total=steps))
        self.ckpt = Checkpointer(ckpt_dir, par=self.par) if ckpt_dir \
            else None
        self.ckpt_every = ckpt_every
        self.injector = FailureInjector(fail_at=fail_at)
        self.data = SyntheticLM(cfg.vocab, seed=seed)
        self.seed = seed
        self.history: list[dict] = []
        self.step_fn = make_train_step(cfg, self.opt, self.device, self.par,
                                       log=log)

    # -- state management ----------------------------------------------------
    def _placed(self, params):
        return params if self.par is None else shard_params(params, self.par)

    def init_state(self):
        params = self._placed(self.model.init_params(self.cfg, self.seed,
                                                     device=self.device))
        return {"params": params, "opt": self.opt.init(params), "step": 0}

    def restore_or_init(self):
        if self.ckpt is not None:
            params = self._placed(self.model.init_params(
                self.cfg, self.seed, device="meta"))
            got = self.ckpt.restore_latest(
                {"params": params, "opt": self.opt.init(params)},
                device=self.device)
            if got is not None:
                step, tree, _ = got
                self.log(f"[train] resumed from step {step}")
                return {"params": tree["params"], "opt": tree["opt"],
                        "step": step}
        return self.init_state()

    # -- main loop -----------------------------------------------------------
    def _run(self, state):
        wd = Watchdog(hang_timeout=600.0,
                      on_straggler=lambda info: self.log(
                          f"[watchdog] straggler: {info}"))
        pipe = DataPipeline(self.data, self.batch, self.seq,
                            start_step=state["step"])
        params, opt_state = state["params"], state["opt"]
        saved = None
        try:
            for step in range(state["step"], self.steps):
                t0 = time.perf_counter()
                batch_np = next(pipe)
                data_s = time.perf_counter() - t0
                self._maybe_fail(step, wd)
                batch = {"tokens": batch_np["tokens"],
                         "labels": batch_np["labels"]}
                with wd.step():
                    t0 = time.perf_counter()
                    params, opt_state, metrics = self.step_fn(
                        params, opt_state, batch)
                    loss = float(metrics["loss"])
                    dt = time.perf_counter() - t0
                self.history.append({"step": step, "loss": loss,
                                     "time": dt, "data_s": data_s})
                if step % 10 == 0 or step == self.steps - 1:
                    self.log(f"[train] step {step:5d} loss {loss:.4f} "
                             f"({dt*1e3:.0f} ms)")
                if self.ckpt and (step + 1) % self.ckpt_every == 0:
                    self.ckpt.save(step + 1,
                                   {"params": params, "opt": opt_state},
                                   extras={"loss": loss})
                    saved = step + 1
            if self.ckpt and saved == self.steps:
                self.ckpt.wait()          # the last step's save is the end's
            elif self.ckpt:
                self.ckpt.save(self.steps,
                               {"params": params, "opt": opt_state},
                               blocking=True)
            return {"params": params, "opt": opt_state, "step": self.steps}
        finally:
            pipe.close()
            wd.close()

    def _maybe_fail(self, step: int, wd: Watchdog) -> None:
        """The injector's failure at ``step`` (one device), or under a mesh
        ``_agreed_fault``: a failure injected, or a hang the watchdog
        flagged, on any rank is raised on every rank before the step, so
        no rank enters the step's collectives while another restores."""
        if self.par is None:
            self.injector.maybe_fail(step)
            return
        mine = self.injector.due(step)
        fail, hang = self.par.agree([mine, wd.hung])
        if hang:
            raise StepHang(f"a rank's step before {step} exceeded "
                           "hang_timeout")
        if fail:
            if mine:
                self.injector.maybe_fail(step)
            raise SimulatedHardwareFailure(f"injected fault at step {step} "
                                           "on another rank")

    def run(self):
        state, restarts = run_with_failover(
            self._run, restore_fn=self.restore_or_init,
            recoverable=(SimulatedHardwareFailure, StepHang),
            log=self.log)
        if restarts:
            self.log(f"[train] completed after {restarts} failover restart(s)")
        return state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmo-1b", choices=TOKEN_ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--mesh", default="off",
                    help="off | pod16x16 | pod2x16x16 | dNxM: train under "
                         "that mesh, one process a rank under torchrun "
                         "(NCCL; gloo with --device cpu)")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu to train on the CPU (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.mesh == "off":
        return _train(args, cfg, args.device, None)
    import os
    import sys

    import torch.distributed as dist

    from ..runtime.elastic import mesh_from_env
    from .mesh import init_distributed
    dev = init_distributed(args.device)
    try:
        os.environ["REPRO_MESH"] = args.mesh
        mesh = mesh_from_env()
        if dist.get_rank() != 0:           # every rank trains, rank 0 prints
            sys.stdout = open(os.devnull, "w")
        loop = _train(args, cfg, dev, mesh)
        # every rank done with its last collective before any tears its
        # connections down (a gloo peer cut off mid-transfer aborts)
        dist.barrier()
        return loop
    finally:
        dist.destroy_process_group()


def _train(args, cfg, device, mesh):
    """``main`` after the device (and under ``--mesh`` the mesh) is set."""
    loop = TrainLoop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt, lr=args.lr, mesh=mesh,
                     fail_at=tuple(args.fail_at), device=device)
    loop.run()
    losses = [h["loss"] for h in loop.history]
    print(f"[train] first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.4f}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(loop.history, f)
    return loop


if __name__ == "__main__":
    main()
