"""End-to-end driver on the PyTorch port: train an LM on the synthetic
corpus with checkpoints, the step watchdog and failover, then serve the
trained weights through the DS-CIM estimator.

Presets (olmo-1b's family, as ``examples/train_lm.py`` sets them):
  tiny  (default) -- about 1M parameters, 300 steps, minutes on a CPU.
  100m            -- olmo-style, about 100M parameters (d=768, 12 layers),
                     f32 compute, no remat: for the GPU.

  PYTHONPATH=src python examples/train_lm_torch.py --preset tiny --device cpu
  PYTHONPATH=src python examples/train_lm_torch.py --preset 100m   # CUDA
"""
import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.qweights import map_params
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.train import TrainLoop


def preset_cfg(name: str):
    base = get_arch("olmo-1b")
    if name == "tiny":
        return dataclasses.replace(
            base.reduced(), d_model=128, n_heads=4, n_kv=4, head_dim=32,
            d_ff=384, vocab=512, n_layers=4)
    if name == "100m":
        return dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv=12,
            head_dim=64, d_ff=3072, compute_dtype="float32", remat=False)
    raise ValueError(name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="tiny", choices=("tiny", "100m"))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (default: a fresh temp dir; pass an "
                         "existing dir to resume)")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject a simulated hardware fault at these steps")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = preset_cfg(args.preset)
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    loop = TrainLoop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=ckpt, lr=2e-3, fail_at=tuple(args.fail_at),
                     device=args.device)
    state = loop.run()
    losses = [h["loss"] for h in loop.history]
    if losses:
        print(f"\nloss: {np.mean(losses[:10]):.3f} -> "
              f"{np.mean(losses[-10:]):.3f} "
              f"({args.steps} steps, {cfg.name} {args.preset})")
    else:
        print(f"\n(already trained to step {state['step']}; resumed "
              f"checkpoint from {ckpt})")

    # serve the trained weights: the float path against the int8-exact
    # DCIM baseline and the DS-CIM1/L256 error model.  The tiny preset's
    # contraction width (d_model 128) is one 128-row macro window, DS-CIM's
    # worst case.
    params = map_params(lambda _, a: a.detach(), state["params"])
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16))
    toks_f, _ = serve_batch(cfg, params, prompts, 8, device=args.device)
    for tag, spec in (("int8-exact", "exact:dscim1:256"),
                      ("DS-CIM1/L256", "paper_inject:dscim1:256")):
        cfg_ds = dataclasses.replace(cfg, dscim=spec)
        toks_d, _ = serve_batch(cfg_ds, params, prompts, 8,
                                device=args.device)
        agree = float((toks_f == toks_d).mean())
        print(f"{tag} serving: greedy-token agreement {agree:.2f} "
              f"vs float path")


if __name__ == "__main__":
    main()
