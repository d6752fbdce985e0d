"""Table II methodology on the port's own stack: train a small LM, then
evaluate it with the FP8 -> INT8-aligned DS-CIM error (injected, and the
bit-exact LUT) against exact, reporting the loss and accuracy deltas.
The LLaMA-7B weights are not available offline; the paper's mechanism
(quantize, align to int8 windows of 128, apply the DS-CIM error to the
MVM outputs) is reproduced end to end on reduced qwen3-0.6b, trained by
``launch/train.py TrainLoop`` on ``data/synthetic.py SyntheticLM``.

  PYTHONPATH=src python -m repro_torch.paper t2_llm [--device cpu]
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs import get_arch
from ..data.synthetic import SyntheticLM
from ..device import resolve_device
from ..launch.train import TrainLoop
from ..models.registry import get_model
from ..models.lm import lm_loss

__all__ = ["ARCH", "SPECS", "config", "evaluate", "train", "run", "main"]

ARCH = "qwen3-0.6b"
# the evaluated DS-CIM specs after the float ('off') row
SPECS = ("exact:dscim1:256", "paper_inject:dscim1:256",
         "paper_inject:dscim2:64", "lut:dscim1:256", "lut:dscim1:256:opt")
EVAL_BATCH, EVAL_SEQ, EVAL_STEP0 = 8, 32, 10_000
# training: batch x sequence, the cosine schedule's peak rate
TRAIN_BATCH, TRAIN_SEQ, LR = 8, 32, 2e-3


def config():
    """The experiment's config: reduced qwen3-0.6b."""
    return get_arch(ARCH).reduced()


@torch.no_grad()
def evaluate(cfg, params, spec: str, eval_batches: int = 4, device=None):
    """(mean loss, mean token accuracy) of ``params`` under the DS-CIM
    ``spec`` on ``eval_batches`` batches of the training language (seed
    0) at steps EVAL_STEP0 + i, which training never reaches.  The
    accuracy's argmax runs over the padded vocabulary, as the
    reference's."""
    dev = resolve_device(device)
    c = dataclasses.replace(cfg, dscim=spec)
    model = get_model(c)
    data = SyntheticLM(cfg.vocab, seed=0)
    losses, accs = [], []
    for i in range(eval_batches):
        b = data.batch(EVAL_BATCH, EVAL_SEQ, step=EVAL_STEP0 + i)
        tokens = torch.as_tensor(b["tokens"], dtype=torch.int64, device=dev)
        labels = torch.as_tensor(b["labels"], dtype=torch.int64, device=dev)
        logits, _ = model.forward(params, c, tokens)
        losses.append(float(lm_loss(logits, labels)))
        accs.append(float((logits.argmax(-1).cpu().numpy()
                           == b["labels"]).mean()))
    return float(np.mean(losses)), float(np.mean(accs))


def train(steps: int = 120, device=None):
    """Reduced qwen3-0.6b trained ``steps`` steps of TRAIN_BATCH x
    TRAIN_SEQ tokens at a cosine rate peaking at LR, no checkpoints ->
    (cfg, params)."""
    cfg = config()
    loop = TrainLoop(cfg, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     ckpt_dir=None, lr=LR, log=lambda *a: None,
                     device=device)
    return cfg, loop.run()["params"]


def run(steps: int = 120, eval_batches: int = 4, device=None):
    """Train, then one row per spec: float ('off') and SPECS.  This
    reduced LM has K = 64-96, under one 128-row window: the worst case
    for DS-CIM (see t1_accuracy's K sweep for the trend that reconciles
    these drops with the paper's near-zero ResNet/LLaMA drops)."""
    dev = resolve_device(device)
    cfg, params = train(steps, dev)
    base_loss, base_acc = evaluate(cfg, params, "off", eval_batches, dev)
    rows = [{"name": "t2/float", "loss": base_loss, "acc": base_acc,
             "delta": 0.0}]
    for spec in SPECS:
        loss, acc = evaluate(cfg, params, spec, eval_batches, dev)
        rows.append({"name": f"t2/{spec.replace(':', '_')}",
                     "loss": loss, "acc": acc, "delta": base_acc - acc})
    return rows


def main(device=None):
    rows = run(device=device)
    for r in rows:
        print(f"{r['name']},0,loss={r['loss']:.4f};acc={r['acc']:.4f};"
              f"acc_drop={r['delta']:+.4f}")
    return rows
