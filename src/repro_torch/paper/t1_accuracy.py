"""Table I (accuracy rows) methodology: train a small classifier on a
synthetic 10-class task (CIFAR-10 is not available offline), quantize
every MVM to int8 and evaluate under the DS-CIM error against exact int8:
the pipeline the paper runs on ResNet18/CIFAR-10.

The classifier is a patchify-MLP (conv as matmul: every MVM goes through
``DSCIMLinear``), trained in float by SGD through autograd and evaluated
in float, exact int8, paper-style injection (DS-CIM1/L256, DS-CIM2/L64)
and the bit-exact LUT (paper and beyond-paper point sets).

  PYTHONPATH=src python -m repro_torch.paper t1_accuracy [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dscim_layer import make_linear
from ..device import resolve_device

__all__ = ["make_task", "init_net", "fwd", "train", "accuracy", "ROWS",
           "run", "main"]

LR, BATCH = 0.01, 128
# (row name, make_linear arguments) of the evaluations after float
ROWS = (
    ("int8_exact", ("dscim1", 256, "exact")),
    ("dscim1_L256_inject", ("dscim1", 256, "paper_inject")),
    ("dscim2_L64_inject", ("dscim2", 64, "paper_inject")),
    ("dscim1_L256_lut_paper", ("dscim1", 256, "lut")),
    ("dscim1_L256_lut_opt", ("dscim1", 256, "lut", "opt")),
)


def make_task(n: int = 2048, d: int = 192, classes: int = 10, seed: int = 0,
              task_seed: int = 42):
    """Separable blobs with structured noise (CIFAR stand-in).

    ``task_seed`` fixes the class prototypes (the task); ``seed`` draws the
    samples: train and eval share the task, never the samples."""
    protos = np.random.default_rng(task_seed).normal(0, 1, (classes, d))
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    x = protos[y] + rng.normal(0, 1.0, (n, d))
    x = x / np.linalg.norm(x, axis=1, keepdims=True) * np.sqrt(d)
    return x.astype(np.float32), y.astype(np.int32)


def init_net(gen: torch.Generator, d: int, h: int, classes: int) -> dict:
    """Fan-in scaled normal weights (host f32) drawn from ``gen``."""
    return {
        "w1": torch.randn(d, h, generator=gen) * d ** -0.5,
        "w2": torch.randn(h, h, generator=gen) * h ** -0.5,
        "w3": torch.randn(h, classes, generator=gen) * h ** -0.5,
    }


def fwd(p: dict, x: torch.Tensor, linear=None) -> torch.Tensor:
    mm = (lambda a, w: a @ w) if linear is None else linear
    h = torch.relu(mm(x, p["w1"]))
    h = torch.relu(mm(h, p["w2"]))
    return mm(h, p["w3"])


def train(p: dict, x: np.ndarray, y: np.ndarray, steps: int, dev) -> dict:
    """``steps`` SGD steps at LR on the mean cross-entropy of batches of
    BATCH rows, drawn as the reference draws them (``default_rng(0)``)."""
    p = {k: v.detach().to(dev).requires_grad_(True) for k, v in p.items()}
    xt = torch.as_tensor(x, device=dev)
    yt = torch.as_tensor(y, dtype=torch.int64, device=dev)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        idx = torch.as_tensor(rng.integers(0, len(x), BATCH), device=dev)
        lg = fwd(p, xt[idx])
        loss = -torch.gather(torch.log_softmax(lg, -1), 1,
                             yt[idx, None]).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            p = {k: (v - LR * g).requires_grad_(True)
                 for (k, v), g in zip(p.items(), grads)}
    return {k: v.detach() for k, v in p.items()}


@torch.no_grad()
def accuracy(p: dict, xe: torch.Tensor, ye: np.ndarray, linear=None) -> float:
    lg = fwd(p, xe, linear)
    return float((lg.argmax(-1).cpu().numpy() == ye).mean())


def run(steps: int = 300, widths=(256, 1024, 2048), init=None, device=None):
    """Sweep the contraction width K (the layer width): the paper-style
    injection's accuracy drop vanishes at ResNet-like K (>= 1k), while the
    physically accumulated path needs the beyond-paper zero-bias
    calibration ('opt') to stay accurate.  ``init``: each width's initial
    weights, a mapping from width to {"w1", "w2", "w3"} numpy arrays (a
    test starts from the reference's); by default each width draws them
    from a generator seeded 0."""
    dev = resolve_device(device)
    # a DSCIMLinear holds no width: each is built once (its count LUT and
    # error moments on the host) for every width
    linears = [(nm, make_linear(*args)) for nm, args in ROWS]
    rows = []
    for h in widths:
        x, y = make_task()
        xe, ye = make_task(512, seed=1)
        if init is None:
            p = init_net(torch.Generator().manual_seed(0), x.shape[1], h, 10)
        else:
            p = {k: torch.as_tensor(np.array(v, np.float32))
                 for k, v in init[h].items()}
        p = train(p, x, y, steps, dev)
        xe_t = torch.as_tensor(xe, device=dev)
        base = accuracy(p, xe_t, ye)
        rows.append({"name": f"t1acc/K{h}/float", "acc": base, "drop": 0.0})
        for nm, lin in linears:
            a = accuracy(p, xe_t, ye, lin)
            rows.append({"name": f"t1acc/K{h}/{nm}", "acc": a,
                         "drop": base - a})
    return rows


def main(device=None, steps: int = 300):
    rows = run(steps=steps, device=device)
    for r in rows:
        print(f"{r['name']},0,acc={r['acc']:.4f};drop={r['drop']:+.4f}")
    return rows
