"""Checkpointing in the reference's on-disk format (port of
``repro/checkpoint/checkpointer.py``): one ``.npy`` file per leaf, a JSON
manifest, atomic renames, async writes and keep-N retention.

Layout:
  <dir>/step_000000123/
      manifest.json          # step, n_leaves, treedef, extras, time
      arr_00000.npy ...      # one file per leaf, in JAX's flatten order
  <dir>/LATEST               # atomic pointer file

Leaves are numbered in JAX's flatten order of the same nested dict (keys
sorted, ``tree.leaves``), and ``restore`` checks only the leaf count and
each leaf's shape, as the reference's does, so a checkpoint written here
restores in the reference and one written there restores here.  The
manifest's ``treedef`` is this package's own string (``tree.structure``)
where the reference writes JAX's.

``save`` copies every leaf to the host before its writer thread starts,
so a caller may update the tensors in place (the train step's AdamW)
while the files are written.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from ..tree import leaves, structure, unflatten

__all__ = ["Checkpointer"]


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy of one leaf, never a view of the caller's memory."""
    return x.detach().to("cpu", copy=True).numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, extras: dict | None = None,
             blocking: bool = False):
        """Async by default; the previous pending save is joined first."""
        self.wait()
        host_leaves = [_host(x) for x in leaves(tree)]
        treedef = structure(tree)

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            for i, leaf in enumerate(host_leaves):
                np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), leaf)
            manifest = {
                "step": step,
                "n_leaves": len(host_leaves),
                "treedef": treedef,
                "extras": extras or {},
                "time": time.time(),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                      # atomic publish
            with open(os.path.join(self.dir, ".LATEST_tmp"), "w") as f:
                f.write(os.path.basename(final))
            os.replace(os.path.join(self.dir, ".LATEST_tmp"),
                       os.path.join(self.dir, "LATEST"))
            self._gc()

        def _run():
            try:
                _write()
            except Exception as e:         # re-raised by wait()
                self._error = e

        t = threading.Thread(target=_run, daemon=True)
        t.start()
        self._pending = t
        if blocking:
            self.wait()

    def wait(self):
        """Join the pending save; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def latest_step(self) -> int | None:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.dir, name, "manifest.json")):
            return None
        return int(name.split("_")[1])

    def restore(self, step: int, target_tree, device=None):
        """Load the leaves of ``step`` as tensors on ``device`` (default:
        each target leaf's device), in the file's dtype.  ``target_tree``
        gives the structure and the shapes, not the values (``meta``
        tensors will do).  Returns (tree, extras); a checkpoint whose leaf
        count or a leaf's shape differs raises ``ValueError``."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        refs = leaves(target_tree)
        if manifest["n_leaves"] != len(refs):
            raise ValueError(f"checkpoint/model structure mismatch: "
                             f"{manifest['n_leaves']} leaves in {d}, "
                             f"{len(refs)} in the target")
        out = []
        for i, ref in enumerate(refs):
            arr = np.load(os.path.join(d, f"arr_{i:05d}.npy"))
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i} shape {arr.shape} != expected "
                                 f"{tuple(ref.shape)}")
            dev = device if device is not None else ref.device
            out.append(torch.from_numpy(arr).to(dev))
        return unflatten(target_tree, out), manifest["extras"]

    def restore_latest(self, target_tree, device=None):
        step = self.latest_step()
        if step is None:
            return None
        tree, extras = self.restore(step, target_tree, device)
        return step, tree, extras
