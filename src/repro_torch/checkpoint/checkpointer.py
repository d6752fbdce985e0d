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

Under a mesh (``par``, a ``parallel.ParallelCtx``) every rank calls
``save`` and ``restore`` at the same points.  ``save`` gathers each
placed (``Sharded``) leaf whole, a collective, and rank 0 alone writes,
in the same format: a checkpoint does not know the mesh it came from.
``restore`` waits for rank 0's pending write and for every rank, reads
the whole leaves and places this rank's pieces where the target's leaf
is a ``Sharded`` (the reference's reshard on restore): a checkpoint
saved under one mesh restores under another or on one device.

A leaf restored onto a CUDA device is read from its file in chunks into
two pinned host buffers, each chunk's copy to the device running while
the next chunk is read (``_Stager``); the bytes are the file's, so the
tensors are bitwise those of ``np.load`` and a pageable copy.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from ..parallel import Sharded
from ..tree import leaves, structure, unflatten

__all__ = ["Checkpointer"]


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy of one leaf, never a view of the caller's memory."""
    return x.detach().to("cpu", copy=True).numpy()


STAGE_BYTES = 64 << 20      # each of the two pinned staging buffers


def _npy_header(f):
    """(shape, dtype) of the ``.npy`` file open at its start, leaving it
    at the first data byte.  ``ValueError`` for a file ``Checkpointer.save``
    does not write (it ``np.save``s C-contiguous copies of torch tensors):
    Fortran order, a header version other than 1.0 or 2.0, a non-native
    or object dtype, a dtype torch lacks."""
    fmt = np.lib.format
    version = fmt.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = fmt.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = fmt.read_array_header_2_0(f)
    else:
        raise ValueError(f"npy header version {version}")
    if fortran or dtype.hasobject or not dtype.isnative:
        raise ValueError(f"npy dtype {dtype} (fortran_order={fortran})")
    try:
        return shape, torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError:
        raise ValueError(f"npy dtype {dtype} has no torch dtype") from None


class _Stager:
    """Reads ``.npy`` files into device tensors through two host buffers
    (pinned where the device is CUDA): chunk j is read into buffer j % 2
    once that buffer's last copy has finished, then copied to the device
    without blocking, so the next read overlaps the copy."""

    def __init__(self, device, nbytes: int = STAGE_BYTES):
        self.dev = torch.device(device)
        cuda = self.dev.type == "cuda"
        self.bufs = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
                     for _ in range(2)]
        self.views = [memoryview(b.numpy()) for b in self.bufs]
        self.events = [None, None]
        self.turn = 0

    def _wait(self, k):
        if self.events[k] is not None:
            self.events[k].synchronize()
            self.events[k] = None

    def load(self, path: str, shape: tuple):
        """The array of ``path`` as a tensor on the device; ``ValueError``
        before any data is read if ``_npy_header`` refuses the file or
        its shape is not ``shape``."""
        with open(path, "rb") as f:
            head = _npy_header(f)
            if tuple(head[0]) != tuple(shape):
                raise ValueError(f"shape {head[0]} != expected "
                                 f"{tuple(shape)}")
            out = torch.empty(head[0], dtype=head[1], device=self.dev)
            flat = out.view(-1).view(torch.uint8)
            total, off = flat.numel(), 0
            while off < total:
                k, self.turn = self.turn, self.turn ^ 1
                n = min(total - off, self.bufs[k].numel())
                self._wait(k)
                view, got = self.views[k], 0
                while got < n:
                    r = f.readinto(view[got:n])
                    if not r:
                        raise ValueError(f"{path}: {total} data bytes "
                                         f"expected, the file ends at "
                                         f"{off + got}")
                    got += r
                flat[off:off + n].copy_(self.bufs[k][:n], non_blocking=True)
                if self.dev.type == "cuda":
                    self.events[k] = torch.cuda.Event()
                    self.events[k].record()
                off += n
        return out

    def finish(self):
        """Wait for the pending copies (the buffers may then be freed)."""
        self._wait(0)
        self._wait(1)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, par=None):
        self.dir = directory
        self.keep = keep
        self.par = par
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._error: Exception | None = None

    @property
    def _writer(self) -> bool:
        """Whether this process writes: one device, or rank 0 of a mesh."""
        import torch.distributed as dist
        return self.par is None or dist.get_rank() == 0

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, extras: dict | None = None,
             blocking: bool = False):
        """Async by default; the previous pending save is joined first.
        Under a mesh, a collective: every rank calls it."""
        self.wait()
        flat = leaves(tree)
        if self.par is not None:
            flat = [self.par.whole(x) for x in flat]
        if not self._writer:
            return
        host_leaves = [_host(x) for x in flat]
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

    def _synced(self) -> None:
        """Under a mesh: rank 0's pending write published, and every rank
        here, before any rank reads."""
        if self.par is not None:
            self.wait()
            self.par.barrier()

    def restore(self, step: int, target_tree, device=None):
        """Load the leaves of ``step`` as tensors on ``device`` (default:
        each target leaf's device), in the file's dtype.  ``target_tree``
        gives the structure and the shapes, not the values (``meta``
        tensors will do); where its leaf is a ``Sharded``, this rank's
        piece of the whole leaf is placed by its spec.  Returns (tree,
        extras); a checkpoint whose leaf count or a leaf's shape differs
        raises ``ValueError``."""
        self._synced()
        return self._read(step, target_tree, device)

    def _read(self, step: int, target_tree, device):
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        refs = leaves(target_tree)
        if manifest["n_leaves"] != len(refs):
            raise ValueError(f"checkpoint/model structure mismatch: "
                             f"{manifest['n_leaves']} leaves in {d}, "
                             f"{len(refs)} in the target")
        out = []
        stager = None
        for i, ref in enumerate(refs):
            path = os.path.join(d, f"arr_{i:05d}.npy")
            dev = device if device is not None else (
                ref.local.device if isinstance(ref, Sharded) else ref.device)
            if not isinstance(ref, Sharded) \
                    and torch.device(dev).type == "cuda":
                stager = stager or _Stager(dev)
                try:
                    out.append(stager.load(path, ref.shape))
                except ValueError as e:
                    raise ValueError(f"leaf {i} {e}") from None
                continue
            arr = np.load(path)
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i} shape {arr.shape} != expected "
                                 f"{tuple(ref.shape)}")
            if isinstance(ref, Sharded):
                from ..launch.sharding import shard_for, wrap
                piece = shard_for(self.par.rank_coords, ref.spec, arr)
                out.append(wrap(torch.from_numpy(
                    np.ascontiguousarray(piece)).to(dev), ref.spec,
                    ref.shape))
                continue
            out.append(torch.from_numpy(arr).to(dev))
        if stager is not None:
            stager.finish()
        return unflatten(target_tree, out), manifest["extras"]

    def restore_latest(self, target_tree, device=None):
        self._synced()
        step = self.latest_step()
        if step is None:
            return None
        tree, extras = self._read(step, target_tree, device)
        return step, tree, extras
