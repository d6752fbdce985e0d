"""Raw DS-CIM OR counts over all L sampling points (port of
``repro/kernels/dscim_mvm.py``), and the count kernel it shares with the
blocked-points wrapper (``dscim_mvm_blocked.dscim_counts_blocked``).

For int8 x (M, K), w (K, N) with a = (x+128)>>k, b = (w+128)>>k and the
folded point coordinates (cu, lu, cv, lv) (L,):

    C[m,n] = Σ_h |{t : (cu_t, cv_t) = block(h mod G),
                     lu_t < a[m,h], lv_t < b[h,n]}|

``dscim_counts``

* on a CUDA tensor launches ``csrc/dscim_counts.cu``, which sums
  ``popc(ta & tb)`` over per-block bit-mask tables built here from the
  points (an exact rewrite of the all-L bit expansion for any point set
  with at most 256 points in one block) as a binary matrix product on the
  b1 tensor cores (see the source's header);
* on a CPU tensor runs ``dscim_counts_plain``, the reference's {0,1}
  bit expansion over all L points (``ref.py dscim_counts_ref``), chunked
  over N.

Counts are exact integers, returned as f32 as in the reference.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.remap import point_block
from . import build

__all__ = ["dscim_counts", "dscim_counts_plain", "points_by_block", "tuned_launch",
           "count_mask_tables", "point_tables", "launch_counts",
           "prepare_capture", "check_exact_matmuls", "LAUNCHES"]

LAUNCHES = build.LaunchCounter("dscim_counts")
_PREPARE = build.LaunchCounter("dscim_counts capture preparation")
BIT_BUDGET = 1 << 26      # plain versions: bit-expansion elements per chunk
# dscim_counts_launch(x, w, ta, tb, out, M, K, N, k, G, S, W, tile, stream)
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def check_exact_matmuls(t: torch.Tensor, name: str) -> None:
    """A plain count version sums {0,1} bits through f32 matmuls, which are
    exact only in full f32: on CUDA that needs TF32 off."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{name} needs exact f32 matmuls; set "
                           "torch.backends.cuda.matmul.allow_tf32=False")


def points_by_block(cu, lu, cv, lv, k: int):
    """Folded points (L,) -> (G, P) int32 tables of each block's local
    coordinates (lu, lv), in point order; empty slots hold S, which no
    shifted value a < S exceeds, so they never fire.  Points whose block
    code lies outside [0, 2^k) belong to no row and are dropped."""
    n, S = 1 << k, 256 >> k
    cu, lu, cv, lv = (np.asarray(t, np.int64) for t in (cu, lu, cv, lv))
    keep = (cu >= 0) & (cu < n) & (cv >= 0) & (cv < n)
    blk = point_block(cu, cv, k)[keep]
    lu, lv = lu[keep], lv[keep]
    G = n * n
    per = np.bincount(blk, minlength=G)
    P = max(int(per.max(initial=0)), 1)
    tu = np.full((G, P), S, np.int64)
    tv = np.full((G, P), S, np.int64)
    fill = np.zeros(G, np.int64)
    for t in range(blk.size):
        g = blk[t]
        tu[g, fill[g]], tv[g, fill[g]] = lu[t], lv[t]
        fill[g] += 1
    return tu, tv


def count_mask_tables(tu, tv, S: int):
    """(G, P) per-block point tables -> (G, S, W) bit-mask tables:
    bit p of word j of ta[g, a] is set when point 32j+p of block g has
    lu < a, and of tb[g, b] when lv < b.  W is ceil(P/32) rounded up to a
    power of two (1, 2, 4 or 8, the kernel's instances); unused bits are 0.
    Returned as int32 arrays holding the uint32 bits, for torch."""
    G, P = tu.shape
    W = 1 << max(0, (-(-P // 32) - 1).bit_length())
    if W > 8:
        raise ValueError(f"{P} points in one block exceed the count "
                         "kernel's 256-bit masks")
    pad = W * 32 - P
    tu = np.pad(np.asarray(tu, np.int64), ((0, 0), (0, pad)),
                constant_values=S)
    tv = np.pad(np.asarray(tv, np.int64), ((0, 0), (0, pad)),
                constant_values=S)
    vals = np.arange(S, dtype=np.int64)[None, :, None, None]
    bits = np.int64(1) << np.arange(32, dtype=np.int64)
    ta = ((tu.reshape(G, 1, W, 32) < vals) * bits).sum(-1)
    tb = ((tv.reshape(G, 1, W, 32) < vals) * bits).sum(-1)
    return (ta.astype(np.uint32).view(np.int32),
            tb.astype(np.uint32).view(np.int32))


@functools.lru_cache(maxsize=64)
def _tables_for_points(points: bytes, L: int, k: int):
    cu, lu, cv, lv = np.frombuffer(points, np.int32).reshape(4, L)
    return count_mask_tables(*points_by_block(cu, lu, cv, lv, k), 256 >> k)


_DEVICE_TABLES: dict = {}


def point_tables(cu, lu, cv, lv, k: int, device):
    """The count kernel's (G, S, W) mask tables for the folded points
    (cu, lu, cv, lv), on ``device``; cached by the points' values.  The
    first copy to a CUDA device is from pageable host memory, which a
    CUDA graph capture forbids: ``prepare_capture`` makes the tables
    first, and a first copy during capture raises."""
    pts = np.stack([torch.as_tensor(t).detach().cpu().numpy().astype(
        np.int32) for t in (cu, lu, cv, lv)])
    points, L = pts.tobytes(), pts.shape[1]
    device = torch.device(device)
    key = (points, L, k, device)
    tabs = _DEVICE_TABLES.get(key)
    if tabs is None:
        if device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("count tables copied to the device during a "
                               "CUDA graph capture; call prepare_capture "
                               "first")
        tabs = tuple(torch.as_tensor(t, device=device)
                     for t in _tables_for_points(points, L, k))
        _DEVICE_TABLES[key] = tabs
    return tabs


def prepare_capture(points, k: int, M: int, device, stream,
                    shapes=((128, 128),), tune: bool = False) -> None:
    """Everything ``dscim_counts`` makes at first use, made before a CUDA
    graph capture on ``stream`` that counts M rows with the folded
    ``points`` (cu, lu, cv, lv): the library built and bound, the mask
    tables on the device, and one launch on zero operands of each (K, N)
    in ``shapes`` (module load, the shared-memory attribute) at the
    tuner's winner under ``tune`` (swept here where no cache holds it:
    timing is impossible inside a capture)."""
    build.load("dscim_counts")
    ta, tb = point_tables(*points, k, device)
    with torch.cuda.stream(stream):
        for K, N in shapes:
            x = torch.zeros((M, K), dtype=torch.int8, device=device)
            w = torch.zeros((K, N), dtype=torch.int8, device=device)
            tuned_launch(x, w, ta, tb, k, _PREPARE, tune)


def dscim_counts_plain(x_i8, w_i8, cu, lu, cv, lv, k: int) -> torch.Tensor:
    """Plain PyTorch counts: the {0,1} bit expansion over all L points,
    abits (M, K·L) @ wbits (K·L, N) in f32 (exact: every partial sum is an
    integer < 2^24), in chunks of N so the expansion stays bounded."""
    check_exact_matmuls(x_i8, "dscim_counts_plain")
    dev = x_i8.device
    a = (x_i8.to(torch.int32) + 128) >> k
    b = (w_i8.to(torch.int32) + 128) >> k
    (M, K), N = a.shape, b.shape[1]
    cu, lu, cv, lv = (torch.as_tensor(t, device=dev).to(torch.int32)
                      for t in (cu, lu, cv, lv))
    L = cu.numel()
    n = 1 << k
    blk = torch.arange(K, device=dev) % (n * n)
    bc, br = blk % n, blk // n
    abit = ((cu[None, None, :] == bc[None, :, None])
            & (lu[None, None, :] < a[:, :, None])).to(torch.float32)
    abit = abit.reshape(M, K * L)
    colbit = (cv[None, :] == br[:, None])[:, :, None]          # (K, L, 1)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    nc = max(1, BIT_BUDGET // max(K * L, 1))
    for n0 in range(0, N, nc):
        bb = b[:, n0:n0 + nc]
        wbit = (colbit & (lv[None, :, None] < bb[:, None, :])).to(
            torch.float32)
        out[:, n0:n0 + nc] = abit @ wbit.reshape(K * L, -1)
    return out


def launch_counts(x, w, ta, tb, k: int, counter: build.LaunchCounter,
                  tile: int = -1) -> torch.Tensor:
    """Launch ``csrc/dscim_counts.cu`` on contiguous int8 x (M, K), w (K, N)
    and int32 (G, S, W) tables on one CUDA device at block ``tile``
    (kernels/autotune.py ``MVM_TILES``; -1 the kernel's rule); counts the
    launch on ``counter``.  Returns (M, N) f32 counts."""
    M, K = x.shape
    N = w.shape[1]
    G, S, W = ta.shape
    for t, dt in ((x, torch.int8), (w, torch.int8), (ta, torch.int32),
                  (tb, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != x.device:
            raise ValueError("dscim_counts kernel takes contiguous int8 x/w "
                             "and int32 tables on one CUDA device")
    if w.shape[0] != K or tb.shape != ta.shape or S != 256 >> k \
            or G != 4 ** k:
        raise ValueError(f"dscim_counts kernel: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, tables {tuple(ta.shape)} for "
                         f"k={k}")
    if K * 32 * W >= 1 << 24:
        raise ValueError(f"dscim_counts kernel: K={K} with {W}-word masks "
                         "can count past 2^24, where f32 is not exact")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    fn = build.bind("dscim_counts", "dscim_counts_launch", ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w.data_ptr(), ta.data_ptr(), tb.data_ptr(),
            out.data_ptr(), M, K, N, k, G, S, W, tile, stream)
    if rc == -1:
        raise ValueError(f"dscim_counts kernel does not take k={k}, W={W} "
                         f"at tile {tile} (its tables past shared memory)")
    if rc != 0:
        raise RuntimeError(f"dscim_counts kernel launch failed: error {rc}")
    counter.count += 1
    return out


def tuned_launch(x, w, ta, tb, k: int, counter: build.LaunchCounter,
                 tune: bool) -> torch.Tensor:
    """``launch_counts`` at the tuner's winner under ``tune`` (a sweep
    where no cache holds the shape), else at the rule."""
    tile = -1
    if tune:
        from . import autotune
        tile = autotune.mvm_tile_index(autotune.mvm_tiles(x, w, ta, tb, k))
    return launch_counts(x, w, ta, tb, k, counter, tile)


def dscim_counts(x_i8, w_i8, cu, lu, cv, lv, *, k: int, length: int,
                 tune: bool = False) -> torch.Tensor:
    """OR-accumulated counts (M, N) f32 of int8 x (M, K) and w (K, N) over
    the L folded points (cu, lu, cv, lv), each (L,) int32.  ``tune``: on
    the card, the tile autotuner's winner (the same counts); on the CPU
    a no-op."""
    if any(t.numel() != length for t in (cu, lu, cv, lv)):
        raise ValueError(f"point coordinates must have length {length}")
    x = x_i8.to(torch.int8)
    w = w_i8.to(torch.int8)
    if x.device.type == "cpu":
        return dscim_counts_plain(x, w, cu, lu, cv, lv, k)
    if x.device.type != "cuda":
        raise ValueError(f"no dscim_counts route for device {x.device}")
    ta, tb = point_tables(cu, lu, cv, lv, k, x.device)
    return tuned_launch(x.contiguous(), w.contiguous(), ta, tb, k, LAUNCHES,
                        tune)
