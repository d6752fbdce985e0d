"""Tile autotuner for the port's Hopper kernels (port of
``repro/kernels/autotune.py``).

Three CUDA entries take a tile argument: the fused DS-CIM MVM
(``csrc/dscim_fused.cu``: the ``launch_mvm`` instantiation, split or
unsplit windows, columns a block and cp.async stages), the count kernel
(``csrc/dscim_counts.cu``: the block's columns, rows and warps) and paged
attention (``csrc/paged_attention.cu``: the KV heads a block takes, and
the q rows padded in the wrapper).  Tile ``-1`` is each kernel's fixed
rule, what an untuned call launches.  Every candidate offered gives
bitwise the output of the rule: the fused MVM adds the same window terms
in the same order whatever its tile (the source's header), the counts are
integers, exact in f32 below 2^24, in any order, and a paged slot's
page walk is its own whatever block holds it.  The paged kernel's
split-KV run length is no candidate: it follows the slot's own length,
so that a slot's output does not depend on its batch-mates.

``best`` returns the cached winner for a key or sweeps the candidates:
each is timed with CUDA events on one shared operand set (a warm-up,
then the least of a few rounds of launches queued behind a device
sleep); one that fails to launch is skipped.
Winners are cached in memory always, in the JSON file that
``REPRO_AUTOTUNE_CACHE`` names, and shipped in ``autotune_cache.json``
beside this module (winners at the main path's decode shapes).  Lookup
order: memory -> the env-named file -> the packaged cache; only the
env-named file is ever written.  A key carries the card's name and the
backend segment ``cuda``, so a cache written on another card never
matches (the reference's ``autotune_cache.json`` holds TPU and
interpret-mode winners and is never read).

A sweep launches kernels and times them, which a CUDA graph capture
cannot hold: the wrappers' ``prepare_capture`` sweep before a capture,
and a lookup that misses during one raises.  The sweep's launches count
on ``SWEEP_LAUNCHES``, not on the kernels' own counters.  On the CPU the
plain versions have no tiles: ``tune=True`` there is a no-op.
"""
from __future__ import annotations

import functools
import json
import os
import time
from pathlib import Path

import torch

from . import build

__all__ = ["best", "clear", "fused_tiles", "mvm_tiles", "paged_attn_tiles",
           "DEFAULT_CACHE", "FUSED_DECODE_TILES", "FUSED_PREFILL_TILES",
           "MVM_TILES", "ARITY", "SWEEP_LAUNCHES", "STATS", "card_name",
           "fused_tile_index", "mvm_tile_index"]

_CACHE: dict[str, tuple] = {}
_CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
DEFAULT_CACHE = Path(__file__).resolve().parent / "autotune_cache.json"
SWEEP_LAUNCHES = build.LaunchCounter("autotune sweeps")
# sweeps run and their seconds (a cached key sweeps nothing)
STATS = {"sweeps": 0, "sweep_s": 0.0}

# The fused MVM's tiles, in the order of csrc/dscim_fused.cu's ``decode``
# / ``prefill`` switches: (columns a block, cp.async
# stages, 2 where the windows are split over blocks else 1).  Decode is
# M <= 16 (8 or 16 rows a block, by M); prefill M > 16 (64 rows).
FUSED_DECODE_TILES = ((64, 4, 2), (64, 3, 2), (64, 2, 2), (128, 3, 1),
                      (128, 4, 1), (128, 2, 1), (64, 3, 1), (64, 4, 1),
                      (64, 2, 1))
FUSED_PREFILL_TILES = ((64, 3, 2), (64, 3, 1), (32, 3, 1), (64, 4, 1),
                       (32, 4, 1))
# The count kernel's tiles, in the order of csrc/dscim_counts.cu's
# ``run_tile`` switch: (columns, rows, warps) a block.
MVM_TILES = ((128, 8, 4), (256, 128, 16), (128, 32, 8), (256, 32, 8),
             (128, 64, 8), (128, 16, 4))
# the paged read's representative walk (paged_attn_tiles): the main
# path's decode ends at prompt 64 + 16 tokens
WALK = 80
# the length of each kind's value: fused and mvm a tile above, paged
# attention (KV heads a block, q rows)
ARITY = {"fused": 3, "mvm": 3, "paged_attn": 2}


def clear():
    _CACHE.clear()


@functools.lru_cache(maxsize=16)
def card_name(device) -> str:
    """The card's name, as a key segment (no '/')."""
    return torch.cuda.get_device_name(torch.device(device)).replace("/", "_")


def _disk_path() -> str | None:
    return os.environ.get(_CACHE_ENV) or None


def _read_json(path) -> dict:
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            pass
    return {}


def _load_disk() -> dict:
    """The on-disk caches merged: the packaged winners, then the
    env-named (writable) file over them."""
    data: dict = {}
    for path in (DEFAULT_CACHE, _disk_path()):
        data.update(_read_json(path))
    return data


def _save_disk(key: str, val: tuple):
    path = _disk_path()
    if not path:
        return
    # the env-named file alone: merging the packaged cache in would freeze
    # its entries there, shadowing later updates of the shipped winners
    data = _read_json(path)
    data[key] = list(val)
    with open(path, "w") as f:
        json.dump(data, f, indent=0, sort_keys=True)


def time_cuda(fn, n: int = 3, reps: int = 10, warmup: int = 2) -> float:
    """Device ms of one call of ``fn``: a warm-up, then the least over
    ``n`` rounds of ``reps`` calls between two CUDA events.  Before each
    round the device sleeps for twice the host time the calls take to
    queue, so the events time the device's work and not the host's (a
    decode-shaped launch takes the host longer to issue than the device
    to run: timed without the sleep, the sweep ranked host noise)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # about 2e9 cycles a second; the sleep only has to outlast the queue
    cycles = int(min(2.0 * reps * (time.perf_counter() - t0) + 1e-3, 1.0)
                 * 2e9)
    best_ms = float("inf")
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best_ms = min(best_ms, start.elapsed_time(end) / reps)
    return best_ms


def best(key: str, candidates, bench, timer=time_cuda) -> tuple:
    """The cached winner for ``key``, or the sweep's over ``candidates``.

    ``bench(cand)`` returns a zero-argument callable that launches the
    kernel with that candidate (it is called only by a sweep, so a
    lookup makes no operands); ``timer`` times such a callable (device
    ms).  A candidate whose bench or launch raises is skipped; with none
    left, ``ValueError``."""
    if key in _CACHE:
        return _CACHE[key]
    disk = _load_disk()
    if key in disk:
        win = tuple(disk[key])
        _CACHE[key] = win
        return win
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"autotune: {key} swept during a CUDA graph "
                           "capture; call the kernel's prepare_capture "
                           "with tune=True first")
    t0 = time.perf_counter()
    win, win_t = None, float("inf")
    for cand in candidates:
        try:
            t = timer(bench(cand))
        except (RuntimeError, ValueError):   # a tile this shape refuses
            continue
        if t < win_t:
            win, win_t = tuple(cand), t
    STATS["sweeps"] += 1
    STATS["sweep_s"] += time.perf_counter() - t0
    if win is None:
        raise ValueError(f"autotune: no viable candidate for {key}")
    _CACHE[key] = win
    _save_disk(key, win)
    return win


def _cfg_seg(cfg) -> str:
    return f"{cfg.name}/k{cfg.k}L{cfg.length}t{cfg.trunc}"


def fused_tile_index(M: int, tile) -> int:
    """The C entry's tile index of a fused-MVM tile at M rows."""
    return (FUSED_DECODE_TILES if M <= 16 else FUSED_PREFILL_TILES).index(
        tuple(tile))


def fused_candidates(M: int, nw: int) -> list:
    """The fused MVM's candidates at M rows and nw windows: split tiles
    only where the windows make more than one chunk (8 chunks at most,
    ``kMaxChunks``)."""
    tiles = FUSED_DECODE_TILES if M <= 16 else FUSED_PREFILL_TILES
    chunk = -(-nw // 8)
    return [t for t in tiles if t[2] == 1 or -(-nw // chunk) > 1]


def fused_tiles(M: int, qw, cfg, dtype: torch.dtype) -> tuple:
    """The fused MVM's winner for x (M, K) of ``dtype`` against the
    prepared weight ``qw`` on its CUDA device.  The sweep times the kernel
    on seeded activations over ``qw`` and copies of it that together
    hold twice the card's L2 cache, in turn: a forward meets each layer's
    weight once, cold, and at decode reading it is the kernel's time."""
    from ..core.qweights import QuantizedLinearWeight
    from .dscim_fused import _launch_kernel
    dev = qw.q.device
    key = (f"fused/{_cfg_seg(cfg)}/{M}x{qw.k_orig}x{qw.n}/g{qw.g}/"
           f"{str(dtype).removeprefix('torch.')}/cuda/{card_name(dev)}")

    @functools.cache
    def operands():
        x = torch.randn((M, qw.k_orig), generator=torch.Generator(
            device=dev).manual_seed(0), device=dev).to(dtype)
        nbytes = qw.q.numel() + 4 * qw.scale.numel()
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        copies = min(32, -(-2 * l2 // nbytes))
        return x, [qw] + [QuantizedLinearWeight(
            qw.q.clone(), qw.scale.clone(), qw.k_orig, qw.group_k)
            for _ in range(copies - 1)]

    def bench(cand):
        (x, ws), i = operands(), fused_tile_index(M, cand)
        return lambda: [_launch_kernel(x, w, cfg, tile=i,
                                       counter=SWEEP_LAUNCHES) for w in ws]
    # a call already walks every copy: two calls a round
    return best(key, fused_candidates(M, qw.nw), bench,
                functools.partial(time_cuda, reps=2))


def mvm_tile_index(tile) -> int:
    return MVM_TILES.index(tuple(tile))


def mvm_tiles(x, w, ta, tb, k: int) -> tuple:
    """The count kernel's winner for int8 x (M, K), w (K, N) with tables
    ta/tb (G, S, W) on their CUDA device (timed on these operands)."""
    from .dscim_mvm import launch_counts
    (M, K), N = x.shape, w.shape[1]
    G, S, W = ta.shape
    key = (f"mvm/k{k}G{G}S{S}W{W}/{M}x{K}x{N}/cuda/"
           f"{card_name(x.device)}")

    def bench(cand):
        i = mvm_tile_index(cand)
        return lambda: launch_counts(x, w, ta, tb, k, SWEEP_LAUNCHES,
                                     tile=i)
    return best(key, MVM_TILES, bench)


def paged_attn_candidates(KV: int, R: int) -> list:
    """(KV heads a block, q rows) candidates: head groups that divide KV,
    and the rows unpadded or padded to a multiple of 8."""
    ghs = sorted({g for g in (1, 2, 4, KV) if KV % g == 0})
    qps = sorted({R, -(-R // 8) * 8})
    return [(gh, qp) for gh in ghs for qp in qps]


def paged_attn_tiles(B: int, KV: int, R: int, HD: int, ps: int,
                     device) -> tuple:
    """The paged read's (gh, qp) winner for a (B, KV, R, HD) query against
    ``ps``-token int8 pages.  The page count is not in the key (the
    reference's rule): candidates are swept over a representative walk
    of ``WALK`` tokens a slot (the reference walked 4 pages; a walk of
    one run, 32 tokens at page 8, lets a block of two heads win where the
    main path's 80 tokens take three runs and one head a block wins by
    40 %)."""
    from .paged_attention import _launch_kernel
    dev = torch.device(device)
    key = (f"paged_attn/B{B}/kv{KV}r{R}hd{HD}/ps{ps}/cuda/"
           f"{card_name(dev)}")
    @functools.cache
    def operands():
        MP = -(-WALK // ps)
        P = B * MP
        gen = torch.Generator(device=dev).manual_seed(0)

        def rnd(*shape, dtype=torch.float32):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        pages = [torch.randint(-127, 128, (P, ps, KV, HD), generator=gen,
                               device=dev, dtype=torch.int8)
                 for _ in range(2)]
        scales = [rnd(P, KV).abs() * 0.01 + 0.005 for _ in range(2)]
        tails = [rnd(B, ps, KV, HD, dtype=torch.bfloat16) for _ in range(2)]
        table = torch.randperm(P, generator=gen, device=dev).to(
            torch.int32).reshape(B, MP)
        pos = torch.full((B,), WALK - 2, dtype=torch.int32, device=dev)
        return (rnd(B, KV, R, HD), *pages, *scales, *tails, table, pos)

    def bench(cand):
        args = operands()
        return lambda: _launch_kernel(*args, tile=cand,
                                      counter=SWEEP_LAUNCHES)
    return best(key, paged_attn_candidates(KV, R), bench)
