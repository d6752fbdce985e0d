"""Failover replay and failure injection for the continuous-batching
scheduler (port of the serving half of ``repro/runtime/failover.py``).

``run_with_failover`` wraps the scheduler's segment loop: on a recoverable
failure it restores the latest serve-state snapshot and runs the loop
again from that segment boundary, up to ``max_restarts`` times.

``FailureInjector`` drives chaos tests deterministically:

* ``fail_at`` — a segment-level device loss: ``maybe_fail(seg)`` raises
  ``SimulatedHardwareFailure`` once per listed segment, so a replay does
  not fail again;
* ``page_flips`` — int8 page-pool bit upsets: at a segment, XOR a mask
  into one element of a slot's share of the paged KV cache (int8 page
  planes, f32 scales or the bf16 tail), addressed logically (slot, plane,
  element) so the affected request is known whatever page ids the
  allocator gave; each fires once (a transient upset);
* ``weight_flips`` — bit upsets in prepared weight planes, addressed by
  the plane's path string and a flat offset; each fires once;
* ``macro_fault_at`` — a persistent stuck-at fault of the DS-CIM macro:
  from that segment on ``serving_fault(seg)`` returns ``macro_fault``
  (a ``cfg.dscim_fault`` spec, models/lm.py ``_parse_fault``) and the
  scheduler serves through a second, faulted segment runner.

``to_host`` / ``restore_into`` take a serve state's host snapshot and copy
it back into the live tensors (the scheduler's and the router's
snapshots), so a restore keeps every captured graph bound.

Every flip XORs into the live tensor in place (``flip_bits``: int8
directly, f32 through ``view(torch.int32)``, bf16 through
``view(torch.int16)``): the captured graphs bound those addresses and
read the corrupted bits on their next replay, as a device would.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SimulatedHardwareFailure", "IntegrityReplay", "FailureInjector",
           "run_with_failover", "flip_bits", "to_host", "restore_into"]


class SimulatedHardwareFailure(RuntimeError):
    pass


class IntegrityReplay(RuntimeError):
    """A repaired fault whose poisoned tokens must be discarded: recovered
    through the same snapshot restore as a device loss."""


_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16}


def flip_bits(t: torch.Tensor, index: tuple, mask: int) -> torch.Tensor:
    """XOR ``mask`` into element ``index`` of ``t``, in place (integer
    dtypes directly, floats through a same-width integer view, so a flip
    can hit a f32 scale's exponent); returns ``t``.  ``mask`` must fit
    the element's width: a wider one would silently truncate, and the
    claim that the flip hit that plane would be false."""
    width = t.element_size() * 8
    if not 0 < int(mask) < (1 << width):
        raise ValueError(f"flip_bits: mask {mask:#x} does not fit a "
                         f"{width}-bit {t.dtype} element")
    view = t.view(_BITS[t.dtype]) if t.dtype.is_floating_point else t
    signed = int(mask) - (1 << width) if mask >= 1 << (width - 1) \
        else int(mask)
    view[tuple(int(i) for i in index)] ^= signed
    return t


@dataclasses.dataclass
class FailureInjector:
    """Deterministic faults at given segment numbers.

    ``page_flips``: {segment: ((slot, plane, index, mask), ...)}; plane is
    'k_pages'/'v_pages' (index (layer, page_ord, tok, kv, hd)),
    'k_scale'/'v_scale' (index (layer, page_ord, kv)) or 'k_tail'/
    'v_tail' (index (layer, tok, kv, hd)); ``page_ord`` is the ordinal in
    the slot's granted pages, translated to a physical id by
    ``corrupt_cache`` through the scheduler's slot_pages.
    ``weight_flips``: {segment: ((path, 'q'|'scale', offset, mask), ...)}
    with ``path`` the plane's path string (core/qweights.py
    ``weight_plane_index``) and ``offset`` a flat element offset taken mod
    the plane's size.  ``macro_fault_at`` / ``macro_fault``: arm
    ``cfg.dscim_fault`` from that segment on (persistent: it is in force
    again on a replay, unlike the one-shot flips).  ``hits`` records each
    page flip applied as (segment, plane, physical index), the
    coordinates an integrity check must name."""
    fail_at: tuple = ()
    page_flips: dict = dataclasses.field(default_factory=dict)
    weight_flips: dict = dataclasses.field(default_factory=dict)
    macro_fault_at: int | None = None
    macro_fault: str = "stuck:5:24.0"
    fired: set = dataclasses.field(default_factory=set)
    hits: list = dataclasses.field(default_factory=list)

    @classmethod
    def sampled(cls, seed: int, *, segments: int = 64, slots: int = 4,
                n_layers: int = 2, page_size: int = 8, n_kv: int = 1,
                head_dim: int = 8, device_losses: int = 1, flips: int = 2,
                macro_fault: str | None = None,
                weight_paths: tuple = (),
                weight_flip_count: int = 0) -> "FailureInjector":
        """A random but reproducible fault schedule over ``segments``
        segments: ``device_losses`` device losses, ``flips`` page-pool
        upsets at random (slot, plane, element) addresses, optionally
        ``weight_flip_count`` weight-plane upsets and a persistent macro
        fault armed mid-run.  All of it comes from one
        ``np.random.default_rng(seed)`` stream drawn in the reference's
        order, so a seed gives the reference's schedule (the
        ``--chaos-seed`` contract)."""
        rng = np.random.default_rng(seed)
        hi = max(segments, 2)
        fail_at = tuple(sorted(rng.choice(
            np.arange(1, hi), size=min(device_losses, hi - 1),
            replace=False).tolist()))
        planes = ("k_pages", "v_pages", "k_scale", "v_scale",
                  "k_tail", "v_tail")
        page_flips: dict = {}
        for _ in range(flips):
            seg = int(rng.integers(1, hi))
            slot = int(rng.integers(0, slots))
            plane = planes[int(rng.integers(0, len(planes)))]
            layer = int(rng.integers(0, n_layers))
            if plane.endswith("_scale"):
                index = (layer, 0, int(rng.integers(0, n_kv)))
                mask = 1 << int(rng.integers(20, 31))      # f32 high bits
            elif plane.endswith("_tail"):
                index = (layer, int(rng.integers(0, page_size)),
                         int(rng.integers(0, n_kv)),
                         int(rng.integers(0, head_dim)))
                mask = 1 << int(rng.integers(8, 15))       # bf16 high bits
            else:
                index = (layer, 0, int(rng.integers(0, page_size)),
                         int(rng.integers(0, n_kv)),
                         int(rng.integers(0, head_dim)))
                mask = 1 << int(rng.integers(0, 8))        # int8 any bit
            page_flips[seg] = page_flips.get(seg, ()) \
                + ((slot, plane, index, mask),)
        weight_flips: dict = {}
        if weight_flip_count and weight_paths:
            for _ in range(weight_flip_count):
                seg = int(rng.integers(1, hi))
                path = weight_paths[int(rng.integers(0, len(weight_paths)))]
                which = ("q", "scale")[int(rng.integers(0, 2))]
                offset = int(rng.integers(0, 1 << 30))   # taken mod size
                mask = (1 << int(rng.integers(0, 8)) if which == "q"
                        else 1 << int(rng.integers(20, 31)))
                weight_flips[seg] = weight_flips.get(seg, ()) \
                    + ((path, which, offset, mask),)
        macro_at = int(rng.integers(1, hi)) if macro_fault else None
        return cls(fail_at=fail_at, page_flips=page_flips,
                   weight_flips=weight_flips, macro_fault_at=macro_at,
                   macro_fault=macro_fault or "stuck:5:24.0")

    def due(self, step: int) -> bool:
        """Whether ``maybe_fail(step)`` would raise (nothing fired)."""
        return step in self.fail_at and step not in self.fired

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedHardwareFailure(f"injected fault at step {step}")

    def serving_fault(self, segment: int) -> str:
        """The cfg.dscim_fault spec in force at this segment ('' =
        healthy)."""
        if self.macro_fault_at is not None and segment >= self.macro_fault_at:
            return self.macro_fault
        return ""

    def corrupt_cache(self, segment: int, cache, slot_pages):
        """Apply this segment's due page-pool flips to the live paged
        cache, in place, once each.  ``slot_pages``: the scheduler's slot
        -> granted physical page ids.  Returns (cache, affected slots)."""
        affected = []
        for flip in self.page_flips.get(segment, ()):
            key = ("flip", segment, flip)
            if key in self.fired:
                continue
            slot, plane, index, mask = flip
            if slot_pages[slot] is None:
                continue            # slot idle this segment: nothing to hit
            self.fired.add(key)
            layer, first, *rest = index
            if plane.endswith("_tail"):
                full = (layer, slot, first, *rest)
            else:
                full = (layer, int(slot_pages[slot][first]), *rest)
            flip_bits(cache[plane], full, mask)
            self.hits.append((segment, plane, full))
            affected.append(slot)
        return cache, affected

    def corrupt_weights(self, segment: int, params):
        """Apply this segment's due prepared-weight flips in place, once
        each; the flat offset is unravelled against the live plane's
        shape.  Returns (params, [(path, which), ...] hit)."""
        from ..core.qweights import iter_qweight_planes
        planes = {(p, w): x for p, w, x in iter_qweight_planes(params)}
        hit = []
        for flip in self.weight_flips.get(segment, ()):
            key = ("wflip", segment, flip)
            if key in self.fired:
                continue
            self.fired.add(key)
            path, which, offset, mask = flip
            t = planes.get((path, which))
            if t is None:
                continue
            flip_bits(t, np.unravel_index(offset % t.numel(), t.shape), mask)
            hit.append((path, which))
        return params, hit


def to_host(tree: dict) -> dict:
    """A host copy of a serve state: every tensor cloned to the CPU,
    nested dicts copied, plain values as they are."""
    return {k: to_host(v) if isinstance(v, dict)
            else v.to("cpu", copy=True) if isinstance(v, torch.Tensor)
            else v for k, v in tree.items()}


def restore_into(dst: dict, src: dict) -> None:
    """Copy a host snapshot back into the live state's own tensors (the
    captured graphs bound their addresses), plain values by assignment."""
    for k, v in src.items():
        if isinstance(v, dict):
            restore_into(dst[k], v)
        elif isinstance(v, torch.Tensor):
            dst[k].copy_(v)
        else:
            dst[k] = v


def run_with_failover(train_fn, *, restore_fn, max_restarts: int = 3,
                      recoverable=(SimulatedHardwareFailure,), log=print):
    """``train_fn(start_state) -> final_state``; ``restore_fn() ->
    start_state``.  Returns (final_state, n_restarts); the failure that
    exceeds ``max_restarts`` propagates."""
    restarts = 0
    while True:
        state = restore_fn()
        try:
            return train_fn(state), restarts
        except recoverable as e:
            restarts += 1
            log(f"[failover] {type(e).__name__}: {e}; "
                f"restart {restarts}/{max_restarts}")
            if restarts > max_restarts:
                raise
