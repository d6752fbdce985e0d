"""Deterministic silent-data-corruption detection and targeted repair
(port of ``repro/runtime/integrity.py``).

* **KV page pool**: every physical page carries a uint32 digest of its
  int8 k/v planes and bitcast f32 scales (``core/kvcache.py
  page_checksums``) in the cache's ``page_sum`` plane, kept current by
  the write paths.  ``check_pages`` digests the live pool again and names
  each mismatch by its (layer, physical page).
* **Prepared weights**: every ``QuantizedLinearWeight`` plane (int8 q,
  f32 scale) is digested once beside a host golden copy
  (``core/qweights.py golden_weight_copy``).  ``check_weights`` digests
  the live planes again and names each mismatch by its (path,
  'q'|'scale'); ``repair_weights`` copies the golden bytes back into the
  live tensors, bitwise the freshly prepared model, no requantization.

Not covered: raw float leaves (norms, the embedding) and transient
activations, which stay the accuracy watchdog's statistical territory.

Cadence (the scheduler's ``integrity`` option): 'off' (no digest plane,
the plain path unchanged), 'verify' (every segment boundary) or
'scrub:<n>' (every n-th).  The counters live on the engine, not in the
scheduler's host books, so a snapshot-restore replay keeps the record of
what was found.  The sweeps run on the planes' device, one digest launch
each on CUDA (``kernels/digest.py``); ``sweep`` reads both sweeps' flags
and the slots' positions in one device-to-host copy, and a boundary's
checks apply them (the live mask on the host).

Under a mesh (``par``) each rank keeps the golden copy of its own
pieces of the prepared planes and digests its pieces and the page pool
it holds (whole on every rank in the port); the mismatch flags are
agreed over the mesh (a max, one collective a sweep), so every rank
names the same detections in whole-model terms, (path, 'q'|'scale') and
(layer, physical page), as one device names them, and the counts count
whole planes.  A rank
repairs the pieces it found corrupted; the repair's check is agreed
too.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

__all__ = ["parse_integrity", "IntegrityEngine", "Sweep"]


@dataclasses.dataclass
class Sweep:
    """One check's sweeps as the host read them (``IntegrityEngine.
    sweep``): this rank's weight mismatches, the agreed weight and page
    flags (the pages' unmasked, (L, P)) and the positions read with
    them."""
    mine: np.ndarray
    weights: np.ndarray
    pages: np.ndarray
    pos: np.ndarray | None


def parse_integrity(spec: str | None) -> int:
    """'off'|'verify'|'scrub:<n>' -> check period in segments (0 = off)."""
    if spec is None or spec == "off":
        return 0
    if spec == "verify":
        return 1
    if spec.startswith("scrub:"):
        try:
            n = int(spec.split(":", 1)[1])
        except ValueError:
            n = 0
        if n >= 1:
            return n
    raise ValueError(f"integrity spec {spec!r}: expected 'off', 'verify' "
                     f"or 'scrub:<n>' with n >= 1")


class IntegrityEngine:
    """Segment-boundary verifier and repair bookkeeping.  ``golden`` is
    the blob of ``prepare_serving_params(..., golden=True)`` (None, or an
    empty index, when the model has no prepared planes: weight checks
    then pass trivially).  ``par``: the mesh the params and the pool are
    placed on (the golden copy of this rank's pieces)."""

    def __init__(self, golden, *, period: int, par=None):
        self.period = int(period)
        self.par = par
        self.golden = golden
        self._mine = None      # this rank's mismatches at the last check
        self.index = list(golden["index"]) if golden else []
        self.ref_digests = (np.asarray(golden["digests"], np.int64)
                            if golden else np.zeros((0,), np.int64))
        self.detections: list = []
        self.counters = {"checks": 0,
                         "pages_verified": 0,
                         "weight_planes_verified": 0,
                         "page_mismatches": 0,
                         "weight_mismatches": 0,
                         "page_repairs": 0,
                         "weight_repairs": 0,
                         # the port's split of page_repairs: owner slots
                         # rewound, requests served again from the prompt
                         "rewinds": 0,
                         "reserves": 0,
                         "replays": 0,
                         "scrub_time_s": 0.0}

    def due(self, segment: int) -> bool:
        return self.period > 0 and segment % self.period == 0

    def sweep(self, params=None, cache=None, pos=None) -> Sweep:
        """Launch the weight sweep (``params``; one digest launch on CUDA)
        and the page compare (``cache``: every page of the pool, one more),
        then read their flags and ``pos`` (a device tensor, e.g. the
        cache's) in one device-to-host copy; under a mesh the flags are
        agreed in one collective.  The page flags are not masked: a check
        masks them on the host (``check_pages``)."""
        from ..core.kvcache import CHECKSUM_KEY, _PAGE_PLANES
        from ..core.qweights import weight_plane_digests
        from ..kernels.digest import page_flags
        t0 = time.perf_counter()
        parts = []
        nw = len(self.index) if params is not None else 0
        if nw:
            parts.append(weight_plane_digests(params))
        shape = (0, 0)
        if cache is not None:
            flags = page_flags(*(cache[name] for name in _PAGE_PLANES),
                               cache[CHECKSUM_KEY])
            shape = tuple(flags.shape)
            parts.append(flags.reshape(-1))
        if pos is not None:
            parts.append(pos.reshape(-1))
        # one copy (cat promotes the flags and positions to int64)
        host = torch.cat(parts).cpu().numpy() if parts \
            else np.zeros((0,), np.int64)
        mine = host[:nw] != self.ref_digests[:nw]
        npg = shape[0] * shape[1]
        flags = np.concatenate([mine, host[nw:nw + npg].astype(bool)])
        if self.par is not None:
            flags = self.par.agree(flags)
        self.counters["scrub_time_s"] += time.perf_counter() - t0
        return Sweep(mine=mine, weights=flags[:nw],
                     pages=flags[nw:].reshape(shape),
                     pos=host[nw + npg:] if pos is not None else None)

    def check_pages(self, cache, live_mask, sweep: Sweep | None = None
                    ) -> list:
        """Compare the pool's digests with the stored plane (``sweep``'s,
        else a page sweep of its own), return the mismatching (layer,
        physical page) coordinates.  ``live_mask`` (n_pages,) bool marks
        the pages granted AND completely flushed: only those have digests
        under warranty."""
        if sweep is None:
            sweep = self.sweep(cache=cache)
        t0 = time.perf_counter()
        mask = np.asarray(live_mask, bool)
        bad = sweep.pages & mask[None, :]
        self.counters["checks"] += 1
        self.counters["pages_verified"] += int(mask.sum()) * bad.shape[0]
        self.counters["scrub_time_s"] += time.perf_counter() - t0
        coords = [tuple(int(v) for v in c) for c in np.argwhere(bad)]
        if coords:
            self.counters["page_mismatches"] += len(coords)
            self.detections.append({"kind": "page", "coords": coords})
        return coords

    def _mismatch(self, params) -> np.ndarray:
        """(n_planes,) bool: this rank's pieces that digest off their
        golden digests."""
        from ..core.qweights import weight_plane_digests
        return weight_plane_digests(params).cpu().numpy() \
            != self.ref_digests

    def _agreed(self, mine: np.ndarray) -> np.ndarray:
        return mine if self.par is None else self.par.agree(mine)

    def check_weights(self, params, sweep: Sweep | None = None) -> list:
        """The prepared planes that digest off their golden digests
        (``sweep``'s, else a weight sweep of its own), as (path,
        'q'|'scale') pairs (under a mesh those of any rank's piece)."""
        if not self.index:
            return []
        if sweep is None:
            sweep = self.sweep(params=params)
        self._mine = sweep.mine
        self.counters["weight_planes_verified"] += len(self.index)
        bad = [self.index[i] for i in np.nonzero(sweep.weights)[0].tolist()]
        if bad:
            self.counters["weight_mismatches"] += len(bad)
            self.detections.append({"kind": "weight", "coords": list(bad)})
        return bad

    def repair_weights(self, params, planes):
        """Copy each corrupted plane's golden bytes back into its live
        tensor (under a mesh: each rank its own pieces that the last
        check found off); the planes then digest clean, which is checked
        (a repair that does not verify would be a silent double fault).
        Returns ``params`` (the same tree)."""
        from ..core.qweights import restore_weight_plane
        for path, which in planes:
            i = self.index.index((path, which))
            if self._mine is None or self._mine[i]:
                restore_weight_plane(params, path, which, self.golden)
            self.counters["weight_repairs"] += 1
        if self._agreed(self._mismatch(params)).any():
            raise RuntimeError("integrity: weight repair failed to verify")
        return params

    def note_page_repair(self, kind: str) -> None:
        """One page repair: ``kind`` 'rewinds' or 'reserves'."""
        self.counters["page_repairs"] += 1
        self.counters[kind] += 1

    def note_replay(self) -> None:
        self.counters["replays"] += 1

    def stats(self) -> dict:
        out = dict(self.counters)
        out["period"] = self.period
        out["scrub_time_s"] = round(out["scrub_time_s"], 6)
        return out
