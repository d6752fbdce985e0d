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
what was found.  The sweeps run on the planes' device; only the mismatch
flags come back to the host.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["parse_integrity", "IntegrityEngine"]


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
    then pass trivially)."""

    def __init__(self, golden, *, period: int):
        self.period = int(period)
        self.golden = golden
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

    def check_pages(self, cache, live_mask) -> list:
        """Digest the pool again, compare with the stored plane, return the
        mismatching (layer, physical page) coordinates.  ``live_mask``
        (n_pages,) bool marks the pages granted AND completely flushed:
        only those have digests under warranty."""
        from ..core.kvcache import CHECKSUM_KEY, page_checksums
        t0 = time.perf_counter()
        mask = np.asarray(live_mask, bool)
        cur = page_checksums(cache["k_pages"], cache["v_pages"],
                             cache["k_scale"], cache["v_scale"])
        bad = ((cur != cache[CHECKSUM_KEY]) & torch.as_tensor(
            mask, device=cur.device)[None, :]).cpu().numpy()
        self.counters["checks"] += 1
        self.counters["pages_verified"] += int(mask.sum()) * bad.shape[0]
        self.counters["scrub_time_s"] += time.perf_counter() - t0
        coords = [tuple(int(v) for v in c) for c in np.argwhere(bad)]
        if coords:
            self.counters["page_mismatches"] += len(coords)
            self.detections.append({"kind": "page", "coords": coords})
        return coords

    def _digests(self, params) -> np.ndarray:
        from ..core.qweights import weight_plane_digests
        return weight_plane_digests(params).cpu().numpy()

    def check_weights(self, params) -> list:
        """Digest every prepared plane again, return the mismatching
        (path, 'q'|'scale') pairs."""
        if not self.index:
            return []
        t0 = time.perf_counter()
        cur = self._digests(params)
        self.counters["weight_planes_verified"] += len(self.index)
        self.counters["scrub_time_s"] += time.perf_counter() - t0
        bad = [self.index[i] for i in
               np.nonzero(cur != self.ref_digests)[0].tolist()]
        if bad:
            self.counters["weight_mismatches"] += len(bad)
            self.detections.append({"kind": "weight", "coords": list(bad)})
        return bad

    def repair_weights(self, params, planes):
        """Copy each corrupted plane's golden bytes back into its live
        tensor; the planes then digest clean, which is checked (a repair
        that does not verify would be a silent double fault).  Returns
        ``params`` (the same tree)."""
        from ..core.qweights import restore_weight_plane
        for path, which in planes:
            restore_weight_plane(params, path, which, self.golden)
            self.counters["weight_repairs"] += 1
        if (self._digests(params) != self.ref_digests).any():
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
