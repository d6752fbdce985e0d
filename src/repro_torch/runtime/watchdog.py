"""Step watchdog (straggler detection and hang escalation) and the
serving accuracy watchdog (port of ``repro/runtime/watchdog.py``; plain
Python and numpy, nothing of it runs on the card).

``Watchdog`` keeps an EMA of step times: a step slower than
``straggler_factor`` times the baseline is a *straggler* (counted, and
reported to ``on_straggler``); no step completion within
``hang_timeout`` seconds raises ``StepHang`` at the next step, which the
scheduler's failover loop (runtime/failover.py) turns into a
snapshot-restore replay.

``AccuracyWatchdog`` is the DS-CIM estimator's health check: every
``probe_every`` segments the fault-tolerant scheduler
(runtime/serving.py) compares the serving path's logits against an
exact-mode decode of the same (token, cache) inputs and trips a slot
whose relative RMSE exceeds a threshold derived from the macro's
``ErrorModel`` moments (core/error_model.py), or whose logits go
NaN/Inf.  A tripped slot is quarantined and its request escalated down
the degradation ladder (dscim2 -> dscim1 -> exact).
"""
from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["Watchdog", "StepHang", "AccuracyWatchdog"]


class StepHang(RuntimeError):
    pass


class Watchdog:
    def __init__(self, straggler_factor: float = 3.0,
                 hang_timeout: float = 300.0, on_straggler=None):
        self.factor = straggler_factor
        self.hang_timeout = hang_timeout
        self.on_straggler = on_straggler or (lambda info: None)
        self.ema = None
        self.n_stragglers = 0
        self._last_done = time.monotonic()
        self._armed = threading.Event()
        self._hang = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()

    # -- hang monitoring (background thread) ----------------------------------
    def _monitor(self):
        while not self._stop.is_set():
            time.sleep(0.1)
            if self._armed.is_set() and \
                    time.monotonic() - self._last_done > self.hang_timeout:
                self._hang.set()
                self._armed.clear()

    @property
    def hung(self) -> bool:
        """Whether a hang was flagged: the next ``step()`` raises
        ``StepHang``."""
        return self._hang.is_set()

    # -- per-step API ---------------------------------------------------------
    def step(self):
        """Context manager wrapping one training step."""
        wd = self

        class _Ctx:
            def __enter__(self):
                if wd._hang.is_set():
                    raise StepHang("previous step exceeded hang_timeout")
                wd._armed.set()
                self.t0 = time.monotonic()
                return self

            def __exit__(self, et, ev, tb):
                wd._armed.clear()
                wd._last_done = time.monotonic()
                if et is not None:
                    return False
                dt = time.monotonic() - self.t0
                if wd.ema is None:
                    wd.ema = dt
                elif dt > wd.factor * wd.ema:
                    wd.n_stragglers += 1
                    wd.on_straggler({"step_time": dt, "baseline": wd.ema})
                else:
                    wd.ema = 0.9 * wd.ema + 0.1 * dt
                return False
        return _Ctx()

    def check_hang(self):
        if self._hang.is_set():
            raise StepHang("no step completed within hang_timeout")

    def reset(self):
        """Clear a latched hang so a failover replay can re-arm cleanly
        (without this, the StepHang that triggered the restart would
        re-raise on the replay's first step)."""
        self._hang.clear()
        self._armed.clear()
        self._last_done = time.monotonic()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1)


class AccuracyWatchdog:
    """Sampled exact-vs-stochastic logit drift monitor for DS-CIM serving.

    ``rel_threshold``: maximum healthy per-slot relative logit RMSE
    (``rmse(serving - exact) / rms(exact)``), normally derived from the
    macro's measured error moments via ``from_error_model``; ``None``
    disables drift probes (NaN/Inf detection stays on — the scheduler
    checks per-step logit finiteness every segment regardless).
    ``probe_every``: probe cadence in segments — the monitoring cost is
    one extra exact-mode decode step per ``probe_every`` segments."""

    def __init__(self, rel_threshold: float | None, probe_every: int = 8):
        if probe_every < 1:
            raise ValueError(f"probe_every must be >= 1, got {probe_every}")
        self.rel_threshold = rel_threshold
        self.probe_every = probe_every
        self.n_probes = 0
        self.n_trips = 0
        self.history: list = []    # per-slot rel rmse of each probe
        self.live_history: list = []   # the live mask of each probe

    @classmethod
    def from_error_model(cls, em, margin: float = 3.0,
                         probe_every: int = 8,
                         rows: int = 128) -> "AccuracyWatchdog":
        """Threshold = margin x the macro's moment-derived relative psum
        error bound (core/error_model.py ``relative_moment_bound``).  The
        margin absorbs layer-to-logit error propagation (partial
        cancellation both ways); healthy logit drift sits ~2x the bound,
        a hard macro fault ~an order of magnitude above it, so margin 3
        separates cleanly on the reduced config (the reference pins it
        empirically there)."""
        return cls(margin * em.relative_moment_bound(rows),
                   probe_every=probe_every)

    def should_probe(self, segment: int) -> bool:
        return self.rel_threshold is not None \
            and segment % self.probe_every == 0

    def check(self, serving_logits, exact_logits, live):
        """Per-slot drift verdicts for one probe.

        serving_logits/exact_logits: (B, V) arrays of the *same* (token,
        cache) decode inputs; live: (B,) bool mask of slots with an active
        request.  Returns (trip (B,) bool, rel (B,) float64) — a slot
        trips when its relative RMSE exceeds the threshold or is not
        finite (NaN/Inf logits)."""
        s = np.asarray(serving_logits, np.float64)
        e = np.asarray(exact_logits, np.float64)
        live = np.asarray(live, bool)
        rms = np.sqrt(np.mean(e * e, axis=-1))
        rel = np.sqrt(np.mean((s - e) ** 2, axis=-1)) / np.maximum(rms, 1e-9)
        trip = live & (~np.isfinite(rel) | (rel > self.rel_threshold))
        self.n_probes += 1
        self.n_trips += int(trip.sum())
        self.history.append(rel)
        self.live_history.append(live)
        return trip, rel

    def live_rels(self, first: int = 0) -> np.ndarray:
        """The rels of live slots over probes ``first`` on, flattened."""
        got = [rel[live] for rel, live in zip(self.history[first:],
                                              self.live_history[first:])]
        return np.concatenate(got) if got else np.zeros((0,))
