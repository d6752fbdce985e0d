"""Failover replay and failure injection for the continuous-batching
scheduler (port of the serving half of ``repro/runtime/failover.py``).

``run_with_failover`` wraps the scheduler's segment loop: on a recoverable
failure it restores the latest serve-state snapshot and runs the loop
again from that segment boundary, up to ``max_restarts`` times.
``FailureInjector.fail_at`` raises ``SimulatedHardwareFailure`` at given
segment boundaries, once each, so a replay does not fail again.

The injector's other faults (page-pool bit flips, weight-plane flips, the
stuck-at DS-CIM macro fault) belong to the accuracy watchdog and the
integrity checks, which are not ported yet (ROADMAP A11): asking for one
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["SimulatedHardwareFailure", "IntegrityReplay", "FailureInjector",
           "run_with_failover"]


class SimulatedHardwareFailure(RuntimeError):
    pass


class IntegrityReplay(RuntimeError):
    """A repaired fault whose poisoned tokens must be discarded: recovered
    through the same snapshot restore as a device loss."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic faults at given segment numbers: ``fail_at`` is a
    segment-level device loss, raised once per listed segment by
    ``maybe_fail``.  ``page_flips``, ``weight_flips`` and
    ``macro_fault_at`` are the reference's other faults and raise
    ``NotImplementedError`` until ROADMAP A11's second half ports them."""
    fail_at: tuple = ()
    page_flips: dict = dataclasses.field(default_factory=dict)
    weight_flips: dict = dataclasses.field(default_factory=dict)
    macro_fault_at: int | None = None
    fired: set = dataclasses.field(default_factory=set)

    def __post_init__(self):
        for name in ("page_flips", "weight_flips", "macro_fault_at"):
            if getattr(self, name) not in (None, {}):
                raise NotImplementedError(
                    f"FailureInjector: {name} is not ported yet (ROADMAP "
                    "A11: the accuracy watchdog and integrity checks)")

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedHardwareFailure(f"injected fault at step {step}")

    def serving_fault(self, segment: int) -> str:
        """The DS-CIM fault spec in force at this segment: always healthy
        ('') until the macro fault is ported."""
        return ""


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
