"""Runtime clock locking around dispatches — the paper's Sec. 5.3 method.

A numpy copy of ``repro.core.scheduler``, limited to :class:`ClockEvent`
and :class:`ClockController`, which the serving layer locks each batch
with.  The per-stage ``DVFSScheduler`` arrives with the pulsar-pipeline
slice of the port.

The paper locks the GPU clock to the mean optimal frequency only for the
duration of the cuFFT call (``nvmlDeviceSetGpuLockedClocks`` /
``nvmlDeviceResetGpuLockedClocks``).  The controller records that
lock/reset pair; the calls into NVML arrive with the power plane.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np

from repro_torch.core.hardware import DeviceSpec


@dataclasses.dataclass(frozen=True)
class ClockEvent:
    """One clock-management call, timestamped relative to controller start."""

    t: float                 # seconds since the controller was created
    action: str              # "lock" | "reset"
    f: float                 # clock in effect after the call [MHz]


class ClockController:
    """Runtime clock locking around dispatches (paper Sec. 5.3).

    ``with ctrl.locked(f):`` records the lock/reset pair and keeps an event
    log from which a service-level Fig. 19-style frequency trace can be
    reconstructed.
    """

    def __init__(self, device: DeviceSpec, timer=time.monotonic,
                 max_events: int | None = None):
        """``max_events`` bounds the event log for long-running services
        (oldest events are dropped); None keeps the full history."""
        self.device = device
        self._timer = timer
        self._t0 = timer()
        self._f = device.f_max
        self._lock_count = 0
        self.events: collections.deque[ClockEvent] = collections.deque(
            maxlen=max_events)
        # The defined initial state (t=0, boost clock) is kept outside the
        # bounded deque, so trace() always starts from it.
        self._first = ClockEvent(0.0, "init", self._f)

    @property
    def current_f(self) -> float:
        return self._f

    @property
    def lock_count(self) -> int:
        return self._lock_count

    def _record(self, action: str, f: float) -> None:
        self._f = f
        if action == "lock":
            self._lock_count += 1
        self.events.append(ClockEvent(self._timer() - self._t0, action, f))

    @contextlib.contextmanager
    def locked(self, f: float):
        """Lock the core clock to ``f`` for the duration of the block."""
        prev = self._f
        self._record("lock", f)
        try:
            yield
        finally:
            self._record("reset", prev)

    def trace(self) -> tuple[np.ndarray, np.ndarray]:
        """(t, f) step trace of the clock since controller start, from the
        initial (t=0, boost clock) sample."""
        events = [self._first, *self.events]
        return (np.array([e.t for e in events]),
                np.array([e.f for e in events]))
