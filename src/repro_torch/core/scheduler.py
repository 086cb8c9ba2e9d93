"""Per-stage DVFS scheduling and runtime clock locking — the paper's
Sec. 5.3 method (a numpy copy of ``repro.core.scheduler``).

The paper locks the GPU clock to the mean optimal frequency only for the
duration of the cuFFT call (``nvmlDeviceSetGpuLockedClocks`` /
``nvmlDeviceResetGpuLockedClocks``) and shows the composite energy gain
equals the FFT's time share times the FFT's gain (Table 4).

* :class:`DVFSScheduler` plans a pipeline: each stage's workload profile
  gets a clock (its sweep optimum, or boost), and the composite
  :class:`PipelineReport` prices it; ``power_trace`` simulates the
  paper's 10 ms ``nvidia-smi`` view (Fig. 19).
* :class:`ClockController` records the lock/reset pair the serving layer
  brackets each batch with; the calls into NVML arrive with the power
  plane.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np

from repro_torch.core.energy import OperatingPoint, evaluate
from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.perf_model import WorkloadProfile
from repro_torch.core.power_model import PowerModel


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: a profile plus the clock the scheduler chose."""

    profile: WorkloadProfile
    f_locked: float | None = None      # None = run at boost (default clocks)


@dataclasses.dataclass(frozen=True)
class StageReport:
    name: str
    f: float
    time: float
    power: float
    energy: float


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    stages: list[StageReport]
    total_time: float
    total_energy: float
    # Same pipeline, everything at boost:
    boost_time: float
    boost_energy: float

    @property
    def i_ef(self) -> float:
        """Composite efficiency increase (work is identical, so E_d/E_o)."""
        return self.boost_energy / self.total_energy

    @property
    def slowdown(self) -> float:
        return self.total_time / self.boost_time - 1.0


class DVFSScheduler:
    """Assigns per-stage clocks and evaluates the composite pipeline."""

    def __init__(self, device: DeviceSpec,
                 power_model: PowerModel | None = None):
        self.device = device
        self.power_model = power_model or PowerModel(device)

    def _point(self, profile: WorkloadProfile, f: float) -> OperatingPoint:
        return evaluate(profile, self.device, self.power_model,
                        np.array([f]))[0]

    def plan(self, profiles: list[WorkloadProfile],
             locked: dict[str, float]) -> list[Stage]:
        """Lock the clock for the named stages; others run at boost."""
        return [Stage(p, locked.get(p.name)) for p in profiles]

    def evaluate_pipeline(self, stages: list[Stage]) -> PipelineReport:
        f_boost = self.device.f_max
        reports, t_tot, e_tot, t_b, e_b = [], 0.0, 0.0, 0.0, 0.0
        for st in stages:
            f = st.f_locked if st.f_locked is not None else f_boost
            pt = self._point(st.profile, f)
            bt = self._point(st.profile, f_boost)
            reports.append(StageReport(st.profile.name, f, pt.time,
                                       pt.power, pt.energy))
            t_tot += pt.time
            e_tot += pt.energy
            t_b += bt.time
            e_b += bt.energy
        return PipelineReport(reports, t_tot, e_tot, t_b, e_b)

    def power_trace(self, stages: list[Stage], dt: float = 0.010
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sampled (t, P, f) trace of one pipeline pass — the paper's
        Fig. 19; ``dt`` mirrors its 10 ms nvidia-smi sampling interval."""
        times, powers, freqs = [], [], []
        t0 = 0.0
        f_boost = self.device.f_max
        for st in stages:
            f = st.f_locked if st.f_locked is not None else f_boost
            pt = self._point(st.profile, f)
            n = max(int(np.ceil(pt.time / dt)), 1)
            times.append(t0 + dt * np.arange(n))
            powers.append(np.full(n, pt.power))
            freqs.append(np.full(n, f))
            t0 += pt.time
        return (np.concatenate(times), np.concatenate(powers),
                np.concatenate(freqs))


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


def predicted_pipeline_i_ef(fft_share: float, fft_i_ef: float) -> float:
    """The paper's Sec. 6.2 sanity arithmetic for Table 4.

    With only the FFT stage rescaled, composite energy is
    ``E = E_fft/I + E_rest`` so
    ``I_pipeline = 1 / (share/I_fft + (1-share))``.
    """
    return 1.0 / (fft_share / fft_i_ef + (1.0 - fft_share))
