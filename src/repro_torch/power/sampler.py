"""Power telemetry sampling: the NVML-style contract and the CI backend.

A numpy copy of ``repro.power.sampler``.  On the card a
:class:`PowerSampler` wraps one call per device —
``nvmlDeviceGetPowerUsage`` (board power, mW), in
:class:`repro_torch.power.nvml.NvmlPowerSampler`.  The contract is
deliberately minimal:

  * ``sample(device_index, now)`` returns ONE timestamped board-power
    reading for ONE device;
  * the sampler never raises for a sick sensor — it *reports* the
    sickness (NaN power, a frozen timestamp, an impossible value) and
    the :class:`repro_torch.power.watchdog.TelemetryWatchdog` classifies it;
  * readings are cheap; callers poll at control-tick rate (the paper's
    Fig. 19 view is 10 ms nvidia-smi sampling).

Without a power sensor, tests run :class:`SimulatedPowerSampler`: the
analytic :class:`repro_torch.core.power_model.PowerModel` evaluated at each
device's *current* clock and utilisation, plus deterministic seeded
measurement noise and a bounded thermal-drift term.  Sensor faults
(dropout / spike / stale) come from a fault plan: any object with
``take(kind, *, batch_id, worker)`` that returns a truthy event once per
scheduled fault of ``kind`` (``repro_torch.runtime.faults.FaultPlan``, or
the reference's, which keeps the same contract), so a seeded run
reproduces the exact same telemetry stream bit for bit.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
from typing import Callable, Iterator

from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.power_model import PowerModel
from repro_torch.runtime.faults import (SENSOR_DROPOUT, SENSOR_SPIKE,
                                        SENSOR_STALE)


@dataclasses.dataclass(frozen=True)
class PowerReading:
    """One timestamped board-power sample for one device.

    ``power_w`` is NaN for a sensor dropout (the NVML call failed or
    returned garbage); a *stale* sensor keeps returning an old reading,
    visible as a frozen ``t`` — classification is the watchdog's job,
    the reading just carries the evidence.
    """

    device_index: int
    t: float                    # sampler timestamp [s, caller's clock]
    power_w: float              # board power [W]; NaN = dropout

    @property
    def ok(self) -> bool:
        """Is the raw value at least a number?  (Not a health verdict.)"""
        return not math.isnan(self.power_w)


class PowerSampler:
    """Abstract NVML-style per-device power sampler."""

    def sample(self, device_index: int, now: float, *,
               token: int | None = None) -> PowerReading:
        """One board-power reading for ``device_index`` at time ``now``.

        ``token`` is an optional deterministic identifier of the sampling
        occasion (a batch id, a control-tick index) that fault-injection
        backends match scheduled sensor faults against; hardware backends
        ignore it.
        """
        raise NotImplementedError


class TelemetryRing:
    """Bounded ring buffer of :class:`PowerReading`.

    Long-running services poll forever; the ring keeps the most recent
    ``capacity`` readings and drops the oldest — the watchdog and the
    governor only ever need a short recent window.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: collections.deque[PowerReading] = collections.deque(
            maxlen=capacity)
        self.pushed = 0             # lifetime count (>= len = some dropped)

    def push(self, reading: PowerReading) -> None:
        self._buf.append(reading)
        self.pushed += 1

    def latest(self) -> PowerReading | None:
        return self._buf[-1] if self._buf else None

    def window(self, k: int) -> list[PowerReading]:
        """The most recent ``k`` readings, oldest first."""
        if k < 0:
            raise ValueError(f"window size must be >= 0, got {k}")
        return list(self._buf)[-k:] if k else []

    def clear(self) -> None:
        """Drop every buffered reading (the host behind the device died).

        ``pushed`` keeps counting lifetime samples, so ``dropped``
        reflects the wipe — a host-kill leaves forensic evidence in the
        counters even though the readings themselves are gone.
        """
        self._buf.clear()

    @property
    def dropped(self) -> int:
        return self.pushed - len(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[PowerReading]:
        return iter(self._buf)


def _hash_frac(seed: int, device_index: int, ordinal: int) -> float:
    """Deterministic uniform [0, 1) — a pure hash, not a shared RNG.

    Per-device noise is a function of (seed, device, sample ordinal), so
    interleaving samples across devices never perturbs any device's noise
    stream and a re-run reproduces every reading exactly.
    """
    h = hashlib.blake2b(f"{seed}:{device_index}:{ordinal}".encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


class SimulatedPowerSampler(PowerSampler):
    """Deterministic simulated backend: model power + seeded noise/drift.

    ``clock_fn(device_index)`` supplies each device's current core clock
    [MHz] and ``utilisation_fn(device_index)`` its ``(u_core, u_mem)``
    pair; both can be overridden per call (the serving layer knows the
    locked clock of the batch it just ran).  Truth power comes from
    :class:`repro_torch.core.power_model.PowerModel`; the measured value adds

      * multiplicative noise, uniform in ``+/- noise_frac`` (sensor LSB
        and sampling-window jitter), and
      * additive thermal drift ``drift_w * (1 - exp(-t / drift_tau_s))``
        (boards read hotter as they soak — the reason static operating
        points need a watchdog at all).

    ``fault_plan`` events of the SENSOR_* kinds (matched on
    ``batch_id=token`` / ``worker=device_index``) corrupt the reading:
    dropout -> NaN, spike -> an out-of-envelope value, stale -> the
    device's previous reading replayed verbatim (frozen timestamp).
    """

    #: Spike magnitude as a multiple of TDP — far outside any credible
    #: envelope, the way a wedged I2C transaction reads.
    SPIKE_FACTOR = 2.0

    def __init__(
        self,
        device: DeviceSpec,
        *,
        clock_fn: Callable[[int], float] | None = None,
        utilisation_fn: Callable[[int], tuple[float, float]] | None = None,
        power_model: PowerModel | None = None,
        seed: int = 0,
        noise_frac: float = 0.01,
        drift_w: float = 0.0,
        drift_tau_s: float = 30.0,
        fault_plan=None,
    ):
        self.device = device
        self.power_model = power_model or PowerModel(device)
        self._clock_fn = clock_fn or (lambda i: device.f_max)
        self._util_fn = utilisation_fn or (lambda i: (1.0, 1.0))
        self.seed = seed
        self.noise_frac = noise_frac
        self.drift_w = drift_w
        self.drift_tau_s = drift_tau_s
        self.faults = fault_plan
        self._ordinal: dict[int, int] = {}
        self._last: dict[int, PowerReading] = {}

    def truth_w(self, device_index: int, *, f_mhz: float | None = None,
                u_core: float | None = None,
                u_mem: float | None = None) -> float:
        """Noiseless model power at the device's current operating point."""
        f = self._clock_fn(device_index) if f_mhz is None else f_mhz
        uc, um = self._util_fn(device_index)
        if u_core is not None:
            uc = u_core
        if u_mem is not None:
            um = u_mem
        return float(self.power_model.power(f, u_core=uc, u_mem=um))

    def sample(self, device_index: int, now: float, *,
               token: int | None = None, f_mhz: float | None = None,
               u_core: float | None = None,
               u_mem: float | None = None) -> PowerReading:
        ordinal = self._ordinal.get(device_index, 0)
        self._ordinal[device_index] = ordinal + 1
        if self.faults is not None:
            if self.faults.take(SENSOR_DROPOUT, batch_id=token,
                                worker=device_index):
                reading = PowerReading(device_index, now, float("nan"))
                self._last[device_index] = reading
                return reading
            if self.faults.take(SENSOR_SPIKE, batch_id=token,
                                worker=device_index):
                reading = PowerReading(device_index, now,
                                       self.SPIKE_FACTOR * self.device.tdp)
                self._last[device_index] = reading
                return reading
            prev = self._last.get(device_index)
            if prev is not None and self.faults.take(
                    SENSOR_STALE, batch_id=token, worker=device_index):
                return prev             # frozen: old value, old timestamp
        truth = self.truth_w(device_index, f_mhz=f_mhz,
                             u_core=u_core, u_mem=u_mem)
        noise = (2.0 * _hash_frac(self.seed, device_index, ordinal) - 1.0
                 ) * self.noise_frac
        drift = self.drift_w * (1.0 - math.exp(-max(now, 0.0)
                                               / self.drift_tau_s))
        reading = PowerReading(device_index, now,
                               truth * (1.0 + noise) + drift)
        self._last[device_index] = reading
        return reading
