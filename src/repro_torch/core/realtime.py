"""Real-time processing constraints — the paper's Sec. 2.3 / 6.1 (a copy
of ``repro.core.realtime``).

The real-time speed-up S = t_acquire / t_process decides whether an energy
saving is free (S stays >= 1 after the slowdown) or costs hardware (more
devices to share the load).  The paper uses this to translate Fig. 11's
slowdowns into capital cost: "on average 60% more hardware" for the Jetson
at its optimal clock, "below 5%" (i.e. usually none) for the V100.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RealTimeBudget:
    """A pipeline's real-time envelope."""

    t_acquire: float          # seconds of data per block (telescope side)
    t_process: float          # seconds to process one block at boost clock

    @property
    def speedup(self) -> float:
        """S = t_a / t_p  (>= 1 means real time)."""
        return self.t_acquire / self.t_process

    @property
    def slowdown_margin(self) -> float:
        """Largest tolerable relative slowdown that keeps S >= 1."""
        return max(self.speedup - 1.0, 0.0)

    def is_realtime(self, slowdown: float = 0.0) -> bool:
        return self.t_process * (1.0 + slowdown) <= self.t_acquire


def extra_hardware(slowdown: float, margin: float = 0.0) -> float:
    """Fractional extra devices needed to absorb ``slowdown`` (Sec. 6.1).

    Work is assumed embarrassingly divisible across devices (the paper's
    stated approximation for batched FFTs): processing rate scales linearly
    with device count, so a slowdown beyond the real-time margin must be
    bought back with extra devices.
    """
    needed = (1.0 + slowdown) / (1.0 + margin)
    return max(needed - 1.0, 0.0)


def devices_required(n_devices: int, slowdown: float, margin: float = 0.0) -> int:
    """Integer device count after applying :func:`extra_hardware`."""
    return math.ceil(n_devices * (1.0 + extra_hardware(slowdown, margin)))


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Operational vs capital cost trade-off (Sec. 6.1, 'language of costs')."""

    device_cost: float              # capital cost per device [currency]
    energy_cost: float = 0.25       # electricity [currency/kWh]
    years: float = 5.0              # amortisation horizon

    def operating_cost(self, avg_power_w: float, n_devices: int) -> float:
        kwh = avg_power_w / 1000.0 * 24 * 365 * self.years * n_devices
        return kwh * self.energy_cost

    def total_cost(self, avg_power_w: float, n_devices: int) -> float:
        return self.device_cost * n_devices + self.operating_cost(
            avg_power_w, n_devices
        )
