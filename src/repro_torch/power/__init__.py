"""Closed-loop power governance (a copy of ``repro.power``), and the card's
own power and clock hooks.

The paper's DVFS savings (Secs. 4-5) come from *offline* frequency sweeps
locked in at dispatch time; live power monitoring with budget enforcement
keeps operating points honest as temperature, contention and sensors
drift.  This package closes the loop — and keeps it safe when its own
sensors lie, stall or disappear:

  sampler    PowerSampler NVML-style contract + a deterministic simulated
             backend for tests (core.power_model + clock state + seeded
             noise/drift), feeding bounded per-device telemetry rings
  watchdog   TelemetryWatchdog: fresh/stale/dropout/spike classification
             with a healthy/suspect/unhealthy per-device state machine
  telemetry  FleetTelemetry: per-device sampler + ring + watchdog bundle
  governor   PowerGovernor: guarded PI feedback over measured power with
             hysteresis, anti-windup and slew-rate-limited clock moves;
             on watchdog-unhealthy telemetry it falls back
             bit-reproducibly to the cached static sweep optimum
  site       SiteBudgetScheduler: fleet-level site power-cap enforcement
             (priority-weighted budget allocation, clock trading,
             lowest-priority-first shedding, an emergency clock-floor
             rung on hard-cap breach)
  nvml       the card's end of the two hardware hooks: board power and
             the energy counter (NvmlPowerSampler, energy_mj) and the
             clock lock around a dispatch (NvmlClockLocker), through
             ctypes over the driver's libnvidia-ml.so.1
"""
from repro_torch.power.governor import GovernorConfig, PowerGovernor
from repro_torch.power.sampler import (PowerReading, PowerSampler,
                                       SimulatedPowerSampler, TelemetryRing)
from repro_torch.power.site import SiteBudgetScheduler, SitePipeline, SiteTick
from repro_torch.power.telemetry import FleetTelemetry, TelemetryRead
from repro_torch.power.watchdog import (DROPOUT, FRESH, HEALTHY, SPIKE, STALE,
                                        SUSPECT, UNHEALTHY, TelemetryWatchdog)

__all__ = [
    "DROPOUT", "FRESH", "FleetTelemetry", "GovernorConfig", "HEALTHY",
    "PowerGovernor", "PowerReading", "PowerSampler", "SPIKE", "STALE",
    "SUSPECT", "SimulatedPowerSampler", "SiteBudgetScheduler",
    "SitePipeline", "SiteTick", "TelemetryRead", "TelemetryRing",
    "TelemetryWatchdog", "UNHEALTHY",
]
