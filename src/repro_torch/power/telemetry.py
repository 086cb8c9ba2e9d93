"""Per-device telemetry bundles: sampler + ring buffer + watchdog (a copy
of ``repro.power.telemetry``).

:class:`FleetTelemetry` is the one object the governor and the serving
layer talk to.  Each ``read()`` takes one sample for one device, pushes
it into that device's bounded :class:`repro_torch.power.sampler.TelemetryRing`,
runs it through that device's
:class:`repro_torch.power.watchdog.TelemetryWatchdog`, and returns the
classified result — so every consumer sees the same health verdict for
the same reading.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import DeviceSpec
from repro_torch.power.sampler import (PowerReading, PowerSampler,
                                 SimulatedPowerSampler, TelemetryRing)
from repro_torch.power.watchdog import FRESH, TelemetryWatchdog


@dataclasses.dataclass(frozen=True)
class TelemetryRead:
    """One classified telemetry read: the evidence plus the verdict.

    ``measured_w`` is the power value a consumer may *act* on: the raw
    reading when the watchdog labelled it fresh, else ``None`` — the
    never-freewheel contract starts here, by refusing to hand suspect
    numbers downstream.
    """

    reading: PowerReading
    label: str                  # watchdog classification of THIS reading
    health: str                 # device health AFTER observing it
    measured_w: float | None    # actionable power [W]; None unless fresh

    @property
    def fresh(self) -> bool:
        return self.label == FRESH


class FleetTelemetry:
    """Sampler + per-device ring + per-device watchdog for a fleet."""

    def __init__(
        self,
        device: DeviceSpec,
        sampler: PowerSampler,
        *,
        ring_capacity: int = 256,
        stale_timeout_s: float = 0.05,
        envelope_frac: float = 1.25,
        step_w: float | None = None,
        unhealthy_after: int = 3,
        rearm_after: int = 2,
    ):
        self.device = device
        self.sampler = sampler
        self.ring_capacity = ring_capacity
        self._watchdog_kw = dict(
            stale_timeout_s=stale_timeout_s, envelope_frac=envelope_frac,
            step_w=step_w, unhealthy_after=unhealthy_after,
            rearm_after=rearm_after)
        self.rings: dict[int, TelemetryRing] = {}
        self.watchdogs: dict[int, TelemetryWatchdog] = {}
        self.reads = 0

    @classmethod
    def for_serving(cls, device: DeviceSpec, *, seed: int = 0,
                    fault_plan=None, noise_frac: float = 0.01,
                    drift_w: float = 0.0,
                    stale_timeout_s: float = 1e-6,
                    power_model=None) -> "FleetTelemetry":
        """A simulated-backend fleet bundle for the serving layer.

        Serving samples at batch-completion times on the simulated clock,
        where successive samples are microseconds apart — the default
        50 ms stale timeout would never classify a replayed reading as
        stale, so the serving preset tightens it to 1 us.

        ``power_model`` overrides the sampler's truth model — pass a
        deliberately miscalibrated one to exercise the serving drift
        detector (the reference's ``obs.drift``) against a sensor whose physics
        disagree with the accounting model.
        """
        sampler = SimulatedPowerSampler(device, seed=seed,
                                        noise_frac=noise_frac,
                                        drift_w=drift_w,
                                        power_model=power_model,
                                        fault_plan=fault_plan)
        return cls(device, sampler, stale_timeout_s=stale_timeout_s)

    def _ring(self, device_index: int) -> TelemetryRing:
        if device_index not in self.rings:
            self.rings[device_index] = TelemetryRing(self.ring_capacity)
        return self.rings[device_index]

    def watchdog(self, device_index: int) -> TelemetryWatchdog:
        if device_index not in self.watchdogs:
            self.watchdogs[device_index] = TelemetryWatchdog(
                self.device, **self._watchdog_kw)
        return self.watchdogs[device_index]

    def read(self, device_index: int, now: float, *,
             token: int | None = None, f_mhz: float | None = None,
             u_core: float | None = None,
             u_mem: float | None = None) -> TelemetryRead:
        """Sample, record, classify — one telemetry read for one device.

        The operating-point overrides (``f_mhz``/``u_core``/``u_mem``)
        are forwarded to simulated backends, which have no hardware to
        inspect; hardware-style samplers measure reality and ignore them.
        """
        if isinstance(self.sampler, SimulatedPowerSampler):
            reading = self.sampler.sample(device_index, now, token=token,
                                          f_mhz=f_mhz, u_core=u_core,
                                          u_mem=u_mem)
        else:
            reading = self.sampler.sample(device_index, now, token=token)
        self.reads += 1
        self._ring(device_index).push(reading)
        label, health = self.watchdog(device_index).observe(reading, now)
        measured = reading.power_w if label == FRESH else None
        return TelemetryRead(reading=reading, label=label, health=health,
                             measured_w=measured)

    def healthy(self, device_index: int) -> bool:
        """Governor-may-feedback verdict (devices never read are healthy)."""
        dog = self.watchdogs.get(device_index)
        return True if dog is None else dog.healthy

    def fill_metrics(self, registry) -> None:
        """Publish fleet telemetry counters into a MetricsRegistry."""
        s = self.summary()
        registry.gauge("repro_telemetry_reads",
                       "power samples taken fleet-wide").set(s["reads"])
        registry.gauge("repro_telemetry_unhealthy_entries",
                       "device entries into the unhealthy state").set(
                           s["unhealthy_entries"])
        for label, n in sorted(s["labels"].items()):
            registry.gauge(
                f"repro_telemetry_label_{label.replace('-', '_')}",
                f"samples the watchdog classified {label}").set(n)

    def summary(self) -> dict:
        """Aggregate label counts and health states across the fleet."""
        counts: dict[str, int] = {}
        health = {}
        unhealthy_entries = 0
        for idx, dog in sorted(self.watchdogs.items()):
            for label, n in dog.counts.items():
                counts[label] = counts.get(label, 0) + n
            health[idx] = dog.health
            unhealthy_entries += dog.unhealthy_entries
        return {
            "reads": self.reads,
            "labels": counts,
            "health": health,
            "unhealthy_entries": unhealthy_entries,
        }
