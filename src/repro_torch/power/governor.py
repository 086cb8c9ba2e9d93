"""Guarded PI feedback from measured power to a core-clock setpoint (a copy
of ``repro.power.governor``).

The paper's Sec. 5.3 pipeline *brackets* each stage with a static NVML
clock lock chosen by an offline sweep; this module closes the loop the
way Barbosa et al.'s operations model asks for — steer the clock so
*measured* board power tracks a target — while keeping every guard that
makes feedback safe on flaky telemetry:

  hysteresis     errors inside a dead band take no action (no limit
                 cycling on sensor noise)
  anti-windup    the integral term is clamped, and does not accumulate
                 while the loop holds (dead band, missing sample)
  slew limit     one control tick moves the clock at most
                 ``slew_mhz_per_tick`` (real drivers reprogram PLLs; big
                 jumps glitch the part and the power estimate)
  clamping       the output is always inside ``[f_min, f_max]``

and one hard rule, the **fallback contract**: when the watchdog says the
device's telemetry is unhealthy, the governor pins the clock to the
cached static sweep optimum (``fallback_mhz``, the
``dvfs.sweep`` result) and zeroes its integral state.  Same inputs, same
bits: the fallback clock is a stored grid value, not a computed one, so
a faulted run is exactly as reproducible as a healthy one.  The loop
*never freewheels* on telemetry it cannot trust.

The setpoint is continuous (not snapped to the device's ``f_step`` grid):
snapping a slew-limited loop to a coarse grid makes it limit-cycle
between adjacent grid points around the target.  Real drivers snap at
the PLL; the simulated plant accepts any clock in range.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hardware import DeviceSpec

# Controller modes, recorded per tick.
MODE_FEEDBACK = "feedback"      # took (or was free to take) a PI move
MODE_HOLD = "hold"              # dead band / missing sample: no move
MODE_FALLBACK = "fallback"      # unhealthy telemetry: pinned to static


@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    """PI gains and guard parameters (defaults sized for ~200 W parts)."""

    kp_mhz_per_w: float = 4.0       # proportional gain
    ki_mhz_per_w: float = 1.0       # integral gain (per tick)
    hysteresis_w: float = 1.5       # dead band on |power error|
    slew_mhz_per_tick: float = 65.0  # max clock move per control tick
    integral_clamp_w: float = 50.0  # anti-windup bound on the integral

    def __post_init__(self):
        if self.hysteresis_w < 0 or self.slew_mhz_per_tick <= 0:
            raise ValueError(
                "hysteresis_w must be >= 0 and slew_mhz_per_tick > 0, got "
                f"{self.hysteresis_w}/{self.slew_mhz_per_tick}")


class PowerGovernor:
    """One device's guarded feedback loop: measured power -> clock."""

    def __init__(self, device: DeviceSpec, *, target_w: float,
                 fallback_mhz: float, config: GovernorConfig | None = None,
                 f0_mhz: float | None = None):
        if not (device.f_min <= fallback_mhz <= device.f_max):
            raise ValueError(
                f"fallback_mhz {fallback_mhz} outside "
                f"[{device.f_min}, {device.f_max}]")
        self.device = device
        self.target_w = float(target_w)
        self.fallback_mhz = float(fallback_mhz)
        self.config = config or GovernorConfig()
        self.f_mhz = float(f0_mhz if f0_mhz is not None else fallback_mhz)
        self.f_mhz = min(max(self.f_mhz, device.f_min), device.f_max)
        self.integral_w = 0.0
        self.mode = MODE_HOLD
        self.ticks = 0
        self.moves = 0
        self.fallback_engagements = 0   # transitions INTO fallback

    def set_target(self, target_w: float) -> None:
        """Retarget (site reallocation); feedback state carries over."""
        self.target_w = float(target_w)

    def step(self, measured_w: float | None, *,
             healthy: bool = True) -> float:
        """One control tick; returns the new clock setpoint [MHz]."""
        self.ticks += 1
        cfg = self.config
        if not healthy:
            if self.mode != MODE_FALLBACK:
                self.fallback_engagements += 1
            self.mode = MODE_FALLBACK
            self.f_mhz = self.fallback_mhz
            self.integral_w = 0.0
            return self.f_mhz
        if measured_w is None or math.isnan(measured_w):
            # Healthy device, missing sample (e.g. a lone suspect read):
            # hold the last setpoint, accumulate nothing.
            self.mode = MODE_HOLD
            return self.f_mhz
        error = self.target_w - measured_w      # +ve: room to speed up
        if abs(error) <= cfg.hysteresis_w:
            self.mode = MODE_HOLD
            return self.f_mhz
        self.mode = MODE_FEEDBACK
        self.integral_w = min(max(self.integral_w + error,
                                  -cfg.integral_clamp_w),
                              cfg.integral_clamp_w)
        delta = cfg.kp_mhz_per_w * error + cfg.ki_mhz_per_w * self.integral_w
        delta = min(max(delta, -cfg.slew_mhz_per_tick),
                    cfg.slew_mhz_per_tick)
        f = min(max(self.f_mhz + delta, self.device.f_min),
                self.device.f_max)
        if f != self.f_mhz:
            self.moves += 1
        self.f_mhz = f
        return self.f_mhz

    @property
    def in_fallback(self) -> bool:
        return self.mode == MODE_FALLBACK
