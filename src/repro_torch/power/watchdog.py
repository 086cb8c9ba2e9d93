"""Telemetry watchdog: reading classification + per-device health states
(a copy of ``repro.power.watchdog``).

Barbosa et al. (2016) frame SKA power management as a *monitored,
failure-aware* control problem: a feedback loop that trusts a lying
sensor is worse than no loop at all.  The watchdog sits between the
sampler and the governor and answers two questions per reading:

  classification    what is THIS reading?
      fresh      a numeric value, recent timestamp, inside the TDP
                 envelope, no impossible jump from the last credible one
      stale      the timestamp is older than ``stale_timeout_s`` (the
                 sensor stopped producing; age == timeout is still fresh
                 — the boundary is exclusive)
      dropout    the value is NaN (the sampling call failed)
      spike      the value is outside the plausible envelope
                 (negative, or above ``envelope_frac * TDP``) or jumps
                 more than ``step_w`` from the last credible reading

  health            can the GOVERNOR act on this device's telemetry?
      healthy    feedback allowed
      suspect    >= 1 consecutive non-fresh reading; feedback holds its
                 last output but takes no new moves
      unhealthy  ``unhealthy_after`` consecutive non-fresh readings; the
                 governor MUST fall back to the static sweep optimum
                 (repro_torch.power.governor's hard rule)

  healthy --bad--> suspect --bad x N--> unhealthy
     ^                |                    |
     +--- fresh x M --+<------ fresh ------+        (re-arm)

  (the same shape as the serving circuit breaker's
  closed -> open -> half-open -> closed loop, with M = ``rearm_after``
  consecutive fresh readings playing the successful-probe role)

Baseline rule for step detection: envelope violations and dropouts never
become the comparison baseline (they are garbage, not a new level); a
*step* reading does — a genuine load shift is flagged exactly once and
the new level is then accepted, while a one-sample glitch is flagged on
the way up AND on the way back down.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hardware import DeviceSpec
from repro_torch.power.sampler import PowerReading

# Reading classifications.
FRESH = "fresh"
STALE = "stale"
DROPOUT = "dropout"
SPIKE = "spike"

LABELS = (FRESH, STALE, DROPOUT, SPIKE)

# Device health states.
HEALTHY = "healthy"
SUSPECT = "suspect"
UNHEALTHY = "unhealthy"


@dataclasses.dataclass
class TelemetryWatchdog:
    """Classifies one device's readings and tracks its telemetry health."""

    device: DeviceSpec
    stale_timeout_s: float = 0.05     # max credible reading age
    envelope_frac: float = 1.25       # plausible ceiling: frac * TDP
    step_w: float | None = None       # max credible jump; None: TDP / 2
    unhealthy_after: int = 3          # consecutive bad -> unhealthy
    rearm_after: int = 2              # consecutive fresh -> healthy again

    def __post_init__(self):
        if self.step_w is None:
            self.step_w = 0.5 * self.device.tdp
        if self.unhealthy_after < 1 or self.rearm_after < 1:
            raise ValueError(
                "unhealthy_after and rearm_after must be >= 1, got "
                f"{self.unhealthy_after}/{self.rearm_after}")
        self.health = HEALTHY
        self.baseline: PowerReading | None = None   # last credible reading
        self._bad = 0                 # consecutive non-fresh
        self._good = 0                # consecutive fresh since last bad
        self.counts = {label: 0 for label in LABELS}
        self.unhealthy_entries = 0    # times health fell to unhealthy

    # ------------------------------------------------------------------ #
    # classification (pure: no state change)
    # ------------------------------------------------------------------ #

    def classify(self, reading: PowerReading, now: float) -> str:
        """Label ``reading`` as seen at time ``now`` — no state change."""
        if math.isnan(reading.power_w):
            return DROPOUT
        if now - reading.t > self.stale_timeout_s:
            return STALE
        p = reading.power_w
        if p < 0.0 or p > self.envelope_frac * self.device.tdp:
            return SPIKE
        if (self.baseline is not None
                and abs(p - self.baseline.power_w) > self.step_w):
            return SPIKE
        return FRESH

    # ------------------------------------------------------------------ #
    # health state machine
    # ------------------------------------------------------------------ #

    def observe(self, reading: PowerReading, now: float) -> tuple[str, str]:
        """Classify ``reading``, update health; returns (label, health)."""
        label = self.classify(reading, now)
        self.counts[label] += 1
        if label == FRESH:
            self.baseline = reading
            self._good += 1
            self._bad = 0
            if self.health != HEALTHY and self._good >= self.rearm_after:
                self.health = HEALTHY
        else:
            if label == SPIKE and reading.ok and \
                    0.0 <= reading.power_w <= self.envelope_frac * \
                    self.device.tdp:
                # A step discontinuity (not an envelope violation): accept
                # the new level as baseline after flagging the jump once.
                self.baseline = reading
            self._good = 0
            self._bad += 1
            if self._bad >= self.unhealthy_after:
                if self.health != UNHEALTHY:
                    self.unhealthy_entries += 1
                self.health = UNHEALTHY
            elif self.health == HEALTHY:
                self.health = SUSPECT
        return label, self.health

    @property
    def healthy(self) -> bool:
        """May the governor run feedback on this device's telemetry?

        Suspect telemetry still counts as usable (the governor holds
        rather than moves); only UNHEALTHY forces the static fallback.
        """
        return self.health != UNHEALTHY
