"""Model-drift detection: modelled vs measured cost, EWMA-tracked.

The counterpart of ``repro.obs.drift``.  The analytic cost model
(``core.workloads`` + ``core.power_model``) drives DVFS sweeps and the
power governor; its numbers are only trustworthy while they track
measured reality.  The :class:`DriftDetector` closes that loop: a serving
layer feeds it one observation per executed batch — the modelled
per-transform energy next to the telemetry-priced one (watchdog-fresh
samples only, so suspect sensors can never *cause* a drift alert) — keyed
by ``(kind, shape, clock_mhz)``, and the detector tracks the EWMA of the
relative error per key.  A key alerts when its smoothed error magnitude
exceeds ``threshold`` after at least ``min_samples`` observations: a
persistently miscalibrated model trips it, sensor noise (zero-mean by
construction of the simulated backend) does not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable

from repro_torch.core.energy import guarded_ratio

__all__ = ["DriftState", "DriftDetector"]


@dataclasses.dataclass
class DriftState:
    """EWMA error state for one (kind, shape, clock) key."""

    ewma: float = 0.0           # smoothed relative error
    n: int = 0                  # observations
    last_error: float = 0.0     # most recent raw relative error


class DriftDetector:
    """Per-key EWMA tracking of (measured - modelled) / modelled."""

    def __init__(self, *, alpha: float = 0.25, threshold: float = 0.2,
                 min_samples: int = 4):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples
        self.states: dict[Hashable, DriftState] = {}
        self.observations = 0

    def observe(self, key: Hashable, *, modelled: float,
                measured: float) -> float:
        """Fold one modelled/measured pair in; returns the key's EWMA.

        The relative error follows the ``guarded_ratio`` convention:
        0/0 -> 0 (nothing modelled, nothing measured: no drift).
        """
        err = guarded_ratio(measured - modelled, modelled, on_zero=0.0)
        st = self.states.get(key)
        if st is None:
            st = self.states[key] = DriftState()
        st.ewma = err if st.n == 0 else (
            (1.0 - self.alpha) * st.ewma + self.alpha * err)
        st.n += 1
        st.last_error = err
        self.observations += 1
        return st.ewma

    def alerting(self, key: Hashable) -> bool:
        st = self.states.get(key)
        return (st is not None and st.n >= self.min_samples
                and abs(st.ewma) > self.threshold)

    @property
    def alerts(self) -> list[Hashable]:
        """Keys currently in alert, in deterministic order."""
        return sorted((k for k in self.states if self.alerting(k)),
                      key=str)

    @property
    def drift_alerts(self) -> int:
        return len(self.alerts)

    def summary(self) -> dict:
        """JSON-safe rollup for ``ServiceReport`` / benchmark artifacts."""
        worst = 0.0
        for st in self.states.values():
            if abs(st.ewma) > abs(worst):
                worst = st.ewma
        return {
            "tracked_keys": len(self.states),
            "observations": self.observations,
            "drift_alerts": self.drift_alerts,
            "alerting": [str(k) for k in self.alerts],
            "worst_ewma_error": worst,
            "threshold": self.threshold,
        }

    def fill_metrics(self, registry: Any) -> None:
        """Publish the rollup into a ``MetricsRegistry``."""
        s = self.summary()
        registry.gauge(
            "repro_drift_alerts",
            "model-vs-measured keys past the EWMA error threshold",
        ).set(s["drift_alerts"])
        registry.gauge(
            "repro_drift_tracked_keys",
            "(kind, shape, clock) keys with drift observations",
        ).set(s["tracked_keys"])
        registry.gauge(
            "repro_drift_worst_ewma_error",
            "largest-magnitude smoothed relative error across keys",
        ).set(s["worst_ewma_error"])
