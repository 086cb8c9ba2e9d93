"""Optimal-frequency search — the paper's central procedure (numpy copy of
``repro.core.dvfs``).

For each workload sweep the device's allowed core-clock grid, compute
E(f) = P(f)·t(f), and pick the minimum-energy clock (Sec. 4).  Across a
family of workloads, compute the **mean optimal frequency** (Sec. 5.2 /
Table 3) and how little is lost by using it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.energy import OperatingPoint, efficiency_increase, evaluate
from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.perf_model import WorkloadProfile
from repro_torch.core.power_model import PowerModel


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Full frequency sweep for one workload plus the paper's summary stats."""

    profile: WorkloadProfile
    points: list[OperatingPoint]          # one per allowed frequency (desc)
    optimal: OperatingPoint               # argmin_f E(f)
    boost: OperatingPoint                 # f = f_max (GPU default behaviour)
    base: OperatingPoint | None           # f = f_base if the device has one

    @property
    def optimal_frequency_frac(self) -> float:
        """Fig. 9: optimal frequency as a fraction of the boost clock."""
        return self.optimal.f / self.boost.f

    @property
    def slowdown(self) -> float:
        """Fig. 11: relative execution-time increase at the optimal clock."""
        return self.optimal.time / self.boost.time - 1.0

    @property
    def power_reduction(self) -> float:
        """Abstract's headline: power cut at the optimal clock vs boost."""
        return 1.0 - self.optimal.power / self.boost.power

    @property
    def i_ef_boost(self) -> float:
        """Fig. 13: efficiency increase vs the boost clock (Eq. 7)."""
        return efficiency_increase(self.optimal, self.boost)

    @property
    def i_ef_base(self) -> float | None:
        """Fig. 14: efficiency increase vs the base clock."""
        if self.base is None:
            return None
        return efficiency_increase(self.optimal, self.base)

    def at(self, f: float) -> OperatingPoint:
        """The sweep point closest to clock ``f`` (grid frequencies only)."""
        return min(self.points, key=lambda p: abs(p.f - f))

    def optimal_under_budget(self, time_budget: float | None
                             ) -> OperatingPoint:
        """Constrained optimum re-selected from the cached sweep points.

        The serving layer sweeps each shape once and caches the result;
        requests with different real-time budgets (Sec. 2.3) re-select the
        minimum-energy feasible point from the cached grid instead of
        re-running the sweep.
        """
        if time_budget is None:
            return self.optimal
        return _constrained_optimal(self.points, self.boost, time_budget)


def _constrained_optimal(
    points: list[OperatingPoint],
    boost: OperatingPoint,
    time_budget: float | None,
) -> OperatingPoint:
    """Minimum-energy point whose slowdown vs boost fits the Sec. 2.3 budget."""
    feasible = [
        p for p in points
        if time_budget is None or p.time / boost.time - 1.0 <= time_budget
    ]
    return min(feasible or [boost], key=lambda p: p.energy)


def sweep(
    profile: WorkloadProfile,
    device: DeviceSpec,
    power_model: PowerModel | None = None,
    *,
    time_budget: float | None = None,
    driver_cap_mhz: float | None = None,
) -> SweepResult:
    """Sweep the allowed clock grid; optionally respect a real-time budget.

    ``time_budget`` is the Sec. 2.3 constraint: the maximum tolerable
    t(f)/t(f_max) - 1.  ``driver_cap_mhz`` models the paper's Titan V
    observation that the driver silently caps compute clocks.
    """
    pm = power_model or PowerModel(device)
    freqs = device.frequencies()
    if driver_cap_mhz is not None:
        freqs = np.minimum(freqs, driver_cap_mhz)
        freqs = np.unique(freqs)[::-1]
    points = evaluate(profile, device, pm, freqs)
    boost = points[0]
    optimal = _constrained_optimal(points, boost, time_budget)
    base = None
    if device.f_base is not None:
        base = evaluate(profile, device, pm, np.array([device.f_base]))[0]
    return SweepResult(profile=profile, points=points, optimal=optimal,
                       boost=boost, base=base)


def energy_per_transform(result: SweepResult, n_transforms: int
                         ) -> dict[str, float]:
    """Per-transform J/time at the optimal and boost clocks (Eqs. 3-6).

    The sweep models a memory-budget-sized batch of ``n_transforms``
    transforms (Eq. 6); energy and time are linear in the count, so
    per-transform figures are exact divisions (an R2C sweep at the same N
    carries ~2x the transforms per batch at ~the same batch energy: the
    paper's Eq. 5/6 argument for real inputs).
    """
    k = max(n_transforms, 1)
    return {
        "optimal_j": result.optimal.energy / k,
        "boost_j": result.boost.energy / k,
        "optimal_s": result.optimal.time / k,
        "boost_s": result.boost.time / k,
        "optimal_mhz": result.optimal.f,
    }


@dataclasses.dataclass(frozen=True)
class MeanOptimal:
    """Table 3 row: one clock for a whole workload family."""

    f_mean: float                         # mean optimal frequency [MHz]
    sweeps: list[SweepResult]
    # Efficiency increase (vs boost) using each workload's own optimum ...
    i_ef_tuned: float
    # ... and using the single shared mean-optimal clock.
    i_ef_mean: float

    @property
    def loss_pp(self) -> float:
        """Percentage points lost by the single shared clock (Sec. 6.2)."""
        return (self.i_ef_tuned - self.i_ef_mean) * 100.0


def mean_optimal(
    sweeps: list[SweepResult],
    device: DeviceSpec,
    *,
    exclude: set[str] = frozenset(),
) -> MeanOptimal:
    """Compute the mean optimal frequency across a family of sweeps.

    ``exclude`` mirrors the paper's treatment of Bluestein lengths on the
    Jetson Nano (excluded from the mean because of measurement error).
    """
    kept = [s for s in sweeps if s.profile.name not in exclude]
    if not kept:
        raise ValueError("no sweeps left after exclusions")
    f_mean_raw = float(np.mean([s.optimal.f for s in kept]))
    # Snap to the device grid.
    grid = device.frequencies()
    f_mean = float(grid[np.argmin(np.abs(grid - f_mean_raw))])
    i_tuned = float(np.mean([s.i_ef_boost for s in kept]))
    i_mean = float(np.mean(
        [efficiency_increase(s.at(f_mean), s.boost) for s in kept]
    ))
    return MeanOptimal(f_mean=f_mean, sweeps=kept,
                       i_ef_tuned=i_tuned, i_ef_mean=i_mean)
