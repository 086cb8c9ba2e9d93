"""Plan + frequency-sweep cache: plan and sweep once per shape (the
counterpart of ``repro.serving.cache`` for 1-D C2C and R2C requests).

The two expensive per-shape artefacts of the paper's method are the FFT
plan (``repro_torch.fft.plan``) and the DVFS frequency sweep over the
device clock grid (``repro_torch.core.dvfs``) that yields the
minimum-energy operating point (Sec. 4).  Both depend only on (kind,
length, precision, transform, device), so the service computes them once
per distinct shape; differing real-time budgets re-select an operating
point from the cached sweep without re-sweeping.

``plan_fn`` / ``sweep_fn`` are injectable so tests can count invocations.
The port runs eagerly, so an entry's ``fn`` is the plan's own function:
nothing is compiled.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import dvfs
from repro_torch.core.energy import OperatingPoint, guarded_ratio
from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.perf_model import WorkloadProfile
from repro_torch.core.power_model import PowerModel
from repro_torch.core.workloads import FFTCase, fft_workload
from repro_torch.fft.plan import FFTPlan, plan_for_length
from repro_torch.serving.request import ShapeKey
from repro_torch.tune.context import plan_config


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    plan_builds: int = 0
    sweeps: int = 0

    @property
    def hit_rate(self) -> float:
        """Hits / lookups; 0.0 for an untouched cache."""
        return guarded_ratio(self.hits, self.hits + self.misses,
                             on_zero=0.0)


@dataclasses.dataclass
class CacheEntry:
    """Everything the executor needs for one shape."""

    key: ShapeKey
    plan: FFTPlan
    fn: Callable                # the plan's function for the shape
    profile: WorkloadProfile    # analytic workload model of one full batch
    sweep: dvfs.SweepResult     # full clock-grid sweep for ``profile``
    n_fft_model: int            # transforms the modelled batch contains

    def point_for(self, time_budget: float | None) -> OperatingPoint:
        """Operating point under a real-time budget — from cached points."""
        return self.sweep.optimal_under_budget(time_budget)

    def per_transform(self, point: OperatingPoint) -> tuple[float, float]:
        """(time_s, energy_j) of ONE transform at ``point``.

        The sweep models a canonical memory-budget-sized batch (Eq. 6);
        both time and energy are linear in the transform count, so actual
        batches scale from the per-transform figures.
        """
        return (point.time / self.n_fft_model,
                point.energy / self.n_fft_model)


class PlanSweepCache:
    """(shape key, tuned config)-keyed cache of plans + sweeps."""

    def __init__(
        self,
        device: DeviceSpec,
        *,
        batch_bytes: float,
        # Called as plan_fn(n) for c2c keys and plan_fn(n, kind) for real
        # transforms — single-arg injectables only serve c2c traffic.
        plan_fn: Callable[..., FFTPlan] = plan_for_length,
        sweep_fn: Callable[..., dvfs.SweepResult] = dvfs.sweep,
    ):
        self.device = device
        self.batch_bytes = batch_bytes
        self._plan_fn = plan_fn
        self._sweep_fn = sweep_fn
        self._power_model = PowerModel(device)
        # Entries are keyed on (shape key, active tuned kernel config): the
        # plan a shape resolves to depends on the tuning context, so a
        # re-tune can never be served a plan built under the previous one.
        self._entries: dict[tuple, CacheEntry] = {}
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _tuned_config(key: ShapeKey):
        """The tuned config this key's plan build will resolve to."""
        return plan_config((key.n,), key.transform)

    def entry(self, key: ShapeKey) -> CacheEntry:
        cache_key = (key, self._tuned_config(key))
        cached = self._entries.get(cache_key)
        if cached is not None:
            self.stats.hits += 1
            return cached
        self.stats.misses += 1
        entry = self._build(key)
        self._entries[cache_key] = entry
        return entry

    def peek(self, key: ShapeKey) -> CacheEntry | None:
        """The cached entry, or None — never builds, never counts."""
        return self._entries.get((key, self._tuned_config(key)))

    def _build(self, key: ShapeKey) -> CacheEntry:
        self.stats.plan_builds += 1
        plan = (self._plan_fn(key.n) if key.transform == "c2c"
                else self._plan_fn(key.n, key.transform))
        case = FFTCase(n=key.n, precision=key.precision,
                       batch_bytes=self.batch_bytes,
                       transform=key.transform)
        profile = fft_workload(case, self.device)
        self.stats.sweeps += 1
        sweep = self._sweep_fn(profile, self.device, self._power_model)
        return CacheEntry(key=key, plan=plan, fn=plan.fn, profile=profile,
                          sweep=sweep, n_fft_model=case.n_fft)
