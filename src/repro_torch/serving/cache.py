"""Plan + frequency-sweep cache: plan and sweep once per shape (the
counterpart of ``repro.serving.cache`` for FFT, FDAS and pulsar requests).

The two expensive per-shape artefacts of the paper's method are the plan
(``repro_torch.fft.plan``, the N-D plan graph ``repro_torch.fft.plan_nd``,
the FDAS search's overlap-save plan, or the pulsar search's dispersion
plan with its per-stage clock plan) and the DVFS frequency sweep over
the device clock grid (``repro_torch.core.dvfs``) that yields the
minimum-energy operating point (Sec. 4).  Both depend only on the shape
key, so the service computes them once per distinct key; differing
real-time budgets re-select an operating point from the cached sweep
without re-sweeping.

``plan_fn`` / ``sweep_fn`` are injectable so tests can count invocations
(``plan_fn`` builds the 1-D plans; N-D keys go through ``plan_nd``, as in
the reference).  The port runs eagerly, so an entry's ``fn`` is the plan's
own function: nothing is compiled.

:meth:`PlanSweepCache.degraded_entry` is the degradation ladder's rung 1:
the heuristic plan (tuning context bypassed) priced at the boost clock
alone, with no clock-grid sweep anywhere on its build path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from repro_torch.core import dvfs
from repro_torch.core.energy import OperatingPoint, evaluate, guarded_ratio
from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.perf_model import WorkloadProfile
from repro_torch.core.power_model import PowerModel
from repro_torch.core.workloads import (ConvCase, FFTCase,
                                        fdas_total_profile, fft_workload)
from repro_torch.data.synthetic import FilterbankSpec
from repro_torch.fft.plan import FFTPlan, plan_for_length, plan_with_config
from repro_torch.fft.plan_nd import plan_nd, plan_nd_with_config
from repro_torch.search.fdas import fdas_search, serving_candidates
from repro_torch.search.pipeline import (DispersionPlan, plan_pulsar_stages,
                                         pulsar_search, serving_sifted)
from repro_torch.search.templates import TemplateBank
from repro_torch.serving.request import KIND_FDAS, KIND_PULSAR, ShapeKey
from repro_torch.tune.context import plan_config


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    plan_builds: int = 0
    sweeps: int = 0
    degraded_builds: int = 0    # sweep-free boost-heuristic entries built

    @property
    def hit_rate(self) -> float:
        """Hits / lookups; 0.0 for an untouched cache."""
        return guarded_ratio(self.hits, self.hits + self.misses,
                             on_zero=0.0)

    def fill_metrics(self, registry) -> None:
        """Publish the cache counters into a MetricsRegistry."""
        for field, help in (
                ("hits", "plan+sweep cache hits"),
                ("misses", "plan+sweep cache misses"),
                ("plan_builds", "plans compiled"),
                ("sweeps", "DVFS sweeps run"),
                ("degraded_builds", "sweep-free boost-heuristic builds")):
            registry.gauge(f"repro_cache_{field}", help).set(
                getattr(self, field))
        registry.gauge("repro_cache_hit_rate",
                       "hits / lookups (0 when untouched)").set(
                           self.hit_rate)


@dataclasses.dataclass
class CacheEntry:
    """Everything the executor needs for one shape."""

    key: ShapeKey
    plan: Any                   # FFTPlan; NDPlan for N-D; ConvPlan for
                                # FDAS; DispersionPlan for pulsar
    fn: Callable                # the plan's function for the shape
    profile: WorkloadProfile    # analytic workload model of one full batch
    sweep: dvfs.SweepResult     # full clock-grid sweep for ``profile``
    n_fft_model: int            # transforms the modelled batch contains
    # Pulsar-pipeline entries only: the per-stage DVFS plan (clock +
    # modelled J per stage, scheduler.PipelineReport), the locked clocks
    # and the end-to-end real-time margin at those clocks.
    stages: Any | None = None
    locked: dict | None = None
    realtime_margin: float | None = None

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
        power_model: PowerModel | None = None,
    ):
        self.device = device
        self.batch_bytes = batch_bytes
        self._plan_fn = plan_fn
        self._sweep_fn = sweep_fn
        self._power_model = (power_model if power_model is not None
                             else PowerModel(device))
        # Entries are keyed on (shape key, active tuned kernel config): the
        # plan a shape resolves to depends on the tuning context, so a
        # re-tune can never be served a plan built under the previous one.
        self._entries: dict[tuple, CacheEntry] = {}
        self._degraded: dict[ShapeKey, CacheEntry] = {}
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _tuned_config(key: ShapeKey):
        """The tuned config this key's plan build will resolve to.

        Every kind keys on the config its build consults (the context
        memoises, so repeated lookups never re-read the tuning cache).
        FDAS entries with ``segment=0`` resolve the conv key exactly like
        ``fft.convolve.conv_plan`` will at build time (an explicit segment
        is already part of the ShapeKey); pulsar entries key on both their
        tunable inner passes: the R2C over the filterbank's time axis and
        the overlap-save conv against the acceleration bank.
        """
        if key.kind == KIND_FDAS:
            if key.segment:
                return None          # segment pinned in the ShapeKey itself
            return plan_config((key.n // 2 + 1, _fdas_bank(key.templates).taps,
                                key.templates), "conv")
        if key.kind == KIND_PULSAR:
            ntime = key.shape[-1] if key.shape else key.n
            return (plan_config((ntime,), "r2c"),
                    plan_config((ntime // 2 + 1,
                                 _fdas_bank(key.templates).taps,
                                 key.templates), "conv"))
        return plan_config(key.shape or (key.n,), key.transform)

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
        """The cached tuned entry, or None — never builds, never counts
        (the admission controller's backlog estimates read it)."""
        return self._entries.get((key, self._tuned_config(key)))

    def degraded_entry(self, key: ShapeKey) -> CacheEntry:
        """The degradation ladder's rung-1 entry for ``key``: the
        heuristic plan (tuning context bypassed) and NO clock-grid sweep —
        the one operating point is boost, evaluated directly."""
        cached = self._degraded.get(key)
        if cached is not None:
            return cached
        entry = self._build(key, degraded=True)
        self._degraded[key] = entry
        return entry

    def _boost_only_sweep(self, profile: WorkloadProfile) -> dvfs.SweepResult:
        """A single-point 'sweep': the boost clock, evaluated directly."""
        boost = evaluate(profile, self.device, self._power_model,
                         np.array([self.device.f_max]))[0]
        return dvfs.SweepResult(profile=profile, points=[boost],
                                optimal=boost, boost=boost, base=None)

    def _build(self, key: ShapeKey, *, degraded: bool = False) -> CacheEntry:
        self.stats.plan_builds += 1
        extras: dict = {}
        if key.kind == KIND_PULSAR:
            plan, fn, profile, n_fft, extras = self._build_pulsar(
                key, degraded=degraded)
        elif key.kind == KIND_FDAS:
            plan, fn, profile, n_fft = self._build_fdas(key)
        else:
            plan, fn, profile, n_fft = self._build_fft(key,
                                                       degraded=degraded)
        if degraded:
            self.stats.degraded_builds += 1
            sweep = self._boost_only_sweep(profile)
        else:
            self.stats.sweeps += 1
            sweep = self._sweep_fn(profile, self.device, self._power_model)
        return CacheEntry(key=key, plan=plan, fn=fn, profile=profile,
                          sweep=sweep, n_fft_model=n_fft, **extras)

    def _build_fft(self, key: ShapeKey, *, degraded: bool = False):
        if key.shape:
            # N-D shapes are first-class: one plan graph (fused
            # transpose-write passes) + one sweep per distinct shape.
            plan = (plan_nd_with_config(key.shape, key.transform)
                    if degraded else plan_nd(key.shape, key.transform))
        elif degraded:
            # Degraded builds bypass the tuning context: the heuristic
            # plan, no tuning-cache consults.
            plan = plan_with_config(key.n, key.transform)
        elif key.transform == "c2c":
            plan = self._plan_fn(key.n)
        else:
            plan = self._plan_fn(key.n, key.transform)
        case = FFTCase(n=0 if key.shape else key.n, precision=key.precision,
                       batch_bytes=self.batch_bytes,
                       transform=key.transform, shape=key.shape or None)
        return plan, plan.fn, fft_workload(case, self.device), case.n_fft

    def _build_fdas(self, key: ShapeKey):
        """Acceleration-search entries: one template bank, one overlap-save
        plan and one sweep per (n, segment, templates) key.  The bank's
        filter spectra are cached process-wide (``fft.convolve``)."""
        n = key.n
        bank = _fdas_bank(key.templates)
        case = ConvCase(n=n // 2 + 1, templates=key.templates,
                        taps=bank.taps, nfft=key.segment,
                        precision=key.precision,
                        batch_bytes=self.batch_bytes)
        profile = fdas_total_profile(case, self.device, series_n=n)
        nfft = key.segment or None

        def fn(x, _bank=bank, _nfft=nfft):
            return serving_candidates(fdas_search(x, _bank, nfft=_nfft))

        # Per-transform receipts divide by the row count the swept profile
        # models: ConvCase.n_rows (real half-spectrum rows).
        return case.plan, fn, profile, case.n_rows

    def _build_pulsar(self, key: ShapeKey, *, degraded: bool = False):
        """Pulsar-pipeline entries: the full search (dedispersion -> FDAS
        -> harmonic sum -> sift) with a per-stage clock plan.  Degraded
        builds replace every per-stage clock sweep with the boost point
        (no grid sweep anywhere on the build path).

        The geometry comes from the key alone — a default
        ``FilterbankSpec`` at the key's (nchan, ntime), the default DM grid
        at ``dm_trials``, the linear bank at ``templates`` — so identical
        submissions share one entry and one set of sweeps.  The merged
        four-stage profile feeds the entry-level sweep (single-clock
        serving); ``plan_pulsar_stages`` prices the per-stage locks the
        receipts report.
        """
        if len(key.shape) != 2:
            raise ValueError(
                f"pulsar keys need a (nchan, ntime) shape, got {key.shape}")
        nchan, ntime = key.shape
        spec = FilterbankSpec(nchan=nchan, ntime=ntime)
        dplan = DispersionPlan.from_spec(spec, n_trials=key.dm_trials)
        bank = _fdas_bank(key.templates)
        stage_sweep = (
            (lambda profile, device, power_model=None, **kw:
             self._boost_only_sweep(profile))
            if degraded else self._sweep_fn)
        stage_plan = plan_pulsar_stages(
            spec, dplan, bank, key.n_harmonics, self.device,
            batch_bytes=self.batch_bytes, power_model=self._power_model,
            sweep_fn=stage_sweep)

        def fn(x, _plan=dplan, _bank=bank, _h=key.n_harmonics):
            return serving_sifted(
                pulsar_search(x, _plan, _bank, n_harmonics=_h))

        extras = {"stages": stage_plan.report, "locked": stage_plan.locked,
                  "realtime_margin": stage_plan.realtime_margin}
        return (dplan, fn, stage_plan.total_profile, stage_plan.case.n_rows,
                extras)


def _fdas_bank(templates: int) -> TemplateBank:
    """The linear bank a ``templates``-wide FDAS key searches with."""
    return TemplateBank.linear(zmax=max((templates - 1) / 2.0, 0.0),
                               n_templates=templates)
