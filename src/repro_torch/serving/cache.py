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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core import dvfs
from repro_torch.core.energy import OperatingPoint, guarded_ratio
from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.perf_model import WorkloadProfile
from repro_torch.core.power_model import PowerModel
from repro_torch.core.workloads import (ConvCase, FFTCase,
                                        fdas_total_profile, fft_workload)
from repro_torch.data.synthetic import FilterbankSpec
from repro_torch.fft.plan import FFTPlan, plan_for_length
from repro_torch.fft.plan_nd import plan_nd
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

    @property
    def hit_rate(self) -> float:
        """Hits / lookups; 0.0 for an untouched cache."""
        return guarded_ratio(self.hits, self.hits + self.misses,
                             on_zero=0.0)


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
        """The cached entry, or None — never builds, never counts."""
        return self._entries.get((key, self._tuned_config(key)))

    def _build(self, key: ShapeKey) -> CacheEntry:
        self.stats.plan_builds += 1
        extras: dict = {}
        if key.kind == KIND_PULSAR:
            plan, fn, profile, n_fft, extras = self._build_pulsar(key)
        elif key.kind == KIND_FDAS:
            plan, fn, profile, n_fft = self._build_fdas(key)
        else:
            plan, fn, profile, n_fft = self._build_fft(key)
        self.stats.sweeps += 1
        sweep = self._sweep_fn(profile, self.device, self._power_model)
        return CacheEntry(key=key, plan=plan, fn=fn, profile=profile,
                          sweep=sweep, n_fft_model=n_fft, **extras)

    def _build_fft(self, key: ShapeKey):
        if key.shape:
            # N-D shapes are first-class: one plan graph (fused
            # transpose-write passes) + one sweep per distinct shape.
            plan = plan_nd(key.shape, key.transform)
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

    def _build_pulsar(self, key: ShapeKey):
        """Pulsar-pipeline entries: the full search (dedispersion -> FDAS
        -> harmonic sum -> sift) with a per-stage clock plan.

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
        stage_plan = plan_pulsar_stages(
            spec, dplan, bank, key.n_harmonics, self.device,
            batch_bytes=self.batch_bytes, power_model=self._power_model,
            sweep_fn=self._sweep_fn)

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
