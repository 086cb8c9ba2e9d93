"""End-to-end real-time pulsar-search pipeline with per-stage DVFS.

The counterpart of ``repro.search.pipeline``: the binary-pulsar search of
White, Adámek & Armour (2022), the workload the paper's Sec. 5 "existing
pipelines" discussion targets, run eagerly on the card:

  filterbank (batch, C, N) real
    │  brute-force dedispersion (the ``dedisperse`` kernel: shift-and-sum
    │  over the DispersionPlan's integer delay table)
  series (batch, D, N)
    │  mean-subtract -> R2C plan -> acceleration matched filter
    │  (repro_torch.search.fdas: fused forward pass + T inverse passes)
  power plane (batch, D, T, nbins)
    │  harmonic sum (the ``harmonic_sum_plane`` kernel: ladder, normalise
    │  and best-rung reduce in one pass; the ladder never reaches memory)
  statistic volume (batch, D, T, nbins)
    │  sifting (repro_torch.search.sift: threshold, DM-adjacency/harmonic
    │  dedupe, top-k)
  candidates (batch, k)

Every stage has a ``core.workloads`` model
(:func:`repro_torch.core.workloads.pulsar_search_workload`), so
``dvfs.sweep`` + ``core.scheduler.DVFSScheduler`` pick a clock per stage
(:func:`plan_pulsar_stages`); serving receipts report modelled J/stage and
the end-to-end real-time margin S = t_acquire / t_process (Sec. 2.3/6.1).

The reference jits ``pulsar_search`` with the plan and bank static; the
port runs eagerly, and the dedispersion kernel reads the plan's delay
table from a device copy cached per table and device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import dvfs
from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.perf_model import WorkloadProfile
from repro_torch.core.power_model import PowerModel
from repro_torch.core.realtime import RealTimeBudget
from repro_torch.core.scheduler import DVFSScheduler, PipelineReport
from repro_torch.core.workloads import (PulsarCase,
                                        pulsar_search_total_profile,
                                        pulsar_search_workload)
from repro_torch.data.synthetic import FilterbankSpec
from repro_torch.fft.plan import plan_for_length
from repro_torch.fft.stockham import _as_tensor
from repro_torch.kernels.dedisp.ops import dedisperse_kernel
from repro_torch.kernels.harmonic_sum.ops import harmonic_sum_plane
from repro_torch.search.fdas import matched_filter_plane, power_plane
from repro_torch.search.sift import SiftedCandidates, sift_candidates
from repro_torch.search.templates import TemplateBank

# Module-level kernel hooks, looked up on every call: tests monkeypatch
# them with counters to show that a search launches each kernel once.
_kernel_dedisp = dedisperse_kernel
_kernel_hsum = harmonic_sum_plane


@dataclasses.dataclass(frozen=True)
class DispersionPlan:
    """A DM trial grid with its integer-sample delay table.

    Hashable (tuples only), like
    :class:`~repro_torch.search.templates.TemplateBank`.  Build with
    :meth:`from_spec` so injection (``data.synthetic``) and dedispersion
    round the SAME delays.
    """

    dms: tuple[float, ...]                    # trial DMs, pc cm^-3
    delays: tuple[tuple[int, ...], ...]       # (D, C) integer samples
    tsamp: float                              # s (for real-time maths)

    def __post_init__(self):
        if not self.dms or not self.delays:
            raise ValueError("DispersionPlan needs >= 1 DM trial")
        if len(self.dms) != len(self.delays):
            raise ValueError(
                f"{len(self.dms)} DMs vs {len(self.delays)} delay rows")

    @classmethod
    def from_spec(cls, spec: FilterbankSpec, *, n_trials: int = 16,
                  dm_step_factor: float = 4.0,
                  dms: tuple[float, ...] | None = None) -> "DispersionPlan":
        """Trial grid ``i * dm_step_factor * spec.dm_step``.

        The default factor of 4 spaces adjacent trials ~4 samples of
        differential delay apart, so a pulsar injected at one trial
        decoheres visibly at its neighbours (clean argmax) while the
        sift stage absorbs whatever leaks into them.
        """
        if dms is None:
            if n_trials < 1:
                raise ValueError(f"need n_trials >= 1, got {n_trials}")
            step = dm_step_factor * spec.dm_step
            dms = tuple(i * step for i in range(n_trials))
        table = []
        for dm in dms:
            row = spec.delay_samples(dm)
            if row.max(initial=0) >= spec.ntime:
                raise ValueError(
                    f"DM {dm} delays up to {int(row.max())} samples exceed "
                    f"the block length ({spec.ntime}); shrink the grid or "
                    f"lengthen the block")
            table.append(tuple(int(d) for d in row))
        return cls(dms=tuple(float(d) for d in dms),
                   delays=tuple(table), tsamp=spec.tsamp)

    @property
    def n_trials(self) -> int:
        return len(self.dms)

    @property
    def nchan(self) -> int:
        return len(self.delays[0])

    @property
    def max_delay(self) -> int:
        return max(max(row) for row in self.delays)

    def delay_array(self) -> np.ndarray:
        return np.asarray(self.delays, dtype=np.int64)


class PulsarSearchResult(NamedTuple):
    """Everything one search produced."""

    power: torch.Tensor        # (batch, D, T, nbins) normalised power
    stat: torch.Tensor         # (batch, D, T, nbins) detection statistic
    level: torch.Tensor        # (batch, D, T, nbins) int32 harmonic level
    candidates: SiftedCandidates
    sigma2: torch.Tensor       # (batch, D, 1, 1) per-series noise power


def pulsar_search(
    fb,
    plan: DispersionPlan,
    bank: TemplateBank,
    *,
    n_harmonics: int = 8,
    threshold: float = 25.0,
    max_candidates: int = 16,
    nfft: int | None = None,
    pool: int = 64,
) -> PulsarSearchResult:
    """Search filterbanks (batch, C, N) or (C, N) end to end.

    Dedispersion, R2C, matched filtering, harmonic summing and sifting,
    on the filterbank's device (numpy input goes to the card).
    """
    fb = _as_tensor(fb)
    if fb.ndim == 2:
        fb = fb[None]
    if fb.ndim != 3:
        raise ValueError(
            f"pulsar_search needs (batch, nchan, ntime) or (nchan, ntime) "
            f"filterbanks, got shape {tuple(fb.shape)}")
    if fb.is_complex():
        fb = fb.real
    fb = fb.to(torch.float32)

    series = _kernel_dedisp(fb, plan.delays)             # (b, D, N)
    n = series.shape[-1]
    x = series - series.mean(dim=-1, keepdim=True)
    del series
    spectrum = plan_for_length(n, "r2c")(x)              # (b, D, nbins)
    del x
    sigma2 = (spectrum.real ** 2 + spectrum.imag ** 2).mean(
        dim=-1, keepdim=True)[..., None]
    mf = matched_filter_plane(spectrum, bank, nfft=nfft)  # (b, D, T, nbins)
    power = power_plane(mf, sigma2)
    del mf
    stat, level = _kernel_hsum(power, n_harmonics)
    cands = sift_candidates(stat, level, threshold=threshold,
                            max_candidates=max_candidates, pool=pool,
                            max_harmonic=n_harmonics)
    return PulsarSearchResult(power=power, stat=stat, level=level,
                              candidates=cands, sigma2=sigma2)


def serving_sifted(result: PulsarSearchResult) -> torch.Tensor:
    """Candidates packed as one (batch, k, 5) float32 tensor for receipts.

    Columns: DM trial, template, bin, harmonic level, statistic
    (-1/-1/-1/-1/0 padding) — a plain tensor so the serving layer's
    per-request result slicing works unchanged.
    """
    c = result.candidates
    return torch.stack([c.dm.to(torch.float32),
                        c.template.to(torch.float32),
                        c.bin.to(torch.float32),
                        c.level.to(torch.float32), c.snr], dim=-1)


@dataclasses.dataclass(frozen=True)
class PulsarStagePlan:
    """The DVFS story of one pipeline configuration.

    ``report`` prices one memory-budgeted batch (``case.n_rows``
    filterbanks) with every stage locked to its own sweep-optimal
    clock; ``realtime_margin`` is S = t_acquire / t_process per
    filterbank at those clocks (>= 1 keeps the pipeline real time,
    Sec. 2.3/6.1).
    """

    case: PulsarCase
    profiles: tuple[WorkloadProfile, ...]     # the four stage models
    locked: dict                              # stage name -> clock [MHz]
    report: PipelineReport                    # per-stage J at the locks
    total_profile: WorkloadProfile            # merged (service sweeps)
    t_acquire: float                          # s of sky per filterbank

    @property
    def realtime(self) -> RealTimeBudget:
        return RealTimeBudget(
            t_acquire=self.t_acquire,
            t_process=self.report.total_time / self.case.n_rows)

    @property
    def realtime_margin(self) -> float:
        return self.realtime.speedup


def plan_pulsar_stages(
    spec: FilterbankSpec,
    plan: DispersionPlan,
    bank: TemplateBank,
    n_harmonics: int,
    device: DeviceSpec,
    *,
    batch_bytes: float = 2e9,
    power_model: PowerModel | None = None,
    sweep_fn=dvfs.sweep,
) -> PulsarStagePlan:
    """Sweep each stage's clock grid and lock it at its energy optimum.

    The serving cache builds its per-stage receipts from this one
    function; ``sweep_fn`` is injectable for the same reason
    ``PlanSweepCache``'s is.
    """
    power_model = power_model or PowerModel(device)
    case = PulsarCase(
        nchan=spec.nchan, ntime=spec.ntime, dm_trials=plan.n_trials,
        templates=bank.n_templates, taps=bank.taps,
        n_harmonics=n_harmonics, batch_bytes=batch_bytes)
    profiles = tuple(pulsar_search_workload(case, device))
    locked = {p.name: sweep_fn(p, device, power_model).optimal.f
              for p in profiles}
    sched = DVFSScheduler(device, power_model)
    report = sched.evaluate_pipeline(sched.plan(list(profiles), locked))
    return PulsarStagePlan(
        case=case, profiles=profiles, locked=locked, report=report,
        total_profile=pulsar_search_total_profile(case, device),
        t_acquire=spec.t_acquire)
