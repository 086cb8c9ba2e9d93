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

A grid too large for the card at once (a survey pointing: 2^23 samples,
thousands of DM trials, 85 templates) runs in blocks of trials
(:class:`PulsarSearch`): dedispersion a block at a time, the planes a
sub-block at a time, the sift's pools merged across blocks.  Each block
records spans (``search.block`` and its stages ``search.dedisperse``,
``search.r2c``, ``search.matched_filter``, ``search.power``,
``search.harmonic_sum``, ``search.sift``; ``obs.trace.span``) and counts
on the card the cells over the threshold, in the read of the sift's
select kernel that pools them.

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
from repro_torch.kernels.dedisp.ops import dedisperse_kernel, prepare_table
from repro_torch.kernels.harmonic_sum.ops import harmonic_sum_plane
from repro_torch.obs.trace import span
from repro_torch.search.fdas import (matched_filter_segments,
                                     segments_power_plane)
from repro_torch.search.sift import (CandidatePool, SiftedCandidates,
                                     merge_pools, pool_cells, sift_pool)
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
    """Everything one search produced.

    The planes hold every DM trial, or, where the search was given
    ``keep``, the kept trials in ascending order."""

    power: torch.Tensor        # (batch, D, T, nbins) normalised power
    stat: torch.Tensor         # (batch, D, T, nbins) detection statistic
    level: torch.Tensor        # (batch, D, T, nbins) int32 harmonic level
    candidates: SiftedCandidates
    sigma2: torch.Tensor       # (batch, D, 1, 1) per-series noise power


class BlockResult(NamedTuple):
    """What one block of DM trials produced (:meth:`PulsarSearch.block`)."""

    trials: range              # the block's trials in the grid
    pool: CandidatePool        # its strongest cells, grid-wide indices
    kept: list                 # the kept trials among them, ascending
    # (batch, len(kept), T, nbins), or None (none kept, or sent to out)
    power: torch.Tensor | None
    stat: torch.Tensor | None
    level: torch.Tensor | None
    sigma2: torch.Tensor       # (batch, trials, 1, 1)
    over: torch.Tensor         # (batch,) int64: cells >= the threshold
    # (batch, 3) int64 over the sub-blocks: cells the select kernel left to
    # its top-k, its refinement reads, its reads of the planes (0 where the
    # sub-blocks took one torch.topk; sift_kernel.Selected.counts)
    sift: torch.Tensor | None = None


def _joined(parts: list, dim: int = 1):
    """The parts joined along ``dim``: the one part itself, uncopied."""
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


class PulsarSearch:
    """A DM-trial grid searched block by block, with its candidates merged
    across the blocks.

    Dedispersion runs ``dedisp_block`` trials at a time, so a filterbank
    is read once a block; the R2C runs on the block's series; the matched
    filter, power, harmonic sum and sift run ``fdas_block`` trials at a
    time, so that only those trials' (T, nbins) planes are on the card at
    once.  Each sub-block's strongest ``pool`` cells merge into the
    block's pool, and the blocks' pools into the grid's
    (:func:`~repro_torch.search.sift.merge_pools`), which :meth:`sift`
    dedupes once: DM neighbours across a boundary see each other.  With
    both sizes None the grid is one block, and a call is the one-volume
    search.

    The blocks' delay tables are fixed at construction; :meth:`prepare`
    puts them on a device before the first block (a table copied to the
    card at a block would wait for the card).
    """

    def __init__(self, plan: DispersionPlan, bank: TemplateBank, *,
                 n_harmonics: int = 8, threshold: float = 25.0,
                 max_candidates: int = 16, nfft: int | None = None,
                 pool: int = 64, dedisp_block: int | None = None,
                 fdas_block: int | None = None):
        d = plan.n_trials
        dedisp_block = d if dedisp_block is None else dedisp_block
        fdas_block = dedisp_block if fdas_block is None else fdas_block
        if dedisp_block < 1 or fdas_block < 1:
            raise ValueError(f"block sizes must be >= 1, got dedisp_block="
                             f"{dedisp_block}, fdas_block={fdas_block}")
        self.plan, self.bank = plan, bank
        self.n_harmonics, self.threshold = n_harmonics, threshold
        self.max_candidates, self.nfft, self.pool = max_candidates, nfft, pool
        self.dedisp_block, self.fdas_block = dedisp_block, fdas_block
        # One block keeps the plan's own table: the device copy is cached
        # on its identity.
        self._delays = ([plan.delays] if dedisp_block >= d else
                        [plan.delays[i:i + dedisp_block]
                         for i in range(0, d, dedisp_block)])

    @property
    def n_blocks(self) -> int:
        return len(self._delays)

    def trials(self, index: int) -> range:
        """The grid's trials that block ``index`` searches."""
        first = index * self.dedisp_block
        return range(first, min(first + self.dedisp_block,
                                self.plan.n_trials))

    def prepare(self, device) -> None:
        """Every block's delay table on ``device``, ahead of the blocks."""
        for delays in self._delays:
            prepare_table(delays, torch.device(device))

    def block(self, fb: torch.Tensor, index: int, keep=(),
              out: dict | None = None) -> BlockResult:
        """Search block ``index`` of (batch, C, N) float32 filterbanks,
        keeping the planes of the grid's trials in ``keep``.  Nothing here
        waits for the card once :meth:`prepare` has run.

        ``out`` (trial -> (power, stat, level) tensors of (batch, T,
        nbins), on any device) receives the kept trials' planes instead:
        each is copied there as its sub-block ends, in the card's order
        (``non_blocking``, so pinned host memory fills without a wait),
        and the result holds no planes.  A sub-block's planes then never
        outlive it, and every sub-block reuses the card's memory of the
        one before (at a survey's sizes, a kept trial's planes are 4.3 GB
        that would otherwise cut that memory up)."""
        trials = self.trials(index)
        batch, nchan, n = fb.shape
        bank = self.bank
        cells, kept, parts = None, [], ([], [], [])
        over = torch.zeros(batch, dtype=torch.int64, device=fb.device)
        counts = torch.zeros((batch, 3), dtype=torch.int64, device=fb.device)
        with span("search.block", fb, trials=len(trials), nchan=nchan, n=n,
                  templates=bank.n_templates, harmonics=self.n_harmonics):
            with span("search.dedisperse"):
                series = _kernel_dedisp(fb, self._delays[index])
                x = series - series.mean(dim=-1, keepdim=True)
                del series
            with span("search.r2c"):
                spectrum = plan_for_length(n, "r2c")(x)     # (b, d, nbins)
                del x
                sigma2 = (spectrum.real ** 2 + spectrum.imag ** 2).mean(
                    dim=-1, keepdim=True)[..., None]
            for lo in range(0, len(trials), self.fdas_block):
                sub = trials[lo:lo + self.fdas_block]
                with span("search.matched_filter"):
                    mf = matched_filter_segments(
                        spectrum[:, lo:lo + len(sub)], bank, nfft=self.nfft)
                with span("search.power"):
                    power = segments_power_plane(
                        mf, bank, spectrum.shape[-1],
                        sigma2[:, lo:lo + len(sub)])
                    del mf
                with span("search.harmonic_sum"):
                    stat, level = _kernel_hsum(power, self.n_harmonics)
                with span("search.sift"):
                    # Below a full pool's weakest cell nothing can enter it.
                    full = (cells is not None
                            and cells.vals.shape[-1] == self.pool)
                    pooled, n_over, n_sift = pool_cells(
                        stat, level, self.pool, sub[0],
                        floor=cells.vals[:, -1] if full else None,
                        threshold=self.threshold)
                    cells = merge_pools(cells, pooled, self.pool)
                    over += n_over
                    counts += n_sift
                mine = [t for t in sub if t in keep]
                kept += mine
                planes = (power, stat, level)
                if out is not None:
                    for t in mine:
                        for dst, plane in zip(out[t], planes):
                            dst.copy_(plane[:, t - sub[0]], non_blocking=True)
                elif mine:
                    rows = (slice(None) if len(mine) == len(sub)
                            else [t - sub[0] for t in mine])
                    for part, plane in zip(parts, planes):
                        part.append(plane[:, rows])
                del power, stat, level, planes
        return BlockResult(trials, cells, kept, *map(_joined, parts),
                           sigma2, over, counts)

    def sift(self, cells: CandidatePool, n: int) -> SiftedCandidates:
        """The candidates of a grid of length-``n`` series from its merged
        pool (steps 2 and 3 of the sift)."""
        return sift_pool(cells, (self.bank.n_templates, n // 2 + 1),
                         (cells.vals.shape[0],), threshold=self.threshold,
                         max_candidates=self.max_candidates,
                         max_harmonic=self.n_harmonics)

    def __call__(self, fb, keep=None) -> PulsarSearchResult:
        """Search every block of filterbanks (batch, C, N) or (C, N).

        ``keep`` (trial indices) limits the returned planes to those
        trials, in ascending order; None keeps every trial.  Numpy input
        goes to the card."""
        fb = _filterbanks(fb)
        keep = range(self.plan.n_trials) if keep is None else set(keep)
        cells, sigma2, parts = None, [], ([], [], [])
        for index in range(self.n_blocks):
            res = self.block(fb, index, keep)
            cells = merge_pools(cells, res.pool, self.pool)
            sigma2.append(res.sigma2)
            for part, plane in zip(parts, res[3:6]):
                if plane is not None:
                    part.append(plane)
            del res
        return PulsarSearchResult(*map(_joined, parts),
                                  candidates=self.sift(cells, fb.shape[-1]),
                                  sigma2=_joined(sigma2))


def _filterbanks(fb) -> torch.Tensor:
    """(batch, C, N) float32 filterbanks from (batch, C, N) or (C, N)
    input (numpy goes to the card)."""
    fb = _as_tensor(fb)
    if fb.ndim == 2:
        fb = fb[None]
    if fb.ndim != 3:
        raise ValueError(
            f"pulsar_search needs (batch, nchan, ntime) or (nchan, ntime) "
            f"filterbanks, got shape {tuple(fb.shape)}")
    if fb.is_complex():
        fb = fb.real
    return fb.to(torch.float32)


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
    dedisp_block: int | None = None,
    fdas_block: int | None = None,
    keep=None,
) -> PulsarSearchResult:
    """Search filterbanks (batch, C, N) or (C, N) end to end.

    Dedispersion, R2C, matched filtering, harmonic summing and sifting,
    on the filterbank's device (numpy input goes to the card), in blocks
    of trials where ``dedisp_block``/``fdas_block`` are given
    (:class:`PulsarSearch`); ``keep`` limits the returned planes to those
    trials.  The blocks give the one-block search's candidates.
    """
    search = PulsarSearch(plan, bank, n_harmonics=n_harmonics,
                          threshold=threshold, max_candidates=max_candidates,
                          nfft=nfft, pool=pool, dedisp_block=dedisp_block,
                          fdas_block=fdas_block)
    return search(fb, keep)


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
