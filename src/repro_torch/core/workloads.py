"""Workload builders for the DVFS model (numpy copy of
``repro.core.workloads``).

:func:`fft_workload` is an analytic model of a batched out-of-place FFT
in the style the paper measures: FLOPs = 5 N log2 N per transform, HBM
traffic = one read + one write of the whole batch per *pass*, where a
pass is one kernel of the multi-kernel plan (``repro_torch.fft.plan`` and
``repro_torch.fft.plan_nd`` run exactly that many kernel passes).
:func:`conv_workload` / :func:`fdas_workload` price the overlap-save
matched filter and the acceleration search from the engine's own
``ConvPlan``.  :func:`pulsar_search_workload` prices the four stages of
the end-to-end pulsar search (``repro_torch.search.pipeline``).  Every
figure is field-identical to the reference's: the model is the paper's,
whatever card runs the port.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.perf_model import WorkloadProfile
from repro_torch.fft.radix import (is_pow2, mixed_radix_flop_count,
                                   r2c_flop_count, stage_count)

# Byte sizes of one complex element per precision (paper: C2C transforms).
COMPLEX_BYTES = {"fp16": 4, "fp32": 8, "fp64": 16}

# Peak-FLOP multiplier per precision relative to the device's FP32 figure
# (V100-style ratios: FP64 = 1/2, FP16 = 2x).
PRECISION_PEAK = {"fp16": 2.0, "fp32": 1.0, "fp64": 0.5}


def largest_prime_factor(n: int) -> int:
    p, f = n, 2
    largest = 1
    while f * f <= p:
        while p % f == 0:
            largest = max(largest, f)
            p //= f
        f += 1
    return max(largest, p if p > 1 else largest)


def uses_bluestein(n: int) -> bool:
    """cuFFT uses Bluestein when a factor exceeds 127 (Sec. 2.1)."""
    return largest_prime_factor(n) > 127


def _butterfly_flops(n: int, radices: tuple[int, ...] | None) -> float:
    """FLOPs of one length-``n`` transform: the paper's Eq. 5 convention
    (5 N log2 N) for ``radices=None``, else the mixed-radix engine's count."""
    if n <= 1:
        return 0.0
    if radices is None:
        return 5.0 * n * math.log2(n)
    return mixed_radix_flop_count(n, radices)


def _r2c_flops(n: int, radices: tuple[int, ...] | None) -> float:
    """FLOPs of one packed length-``n`` R2C/C2R transform (Eq. 5 at N/2)."""
    if radices is not None:
        return r2c_flop_count(n, radices)
    m = max(n // 2, 1)
    return _butterfly_flops(m, None) + 10.0 * (m + 1)


def _stage_count(n: int, radices: tuple[int, ...] | None) -> float:
    """Butterfly stages of one fused pass (feeds the t_cache term);
    ``radices=None`` keeps the cuFFT-flavoured radix-8 estimate."""
    if radices is None:
        return max(math.log2(max(n, 2)), 1.0) / 3.0
    return float(stage_count(n, radices))


def plan_passes(n: int, *, max_inplace: int = 2**13) -> int:
    """Number of device-memory passes of the FFT plan.

    One kernel keeps transforms of length <= ``max_inplace`` resident in
    shared memory (one HBM read + one write); each extra level of the
    four-step decomposition adds a full read+write pass — the staircase
    of the paper's Fig. 4.
    """
    if n <= max_inplace:
        return 1
    return max(1, math.ceil(math.log(n) / math.log(max_inplace)))


#: Transform kinds the analytic model understands.
TRANSFORMS = ("c2c", "r2c", "c2r")


@dataclasses.dataclass(frozen=True)
class FFTCase:
    """One measured configuration: length/shape, precision, transform, batch.

    Field-for-field the reference's ``FFTCase``; see its docstring.
    """

    n: int = 0
    precision: str = "fp32"
    batch_bytes: float = 2e9      # paper: ~2 GB of input per batch
    name: str = ""
    transform: str = "c2c"
    radices: tuple[int, ...] | None = None
    shape: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.shape is not None:
            prod = 1
            for d in self.shape:
                prod *= d
            if self.n not in (0, prod):
                raise ValueError(
                    f"n={self.n} inconsistent with shape={self.shape}")
            object.__setattr__(self, "n", prod)
        if self.n < 1:
            raise ValueError("FFTCase needs n >= 1 (or a shape)")
        if self.transform not in TRANSFORMS:
            raise ValueError(f"unknown transform {self.transform!r}; "
                             f"have {TRANSFORMS}")
        if not self.name:
            suffix = "" if self.transform == "c2c" else f"-{self.transform}"
            dims = ("x".join(str(d) for d in self.shape)
                    if self.shape else str(self.n))
            object.__setattr__(
                self, "name", f"fft-n{dims}-{self.precision}{suffix}"
            )

    @property
    def last_axis(self) -> int:
        """The axis the R2C packing applies to (Eq. 2: the last one)."""
        return self.shape[-1] if self.shape else self.n

    @property
    def elem_bytes(self) -> int:
        """Per-point input bytes: complex for C2C, real (half) for pow2
        R2C/C2R (non-pow2 real transforms run the full C2C algorithm)."""
        full = COMPLEX_BYTES[self.precision]
        if self.transform in ("r2c", "c2r") and is_pow2(self.last_axis):
            return full // 2
        return full

    @property
    def n_fft(self) -> int:
        """Eq. 6: transforms per batch — R2C fits 2x more per byte."""
        return max(int(self.batch_bytes // (self.n * self.elem_bytes)), 1)


def fft_workload(
    case: FFTCase,
    device: DeviceSpec,
    *,
    regime_c: bool = False,
) -> WorkloadProfile:
    """Analytic profile of a batched FFT on ``device``.

    ``regime_c`` marks plan/length combinations whose kernel saturates a
    core-clocked cache at f_max (the paper observes this for N = 8192 on
    the V100): the cache term is pinned just above the memory term.
    """
    if case.shape is not None and len(case.shape) > 1:
        return _nd_fft_workload(case, device, regime_c=regime_c)
    n, b = case.n, case.elem_bytes
    n_fft = case.n_fft
    # The packed R2C/C2R path only exists for pow2 lengths.
    real = case.transform in ("r2c", "c2r") and is_pow2(n)
    n_work = max(n // 2, 1) if real else n
    data_bytes = float(n) * b * n_fft

    if uses_bluestein(n):
        # Bluestein: one forward + one inverse FFT of length M ~ 2N (pow2;
        # the filter spectrum is precomputed per length) plus pointwise
        # chirp passes.
        m = 1 << math.ceil(math.log2(2 * n - 1))
        passes = 2 * plan_passes(m) + 1
        flops = 2 * _butterfly_flops(m, case.radices) * n_fft \
            + 20.0 * n * n_fft
        stages = _stage_count(min(m, 2**13), case.radices)
    else:
        passes = plan_passes(n_work)
        flops = (_r2c_flops(n, case.radices) if real
                 else _butterfly_flops(n_work, case.radices)) * n_fft
        stages = _stage_count(min(n_work, 2**13), case.radices)

    hbm_bytes = 2.0 * data_bytes * passes          # read + write per pass
    peak = device.peak_flops * PRECISION_PEAK[case.precision]

    t_mem = hbm_bytes / device.hbm_bandwidth
    t_issue = flops / (peak * device.issue_efficiency)
    # Shared-memory traffic: every butterfly stage exchanges the working set.
    cache_bytes = 2.0 * data_bytes * stages
    t_cache = cache_bytes / device.cache_bandwidth
    if regime_c:
        t_cache = max(t_cache, 1.02 * t_mem)
    return WorkloadProfile(
        name=case.name,
        t_mem=t_mem,
        t_issue=t_issue,
        t_cache=t_cache,
        t_compute=flops / peak,
        contention=0.01,            # mild regime-(a) relief, Fig. 6
        flops=flops,
    )


def _nd_fft_workload(
    case: FFTCase,
    device: DeviceSpec,
    *,
    regime_c: bool = False,
) -> WorkloadProfile:
    """Analytic profile of a batched N-D FFT (Eq. 2 factored passes).

    Pass counts come from the compiled plan graph
    (:func:`repro_torch.fft.plan_nd.nd_pass_summary`) — pow2 axes fuse
    their hand-off transpose into the FFT write, so a pow2 2-D transform
    costs 2 HBM passes.  FLOPs sum the per-axis butterfly counts over the
    points of the other axes; an R2C last axis does half the work and
    shrinks every later axis's row count to (n_last/2 + 1)/n_last.
    """
    from repro_torch.fft.plan_nd import nd_pass_summary

    shape = case.shape
    n, b = case.n, case.elem_bytes
    n_fft = case.n_fft
    transform = case.transform if case.transform != "c2r" else "r2c"
    passes, _chain, stages = nd_pass_summary(shape, transform)

    def axis_flops(na: int) -> float:
        """One length-``na`` 1-D transform, Bluestein-aware (Sec. 2.1)."""
        if not is_pow2(na):
            m = 1 << math.ceil(math.log2(max(2 * na - 1, 2)))
            return 2 * _butterfly_flops(m, case.radices) + 20.0 * na
        return _butterfly_flops(na, case.radices)

    real = transform == "r2c" and is_pow2(shape[-1]) and shape[-1] >= 2
    flops = 0.0
    rows_frac = 1.0
    for axis in reversed(range(len(shape))):
        na = shape[axis]
        batch_pts = n / na                      # transforms of this axis
        if axis == len(shape) - 1 and real:
            flops += batch_pts * _r2c_flops(na, case.radices)
            rows_frac = (na // 2 + 1) / na      # half-spectrum downstream
        else:
            flops += rows_frac * batch_pts * axis_flops(na)
    flops *= n_fft

    data_bytes = float(n) * b * n_fft
    hbm_bytes = 2.0 * data_bytes * passes
    cache_bytes = 2.0 * data_bytes * stages
    peak = device.peak_flops * PRECISION_PEAK[case.precision]
    t_mem = hbm_bytes / device.hbm_bandwidth
    t_cache = cache_bytes / device.cache_bandwidth
    if regime_c:
        t_cache = max(t_cache, 1.02 * t_mem)
    return WorkloadProfile(
        name=case.name,
        t_mem=t_mem,
        t_issue=flops / (peak * device.issue_efficiency),
        t_cache=t_cache,
        t_compute=flops / peak,
        contention=0.01,
        flops=flops,
    )


@dataclasses.dataclass(frozen=True)
class ConvCase:
    """One overlap-save matched-filter configuration (the FDAS workload).

    ``n`` complex points per row are convolved against a bank of
    ``templates`` filters of ``taps`` points each through the segmented
    engine (``repro_torch.fft.convolve``); ``nfft=0`` lets the engine's
    cost model pick the segment length.  ``batch_bytes`` sizes the batch
    by the Eq. 6 memory budget, exactly like :class:`FFTCase`.
    """

    n: int
    templates: int
    taps: int
    nfft: int = 0
    precision: str = "fp32"
    batch_bytes: float = 2e9
    radices: tuple[int, ...] | None = None
    name: str = ""

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"ConvCase needs n >= 1, got {self.n}")
        if self.templates < 1 or self.taps < 1:
            raise ValueError(
                f"ConvCase needs templates/taps >= 1, got "
                f"{self.templates}/{self.taps}")
        if self.precision not in COMPLEX_BYTES:
            raise ValueError(f"unknown precision {self.precision!r}")
        if not self.name:
            object.__setattr__(
                self, "name",
                f"conv-n{self.n}-t{self.templates}x{self.taps}"
                f"-{self.precision}")

    @property
    def plan(self):
        """The memoised overlap-save plan (segmentation + pass counts)."""
        from repro_torch.fft.convolve import conv_plan
        return conv_plan(self.n, self.taps, self.templates, self.nfft)

    @property
    def n_rows(self) -> int:
        """Eq. 6: complex rows per memory-budgeted batch."""
        return max(int(self.batch_bytes
                       // (self.n * COMPLEX_BYTES[self.precision])), 1)


def conv_workload(case: ConvCase, device: DeviceSpec) -> WorkloadProfile:
    """Analytic profile of one batched overlap-save matched-filter plane.

    Pass and traffic counts come straight from the engine's own plan
    (``ConvPlan``: one fused forward pass feeding T filters, T inverse
    passes, zero standalone multiply passes).
    """
    plan = case.plan
    rows = case.n_rows
    t = case.templates
    seg_pts = plan.n_segments * plan.nfft
    scale = COMPLEX_BYTES[case.precision] / 8.0    # plan bytes are complex64
    hbm_bytes = plan.os_bytes * scale * rows
    flops = ((1 + t) * _butterfly_flops(plan.nfft, case.radices)
             * plan.n_segments + 6.0 * t * seg_pts) * rows
    # Every fused pass exchanges its working set once per butterfly stage.
    stages = _stage_count(plan.nfft, case.radices)
    cache_bytes = 2.0 * seg_pts * 8.0 * scale * rows * stages * (1 + t)
    peak = device.peak_flops * PRECISION_PEAK[case.precision]
    return WorkloadProfile(
        name=case.name,
        t_mem=hbm_bytes / device.hbm_bandwidth,
        t_issue=flops / (peak * device.issue_efficiency),
        t_cache=cache_bytes / device.cache_bandwidth,
        t_compute=flops / peak,
        contention=0.01,
        flops=flops,
    )


def fdas_workload(case: ConvCase, device: DeviceSpec, *,
                  series_n: int | None = None) -> list[WorkloadProfile]:
    """Per-stage profiles of the acceleration search: R2C FFT -> template
    convolution -> power/threshold detection.

    ``case.n`` is the half-spectrum length; ``series_n`` overrides the
    time-series length (default ``2 * (n - 1)``).
    """
    if series_n is None:
        series_n = 2 * (case.n - 1)
    fft_prof = fft_workload(
        FFTCase(n=series_n, precision=case.precision,
                batch_bytes=case.batch_bytes, transform="r2c",
                radices=case.radices, name="fdas-fft"),
        device,
    )
    conv_prof = dataclasses.replace(conv_workload(case, device),
                                    name="fdas-conv")
    # Detection: read the (T, nbins) plane, write power + the top-k pass.
    rows = case.n_rows
    plane = float(case.templates * case.n * rows)
    det_bytes = plane * (8.0 + 4.0) * (COMPLEX_BYTES[case.precision] / 8.0)
    det_flops = 5.0 * plane
    peak = device.peak_flops * PRECISION_PEAK[case.precision]
    detect = WorkloadProfile(
        name="fdas-detect",
        t_mem=det_bytes / device.hbm_bandwidth,
        t_issue=det_flops / (peak * 0.4),
        t_compute=det_flops / peak,
        flops=det_flops,
    )
    return [fft_prof, conv_prof, detect]


def merge_profiles(name: str,
                   profs: list[WorkloadProfile]) -> WorkloadProfile:
    """Sum stage profiles into one (for service-level single-clock sweeps).

    Times and FLOPs add; contention is t_mem-weighted (the memory-bound
    fraction is what the contention term scales, Fig. 6)."""
    t_mem = sum(p.t_mem for p in profs)
    contention = (sum(p.contention * p.t_mem for p in profs) / t_mem
                  if t_mem > 0 else 0.0)
    return WorkloadProfile(
        name=name,
        t_mem=t_mem,
        t_issue=sum(p.t_issue for p in profs),
        t_cache=sum(p.t_cache for p in profs),
        t_compute=sum(p.t_compute for p in profs),
        t_coll=sum(p.t_coll for p in profs),
        contention=contention,
        flops=sum(p.flops for p in profs),
    )


def fdas_total_profile(case: ConvCase, device: DeviceSpec, *,
                       series_n: int | None = None) -> WorkloadProfile:
    """All FDAS stages merged into one profile (service-level sweeps)."""
    return merge_profiles(f"fdas-n{case.n}-t{case.templates}",
                          fdas_workload(case, device, series_n=series_n))


@dataclasses.dataclass(frozen=True)
class PulsarCase:
    """One end-to-end pulsar-search configuration
    (``repro_torch.search.pipeline``).

    A batch holds ``n_rows`` filterbanks of (nchan, ntime) float32
    samples (the Eq. 6 memory budget applied to the pipeline's *input*);
    each expands to ``dm_trials`` dedispersed series, which FDAS turns
    into (dm_trials * templates) power rows of ``nbins`` each for the
    harmonic-sum and sift stages.
    """

    nchan: int
    ntime: int
    dm_trials: int
    templates: int
    taps: int
    n_harmonics: int = 8
    precision: str = "fp32"
    batch_bytes: float = 2e9
    radices: tuple[int, ...] | None = None
    name: str = ""

    def __post_init__(self):
        if min(self.nchan, self.ntime, self.dm_trials, self.templates,
               self.taps) < 1:
            raise ValueError(
                f"PulsarCase needs every dimension >= 1, got nchan="
                f"{self.nchan} ntime={self.ntime} dm_trials="
                f"{self.dm_trials} templates={self.templates} "
                f"taps={self.taps}")
        if self.n_harmonics < 1 or self.n_harmonics & (self.n_harmonics - 1):
            raise ValueError(
                f"n_harmonics must be a power of two, got "
                f"{self.n_harmonics}")
        if self.precision not in COMPLEX_BYTES:
            raise ValueError(f"unknown precision {self.precision!r}")
        if not self.name:
            object.__setattr__(
                self, "name",
                f"pulsar-c{self.nchan}x{self.ntime}-d{self.dm_trials}"
                f"-t{self.templates}-{self.precision}")

    @property
    def sample_bytes(self) -> int:
        """Bytes of one filterbank sample (real, half the complex size)."""
        return COMPLEX_BYTES[self.precision] // 2

    @property
    def n_rows(self) -> int:
        """Eq. 6: filterbanks per memory-budgeted batch."""
        return max(int(self.batch_bytes
                       // (self.nchan * self.ntime * self.sample_bytes)), 1)

    @property
    def nbins(self) -> int:
        return self.ntime // 2 + 1


def pulsar_search_workload(case: PulsarCase,
                           device: DeviceSpec) -> list[WorkloadProfile]:
    """Per-stage profiles of the end-to-end search: dedisp -> fdas ->
    harmonic-sum -> sift.

    Each stage's traffic follows its kernel's HBM/on-chip pattern (the
    same discipline as ``fft_workload`` vs ``repro_torch.fft.plan``):
    dedispersion reads the (C, N) block once and writes D series while
    re-reading on-chip memory D*C times; FDAS is the merged R2C + overlap-save
    model over D series per filterbank; the harmonic-sum plane kernel
    reads the power plane once and writes only (stat, level); sifting
    is one streaming top-k pass.  These four feed ``dvfs.sweep`` +
    ``DVFSScheduler`` for the per-stage clock plan.
    """
    rows = case.n_rows
    sb = float(case.sample_bytes)
    peak = device.peak_flops * PRECISION_PEAK[case.precision]
    c, n, d, t = case.nchan, case.ntime, case.dm_trials, case.templates

    # --- dedispersion: shift-and-sum, memory-bound ----------------------
    dd_hbm = (c + d) * n * sb * rows                 # read block, write D
    dd_flops = float(d) * c * n * rows               # one add per (dm, ch)
    dd_cache = 2.0 * d * c * n * sb * rows           # on-chip re-reads
    dedisp = WorkloadProfile(
        name="dedisp",
        t_mem=dd_hbm / device.hbm_bandwidth,
        t_issue=dd_flops / (peak * 0.4),
        t_cache=dd_cache / device.cache_bandwidth,
        t_compute=dd_flops / peak,
        contention=0.01,
        flops=dd_flops,
    )

    # --- FDAS (R2C + matched filter) over D series per filterbank -------
    conv_case = ConvCase(
        n=case.nbins, templates=t, taps=case.taps,
        precision=case.precision,
        batch_bytes=float(rows * d) * case.nbins
        * COMPLEX_BYTES[case.precision],
        radices=case.radices)
    fdas = dataclasses.replace(
        merge_profiles("fdas", fdas_workload(conv_case, device,
                                             series_n=n)[:2]),
        name="fdas")

    # --- harmonic sum: fused plane kernel (stat + level out only) -------
    plane_rows = float(rows * d) * t
    hs_hbm = plane_rows * case.nbins * (sb + 2 * sb)  # read P, write 2
    hs_levels = max(case.n_harmonics.bit_length(), 1)
    hs_flops = plane_rows * case.nbins * (case.n_harmonics + 3 * hs_levels)
    hs_cache = 2.0 * plane_rows * case.nbins * sb * hs_levels
    hsum = WorkloadProfile(
        name="harmonic-sum",
        t_mem=hs_hbm / device.hbm_bandwidth,
        t_issue=hs_flops / (peak * 0.4),
        t_cache=hs_cache / device.cache_bandwidth,
        t_compute=hs_flops / peak,
        contention=0.01,
        flops=hs_flops,
    )

    # --- sift: one streaming top-k over the statistic volume ------------
    sf_bytes = plane_rows * case.nbins * 2 * sb      # read stat + level
    sf_flops = 5.0 * plane_rows * case.nbins
    sift = WorkloadProfile(
        name="sift",
        t_mem=sf_bytes / device.hbm_bandwidth,
        t_issue=sf_flops / (peak * 0.4),
        t_compute=sf_flops / peak,
        flops=sf_flops,
    )
    return [dedisp, fdas, hsum, sift]


def pulsar_search_total_profile(case: PulsarCase,
                                device: DeviceSpec) -> WorkloadProfile:
    """All four stages merged into one profile (service-level sweeps)."""
    return merge_profiles(case.name, pulsar_search_workload(case, device))


def roofline_workload(
    name: str,
    device: DeviceSpec,
    *,
    hlo_flops: float,
    hbm_bytes: float,
    collective_bytes: float = 0.0,
    useful_flops: float | None = None,
    issue_efficiency: float | None = None,
) -> WorkloadProfile:
    """Profile a model step for the DVFS planner from its FLOPs and bytes
    (the reference's name ``hlo_flops`` kept: there, a compiled XLA
    step's).

    ``issue_efficiency`` defaults to the device's calibrated value; steps
    dominated by large matmuls run much closer to peak than a butterfly
    kernel, so callers may pass a higher value.
    """
    eff = device.issue_efficiency if issue_efficiency is None else issue_efficiency
    t_coll = (
        collective_bytes / device.link_bandwidth
        if device.link_bandwidth and collective_bytes else 0.0
    )
    return WorkloadProfile(
        name=name,
        t_mem=hbm_bytes / device.hbm_bandwidth,
        t_issue=hlo_flops / (device.peak_flops * eff),
        t_cache=0.0,
        t_compute=hlo_flops / device.peak_flops,
        t_coll=t_coll,
        flops=useful_flops if useful_flops is not None else hlo_flops,
    )


# The FFT-length sweep the paper covers (powers of two 2^5..2^22 plus a few
# radix-7+/Bluestein lengths for completeness).
def paper_lengths() -> list[int]:
    pow2 = [2**k for k in range(5, 23)]
    other = [3**7, 7**4, 139**2]            # mixed radix-3, radix-7, Bluestein
    return pow2 + other


# V100 lengths the paper singles out as regime (c).
V100_REGIME_C_LENGTHS = {8192}
