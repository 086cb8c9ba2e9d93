"""Workload builders for the DVFS model (numpy copy of
``repro.core.workloads``, limited to the 1-D FFT).

:func:`fft_workload` is an analytic model of a batched out-of-place 1-D
FFT in the style the paper measures: FLOPs = 5 N log2 N per transform,
HBM traffic = one read + one write of the whole batch per *pass*, where a
pass is one kernel of the multi-kernel plan (``repro_torch.fft.plan``
runs exactly that many kernel launches).

The N-D, convolution/FDAS and pulsar-search builders of the reference
arrive with the slices that port their engines; until then they raise.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.perf_model import WorkloadProfile
from repro_torch.fft.radix import (mixed_radix_flop_count, r2c_flop_count,
                                   stage_count)

# Byte sizes of one complex element per precision (paper: C2C transforms).
COMPLEX_BYTES = {"fp16": 4, "fp32": 8, "fp64": 16}

# Peak-FLOP multiplier per precision relative to the device's FP32 figure
# (V100-style ratios: FP64 = 1/2, FP16 = 2x).
PRECISION_PEAK = {"fp16": 2.0, "fp32": 1.0, "fp64": 0.5}


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


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

    Field-for-field the reference's ``FFTCase``; see its docstring.  The
    port prices 1-D cases only so far (``shape`` of more than one axis
    raises in :func:`fft_workload`).
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
    """Analytic profile of a batched 1-D FFT on ``device``.

    ``regime_c`` marks plan/length combinations whose kernel saturates a
    core-clocked cache at f_max (the paper observes this for N = 8192 on
    the V100): the cache term is pinned just above the memory term.
    """
    if case.shape is not None and len(case.shape) > 1:
        raise NotImplementedError(
            "N-D FFT workloads arrive with the N-D plan-graph slice of the "
            "port (repro_torch.fft.plan_nd)")
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


def conv_workload(*args, **kwargs) -> WorkloadProfile:
    """Overlap-save convolution profile: arrives with the FDAS slice."""
    raise NotImplementedError(
        "conv_workload arrives with the overlap-save/FDAS slice of the port")


def fdas_workload(*args, **kwargs) -> list[WorkloadProfile]:
    """Acceleration-search stage profiles: arrive with the FDAS slice."""
    raise NotImplementedError(
        "fdas_workload arrives with the overlap-save/FDAS slice of the port")


def pulsar_search_workload(*args, **kwargs) -> list[WorkloadProfile]:
    """Pulsar-search stage profiles: arrive with the pipeline slice."""
    raise NotImplementedError(
        "pulsar_search_workload arrives with the pulsar-pipeline slice of "
        "the port")
