"""The paper's demonstration pipeline (Sec. 5.3): pulsar search stages.

  FFT -> power spectrum -> mean/std normalisation -> harmonic sum -> S/N

The counterpart of ``repro.fft.pipeline``.  The paper uses this pipeline
to show that locking the clock to the mean optimal frequency *only around
the FFT call* yields the share-weighted energy saving (Table 4).  The FFT
runs the port's plan (``plan_nd``, so its kernels); every other stage is
plain torch, as the reference's demo is plain JAX.  Its harmonic sum
clamps an out-of-range harmonic to bin n - 1, as the reference's does,
where the harmonic-sum kernels (``repro_torch.kernels.harmonic_sum``)
zero-pad: the two agree where k * n_harmonics < n.  ``stage_profiles``
exports the per-stage workload profiles the clock scheduler consumes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.perf_model import WorkloadProfile
from repro_torch.core.workloads import FFTCase, fft_workload, merge_profiles
from repro_torch.fft.plan_nd import plan_nd
from repro_torch.fft.stockham import _as_tensor

MAX_HARMONICS = 32


def power_spectrum(spectrum: torch.Tensor, n: int | None = None
                   ) -> torch.Tensor:
    """|X|^2 / N of an FFT output (batch, n).

    ``n`` overrides the normalisation length — pass the original transform
    length when ``spectrum`` is an R2C half-spectrum (n/2+1 bins).
    """
    if n is None:
        n = spectrum.shape[-1]
    return (spectrum.real ** 2 + spectrum.imag ** 2) / n


def spectrum_stats(power: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-spectrum mean and (population) std, the normalisation stage."""
    mean = power.mean(dim=-1, keepdim=True)
    std = power.std(dim=-1, keepdim=True, correction=0)
    return mean, std


def harmonic_sum(power: torch.Tensor, n_harmonics: int = MAX_HARMONICS
                 ) -> torch.Tensor:
    """Harmonic-summed spectra: S_h[k] = sum_{j=1..h} P[min(j*k, n-1)].

    Returns (batch, n_levels, n) where level i holds h = 2^i harmonics
    (h in {1, 2, 4, ..., n_harmonics}), the standard levels used in
    Fourier-domain pulsar searches [Adamek & Armour 2019].
    """
    n = power.shape[-1]
    levels = int(math.log2(n_harmonics)) + 1
    k = torch.arange(n, device=power.device)
    outs = [power]
    acc = power
    h = 1
    for _ in range(levels - 1):
        h *= 2
        # add harmonics j = h/2+1 .. h in one shot via gathered indices
        js = torch.arange(h // 2 + 1, h + 1, device=power.device)
        idx = torch.clamp(js[:, None] * k[None, :], max=n - 1)  # (h/2, n)
        acc = acc + power[..., idx].sum(dim=-2)
        outs.append(acc)
    return torch.stack(outs, dim=-2)                        # (batch, L, n)


def candidate_snr(hsums: torch.Tensor, mean: torch.Tensor,
                  std: torch.Tensor) -> torch.Tensor:
    """S/N per harmonic level: (S_h - h*mu) / (sqrt(h)*sigma)."""
    levels = hsums.shape[-2]
    h = (2.0 ** torch.arange(levels, device=hsums.device))[:, None]
    return ((hsums - h * mean[..., None, :])
            / (torch.sqrt(h) * std[..., None, :]))


def pulsar_pipeline(x, n_harmonics: int = MAX_HARMONICS,
                    real_input: bool = False) -> torch.Tensor:
    """End-to-end pipeline on a batch of time series (batch, n).

    Returns the S/N spectra (batch, levels, n); a search would threshold
    these for candidates.  ``real_input=True`` runs the R2C plan instead —
    telescope voltages are real, so the FFT stage does half the work and
    the downstream stages see the n/2+1-bin half-spectrum.  Numpy input
    goes to the card.
    """
    x = _as_tensor(x)
    n = x.shape[-1]
    # Through the plan graph (rank 1 is the 1-D planner), as the reference.
    if real_input:
        real = x.real if x.is_complex() else x
        spec = plan_nd((n,), "r2c")(real.to(torch.float32))
    else:
        spec = plan_nd((n,), "c2c")(x.to(torch.complex64))
    p = power_spectrum(spec, n)
    mean, std = spectrum_stats(p)
    hs = harmonic_sum(p, n_harmonics)
    return candidate_snr(hs, mean, std)


# ---------------------------------------------------------------------------
# DVFS integration: per-stage workload profiles for the clock scheduler.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelineShape:
    batch: int
    n: int
    n_harmonics: int = MAX_HARMONICS
    elem_bytes: int = 8          # complex64 input
    real_input: bool = False     # R2C front end: half-spectrum downstream


def stage_profiles(shape: PipelineShape, device: DeviceSpec
                   ) -> list[WorkloadProfile]:
    """Analytic traffic/FLOP model of each stage, feeding the scheduler.

    Mirrors the paper's Sec. 5.3 accounting: with more harmonics summed,
    the non-FFT share grows and the composite saving shrinks (Table 4).
    With ``real_input`` the FFT stage uses the R2C cost model and every
    downstream stage processes the n/2+1-bin half-spectrum.
    """
    b, n = shape.batch, shape.n
    transform = "r2c" if shape.real_input else "c2c"
    elem = shape.elem_bytes // 2 if shape.real_input else shape.elem_bytes
    # Downstream stages see n bins (C2C) or n/2+1 bins (R2C half-spectrum).
    data = float(b * (n // 2 + 1 if shape.real_input else n))

    fft_prof = fft_workload(
        FFTCase(n=n, precision="fp32",
                batch_bytes=float(b * n) * elem,
                transform=transform, name="fft"),
        device,
    )

    def simple(name: str, bytes_moved: float, flops: float,
               issue_eff: float = 0.6) -> WorkloadProfile:
        return WorkloadProfile(
            name=name,
            t_mem=bytes_moved / device.hbm_bandwidth,
            t_issue=flops / (device.peak_flops * issue_eff),
            t_compute=flops / device.peak_flops,
            flops=flops,
        )

    # |X|^2: read c64, write f32; 3 flops/point.
    power = simple("power", data * (8 + 4), 3 * data)
    # mean/std: read f32, two reduction passes fused into one read.
    stats = simple("stats", data * 4, 4 * data)
    # harmonic sum: each doubling reads the base spectrum h/2 more times
    # (gather traffic) + writes one level.
    levels = int(math.log2(shape.n_harmonics))
    gather_reads = sum(2**i for i in range(levels))          # 1+2+...  ~ h-1
    hsum_bytes = data * 4 * (gather_reads + levels + 1)
    hsum = simple("harmonic_sum", hsum_bytes, data * (shape.n_harmonics - 1),
                  issue_eff=0.3)
    # S/N: read levels+stats, write levels.
    snr = simple("snr", data * 4 * 2 * (levels + 1), 4 * data * (levels + 1))
    return [fft_prof, power, stats, hsum, snr]


def total_profile(shape: PipelineShape, device: DeviceSpec
                  ) -> WorkloadProfile:
    """All five stages merged into one profile for service-level
    accounting: times add, contention is t_mem-weighted."""
    return merge_profiles(
        f"pulsar-b{shape.batch}-n{shape.n}-h{shape.n_harmonics}",
        stage_profiles(shape, device))


def fft_time_share(shape: PipelineShape, device: DeviceSpec) -> float:
    """Fraction of pipeline time spent in the FFT at boost clock (Table 4)."""
    times = [p._t0(device) for p in stage_profiles(shape, device)]
    return times[0] / sum(times)
