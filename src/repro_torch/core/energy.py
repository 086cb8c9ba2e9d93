"""Energy and efficiency metrics — Eqs. (3)-(7) of the paper (numpy copy of
``repro.core.energy``).

  E_f   = sum_i P_i * t_i                       (3)  energy of a run
  E_ef  = C_p * t / E_f = C_p / P_avg           (4)  energy efficiency
  C_p   = 5 N log2(N) * N_b * N_FFT / t         (5)  FFT computational perf
  N_FFT = M_GB / (N * B)                        (6)  transforms per batch
  I_ef  = E_ef,o / E_ef,d                       (7)  efficiency increase

The model is analytic, so (3) collapses to E(f) = P(f) * t(f); the sampled
form prices a measured power trace (the paper's 10 ms nvidia-smi samples,
``repro_torch.power.nvml.PowerTrace`` on the card).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.perf_model import WorkloadProfile
from repro_torch.core.power_model import PowerModel


def guarded_ratio(num: float, den: float, *, on_zero: float = 1.0) -> float:
    """``num / den`` with ONE documented zero-denominator convention.

    ``den == 0`` and ``num == 0`` gives ``on_zero``, which the metric
    defines: 1.0 for "fraction of demand served"-style metrics (no demand,
    nothing unserved), 0.0 for "fraction of events that hit"-style metrics
    (no events, no hits).  ``den == 0`` and ``num != 0`` gives NaN, always:
    work accounted against no demand is an accounting bug, not an edge.
    """
    if den == 0:
        return on_zero if num == 0 else float("nan")
    return num / den


def fft_flops(n: int, n_batches: int = 1, n_fft: int = 1) -> float:
    """Eq. (5) numerator: 5 N log2(N) * N_b * N_FFT."""
    return 5.0 * n * np.log2(n) * n_batches * n_fft


def ffts_per_batch(m_bytes: float, n: int, elem_bytes: int) -> int:
    """Eq. (6): how many length-N transforms fill ``m_bytes`` of memory."""
    return max(int(m_bytes // (n * elem_bytes)), 1)


def energy_from_trace(power_samples: np.ndarray, dt: np.ndarray | float) -> float:
    """Eq. (3) on a sampled power trace (paper: 10 ms nvidia-smi samples)."""
    p = np.asarray(power_samples, dtype=np.float64)
    dt = np.broadcast_to(np.asarray(dt, dtype=np.float64), p.shape)
    return float(np.sum(p * dt))


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """Everything the paper reports about running a workload at a clock f."""

    f: float                 # core clock [MHz]
    time: float              # execution time [s]
    power: float             # average power [W]
    energy: float            # E(f) = P * t [J]
    gflops: float            # C_p / 1e9
    gflops_per_watt: float   # E_ef / 1e9  (Eq. 4 with C_p in FLOPS)


def evaluate(
    profile: WorkloadProfile,
    device: DeviceSpec,
    power_model: PowerModel,
    f: np.ndarray | float,
) -> OperatingPoint | list[OperatingPoint]:
    """Evaluate a workload at one or many core-clock frequencies."""
    f_arr = np.atleast_1d(np.asarray(f, dtype=np.float64))
    t = profile.time(f_arr, device)
    p = power_model.power(
        f_arr,
        u_core=profile.core_utilisation(device),
        u_mem=profile.mem_utilisation(device),
    )
    e = p * t
    c_p = profile.flops / t if profile.flops else np.zeros_like(t)
    pts = [
        OperatingPoint(
            f=float(fi), time=float(ti), power=float(pi), energy=float(ei),
            gflops=float(ci) / 1e9,
            gflops_per_watt=(float(ci) / float(pi)) / 1e9 if pi > 0 else 0.0,
        )
        for fi, ti, pi, ei, ci in zip(f_arr, t, p, e, c_p)
    ]
    return pts[0] if np.isscalar(f) or np.asarray(f).ndim == 0 else pts


def efficiency_increase(opt: OperatingPoint, ref: OperatingPoint) -> float:
    """Eq. (7): I_ef = E_ef(optimal) / E_ef(reference clock)."""
    if ref.gflops_per_watt > 0:
        return opt.gflops_per_watt / ref.gflops_per_watt
    # Workloads without a FLOP count: efficiency ratio reduces to E_d/E_o.
    return ref.energy / opt.energy
