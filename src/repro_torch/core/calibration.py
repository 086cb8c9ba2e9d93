"""Paper-faithful reproduction: the V100/Jetson DVFS study, from the model
(a numpy copy of ``repro.core.calibration``).

This module runs the exact experiment grid of the paper (FFT lengths x
precisions x allowed clock grid) through the analytic DVFS model and
summarises it with the paper's own metrics.  The reference's
``tests/test_calibration.py`` asserts the summary against the paper's
published claims (Abstract, Table 3, Figs. 9/11/13/15, Sec. 6.2); the
port's ``tests/test_torch_calibration.py`` holds this copy to the same
claims and to the reference, row for row.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import workloads
from repro_torch.core.dvfs import MeanOptimal, SweepResult, mean_optimal, sweep
from repro_torch.core.hardware import DeviceSpec, JETSON_NANO, TESLA_V100
from repro_torch.core.power_model import PowerModel
from repro_torch.core.workloads import FFTCase, V100_REGIME_C_LENGTHS, fft_workload


@dataclasses.dataclass(frozen=True)
class CalibrationSummary:
    """The paper's headline numbers for one (device, precision)."""

    device: str
    precision: str
    sweeps: list[SweepResult]
    mean_opt: MeanOptimal

    # Fig. 9 / Table 3
    @property
    def mean_opt_frac(self) -> float:
        return self.mean_opt.f_mean / self.sweeps[0].boost.f

    # Fig. 11 (median over lengths; paper: "below 5-10% with few exceptions")
    @property
    def median_slowdown(self) -> float:
        return float(np.median([s.slowdown for s in self.sweeps]))

    @property
    def max_power_reduction(self) -> float:
        return float(np.max([s.power_reduction for s in self.sweeps]))

    @property
    def mean_power_reduction(self) -> float:
        return float(np.mean([s.power_reduction for s in self.sweeps]))

    # Fig. 13 (mean over lengths)
    @property
    def mean_i_ef_boost(self) -> float:
        return float(np.mean([s.i_ef_boost for s in self.sweeps]))

    # Fig. 14
    @property
    def mean_i_ef_base(self) -> float | None:
        vals = [s.i_ef_base for s in self.sweeps if s.i_ef_base is not None]
        return float(np.mean(vals)) if vals else None

    def row(self) -> dict:
        return {
            "device": self.device,
            "precision": self.precision,
            "mean_opt_mhz": self.mean_opt.f_mean,
            "mean_opt_frac_boost": round(self.mean_opt_frac, 3),
            "median_slowdown_pct": round(100 * self.median_slowdown, 2),
            "max_power_cut_pct": round(100 * self.max_power_reduction, 1),
            "mean_power_cut_pct": round(100 * self.mean_power_reduction, 1),
            "mean_I_ef_boost": round(self.mean_i_ef_boost, 3),
            "mean_I_ef_base": (round(v, 3)
                               if (v := self.mean_i_ef_base) is not None else None),
            "mean_opt_loss_pp": round(self.mean_opt.loss_pp, 2),
        }


def supported_precisions(device: DeviceSpec) -> list[str]:
    # Paper Sec. 5: P4/Titan XP lack FP16; Nano and consumer cards have
    # crippled FP64 (modelled via PRECISION_PEAK anyway); V100 has all.
    if device.name == "jetson-nano":
        return ["fp32", "fp16"]
    return ["fp32", "fp64", "fp16"]


def calibrate(
    device: DeviceSpec,
    precision: str = "fp32",
    lengths: list[int] | None = None,
) -> CalibrationSummary:
    lengths = lengths or workloads.paper_lengths()
    if precision == "fp16":
        # cuFFT restricts FP16 to power-of-two lengths (Sec. 5).
        lengths = [n for n in lengths if workloads.is_pow2(n)]
    pm = PowerModel(device)
    sweeps = []
    batch = 2e9 if device.name != "jetson-nano" else 0.5e9   # Nano: 1/4 data
    for n in lengths:
        case = FFTCase(n=n, precision=precision, batch_bytes=batch)
        profile = fft_workload(
            case, device,
            regime_c=(device.name == "tesla-v100" and n in V100_REGIME_C_LENGTHS),
        )
        sweeps.append(sweep(profile, device, pm))
    # Paper: Bluestein lengths excluded from the Nano's mean (Sec. 4).
    exclude = set()
    if device.name == "jetson-nano":
        exclude = {s.profile.name for s in sweeps
                   if workloads.uses_bluestein(int(s.profile.name.split("-")[1][1:]))}
    mo = mean_optimal(sweeps, device, exclude=exclude)
    return CalibrationSummary(
        device=device.name, precision=precision, sweeps=sweeps, mean_opt=mo
    )


def full_report() -> list[dict]:
    rows = []
    for device in (TESLA_V100, JETSON_NANO):
        for prec in supported_precisions(device):
            rows.append(calibrate(device, prec).row())
    return rows

