"""Hardware specifications and DVFS frequency tables.

A numpy copy of ``repro.core.hardware``: the same :class:`DeviceSpec` and
the paper's three device records, so that the port prices a workload
exactly as the reference does, and the record of the card the port runs on
(:data:`H100_SXM`) in place of the reference's TPU record.  Paper
reference: Table 1 (allowed core clock frequencies) and Table 2 (GPU card
specifications).

Frequencies are MHz, bandwidths are bytes/s, powers are watts.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Static description of one device model for the DVFS model."""

    name: str
    # --- frequency tables (paper Table 1) -------------------------------
    f_max: float                  # maximal / boost core clock [MHz]
    f_base: float | None          # base core clock [MHz] (None: no base clock)
    f_min: float                  # minimal core clock [MHz]
    f_step: float                 # nominal frequency step [MHz]
    # --- compute/memory capability (paper Table 2) ----------------------
    peak_flops: float             # peak FLOP/s at f_max for the modelled dtype
    hbm_bandwidth: float          # device-memory bandwidth [bytes/s]
    cache_bandwidth: float        # shared/L1-class bandwidth at f_max [bytes/s]
    memory_bytes: float           # device memory size [bytes]
    tdp: float                    # thermal design power [W]
    idle_power: float             # static (idle/P-state floor) power [W]
    # --- DVFS voltage model ---------------------------------------------
    v_max: float = 1.0            # relative voltage at f_max
    v_floor: float = 0.60         # voltage floor (no undervolting below this)
    f_vfloor_frac: float = 0.45   # f/f_max below which voltage stays at floor
    # --- scheduler behaviour ---------------------------------------------
    # Exponent p in t_issue(f) = t_issue(f_max) * (f_max/f)^p.  p > 1 models
    # the paper's Sec. 6 observation that once instruction issue saturates,
    # latency hiding collapses and the slowdown is superlinear in 1/f.
    issue_superlinearity: float = 2.0
    # Effective fraction of peak FLOP/s the device can issue for a
    # shuffle-heavy butterfly kernel (calibrated; cuFFT is far from peak).
    issue_efficiency: float = 0.33
    # Fraction of core switching power still burned while stalled on
    # memory (datacenter parts keep warps resident and hot; mobile SoCs
    # clock-gate aggressively).
    stall_power_frac: float = 0.75
    # How well the memory system and the core pipelines overlap (1.0 =
    # perfect latency hiding, the roofline max; 0.0 = fully serialised).
    exec_overlap: float = 1.0
    # Fraction of the dynamic power envelope drawn by the memory system
    # when saturated (HBM2 stacks are power-hungry; LPDDR4 is not).
    mem_power_frac: float = 0.12
    # Whether the device's power sensor covers the memory rail (the
    # Nano's tegrastats GPU rail does not; nvidia-smi's board power does).
    power_sensor_includes_mem: bool = True
    # --- interconnect ------------------------------------------------------
    link_bandwidth: float | None = None   # per-link interconnect [bytes/s]

    def frequencies(self) -> np.ndarray:
        """The discrete allowed core-clock grid, descending from f_max.

        The paper notes the step alternates between two close values
        (e.g. 7/8 MHz on V100); a fixed nominal step is an accurate model.
        """
        n = int(np.floor((self.f_max - self.f_min) / self.f_step)) + 1
        f = self.f_max - self.f_step * np.arange(n)
        return np.clip(f, self.f_min, None)

    def voltage(self, f: np.ndarray | float) -> np.ndarray:
        """Relative supply voltage V(f)/V(f_max), piecewise linear with floor.

        Below a certain frequency the P-state (and voltage) stops
        dropping, which is why power flattens at the low end of Fig. 8.
        """
        f = np.asarray(f, dtype=np.float64)
        frac = f / self.f_max
        knee = self.f_vfloor_frac
        slope = (self.v_max - self.v_floor) / (1.0 - knee)
        v = self.v_floor + slope * np.clip(frac - knee, 0.0, None)
        return np.clip(v, self.v_floor, self.v_max)


# ---------------------------------------------------------------------------
# Paper devices (Tables 1 & 2).  peak_flops is the FP32 figure.
# idle_power is estimated from the paper's Fig. 8 low-frequency plateau.
# ---------------------------------------------------------------------------

TESLA_V100 = DeviceSpec(
    name="tesla-v100",
    f_max=1530.0, f_base=1200.0, f_min=135.0, f_step=7.5,
    peak_flops=15.7e12,           # FP32 TFLOP/s at boost
    hbm_bandwidth=900e9,
    cache_bandwidth=14550e9,      # shared-memory bandwidth, Table 2
    memory_bytes=16e9,
    tdp=300.0,
    idle_power=40.0,
    v_floor=0.60, f_vfloor_frac=0.45,
    issue_superlinearity=2.0, issue_efficiency=0.42,
    stall_power_frac=0.75, exec_overlap=1.0,
    mem_power_frac=0.30,                     # HBM2 stacks draw ~60-70 W
)

JETSON_NANO = DeviceSpec(
    name="jetson-nano",
    f_max=921.6, f_base=None, f_min=76.8, f_step=76.8,
    peak_flops=472e9,             # FP32 GFLOP/s
    hbm_bandwidth=25.6e9,
    cache_bandwidth=230e9,
    memory_bytes=4e9,
    tdp=10.0,
    idle_power=0.5,                # GPU rail only (tegrastats view)
    # Little compute margin over LPDDR4 bandwidth: the issue term is
    # near-saturated at f_max, so every frequency step costs time (Fig. 6).
    v_floor=0.72, f_vfloor_frac=0.50,
    issue_superlinearity=1.0, issue_efficiency=0.16,
    stall_power_frac=0.30, exec_overlap=0.5,
    mem_power_frac=0.10,                     # LPDDR4 is cheap to drive
)

TITAN_V = DeviceSpec(
    name="titan-v",
    f_max=1912.0, f_base=1220.0, f_min=135.0, f_step=7.5,
    peak_flops=14.9e12,
    hbm_bandwidth=652e9,
    cache_bandwidth=14550e9,
    memory_bytes=12e9,
    tdp=250.0,
    idle_power=36.0,
    v_floor=0.60, f_vfloor_frac=0.45,
    issue_superlinearity=2.0, issue_efficiency=0.42,
    stall_power_frac=0.75, exec_overlap=1.0,
    mem_power_frac=0.30,
)

# Driver cap observed by the paper on the Titan V during compute kernels.
TITAN_V_DRIVER_CAP_MHZ = 1335.0

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM (80 GB HBM3) — the card the port runs on.  It takes the
# place of the reference's TPU record.
#
# From NVIDIA's data sheet (SXM part): peak_flops is the float32 rate
# outside the tensor cores, hbm_bandwidth, memory_bytes and tdp as
# published.  cache_bandwidth is derived: 132 SMs x 128 bytes a clock of
# shared memory x f_max.  Read on an H100 80GB HBM3 at a 700 W power limit
# (chip_smoke.py phase 9, through NVML): the supported graphics-clock grid
# (1980 down to 345 MHz in 15 MHz steps, at either memory clock), the
# default application clock (1980 MHz) and the board power at rest
# (129.32 W: idle with a CUDA context up, the SM clock held at 1980 MHz,
# which is the model's P(f_max) at zero utilisation).
# The voltage, issue and power-split parameters are the DeviceSpec
# defaults: uncalibrated, not fitted to any measurement of this card.
# ---------------------------------------------------------------------------

H100_SXM = DeviceSpec(
    name="h100-sxm",
    f_max=1980.0, f_base=1980.0, f_min=345.0, f_step=15.0,
    peak_flops=67e12,             # FP32, outside the tensor cores
    hbm_bandwidth=3.35e12,
    cache_bandwidth=132 * 128 * 1980e6,
    memory_bytes=80e9,
    tdp=700.0,
    idle_power=129.32,
)

#: The H100 SXM record with NVIDIA's published dense bf16 tensor-core rate
#: (data sheet, SXM part: 989 TFLOP/s without sparsity) as its peak: a bf16
#: model step runs on the tensor cores, while ``H100_SXM.peak_flops`` is
#: the float32 rate outside them.  It is not in :data:`DEVICES`, so that
#: ``H100_SXM`` prices everything else as it is.
H100_SXM_BF16 = dataclasses.replace(H100_SXM, name="h100-sxm-bf16",
                                    peak_flops=989e12)

DEVICES: dict[str, DeviceSpec] = {
    d.name: d for d in (TESLA_V100, JETSON_NANO, TITAN_V, H100_SXM)
}


def get_device(name: str) -> DeviceSpec:
    try:
        return DEVICES[name]
    except KeyError as e:
        raise KeyError(f"unknown device {name!r}; have {sorted(DEVICES)}") from e
