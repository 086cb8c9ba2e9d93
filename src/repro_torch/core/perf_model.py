"""Execution-time-vs-frequency model (numpy copy of ``repro.core.perf_model``).

A kernel is described by latency components executed with overlap:

  t_mem           HBM traffic            frequency-INDEPENDENT
  t_coll          interconnect traffic   frequency-INDEPENDENT
  t_issue(f)      instruction issue      ~ (1/f)^p
  t_cache(f)      shared-memory traffic  ~ 1/f
  t_compute(f)    FPU flops              ~ 1/f

plus a contention term that inflates t_mem at *high* f (the paper's
regime (a), Fig. 6).  All component magnitudes are seconds *at f_max*.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hardware import DeviceSpec


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """A kernel/step as seen by the DVFS model (all times at f_max, seconds)."""

    name: str
    t_mem: float = 0.0          # HBM traffic (frequency-independent)
    t_issue: float = 0.0        # instruction-issue bound at f_max
    t_cache: float = 0.0        # shared-memory bound at f_max
    t_compute: float = 0.0      # FPU bound at f_max
    t_coll: float = 0.0         # interconnect (frequency-independent)
    contention: float = 0.0     # regime-(a) strength: relative t_mem
    #                             inflation at f_max, fading to 0 at the
    #                             voltage-floor knee.
    flops: float = 0.0          # useful FLOPs (for GFLOPS & GFLOPS/W)

    @property
    def t_core(self) -> float:
        """Core-clocked bound at f_max."""
        return max(self.t_issue, self.t_cache, self.t_compute)

    @property
    def t_flat(self) -> float:
        """Frequency-independent bound."""
        return max(self.t_mem, self.t_coll)

    def time(self, f: np.ndarray | float, device: DeviceSpec) -> np.ndarray:
        """Execution time [s] at core clock ``f`` MHz."""
        f = np.asarray(f, dtype=np.float64)
        scale = device.f_max / f
        knee = device.f_vfloor_frac
        # Regime (a): cache/HBM contention relief as the core slows down.
        frac = np.clip((f / device.f_max - knee) / (1.0 - knee), 0.0, 1.0)
        t_mem_eff = self.t_mem * (1.0 + self.contention * frac)
        # Issue saturation is superlinear (latency-hiding collapse, Sec. 6);
        # cache and FPU bounds scale linearly with 1/f.
        t_issue = self.t_issue * scale**device.issue_superlinearity
        t_core = np.maximum(t_issue,
                            max(self.t_cache, self.t_compute) * scale)
        t_flat = np.maximum(t_mem_eff, self.t_coll)
        # Overlap blend: beta=1 -> roofline max (perfect latency hiding),
        # beta=0 -> fully serialised.
        beta = device.exec_overlap
        return beta * np.maximum(t_flat, t_core) + (1.0 - beta) * (t_flat + t_core)

    def regime_on(self, device: DeviceSpec) -> str:
        """Classify into the paper's (a)/(b)/(c) behaviours empirically:
        evaluate t(f) on the device's clock grid, as Fig. 6 does."""
        freqs = device.frequencies()
        t = self.time(freqs, device)
        if len(t) > 2 and t[2] > t[0] * 1.005:
            return "c"
        if t.min() < t[0] * 0.998:
            return "a"
        return "b"

    @property
    def knee_frac(self) -> float:
        """f/f_max below which a core-clocked resource becomes the bound."""
        if self.t_flat <= 0:
            return 1.0
        return min(self.t_core / self.t_flat, 1.0) if self.t_core > 0 else 0.0

    def regime(self, device: DeviceSpec | None = None) -> str:
        """The paper's (a)/(b)/(c) behaviour: on ``device``'s clock grid
        (what Fig. 6 plots), else from the structural bound."""
        if device is not None:
            return self.regime_on(device)
        if self.t_flat <= 0 or self.t_core / self.t_flat >= 0.97:
            return "c"
        if self.contention > 0.005:
            return "a"
        return "b"

    def _t0(self, device: DeviceSpec) -> float:
        """Execution time at f_max."""
        return float(self.time(np.array([device.f_max]), device)[0])

    def core_utilisation(self, device: DeviceSpec) -> float:
        """How busy the core-clocked resources are at f_max (feeds P(f)):
        the issue/cache duty cycle plus the stalled-but-resident share."""
        t0 = self._t0(device)
        if t0 <= 0:
            return 1.0
        duty = self.t_core / t0
        stall = device.stall_power_frac * (1.0 - duty)
        return float(np.clip(duty + stall, 0.05, 1.0))

    def mem_utilisation(self, device: DeviceSpec) -> float:
        t0 = self._t0(device)
        return float(np.clip(self.t_mem / t0, 0.0, 1.0)) if t0 > 0 else 0.0


def absolute_profile(
    name: str,
    *,
    device: DeviceSpec,
    hbm_bytes: float,
    flops: float,
    issue_efficiency: float = 1.0,
    cache_bytes: float = 0.0,
    collective_bytes: float = 0.0,
    contention: float = 0.0,
    mxu_flops: float | None = None,
    stages: float = 0.0,
    stage_bytes: float = 0.0,
    passes: float = 1.0,
    pass_bytes: float = 0.0,
) -> WorkloadProfile:
    """Build a profile from absolute traffic/flop counts.

    ``issue_efficiency`` maps raw FLOPs onto the effective issue-limited
    throughput: achieved_flops = issue_efficiency * peak_flops.  The FFT is
    far from peak FLOPs (a shuffle-heavy butterfly), so its ceiling is
    issue-limited (the paper's Fig. 20).  ``mxu_flops`` (default:
    ``flops``) is what occupies the FPU/matrix units.

    ``stages * stage_bytes`` adds to ``cache_bytes`` (butterfly stages x
    working-set bytes exchanged a stage, ``repro_torch.fft.radix.stage_count``)
    and ``passes * pass_bytes`` to ``hbm_bytes`` (the plan graph's HBM
    passes, ``repro_torch.fft.plan_nd``).
    """
    if mxu_flops is None:
        mxu_flops = flops
    cache_bytes = cache_bytes + stages * stage_bytes
    hbm_bytes = hbm_bytes + passes * pass_bytes
    t_issue = flops / (device.peak_flops * issue_efficiency) if flops else 0.0
    return WorkloadProfile(
        name=name,
        t_mem=hbm_bytes / device.hbm_bandwidth,
        t_issue=t_issue,
        t_cache=cache_bytes / device.cache_bandwidth,
        t_compute=mxu_flops / device.peak_flops,
        t_coll=(collective_bytes / device.link_bandwidth
                if device.link_bandwidth and collective_bytes else 0.0),
        contention=contention,
        flops=flops,
    )
