"""Analytic DVFS power model (numpy copy of ``repro.core.power_model``).

P(f) = P_static + u_core * P_dyn_max * (f/f_max) * (V(f)/V_max)^2
              + u_mem  * P_mem_max

``V(f)`` comes from :class:`repro_torch.core.hardware.DeviceSpec` and
carries the P-state voltage floor that produces the low-frequency power
plateau the paper observes in Fig. 8.  ``u_core``/``u_mem`` are workload
utilisation factors in [0, 1].
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hardware import DeviceSpec


@dataclasses.dataclass(frozen=True)
class PowerModel:
    device: DeviceSpec
    # Fraction of the (TDP - idle) dynamic envelope attributable to the
    # memory system when fully utilised; ``None`` defers to the device's
    # calibrated value.
    mem_power_frac: float | None = None

    @property
    def _mem_frac(self) -> float:
        if self.mem_power_frac is not None:
            return self.mem_power_frac
        return self.device.mem_power_frac

    @property
    def p_dyn_max(self) -> float:
        return (self.device.tdp - self.device.idle_power) * (1.0 - self._mem_frac)

    @property
    def p_mem_max(self) -> float:
        return (self.device.tdp - self.device.idle_power) * self._mem_frac

    def power(
        self,
        f: np.ndarray | float,
        *,
        u_core: float = 1.0,
        u_mem: float = 1.0,
    ) -> np.ndarray:
        """Board power [W] at core clock ``f`` MHz under the given utilisation."""
        d = self.device
        f = np.asarray(f, dtype=np.float64)
        v_rel = d.voltage(f) / d.v_max
        # Static/leakage power also scales with supply voltage (~V^2).
        p_static = d.idle_power * v_rel**2
        p_core = u_core * self.p_dyn_max * (f / d.f_max) * v_rel**2
        p_mem = u_mem * self.p_mem_max
        return p_static + p_core + p_mem
