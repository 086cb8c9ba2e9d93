"""Board energy, power limit and SM clock of one card, through NVML.

A frozen copy of the calls the benchmark needs from
``repro_torch.power.nvml`` (ctypes over ``libnvidia-ml.so.1``), so that a
change to the program cannot move the yardstick.  :class:`Meter` samples
the energy counter and the SM clock on a host thread, and
:meth:`Meter.reading` takes the window's mean power from the counter's
rise between its first and last step inside the window (the counter steps
about every 100 ms, and the power reading NVML gives is itself a lagging
average), as ``chip_smoke.py`` phase 9 does.  The library is loaded on
first use, never at import.
"""
from __future__ import annotations

import ctypes
import statistics
import threading
import time

LIBRARY = "libnvidia-ml.so.1"
NVML_SUCCESS = 0
NVML_CLOCK_SM = 1
#: Sampling period of the meter's thread [s] (the paper's Fig. 19: 10 ms).
PERIOD_S = 0.01

_UINT_P = ctypes.POINTER(ctypes.c_uint)
_SIGNATURES = {
    "nvmlInit_v2": ((), ctypes.c_int),
    "nvmlErrorString": ((ctypes.c_int,), ctypes.c_char_p),
    "nvmlDeviceGetHandleByUUID": (
        (ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)), ctypes.c_int),
    "nvmlDeviceGetTotalEnergyConsumption": (
        (ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)), ctypes.c_int),
    "nvmlDeviceGetClockInfo": ((ctypes.c_void_p, ctypes.c_int, _UINT_P),
                               ctypes.c_int),
    "nvmlDeviceGetPowerManagementLimit": ((ctypes.c_void_p, _UINT_P),
                                          ctypes.c_int),
}


class NvmlError(RuntimeError):
    pass


class Nvml:
    """One card's NVML handle with the entry points the meter calls."""

    def __init__(self, uuid: str):
        self.lib = ctypes.CDLL(LIBRARY)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        self._call("nvmlInit_v2")
        self.handle = ctypes.c_void_p()
        uuid = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"
        self._call("nvmlDeviceGetHandleByUUID", uuid.encode(),
                   ctypes.pointer(self.handle))

    def _call(self, name: str, *args) -> None:
        code = getattr(self.lib, name)(*args)
        if code != NVML_SUCCESS:
            msg = self.lib.nvmlErrorString(code)
            raise NvmlError(f"{name}: NVML error {code} "
                            f"({msg.decode() if isinstance(msg, bytes) else msg})")

    def energy_mj(self) -> int:
        """The board's energy counter [mJ since NVIDIA's kernel module loaded]."""
        out = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self.handle,
                   ctypes.pointer(out))
        return out.value

    def sm_mhz(self) -> int:
        out = ctypes.c_uint()
        self._call("nvmlDeviceGetClockInfo", self.handle, NVML_CLOCK_SM,
                   ctypes.pointer(out))
        return out.value

    def power_limit_w(self) -> float:
        out = ctypes.c_uint()
        self._call("nvmlDeviceGetPowerManagementLimit", self.handle,
                   ctypes.pointer(out))
        return out.value / 1000.0


def device_nvml(index: int = 0) -> Nvml:
    """NVML of CUDA device ``index``, found by its UUID (NVML's own index
    need not be CUDA's)."""
    import torch
    return Nvml(str(torch.cuda.get_device_properties(index).uuid))


class Meter:
    """Energy counter and SM clock sampled every ``period_s`` on a host
    thread between :meth:`start` and :meth:`stop`.  ``source`` is anything
    with ``energy_mj()``, ``sm_mhz()`` and ``power_limit_w()``."""

    def __init__(self, source, period_s: float = PERIOD_S):
        self.source = source
        self.period_s = period_s
        self.samples: list[tuple[float, int, int]] = []   # (t, mJ, MHz)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self) -> None:
        next_t = time.perf_counter()
        while not self._stop.is_set():
            self.samples.append((time.perf_counter(),
                                 self.source.energy_mj(),
                                 self.source.sm_mhz()))
            next_t += self.period_s
            self._stop.wait(max(next_t - time.perf_counter(), 0.0))

    def start(self) -> "Meter":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                raise RuntimeError("the NVML meter's thread did not stop")

    def reading(self, t0: float, t1: float) -> dict:
        """Joules, mean watts and median SM clock over the window [t0, t1].

        The mean power is the counter's rise between its first and last
        step inside the window over the time between them (each step's
        time known to one sampling period); the joules are that power
        times the window's length."""
        ticks = [(t, e) for (t, e, _), (_, prev, _) in
                 zip(self.samples[1:], self.samples[:-1])
                 if t0 <= t <= t1 and e != prev]
        if len(ticks) < 2:
            raise RuntimeError(f"the energy counter stepped {len(ticks)} "
                               f"times in the {t1 - t0:.3f} s window")
        (ta, ea), (tb, eb) = ticks[0], ticks[-1]
        watts = (eb - ea) / 1e3 / (tb - ta)
        clocks = [mhz for t, _, mhz in self.samples if t0 <= t <= t1]
        return {"joules": watts * (t1 - t0), "watts": watts,
                "sm_mhz": statistics.median(clocks),
                "power_limit_w": self.source.power_limit_w(),
                "counter_steps": len(ticks)}
