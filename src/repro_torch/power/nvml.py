"""The card's end of the power plane's two hardware hooks, through NVML.

The reference names two hooks it cannot implement on its own hardware:
the board-power sampler (``repro.power.sampler``'s :class:`PowerSampler`
contract) and the clock lock around a dispatch (the paper's Sec. 5.3
``nvmlDeviceSetGpuLockedClocks`` / ``nvmlDeviceResetGpuLockedClocks``
bracket, modelled by ``core.scheduler.ClockController``).  This module
implements both on an NVIDIA card with ctypes over ``libnvidia-ml.so.1``,
which ships with the driver:

  * :class:`NvmlPowerSampler` — board power (``nvmlDeviceGetPowerUsage``,
    mW); a failed read is reported as NaN, never raised;
  * :class:`NvmlEnergySampler` — the mean power of a window the caller
    opens (a batch), from the energy counter: no lag behind the window;
  * :func:`energy_mj` — the board's energy counter
    (``nvmlDeviceGetTotalEnergyConsumption``, mJ since the driver loaded),
    the primary energy reading: the power reading may be a windowed
    average;
  * :func:`supported_clocks`, :func:`default_clock`, :func:`sm_clock` —
    the supported clock grid, the default application clock and the SM
    clock now;
  * :class:`NvmlClockLocker` — ``with locker.locked(f):`` locks the
    graphics clock to ``f`` and resets it in ``finally``, with the reset
    also registered with ``atexit`` while the lock is held.  A lock the
    driver refuses (no permission, not supported) raises
    :class:`ClockLockDenied`; any other NVML error raises
    :class:`NvmlError` (a ``RuntimeError``) with ``nvmlErrorString``;
  * :class:`PowerTrace` — board power and SM clock sampled on a host
    thread at a fixed period (the paper's Fig. 19 view, 10 ms).

The library is loaded on first use, never at import; :func:`use_library`
injects a stand-in (the tests drive the logic with a fake).  Devices are
found by UUID, because NVML's index is not the CUDA index under
``CUDA_VISIBLE_DEVICES``.
"""
from __future__ import annotations

import atexit
import contextlib
import ctypes
import math
import threading
import time

from repro_torch.power.sampler import PowerReading, PowerSampler

LIBRARY = "libnvidia-ml.so.1"

NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3
NVML_ERROR_NO_PERMISSION = 4
#: The errors that mean the driver will not lock clocks for this caller.
LOCK_DENIED = (NVML_ERROR_NOT_SUPPORTED, NVML_ERROR_NO_PERMISSION)

# nvmlClockType_t
NVML_CLOCK_GRAPHICS = 0
NVML_CLOCK_SM = 1
NVML_CLOCK_MEM = 2

#: Room for one supported-clocks query (an H100 lists about a hundred).
MAX_CLOCKS = 512

Handle = ctypes.c_void_p
_UINT_P = ctypes.POINTER(ctypes.c_uint)

#: Every NVML entry point the module calls: (argument types, result type),
#: as ``nvml.h`` declares them (``nvmlDevice_t`` is an opaque pointer,
#: ``nvmlClockType_t`` an enum, every result an ``nvmlReturn_t``).
SIGNATURES: dict[str, tuple[tuple, type]] = {
    "nvmlInit_v2": ((), ctypes.c_int),
    "nvmlErrorString": ((ctypes.c_int,), ctypes.c_char_p),
    "nvmlDeviceGetHandleByUUID": (
        (ctypes.c_char_p, ctypes.POINTER(Handle)), ctypes.c_int),
    "nvmlDeviceGetPowerUsage": ((Handle, _UINT_P), ctypes.c_int),
    "nvmlDeviceGetTotalEnergyConsumption": (
        (Handle, ctypes.POINTER(ctypes.c_ulonglong)), ctypes.c_int),
    "nvmlDeviceGetSupportedMemoryClocks": (
        (Handle, _UINT_P, _UINT_P), ctypes.c_int),
    "nvmlDeviceGetSupportedGraphicsClocks": (
        (Handle, ctypes.c_uint, _UINT_P, _UINT_P), ctypes.c_int),
    "nvmlDeviceGetClockInfo": ((Handle, ctypes.c_int, _UINT_P), ctypes.c_int),
    "nvmlDeviceGetDefaultApplicationsClock": (
        (Handle, ctypes.c_int, _UINT_P), ctypes.c_int),
    "nvmlDeviceSetGpuLockedClocks": (
        (Handle, ctypes.c_uint, ctypes.c_uint), ctypes.c_int),
    "nvmlDeviceResetGpuLockedClocks": ((Handle,), ctypes.c_int),
}


class NvmlError(RuntimeError):
    """An NVML call failed; ``code`` is its ``nvmlReturn_t``."""

    def __init__(self, call: str, code: int, message: str):
        super().__init__(f"{call}: NVML error {code} ({message})")
        self.call = call
        self.code = code
        self.message = message


class ClockLockDenied(NvmlError):
    """The driver refused to lock clocks: no permission or not supported."""


class Nvml:
    """A loaded NVML library with its entry points declared and initialised."""

    def __init__(self, lib):
        self.lib = lib
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        self.call("nvmlInit_v2")

    def error_string(self, code: int) -> str:
        msg = self.lib.nvmlErrorString(code)
        return msg.decode() if isinstance(msg, bytes) else str(msg)

    def call(self, name: str, *args) -> None:
        """Call ``name``; raise :class:`NvmlError` unless it succeeds."""
        code = getattr(self.lib, name)(*args)
        if code != NVML_SUCCESS:
            raise NvmlError(name, code, self.error_string(code))

    def read_uint(self, name: str, handle, *args) -> int:
        """Call ``name(handle, *args, &out)`` and return ``out``."""
        out = ctypes.c_uint()
        self.call(name, handle, *args, ctypes.pointer(out))
        return out.value


_nvml: Nvml | None = None
_nvml_lock = threading.Lock()


def use_library(lib) -> Nvml | None:
    """Use ``lib`` (a loaded library or a stand-in) from now on; ``None``
    forgets the current one, so the next use loads :data:`LIBRARY`."""
    global _nvml
    with _nvml_lock:
        _nvml = None if lib is None else Nvml(lib)
        return _nvml


def nvml() -> Nvml:
    """The library in use, loaded and initialised on first use."""
    global _nvml
    with _nvml_lock:
        if _nvml is None:
            _nvml = Nvml(ctypes.CDLL(LIBRARY))
        return _nvml


def handle_by_uuid(uuid: str) -> Handle:
    """The NVML handle of the card whose UUID is ``uuid`` ("GPU-...")."""
    handle = Handle()
    nvml().call("nvmlDeviceGetHandleByUUID", uuid.encode(),
                ctypes.pointer(handle))
    return handle


def device_handle(index: int = 0) -> Handle:
    """The NVML handle of CUDA device ``index`` (found by its UUID)."""
    import torch
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    return handle_by_uuid(uuid if uuid.startswith("GPU-") else f"GPU-{uuid}")


def power_w(handle: Handle) -> float:
    """Board power now [W] (raises :class:`NvmlError` on a failed read)."""
    return nvml().read_uint("nvmlDeviceGetPowerUsage", handle) / 1000.0


def energy_mj(handle: Handle) -> int:
    """The board's energy counter [mJ since the driver loaded]."""
    out = ctypes.c_ulonglong()
    nvml().call("nvmlDeviceGetTotalEnergyConsumption", handle,
                ctypes.pointer(out))
    return out.value


def sm_clock(handle: Handle) -> int:
    """The SM clock now [MHz]."""
    return nvml().read_uint("nvmlDeviceGetClockInfo", handle, NVML_CLOCK_SM)


def default_clock(handle: Handle) -> int:
    """The default application graphics clock [MHz]."""
    return nvml().read_uint("nvmlDeviceGetDefaultApplicationsClock", handle,
                            NVML_CLOCK_GRAPHICS)


def _clock_list(name: str, handle: Handle, *args) -> list[int]:
    count = ctypes.c_uint(MAX_CLOCKS)
    clocks = (ctypes.c_uint * MAX_CLOCKS)()
    nvml().call(name, handle, *args, ctypes.pointer(count),
                ctypes.cast(clocks, _UINT_P))
    return sorted((clocks[i] for i in range(count.value)), reverse=True)


def supported_clocks(handle: Handle) -> dict[int, list[int]]:
    """Each supported memory clock [MHz] with its supported graphics
    clocks, all in descending order."""
    return {mem: _clock_list("nvmlDeviceGetSupportedGraphicsClocks", handle,
                             mem)
            for mem in _clock_list("nvmlDeviceGetSupportedMemoryClocks",
                                   handle)}


class NvmlPowerSampler(PowerSampler):
    """Board power of real cards, one NVML read a sample.

    ``handles`` maps each device index the caller samples to its NVML
    handle.  Per the :class:`PowerSampler` contract a failed read is a
    NaN reading, not an exception.
    """

    def __init__(self, handles: dict[int, Handle]):
        self.handles = dict(handles)

    def sample(self, device_index: int, now: float, *,
               token: int | None = None) -> PowerReading:
        try:
            p = power_w(self.handles[device_index])
        except NvmlError:
            p = float("nan")
        return PowerReading(device_index, now, p)


class NvmlEnergySampler(PowerSampler):
    """Mean board power over a window, from the energy counter.

    :meth:`mark` opens a window on a device index (at a batch's start);
    :meth:`sample` closes it and reports the counter's rise over the
    ``clock`` time between the ends [W]: the energy the card drew in that
    interval, where the board power read is NVML's own windowed average,
    read late.  The counter moves in steps, so each end waits for its
    next step (at most ``tick_timeout_s``): the window is the batch and
    at most one step on each side.  ``last[i]`` keeps the closed window's
    (seconds, joules).  A failed read, a counter that did not step in
    time, or a sample with no open window is NaN.
    """

    def __init__(self, handles: dict[int, Handle], *,
                 clock=time.perf_counter, tick_timeout_s: float = 1.0):
        self.handles = dict(handles)
        self._clock = clock
        self.tick_timeout_s = tick_timeout_s
        self._open: dict[int, tuple[float, int]] = {}
        self.last: dict[int, tuple[float, float]] = {}

    def _tick(self, device_index: int) -> tuple[float, int] | None:
        """The clock and counter at the counter's next step."""
        handle = self.handles[device_index]
        try:
            e0 = energy_mj(handle)
            t0 = self._clock()
            while True:
                e, t = energy_mj(handle), self._clock()
                if e != e0:
                    return t, e
                if t - t0 > self.tick_timeout_s:
                    return None
        except NvmlError:
            return None

    def mark(self, device_index: int) -> None:
        start = self._tick(device_index)
        if start is None:
            self._open.pop(device_index, None)
        else:
            self._open[device_index] = start

    def sample(self, device_index: int, now: float, *,
               token: int | None = None) -> PowerReading:
        p = float("nan")
        start = self._open.pop(device_index, None)
        end = self._tick(device_index) if start is not None else None
        if end is not None and end[0] > start[0]:
            dt, joules = end[0] - start[0], (end[1] - start[1]) / 1e3
            self.last[device_index] = (dt, joules)
            p = joules / dt
        return PowerReading(device_index, now, p)


class NvmlClockLocker:
    """The clock lock around a dispatch, on the card.

    ``with locker.locked(f):`` has the shape of
    ``core.scheduler.ClockController.locked``: it locks the graphics clock
    to ``f`` MHz (``nvmlDeviceSetGpuLockedClocks(h, f, f)``) and resets it
    (``nvmlDeviceResetGpuLockedClocks``) in ``finally``.  While the lock
    is held the reset is also registered with ``atexit``, so a process
    that dies of an exception never leaves the card locked.
    """

    def __init__(self, handle: Handle):
        self.handle = handle

    def reset(self) -> None:
        """Give the clocks back to the driver."""
        nvml().call("nvmlDeviceResetGpuLockedClocks", self.handle)

    @contextlib.contextmanager
    def locked(self, f_mhz: float):
        f = int(round(f_mhz))
        try:
            nvml().call("nvmlDeviceSetGpuLockedClocks", self.handle, f, f)
        except NvmlError as e:
            if e.code in LOCK_DENIED:
                raise ClockLockDenied(e.call, e.code, e.message) from None
            raise
        atexit.register(self.reset)
        try:
            yield f
        finally:
            atexit.unregister(self.reset)
            self.reset()


class PowerTrace:
    """Board power, SM clock and the energy counter of one card, sampled on
    a host thread every ``period_s`` between :meth:`start` and :meth:`stop`
    (or as a context manager).  ``t`` holds ``time.perf_counter()`` stamps;
    a failed read is NaN (power), 0 (clock) or None (counter)."""

    def __init__(self, handle: Handle, period_s: float = 0.01):
        self.handle = handle
        self.period_s = period_s
        self.t: list[float] = []
        self.power_w: list[float] = []
        self.sm_mhz: list[int] = []
        self.energy_mj: list[int | None] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self) -> None:
        sampler = NvmlPowerSampler({0: self.handle})
        next_t = time.perf_counter()
        while not self._stop.is_set():
            now = time.perf_counter()
            self.power_w.append(sampler.sample(0, now).power_w)
            try:
                self.sm_mhz.append(sm_clock(self.handle))
            except NvmlError:
                self.sm_mhz.append(0)
            try:
                self.energy_mj.append(energy_mj(self.handle))
            except NvmlError:
                self.energy_mj.append(None)
            self.t.append(now)
            next_t += self.period_s
            self._stop.wait(max(next_t - time.perf_counter(), 0.0))

    def start(self) -> "PowerTrace":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> "PowerTrace":
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        return self

    def __enter__(self) -> "PowerTrace":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def window(self, t0: float, t1: float) -> tuple[list[float], list[float],
                                                    list[int]]:
        """(power, seconds held, SM clock) of the samples that cover
        [t0, t1]: each sample holds until the next one, clipped to the
        window, the sample taken last before ``t0`` included."""
        first = max((i for i, t in enumerate(self.t) if t <= t0), default=0)
        keep = [i for i in range(first, len(self.t)) if self.t[i] <= t1]
        ends = [min(self.t[i + 1], t1) if i + 1 < len(self.t) else t1
                for i in keep]
        dts = [max(end - max(self.t[i], t0), 0.0)
               for i, end in zip(keep, ends)]
        return ([self.power_w[i] for i in keep], dts,
                [self.sm_mhz[i] for i in keep])

    def ticks(self, t0: float, t1: float) -> list[tuple[float, int]]:
        """(time, mJ) of each sample in [t0, t1] that saw the energy
        counter move: the counter updates in steps, and a step's time is
        known to within one sampling period."""
        out = []
        for i in range(1, len(self.t)):
            e, prev = self.energy_mj[i], self.energy_mj[i - 1]
            if (t0 <= self.t[i] <= t1 and e is not None and prev is not None
                    and e != prev):
                out.append((self.t[i], e))
        return out

    @property
    def failed_reads(self) -> int:
        """Samples with a failed power or counter read."""
        return sum(math.isnan(p) or e is None
                   for p, e in zip(self.power_w, self.energy_mj))
