"""``repro_torch.power.nvml`` driven with a stand-in NVML library.

The module's logic (declared argument types, units, error mapping, the
reset of a clock lock on every way out) runs here against a fake that
records each call.  The last test reads the real energy counter on a card
and skips without one."""
import atexit
import ctypes
import math
import time

import pytest
import torch

from repro_torch.power import PowerSampler, nvml

HANDLE = 0x5EED

#: The prototypes of ``nvml.h`` for every entry point the module calls.
PROTOTYPES = {
    "nvmlInit_v2": "nvmlReturn_t (void)",
    "nvmlErrorString": "const char * (nvmlReturn_t result)",
    "nvmlDeviceGetHandleByUUID":
        "nvmlReturn_t (const char * uuid, nvmlDevice_t * device)",
    "nvmlDeviceGetPowerUsage":
        "nvmlReturn_t (nvmlDevice_t device, unsigned int * power)",
    "nvmlDeviceGetTotalEnergyConsumption":
        "nvmlReturn_t (nvmlDevice_t device, unsigned long long * energy)",
    "nvmlDeviceGetSupportedMemoryClocks":
        "nvmlReturn_t (nvmlDevice_t device, unsigned int * count, "
        "unsigned int * clocksMHz)",
    "nvmlDeviceGetSupportedGraphicsClocks":
        "nvmlReturn_t (nvmlDevice_t device, unsigned int memoryClockMHz, "
        "unsigned int * count, unsigned int * clocksMHz)",
    "nvmlDeviceGetClockInfo":
        "nvmlReturn_t (nvmlDevice_t device, nvmlClockType_t type, "
        "unsigned int * clock)",
    "nvmlDeviceGetDefaultApplicationsClock":
        "nvmlReturn_t (nvmlDevice_t device, nvmlClockType_t clockType, "
        "unsigned int * clockMHz)",
    "nvmlDeviceSetGpuLockedClocks":
        "nvmlReturn_t (nvmlDevice_t device, unsigned int minGpuClockMHz, "
        "unsigned int maxGpuClockMHz)",
    "nvmlDeviceResetGpuLockedClocks": "nvmlReturn_t (nvmlDevice_t device)",
}
C_TYPES = {
    "nvmlReturn_t": ctypes.c_int, "nvmlClockType_t": ctypes.c_int,
    "nvmlDevice_t": ctypes.c_void_p,
    "nvmlDevice_t *": ctypes.POINTER(ctypes.c_void_p),
    "unsigned int": ctypes.c_uint,
    "unsigned int *": ctypes.POINTER(ctypes.c_uint),
    "unsigned long long *": ctypes.POINTER(ctypes.c_ulonglong),
    "const char *": ctypes.c_char_p,
}


def _parse(proto):
    result, params = proto.split(" (")
    params = params.rstrip(")")
    args = [] if params == "void" else [
        " ".join(p.split()[:-1]) for p in params.split(", ")]
    return [C_TYPES[a] for a in args], C_TYPES[result]


class Fn:
    """One fake entry point: records its calls, answers with ``body``."""

    def __init__(self, body):
        self.body = body
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.body(*args)


class FakeNvml:
    """A stand-in for libnvidia-ml.so.1."""

    def __init__(self):
        self.power_mw = 250125
        self.power_rc = 0
        self.energy = 10_000
        self.lock_rc = 0
        self.reset_rc = 0
        self.sm = 1410
        self.grid = {2619: [1980, 1965, 1950], 1593: [1980, 1965]}
        self.locked = None
        self.uuids = []

        def handle(uuid, out):
            self.uuids.append(uuid)
            out.contents.value = HANDLE
            return 0

        def power(h, out):
            assert h.value == HANDLE
            if self.power_rc:
                return self.power_rc
            out.contents.value = self.power_mw
            return 0

        def energy(h, out):
            self.energy += 7
            out.contents.value = self.energy
            return 0

        def mem_clocks(h, count, clocks):
            for i, m in enumerate(sorted(self.grid)):
                clocks[i] = m
            count.contents.value = len(self.grid)
            return 0

        def graphics_clocks(h, mem, count, clocks):
            for i, g in enumerate(self.grid[mem]):
                clocks[i] = g
            count.contents.value = len(self.grid[mem])
            return 0

        def clock_info(h, kind, out):
            out.contents.value = {nvml.NVML_CLOCK_SM: self.sm}[kind]
            return 0

        def default_clock(h, kind, out):
            assert kind == nvml.NVML_CLOCK_GRAPHICS
            out.contents.value = 1980
            return 0

        def lock(h, lo, hi):
            if self.lock_rc:
                return self.lock_rc
            self.locked = (lo, hi)
            return 0

        def reset(h):
            if self.reset_rc:
                return self.reset_rc
            self.locked = None
            return 0

        self.nvmlInit_v2 = Fn(lambda: 0)
        self.nvmlErrorString = Fn(lambda code: f"fake error {code}".encode())
        self.nvmlDeviceGetHandleByUUID = Fn(handle)
        self.nvmlDeviceGetPowerUsage = Fn(power)
        self.nvmlDeviceGetTotalEnergyConsumption = Fn(energy)
        self.nvmlDeviceGetSupportedMemoryClocks = Fn(mem_clocks)
        self.nvmlDeviceGetSupportedGraphicsClocks = Fn(graphics_clocks)
        self.nvmlDeviceGetClockInfo = Fn(clock_info)
        self.nvmlDeviceGetDefaultApplicationsClock = Fn(default_clock)
        self.nvmlDeviceSetGpuLockedClocks = Fn(lock)
        self.nvmlDeviceResetGpuLockedClocks = Fn(reset)


@pytest.fixture
def fake():
    lib = FakeNvml()
    nvml.use_library(lib)
    yield lib
    nvml.use_library(None)


@pytest.fixture
def handle(fake):
    return nvml.handle_by_uuid("GPU-f4db4a58")


def test_declared_argument_types_match_nvml_h(fake):
    assert set(nvml.SIGNATURES) == set(PROTOTYPES)
    for name, proto in PROTOTYPES.items():
        argtypes, restype = _parse(proto)
        fn = getattr(fake, name)
        assert fn.argtypes == argtypes, name
        assert fn.restype == restype, name
    assert fake.nvmlInit_v2.calls == [()]


def test_library_loads_on_first_use(monkeypatch):
    nvml.use_library(None)
    loaded = []

    def cdll(name):
        loaded.append(name)
        return FakeNvml()

    monkeypatch.setattr(ctypes, "CDLL", cdll)
    try:
        assert loaded == []
        first = nvml.nvml()
        assert loaded == [nvml.LIBRARY] and nvml.nvml() is first
    finally:
        nvml.use_library(None)


def test_failed_init_raises(monkeypatch):
    lib = FakeNvml()
    lib.nvmlInit_v2 = Fn(lambda: 9)
    with pytest.raises(nvml.NvmlError, match="fake error 9"):
        nvml.use_library(lib)
    nvml.use_library(None)


def test_handle_by_uuid(fake, monkeypatch):
    h = nvml.handle_by_uuid("GPU-abc")
    assert fake.uuids == [b"GPU-abc"] and h.value == HANDLE

    class Props:
        uuid = "f4db4a58-f57f-3c5c-72d7-4dd68c84f3a6"

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    assert nvml.device_handle(0).value == HANDLE
    assert fake.uuids[-1] == b"GPU-f4db4a58-f57f-3c5c-72d7-4dd68c84f3a6"


def test_power_is_read_in_milliwatts(fake, handle):
    sampler = nvml.NvmlPowerSampler({3: handle})
    assert isinstance(sampler, PowerSampler)
    r = sampler.sample(3, 12.5, token=7)
    assert (r.device_index, r.t, r.power_w) == (3, 12.5, 250.125)
    assert nvml.power_w(handle) == 250.125


@pytest.mark.parametrize("rc", (1, 2, 3, 4, 15, 999))
def test_failed_power_read_is_nan(fake, handle, rc):
    fake.power_rc = rc
    r = nvml.NvmlPowerSampler({0: handle}).sample(0, 1.0)
    assert math.isnan(r.power_w) and not r.ok
    with pytest.raises(nvml.NvmlError, match=f"fake error {rc}"):
        nvml.power_w(handle)


def test_counter_clocks_and_grid(fake, handle):
    e0 = nvml.energy_mj(handle)
    assert nvml.energy_mj(handle) == e0 + 7
    assert nvml.sm_clock(handle) == 1410
    assert nvml.default_clock(handle) == 1980
    assert nvml.supported_clocks(handle) == {2619: [1980, 1965, 1950],
                                             1593: [1980, 1965]}
    count = fake.nvmlDeviceGetSupportedMemoryClocks.calls[0][1]
    assert count.contents.value == 2          # NVML wrote back the count


@pytest.mark.parametrize("rc", nvml.LOCK_DENIED)
def test_denied_lock_raises_clock_lock_denied(fake, handle, rc, monkeypatch):
    registered = []
    monkeypatch.setattr(atexit, "register", registered.append)
    fake.lock_rc = rc
    locker = nvml.NvmlClockLocker(handle)
    body = []
    with pytest.raises(nvml.ClockLockDenied) as err:
        with locker.locked(1500):
            body.append(1)
    assert err.value.code == rc and f"fake error {rc}" in str(err.value)
    assert body == [] and registered == []
    assert fake.nvmlDeviceResetGpuLockedClocks.calls == []


@pytest.mark.parametrize("rc", (1, 2, 6, 15, 999))
def test_other_lock_errors_raise_runtime_error(fake, handle, rc):
    fake.lock_rc = rc
    with pytest.raises(RuntimeError) as err:
        with nvml.NvmlClockLocker(handle).locked(1500):
            pass
    assert not isinstance(err.value, nvml.ClockLockDenied)
    assert f"fake error {rc}" in str(err.value)


def test_lock_resets_after_the_body(fake, handle, monkeypatch):
    registered, unregistered = [], []
    monkeypatch.setattr(atexit, "register", registered.append)
    monkeypatch.setattr(atexit, "unregister", unregistered.append)
    locker = nvml.NvmlClockLocker(handle)
    with locker.locked(1234.6) as f:
        assert f == 1235 and fake.locked == (1235, 1235)
        assert registered == [locker.reset] and unregistered == []
    assert fake.locked is None and unregistered == [locker.reset]
    assert len(fake.nvmlDeviceSetGpuLockedClocks.calls) == 1
    assert len(fake.nvmlDeviceResetGpuLockedClocks.calls) == 1


def test_reset_runs_when_the_body_raises(fake, handle, monkeypatch):
    registered, unregistered = [], []
    monkeypatch.setattr(atexit, "register", registered.append)
    monkeypatch.setattr(atexit, "unregister", unregistered.append)
    locker = nvml.NvmlClockLocker(handle)
    with pytest.raises(ValueError, match="body failed"):
        with locker.locked(1500):
            raise ValueError("body failed")
    assert fake.locked is None
    assert len(fake.nvmlDeviceResetGpuLockedClocks.calls) == 1
    assert unregistered == registered == [locker.reset]


def test_atexit_covers_a_crash_inside_the_lock(fake, handle, monkeypatch):
    registered = []
    monkeypatch.setattr(atexit, "register", registered.append)
    monkeypatch.setattr(atexit, "unregister", lambda fn: None)
    locker = nvml.NvmlClockLocker(handle)
    ctx = locker.locked(1500)
    ctx.__enter__()                           # the process dies in here
    assert fake.locked == (1500, 1500)
    for fn in registered:                     # what the interpreter runs
        fn()
    assert fake.locked is None


def test_failed_reset_raises(fake, handle):
    fake.reset_rc = 2
    with pytest.raises(nvml.NvmlError, match="ResetGpuLockedClocks"):
        with nvml.NvmlClockLocker(handle).locked(1500):
            pass


def test_power_trace_samples_on_a_thread(fake, handle):
    with nvml.PowerTrace(handle, period_s=0.002) as trace:
        time.sleep(0.05)
    n = len(trace.t)
    assert n >= 3 and trace.failed_reads == 0
    assert len(trace.power_w) == len(trace.sm_mhz) == len(trace.energy_mj) == n
    assert set(trace.power_w) == {250.125} and set(trace.sm_mhz) == {1410}
    assert trace.t == sorted(trace.t)
    assert len(trace.ticks(trace.t[0], trace.t[-1])) == n - 1
    fake.power_rc = 15
    with nvml.PowerTrace(handle, period_s=0.002) as bad:
        time.sleep(0.02)
    assert bad.failed_reads == len(bad.t) > 0


def test_power_trace_window_and_ticks(fake, handle):
    trace = nvml.PowerTrace(handle)
    trace.t = [0.0, 1.0, 2.0, 3.0, 4.0]
    trace.power_w = [10.0, 20.0, 30.0, 40.0, 50.0]
    trace.sm_mhz = [1, 2, 3, 4, 5]
    trace.energy_mj = [100, 100, 160, 160, 250]
    power, dts, sm = trace.window(1.5, 3.5)
    # Samples at 1, 2, 3 cover [1.5, 3.5]: 0.5 s, 1 s and 0.5 s of it.
    assert (power, dts, sm) == ([20.0, 30.0, 40.0], [0.5, 1.0, 0.5],
                                [2, 3, 4])
    assert trace.ticks(0.0, 4.0) == [(2.0, 160), (4.0, 250)]
    assert trace.ticks(2.5, 4.0) == [(4.0, 250)]
    trace.energy_mj[3] = None
    assert trace.failed_reads == 1
    assert trace.ticks(0.0, 4.0) == [(2.0, 160)]


@pytest.mark.cuda
def test_energy_counter_rises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and its driver's NVML")
    nvml.use_library(None)
    h = nvml.device_handle(torch.cuda.current_device())
    e0 = nvml.energy_mj(h)
    x = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        x = x @ x
        x /= x.abs().max()
    torch.cuda.synchronize()
    time.sleep(0.2)
    assert nvml.energy_mj(h) > e0
    assert not math.isnan(nvml.NvmlPowerSampler({0: h}).sample(0, 0.0).power_w)
    grid = nvml.supported_clocks(h)
    assert grid and all(g == sorted(g, reverse=True) for g in grid.values())
    try:                                      # denied without privileges
        with nvml.NvmlClockLocker(h).locked(grid[max(grid)][0]):
            pass
    except nvml.ClockLockDenied as e:
        assert e.code in nvml.LOCK_DENIED
