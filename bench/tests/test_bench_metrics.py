"""The metric arithmetic on synthetic event lists and readings."""
from __future__ import annotations

import pytest

from bench.harness import BENCH, load_file_module
from bench.record import Run, Unit, Window
from bench.yardstick import roofline, trace
from bench.yardstick.nvml import Meter


def reader(name: str):
    return load_file_module(BENCH / "metrics" / f"{name}.py",
                            f"test_metric_{name}")


def test_union_merges_overlaps_and_keeps_gaps():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7), (4.0, 5.0)]
    assert trace.union(ivs) == [(0.0, 2.0), (3.0, 5.0)]
    assert trace.union_seconds(ivs) == pytest.approx(4.0)
    # a sum would count the overlaps twice
    assert sum(b - a for a, b in ivs) > trace.union_seconds(ivs)


def _events():
    """A spin, two overlapping kernels, a gap covered by a host sync, and
    one kernel before the spin ended (left out)."""
    return [("spin_kernel", True, 0.00, 0.05),
            ("void dedisperse_kernel(float const*)", True, 0.04, 0.049),
            ("void dedisperse_kernel(float const*)", True, 0.05, 0.062),
            ("void at::native::reduce_kernel<512, 1>(...)", True, 0.055, 0.07),
            ("Memcpy DtoD (Device -> Device)", True, 0.09, 0.10),
            ("cudaStreamSynchronize", False, 0.069, 0.085),
            ("aten::topk", False, 0.06, 0.095)]


def test_trace_window_busy_idle_and_labels():
    t = trace.from_events(_events(), units=[])
    assert (t.t0, t.t1) == (0.05, 0.10)
    assert len(t.device) == 3                    # the early kernel is out
    assert t.busy_s == pytest.approx(0.03)       # union of 0.05-0.07, 0.09-0.10
    assert t.window_s == pytest.approx(0.05)
    assert t.idle_gaps() == [(0.07, 0.09)]
    assert t.host_during([(0.07, 0.09)]) == ["cudaStreamSynchronize"]
    b = t.breakdown()
    assert b["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(0.02)]]
    assert [op for op, _ in b["device_ops"]] == [
        "at::native::reduce_kernel<512, 1>", "dedisperse_kernel",
        "Memcpy DtoD "]


def test_port_kernel_classifier():
    assert trace.port_kernel(
        "void fft_c2c_regs_kernel<8, 2>(float2 const*, float2*)") == \
        "fft_c2c_regs_kernel"
    assert trace.port_kernel("void fft_c2c_t_regs_kernel<4, 1>(...)") == \
        "fft_c2c_t_regs_kernel"
    assert trace.port_kernel("void harmonic_sum_plane_kernel<2>(...)") == \
        "harmonic_sum_plane_kernel"
    # the csrc kernels live in their file's anonymous namespace
    name = "void (anonymous namespace)::dedisperse_kernel(float const*, int)"
    assert trace.port_kernel(name) == "dedisperse_kernel"
    assert trace.short_name(name) == "{anon}::dedisperse_kernel"
    # a kernel a later change adds to csrc, by the csrc naming rule
    assert trace.port_kernel("void fused_split_kernel<4>(float2*)") == \
        "fused_split_kernel"
    assert trace.port_kernel(
        "void (anonymous namespace)::fused_split_kernel<4>(float2*)") == \
        "fused_split_kernel"
    for name in ("void at::native::vectorized_elementwise_kernel<4>(...)",
                 "void at::native::(anonymous namespace)::reduce_kernel<1>()",
                 "Memcpy DtoD (Device -> Device)", "Memset (Device)",
                 "void cub::DeviceRadixSortOnesweepKernel<...>(...)"):
        assert trace.port_kernel(name) is None, name


def _run(units, tr=None, energy=None, cfg=None, t0=0.0, t1=10.0):
    return Run(setup_s=12.5, window=Window(t0, t1, units, {}, tr),
               energy=energy, cfg=cfg or {}, traffic={})


class FakeNvml:
    def __init__(self):
        self.e, self.mhz = 0, 1500

    def energy_mj(self):
        return self.e

    def sm_mhz(self):
        return self.mhz

    def power_limit_w(self):
        return 700.0


def test_energy_counter_window():
    """The counter steps every 100 ms at 500 W; the window's watts come
    from its first and last step inside the window."""
    m = Meter(FakeNvml())
    for i in range(0, 400):                       # 10 ms samples, 4 s
        t = i * 0.01
        e = int(t * 10) * 50_000                  # 50 J a 100 ms step
        m.samples.append((t, e, 1400 if i % 2 else 1600))
    r = m.reading(0.95, 3.05)
    assert r["watts"] == pytest.approx(500.0)
    assert r["joules"] == pytest.approx(500.0 * 2.1)
    assert r["sm_mhz"] == 1500.0 and r["power_limit_w"] == 700.0
    with pytest.raises(RuntimeError, match="stepped 1 times"):
        m.reading(1.05, 1.15)


def test_meter_thread_samples_and_stops():
    src = FakeNvml()
    m = Meter(src, period_s=0.001).start()
    import time
    time.sleep(0.05)
    m.stop()
    assert len(m.samples) >= 5
    assert not m._thread.is_alive()


def test_fft_readers():
    units = [Unit("c2c", 1024, 244140, 244140 * 1024, 244140 * 1024 * 8,
                  t_start=0.0) for _ in range(4)]
    run = _run(units, energy={"joules": 100.0, "watts": 690.0,
                              "sm_mhz": 1755})
    assert reader("fft_gsample_s").read(run) == pytest.approx(
        4 * 244140 * 1024 / 10.0 / 1e9)
    assert reader("energy_j_per_gb").read(run) == pytest.approx(
        100.0 / (4 * 244140 * 1024 * 8 / 1e9))
    assert reader("board_w").read(run) == 690.0
    assert reader("sm_clock_mhz").read(run) == 1755.0
    # a traced pair of batches: 2 ms of the port's kernel, 1 ms of torch's
    tr = trace.Trace(device=[("void fft_c2c_regs_kernel<8,2>()", 0.0, 0.002),
                             ("void at::native::copy_kernel()", 0.003, 0.004)],
                     host=[], t0=0.0, t1=0.004, units=units[:2])
    run = _run(units, tr)
    bound, binds = roofline.bound_s(*roofline.fft_work("c2c", 1024, 244140))
    assert binds == "bytes"
    value, extra = reader("fft_roofline").read(run)
    assert value == pytest.approx(100 * 2 * bound / 0.003)
    assert extra == {"binds": "bytes"}
    assert reader("plan_torch_ms").read(run) == pytest.approx(0.5)
    assert reader("idle_share.fft").read(run) == pytest.approx(25.0)


def test_trace_helpers_select_units_by_kind():
    """The shared helpers read only a sub-window that ran units of the
    kinds asked for; a reader of FFT batches finds nothing in another
    kind's trace and returns nothing, never 0."""
    units = [Unit("search", 2**17, 2, 0, 2 * 1024 * 2**17 * 4, t_start=0.0,
                  t_end=0.08)]
    tr = trace.Trace(device=[("void dedisperse_kernel()", 0.0, 0.0072),
                             ("void at::native::topk_kernel()", 0.008, 0.05)],
                     host=[], t0=0.0, t1=0.06, units=units)
    assert trace.torch_ms_a_unit(tr, ("search",)) == pytest.approx(42.0)
    assert trace.idle_share(tr, ("search",)) == pytest.approx(
        100 * (1 - 0.0492 / 0.06))
    assert trace.traced_units(None, ("search",)) == []
    for name in ("fft_roofline", "plan_torch_ms", "idle_share.fft"):
        assert reader(name).read(_run(units, tr)) is None, name
        assert reader(name).read(_run(units)) is None, name
    assert reader("fft_gsample_s").read(_run(units)) is None


def test_roofline_work():
    nbytes, flops = roofline.fft_work("c2c", 1024, 244140)
    assert nbytes == 2 * 244140 * 1024 * 8
    assert flops == pytest.approx(244140 * 5 * 1024 * 10)
    nbytes, _ = roofline.fft_work("r2c", 2**20, 476)
    assert nbytes == 476 * (2**20 * 4 + (2**19 + 1) * 8)
    assert roofline.fft_work("c2r", 2**20, 476)[0] == nbytes
    t, binds = roofline.bound_s(nbytes, 476 * 2.5 * 2**20 * 20)
    assert binds == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    assert roofline.bound_s(1.0, 67e12) == (1.0, "operations")
