"""The ``pulsar.accel`` cell on the CPU at a tiny size: its files found by
name, a correct run reporting the cell's metrics, the control (the
reference at bfloat16) failing the real cell's limits, the search
yardstick's arithmetic on a made-up trace, and the configuration's
reference a copy of the port's plain search.

The tiny configuration keeps the real one's keys at 32 channels x 2^13
samples, 24 DM trials in blocks of 8 and sub-blocks of 2, the linear bank
of drift 4 and 4 harmonics; its limits are the real cell's."""
from __future__ import annotations

import inspect
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness
from bench.harness import BENCH, load_file_module
from bench.record import Unit
from bench.tests.tiny import ROOT, FakeMeter, make_bench
from bench.yardstick import search as ys
from bench.yardstick.roofline import HBM_BYTES_PER_S
from bench.yardstick.trace import Trace

SEED = 2**31 + 7919
CELL = "tiny.pulsar"
REAL = "pulsar.accel"
END_TO_END = ["energy_j_per_gb", "setup_s"]
PER_LAYER = ["search_stage_ms", "search_roofline", "search_torch_ms",
             "idle_share.search"]


def _tiny_cfg() -> dict:
    cfg = json.loads((BENCH / "configs" / "htru_medlat_search.json")
                     .read_text())
    cfg.update(name="tiny_search", nchan=32, ntime=2**13,
               reduced=["ntime", "nchan"])
    cfg["assumed"].update(f_lo_mhz=1300.0, f_hi_mhz=1500.0, dm_trials=24,
                          zmax=4, templates=9, taps=32, n_harmonics=4,
                          pool=1024, max_candidates=16, nfft=256)
    return cfg


def _tiny_traffic() -> dict:
    traffic = json.loads((BENCH / "traffic" / "pulsar_accel.json")
                         .read_text())
    traffic.update(dedisp_block=8, fdas_block=2, pulsar_blocks=2,
                   spin_bins=[0.02, 0.09], boundary_spin_bins=[0.02, 0.05])
    return traffic


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Path:
    """A checkout with the tiny search cell beside the real ones."""
    tmp = tmp_path_factory.mktemp("checkout")
    bench = make_bench(tmp)
    cfg = _tiny_cfg()
    (bench / "configs" / "tiny_search.json").write_text(json.dumps(cfg))
    (bench / "configs" / "tiny_search_ref.py").write_text(
        (BENCH / "configs" / "htru_medlat_search_ref.py").read_text())
    (bench / "traffic" / "tiny_pulsar.json").write_text(
        json.dumps(_tiny_traffic()))
    (bench / "limits" / f"{CELL}.json").write_text(
        (BENCH / "limits" / f"{REAL}.json").read_text())
    spec_path = tmp / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "tiny_search", "source": "tiny",
                            "file": "bench/configs/tiny_search.json",
                            "reduced": cfg["reduced"], "why": "the CPU"})
    spec["workloads"].append({"name": CELL, "config": "tiny_search",
                              "traffic": "tiny_pulsar", "chips": 1,
                              "why": "a size the CPU runs"})
    for metric in spec["per_layer"]:
        if REAL in metric.get("workloads", ()):
            metric["workloads"].append(CELL)
    spec_path.write_text(json.dumps(spec))
    return bench


def _run(bench: Path, trace: bool = False, make_system=None,
         seed: int = SEED) -> dict:
    c = harness.Cell(CELL, bench=bench)
    return harness.run_cell(c, seed, 0.3, trace, "cpu", time.perf_counter(),
                            meter=FakeMeter(), make_system=make_system)


def test_cell_metrics_follow_benchmark_json():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = lambda trace: [m["name"] for m in  # noqa: E731
                           harness.cell_metrics(spec, REAL, trace)]
    assert names(False) == END_TO_END
    assert names(True) == PER_LAYER
    c = harness.Cell(REAL)
    assert c.generator.__name__ == "bench.generators.search_blocks"
    assert set(c.limits) == {"delay_mismatch", "power_err", "stat_err",
                             "level_flips", "pool_misses", "sift_mismatch",
                             "missed_pulsars"}


def test_tiny_cell_is_correct_and_reports_its_metrics(tiny):
    res = _run(tiny)
    assert res["correct"], res["checks"]
    # The window lasts at least until blocks 0 and 1 (the checked trials).
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert list(res["metrics"]) == END_TO_END
    assert res["checks"]["missed_pulsars"]["value"] == 0
    traced = _run(tiny, trace=True, seed=SEED + 1)
    assert traced["correct"], traced["checks"]
    # On the CPU the spans' device time is their host time; the profiler
    # sees no device: no kernel of torch's, and no share to read.
    assert list(traced["metrics"]) == ["search_stage_ms", "search_torch_ms"]
    assert traced["metrics"]["search_torch_ms"]["value"] == 0.0
    stage = traced["metrics"]["search_stage_ms"]
    assert set(stage["stages_ms"]) == {"dedisperse", "r2c", "matched_filter",
                                       "power", "harmonic_sum", "sift"}
    assert stage["value"] == pytest.approx(
        sum(stage["stages_ms"].values()) + stage["unattributed_ms"])
    assert stage["realtime_margin"] > 0 and stage["window_blocks"] >= 2


def test_control_fails_the_real_limits(tiny):
    res = _run(tiny, make_system=lambda c, state: c.generator.control(
        c.cfg, c.traffic, state, c.ref))
    assert not res["correct"], res["checks"]
    assert res["checks"]["power_err"]["value"] > \
        res["checks"]["power_err"]["limit"]


def test_a_broken_plane_fails(tiny):
    """The program with one power cell of each kept trial moved by a
    hundredth of a noise unit fails the check."""
    def make(cell, state):
        system = cell.generator.program(cell.cfg, cell.traffic, state)
        block = system.block

        def broken(index, keep, out):
            res = block(index, keep, out)
            for t in res.kept:
                out[t][0][..., 7] += 0.01
            return res
        system.block = broken
        return system
    res = _run(tiny, make_system=make)
    assert not res["correct"]
    assert res["checks"]["power_err"]["value"] >= 0.01


def _trace(cfg: dict, ms: dict, idle_ms: float = 0.0) -> Trace:
    """One block of 32 trials whose kernels took ``ms`` each, back to
    back, with ``idle_ms`` of idle after the first."""
    device, t = [], 0.0
    for i, (name, dt) in enumerate(ms.items()):
        device.append((name, t, t + dt * 1e-3))
        t += dt * 1e-3 + (idle_ms * 1e-3 if i == 0 else 0.0)
    unit = Unit(kind="search", n=cfg["ntime"], rows=32, points=0,
                in_bytes=0, t_start=0.0)
    return Trace(device=device, host=[], t0=0.0, t1=t, units=[unit])


def test_search_yardstick_on_a_made_up_trace():
    cfg = json.loads((BENCH / "configs" / "htru_medlat_search.json")
                     .read_text())
    s = ys.shapes(cfg)
    assert (s["nbins"], s["segments"]) == (2**22 + 1, 2153)
    stages = ys.stage_bounds(cfg, 32)
    cells = 32 * 85 * (2**22 + 1)
    assert stages["dedisperse"] == pytest.approx(
        4 * 2**23 * (1024 + 32) / HBM_BYTES_PER_S)
    assert stages["harmonic_sum"] == pytest.approx(
        12 * cells / HBM_BYTES_PER_S)
    ms = {"void dedisperse_kernel(float const*)": 100.0,
          "void (anonymous namespace)::fft_c2c_axis1_regs_kernel<3, 1>()":
          1.5,
          "void (anonymous namespace)::fft_c2c_t_regs_kernel<3, 1>()": 1.0,
          "void (anonymous namespace)::fft_r2c_split_kernel()": 1.0,
          "void (anonymous namespace)::fft_c2c_mul_kernel<11>()": 50.0,
          "void (anonymous namespace)::fft_c2c_regs_kernel<11, 1>()": 60.0,
          "void harmonic_sum_plane_kernel<4>(float const*)": 90.0,
          "void at::native::vectorized_elementwise_kernel<4>()": 70.0}
    trace = _trace(cfg, ms, idle_ms=5.0)
    value, extra = ys.search_roofline(trace, cfg)
    device = sum(ms.values()) * 1e-3
    assert value == pytest.approx(100 * sum(stages.values()) / device)
    kernels = ys.kernel_bounds(cfg, 32)
    assert extra["by_kernel"]["dedisperse"] == pytest.approx(
        100 * kernels["dedisperse"] / 0.1)
    assert extra["by_kernel"][ys.FOUR_STEP] == pytest.approx(
        100 * kernels[ys.FOUR_STEP] / 2.5e-3)
    assert set(extra["by_kernel"]) == set(kernels)
    assert all(0 < v < 100 for v in extra["by_kernel"].values())
    assert extra["dedisperse_binds"] == "bytes"
    from bench.yardstick.trace import idle_share, torch_ms_a_unit
    assert torch_ms_a_unit(trace, (ys.KIND,)) == pytest.approx(70.0)
    assert idle_share(trace, (ys.KIND,)) == pytest.approx(
        100 * 5.0 / (sum(ms.values()) + 5.0))


def test_configuration_reference_is_the_ports():
    """Every function of ``search/reference.py`` is in the configuration's
    reference with the same source, and the two give the same planes and
    candidates."""
    from repro_torch.search import reference as port_ref
    bench_ref = load_file_module(
        BENCH / "configs" / "htru_medlat_search_ref.py", "test_search_ref")
    for name, fn in inspect.getmembers(port_ref, inspect.isfunction):
        assert inspect.getsource(getattr(bench_ref, name)) == \
            inspect.getsource(fn), name
    fb = torch.randn(1, 8, 1024, generator=torch.Generator().manual_seed(3))
    delays = torch.tensor([[0, 1, 2, 3, 4, 5, 6, 7], [0, 0, 1, 1, 2, 2, 3, 3]])
    a = port_ref.search(fb, delays, (-2.0, 0.0, 2.0), 32, n_harmonics=4,
                        threshold=5.0)
    b = bench_ref.search(fb, delays, (-2.0, 0.0, 2.0), 32, n_harmonics=4,
                         threshold=5.0)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert a[3] == b[3] and a[3][0]
    control = bench_ref.control_planes(fb, delays[0], (-2.0, 0.0, 2.0), 32, 4)
    ref = [p[0] for p in port_ref.trial_planes(fb, delays[0],
                                               (-2.0, 0.0, 2.0), 32, 4)]
    errs = bench_ref.plane_errors([p[0] for p in control], ref)
    assert errs[0] > 1e-3 and np.isfinite(errs[1])
