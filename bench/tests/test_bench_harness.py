"""The harness on the CPU: cells found from files, correct runs, and the
check failing under the faults a cell can have and under the control.

The tiny cells (``tiny.py``) run the port's plain torch versions at a
size the CPU holds, with the real cells' limits.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bench import harness
from bench.tests.tiny import BENCH, CELLS, ROOT, FakeMeter, make_bench

SEED = 2**31 + 977


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Path:
    return make_bench(tmp_path_factory.mktemp("checkout"))


def _run(bench: Path, cell: str, trace: bool = False, make_system=None,
         seed: int = SEED) -> dict:
    c = harness.Cell(cell, bench=bench)
    return harness.run_cell(c, seed, 0.3, trace, "cpu", time.perf_counter(),
                            meter=FakeMeter(), make_system=make_system)


def test_cell_metrics_follow_benchmark_json():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = lambda cell, trace: [m["name"] for m in  # noqa: E731
                                 harness.cell_metrics(spec, cell, trace)]
    assert names("fft1d.c2c_fused", False) == [
        "fft_gsample_s", "energy_j_per_gb", "setup_s"]
    assert names("fft1d.real_fourstep", True) == [
        "fft_roofline", "plan_torch_ms", "idle_share.fft", "board_w",
        "sm_clock_mhz"]


def test_every_named_file_exists():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        c = harness.Cell(w["name"])
        assert c.generator.__name__.startswith("bench.generators.")
        assert set(c.limits)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_new_cell_config_traffic_and_metric_are_files(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files and entries alone are found and reported."""
    bench = make_bench(tmp_path)
    (bench / "metrics" / "units_traced.py").write_text(
        "def read(run):\n"
        "    t = run.window.trace\n"
        "    return None if t is None else float(len(t.units))\n")
    spec_path = tmp_path / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["per_layer"].append({
        "name": "units_traced", "unit": "count", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "fft_gsample_s", "workloads": ["tiny.c2c"]})
    spec_path.write_text(json.dumps(spec))
    res = _run(bench, "tiny.c2c", trace=True)
    assert res["correct"]
    assert res["metrics"]["units_traced"]["value"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"c2c_16_err", "c2c_256_err"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_is_correct(tiny, cell):
    res = _run(tiny, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    e2e = {m: v["value"] for m, v in res["metrics"].items()}
    assert e2e["setup_s"] > 0 and e2e["energy_j_per_gb"] > 0
    assert e2e["fft_gsample_s"] > 0


def _broken(fault: str):
    """A make_system that puts the program with ``fault`` in its place."""
    def make(cell, state):
        system = cell.generator.program(cell.cfg, cell.traffic, state)

        def wrap(fn):
            def call(x):
                y = fn(x).clone()
                if fault == "answer_altered":
                    y.view(-1)[7] += 0.01 * y.abs().max()
                else:                           # half of the batch left out
                    y[y.shape[0] // 2:] = 0
                return y
            return call
        return {key: wrap(fn) for key, fn in system.items()}
    return make


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_makes_run_incorrect(tiny, cell, fault):
    res = _run(tiny, cell, make_system=_broken(fault))
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(tiny, cell):
    """The reference at bfloat16 in the program's place fails the check."""
    res = _run(tiny, cell, make_system=lambda c, state: c.generator.control(
        c.cfg, c.traffic, state, c.ref))
    assert not res["correct"], res["checks"]


def _bench_cli(cwd: Path, *extra) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "fft1d.c2c_fused",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    proc = _bench_cli(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA device" in proc.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory with BENCHMARK.json and bench/ alone has no program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _bench_cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_control_script_readings(tiny):
    """``bench/control.py``'s readings: the program's seeds pass, the
    control's fail, and the summary pairs their extremes."""
    from bench import control
    out = control.readings("tiny.c2c", SEED, 2, 1, 0.2, device="cpu",
                           bench=tiny)
    assert [r["correct"] for r in out["program"]] == [True, True]
    assert [r["correct"] for r in out["control"]] == [False]
    summary = control.summary(out)
    assert set(summary) == {"c2c_16_err", "c2c_256_err"}
    for s in summary.values():
        assert s["program_max"] < 5e-5 < s["control_min"]
