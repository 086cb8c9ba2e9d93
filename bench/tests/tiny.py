"""A copy of the benchmark at a size the CPU can run, for the tests.

:func:`make_bench` copies ``bench/`` into a temporary checkout and adds,
as files and entries only, tiny configurations (with their references
beside them), traffic mixes, limits and cells.  The limits are the real
cells' own, so a run that is not correct here would not be there.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY_FFT = {"name": "tiny_fft", "batch_bytes": 2**20, "precision": "float32",
            "reduced": ["batch_bytes"], "assumed": {}}
TRAFFIC = {
    "tiny_c2c": {"generator": "fft_batches", "in_flight": 2,
                 "batches": [{"kind": "c2c", "n": 16},
                             {"kind": "c2c", "n": 256}]},
    "tiny_real": {"generator": "fft_batches", "in_flight": 2,
                  "batches": [{"kind": "r2c", "n": 2**15},
                              {"kind": "c2r", "n": 2**15}]},
}
#: tiny cell -> (configuration, traffic, the real cell whose limits hold)
CELLS = {"tiny.c2c": ("tiny_fft", "tiny_c2c", "fft1d.c2c_fused"),
         "tiny.real": ("tiny_fft", "tiny_real", "fft1d.real_fourstep")}
REAL_REF = {"tiny_fft": "paper_fft_2gb"}


def _limits(real_cell: str, traffic: dict) -> dict:
    real = json.loads((BENCH / "limits" / f"{real_cell}.json").read_text())
    kinds = {name.split("_")[0]: value for name, value in real.items()}
    return {f"{b['kind']}_{b['n']}_err": kinds[b["kind"]]
            for b in traffic["batches"]}


def make_bench(tmp: Path) -> Path:
    """A checkout under ``tmp`` holding BENCHMARK.json and bench/ with the
    tiny cells added; returns its bench/ directory."""
    bench = tmp / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in (TINY_FFT,):
        (bench / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
        shutil.copy(BENCH / "configs" / f"{REAL_REF[cfg['name']]}_ref.py",
                    bench / "configs" / f"{cfg['name']}_ref.py")
        spec["configs"].append({
            "name": cfg["name"], "source": "https://arxiv.org/abs/2009.06009",
            "file": f"bench/configs/{cfg['name']}.json",
            "reduced": cfg["reduced"], "why": "a size the CPU runs"})
    for name, traffic in TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for cell, (cfg, traffic, real) in CELLS.items():
        (bench / "limits" / f"{cell}.json").write_text(
            json.dumps(_limits(real, TRAFFIC[traffic])))
        spec["workloads"].append({"name": cell, "config": cfg,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a size the CPU runs"})
        for metric in spec["end_to_end"] + spec["per_layer"]:
            if real in metric.get("workloads", ()):
                metric["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


class FakeMeter:
    """The NVML meter's interface with made-up readings (no card here)."""

    def start(self):
        return self

    def stop(self):
        pass

    def reading(self, t0, t1):
        return {"joules": 100.0 * (t1 - t0), "watts": 100.0, "sm_mhz": 1000,
                "power_limit_w": 700.0, "counter_steps": 2}
