"""Runs one cell of ``BENCHMARK.json`` once and reports it.

A cell names a configuration (``configs/<config>.json``, with its plain
reference ``configs/<config>_ref.py``) and a traffic mix
(``traffic/<traffic>.json``, which names its generator in ``generators/``);
its limits are ``limits/<workload>.json``, and each metric is read by
``metrics/<metric>.py``.  Nothing here names a cell, a configuration or a
metric: a new one is new files and new entries.

A run: set-up (inputs from the seed on the device, the program's plans,
every shape of the cell warmed), the measured window under the NVML
meter (and, with ``--trace 1``, a profiled sub-window), then the check of
what the window produced against the reference, and the result line.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from bench.record import Run, TraceWindow

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class CellError(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _find(entries, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise CellError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics (those that list the cell, or
    list no cells and move an end-to-end metric the cell reports)."""
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


class Cell:
    """Everything one cell is made of, found by name under ``bench``."""

    def __init__(self, name: str, bench: Path = BENCH):
        self.bench = bench
        self.spec = load_json(bench.parent / "BENCHMARK.json")
        self.workload = _find(self.spec["workloads"], name, "workload")
        self.config = _find(self.spec["configs"], self.workload["config"],
                            "configuration")
        self.cfg = load_json(bench.parent / self.config["file"])
        self.traffic = load_json(bench / "traffic" /
                                 f"{self.workload['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{name}.json")
        self.generator = importlib.import_module(
            f"bench.generators.{self.traffic['generator']}")
        self.ref = load_file_module(
            bench / "configs" / f"{self.config['name']}_ref.py",
            f"bench_ref_{self.config['name']}")

    def metrics(self, trace: bool) -> list[dict]:
        return cell_metrics(self.spec, self.workload["name"], trace)

    def reader(self, metric: str):
        return load_file_module(self.bench / "metrics" / f"{metric}.py",
                                f"bench_metric_{metric}")


def _read(cell: Cell, run: Run, trace: bool) -> dict:
    out = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(run)
        if value is None:
            continue
        extra = {}
        if isinstance(value, tuple):
            value, extra = value
        if not math.isfinite(value):
            raise CellError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"], **extra}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, meter=None, make_system=None) -> dict:
    """One run of ``cell``: returns the result line's object.

    ``meter`` reads the window's energy (the NVML meter on the card);
    ``make_system(cell, state)`` puts something else in the program's
    place (the control, or a broken program in the tests)."""
    import torch
    marks = [("imports", time.perf_counter())]
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("context", time.perf_counter()))
    gen = cell.generator
    state = gen.setup(cell.cfg, cell.traffic, seed, device)
    marks.append(("inputs", time.perf_counter()))
    system = (make_system(cell, state) if make_system is not None
              else gen.program(cell.cfg, cell.traffic, state))
    marks.append(("plans", time.perf_counter()))
    gen.warm(system, state)
    marks.append(("warm-up", time.perf_counter()))
    if meter is not None:
        meter.start()
    tracer = TraceWindow(device, seconds) if trace else None
    try:
        win = gen.window(system, state, seconds, tracer)
    finally:
        if meter is not None:
            meter.stop()
    setup_s = win.t0 - t_start
    # A traced run's power is read before the profiler starts.
    t_end = tracer.host_open if trace else win.t1
    energy = meter.reading(win.t0, t_end) if meter is not None else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del system
    if cuda:
        torch.cuda.empty_cache()
    checks = gen.check(cell.ref, cell.cfg, cell.traffic, state, win,
                       cell.limits)
    run = Run(setup_s=setup_s, window=win, energy=energy, cfg=cell.cfg,
              traffic=cell.traffic)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if energy is not None:
        dev["power_limit_w"] = energy["power_limit_w"]
    result = {"correct": all(c.ok for c in checks),
              "attempted": len(win.units),
              "failed": int(win.kept.get("failed", 0)),
              "metrics": _read(cell, run, trace), "device": dev}
    if trace:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
        result["breakdown"] = win.trace.breakdown()
    starts = [t_start] + [t for _, t in marks[:-1]]
    result["setup_parts"] = {name: t - t0 for (name, t), t0
                             in zip(marks, starts)}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = Cell(args.workload)
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from bench.yardstick.nvml import Meter, device_nvml
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t_start, meter=Meter(device_nvml(0)))
    found = forbidden_modules()
    if found:
        print(f"bench: the process holds forbidden modules: {found}",
              file=sys.stderr)
        return 3
    parts = result.pop("setup_parts")
    print("bench setup_s: " + ", ".join(f"{k} {v:.3f} s"
                                         for k, v in parts.items()),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"bench check {name}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
