#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. build every CUDA kernel of the port from ``src/repro_torch/csrc``;
  2. print the card's name and power limit (``nvidia-smi``);
  3. hold each kernel (all five variants: fft_c2c, fft_c2c_t with and
     without twiddle, fft_c2c_axis1 with and without twiddle; forward and
     inverse) against its plain torch version on the card, at small
     shapes and at the shapes the main path gives it; time the kernel,
     the plain version and, where one call computes the same function,
     ``torch.fft``;
  4. drive the main path — ``plan_for_length(n)(x)`` on a 2 GB batch
     (``FFTCase(n).n_fft`` transforms) for n = 1024, 8192, 2**20 and
     19321 = 139**2 — with every launch count set to 0 just before each
     run and read just after; check the ledger and the launch counts,
     compare with ``torch.fft.fft``, time it, and price it with the DVFS
     model;
  5. print the ``kernels`` JSON line, then the final ``{"ok": true, ...}``.

Exits non-zero without printing a result when no CUDA device is present.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch  # noqa: E402

from repro_torch.core import TESLA_V100, FFTCase, fft_workload, sweep  # noqa: E402
from repro_torch.fft.plan import plan_for_length  # noqa: E402
from repro_torch.fft.radix import (DEFAULT_RADICES,  # noqa: E402
                                   mixed_radix_flop_count)
from repro_torch.kernels.common import build_all  # noqa: E402
from repro_torch.kernels.fft import fft_kernel as K  # noqa: E402
from repro_torch.kernels.fft import ops  # noqa: E402
from repro_torch.kernels.fft.ref import fft_ref  # noqa: E402
from repro_torch.obs.ledger import LaunchLedger  # noqa: E402

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and float32
#: FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

#: Kernel vs its plain version on the same inputs: both run the same f32
#: schedule; they differ only by FMA contraction and rounding order.
KERNEL_RTOL = 1e-5
#: Plan vs torch.fft.fft (cuFFT): pow2 plans, and Bluestein with its f32
#: chirp and filter spectrum.
PLAN_RTOL = {"stockham": 2e-5, "four-step": 2e-5, "bluestein": 1e-4}

MAIN_LENGTHS = (1024, 8192, 2**20, 19321)
EXPECTED_LEDGER = {
    1024: {"fft-c2c": 1},
    8192: {"fft-c2c": 1},
    2**20: {"fft-c2c-axis1": 1, "fft-c2c-t": 1},
    19321: {"fft-c2c-axis1": 2, "fft-c2c-t": 2},
}
LEDGER_TO_KERNEL = {"fft-c2c": "fft_c2c", "fft-c2c-t": "fft_c2c_t",
                    "fft-c2c-axis1": "fft_c2c_axis1"}
SOURCE = "src/repro_torch/csrc/fft_c2c.cu"
REPLACES = {
    "fft_c2c": "src/repro/kernels/fft/fft_kernel.py:360",
    "fft_c2c_t": "src/repro/kernels/fft/fft_kernel.py:413",
    "fft_c2c_axis1": "src/repro/kernels/fft/fft_kernel.py:515",
}
SEED = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, max |a - b| / max |b|)."""
    diff = (a - b).abs().max().item()
    return diff, diff / max(b.abs().max().item(), 1e-30)


def median_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` runs, each timed with CUDA events, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def randn(gen: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.randn(*shape, dtype=torch.complex64, device="cuda",
                       generator=gen)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time [ms] the card could take, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_breakdown(fn) -> dict[str, float]:
    """Device time [ms] of one profiled run of ``fn``, by kernel: the
    port's kernels by name, every other (torch) kernel summed."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in ("fft_c2c_axis1", "fft_c2c_t", "fft_c2c")
                     if f"{k}_kernel" in ev.name), "torch (other kernels)")
        out[name] = out.get(name, 0.0) + ev.device_time / 1e3
    return out


def phase1_build() -> None:
    t0 = time.perf_counter()
    libs = build_all()
    dt = time.perf_counter() - t0
    print(f"phase 1: built {len(libs)} kernel libraries in {dt:.2f} s")
    for stem, path in libs.items():
        log = path.with_suffix(".so.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {stem}: {line.strip()}")


def phase2_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    line = out.strip().splitlines()[0]
    print(line)
    return line


#: Each kernel's wrapper (what the plans call) and its plain version.
FNS = {"fft_c2c": (ops.fft_kernel_c2c, K.fft_c2c_plain),
       "fft_c2c_t": (ops.fft_kernel_c2c_t, K.fft_c2c_t_plain),
       "fft_c2c_axis1": (ops.fft_kernel_c2c_axis1, K.fft_c2c_axis1_plain)}


# Each variant: (kernel name, kernel wrapper, plain fn, input shape for a
# transform length n, twiddle shape or None).
def _variants(n: int, b: int, other: int):
    return [
        ("fft_c2c", *FNS["fft_c2c"], (b, n), None),
        ("fft_c2c_t", *FNS["fft_c2c_t"], (b, other, n), None),
        ("fft_c2c_t", *FNS["fft_c2c_t"], (b, other, n), (other, n)),
        ("fft_c2c_axis1", *FNS["fft_c2c_axis1"], (b, n, other), None),
        ("fft_c2c_axis1", *FNS["fft_c2c_axis1"], (b, n, other), (other, n)),
    ]


def _call(fn, x, tw, inverse):
    if tw is None:
        return fn(x, inverse=inverse)
    return fn(x, twiddle=tw, inverse=inverse)


def phase3_kernels(gen: torch.Generator) -> dict[str, dict]:
    """Kernel vs plain on the card; returns per-kernel measurements at
    the main path's shapes."""
    worst = 0.0
    checked = 0
    # Small and medium shapes: ragged batches and block edges.
    for n in (64, 1024, 8192):
        for name, fn, plain, shape, tw_shape in _variants(n, 1001 if n < 8192
                                                          else 37, 37):
            if name != "fft_c2c":
                shape = (3,) + shape[1:]
            x = randn(gen, *shape)
            tw = randn(gen, *tw_shape) if tw_shape else None
            for inverse in (False, True):
                _, rel = rel_err(_call(fn, x, tw, inverse),
                                 _call(plain, x, tw, inverse))
                check(rel <= KERNEL_RTOL,
                      f"{name} n={n} shape={shape} twiddle={tw_shape} "
                      f"inverse={inverse}: rel err {rel:.3e}")
                worst = max(worst, rel)
                checked += 1
    for name, fn, plain, shape, tw_shape in _variants(1024, 4, 1024)[1:]:
        x = randn(gen, *shape)
        tw = randn(gen, *tw_shape) if tw_shape else None
        for inverse in (False, True):
            _, rel = rel_err(_call(fn, x, tw, inverse),
                             _call(plain, x, tw, inverse))
            check(rel <= KERNEL_RTOL, f"{name} {shape}: rel err {rel:.3e}")
            worst = max(worst, rel)
            checked += 1
    torch.cuda.synchronize()
    print(f"phase 3: {checked} kernel-vs-plain checks, max relative error "
          f"{worst:.3e} (limit {KERNEL_RTOL})")

    # The main path's shapes, forward, as the plans launch them; the
    # first row of each kernel is its headline in the kernels line.
    results: dict[str, dict] = {}
    main_shapes = [
        ("fft_c2c", (FFTCase(1024).n_fft, 1024), None),
        ("fft_c2c", (FFTCase(8192).n_fft, 8192), None),
        ("fft_c2c_axis1", (FFTCase(2**20).n_fft, 1024, 1024), (1024, 1024)),
        ("fft_c2c_t", (FFTCase(2**20).n_fft, 1024, 1024), None),
        ("fft_c2c_axis1", (FFTCase(19321).n_fft, 256, 256), (256, 256)),
        ("fft_c2c_t", (FFTCase(19321).n_fft, 256, 256), None),
        # The variants no plan launches, at the 2**20 pass shape.
        ("fft_c2c_axis1", (FFTCase(2**20).n_fft, 1024, 1024), None),
        ("fft_c2c_t", (FFTCase(2**20).n_fft, 1024, 1024), (1024, 1024)),
    ]
    for name, shape, tw_shape in main_shapes:
        fn, plain = FNS[name]
        x = randn(gen, *shape)
        tw = randn(gen, *tw_shape) if tw_shape else None
        # One torch.fft call computes the same function for every kernel
        # without twiddle: fft_c2c_t's row FFT written as (B, C, R) is the
        # FFT along dim -2 of the transposed view.  With a twiddle it is
        # the FFT part alone, timed as a yardstick.
        if name == "fft_c2c":
            lib, lib_call = (lambda: torch.fft.fft(x)), "torch.fft.fft(x)"
        elif name == "fft_c2c_t":
            lib = lambda: torch.fft.fft(x.transpose(1, 2), dim=-2)  # noqa: E731
            lib_call = "torch.fft.fft(x.transpose(1, 2), dim=-2)"
        else:
            lib = lambda: torch.fft.fft(x, dim=-2)  # noqa: E731
            lib_call = "torch.fft.fft(x, dim=-2)"
        y = _call(fn, x, tw, False)
        y_plain = _call(plain, x, tw, False)
        abs_err, rel = rel_err(y, y_plain)
        check(rel <= KERNEL_RTOL, f"{name} {shape}: rel err {rel:.3e}")
        if tw is None:
            # The library call must compute the kernel's function.
            y_lib = lib()
            _, lib_rel = rel_err(y_lib, y)
            check(tuple(y_lib.shape) == tuple(y.shape)
                  and lib_rel <= PLAN_RTOL["stockham"],
                  f"{name} {shape}: {lib_call} differs, rel {lib_rel:.3e}")
            lib_call += (f" (rel diff {lib_rel:.3e}, output contiguous "
                         f"{y_lib.is_contiguous()})")
            del y_lib
        del y, y_plain
        ms = median_ms(lambda: _call(fn, x, tw, False))
        plain_ms = median_ms(lambda: _call(plain, x, tw, False), reps=3)
        n = shape[1] if name == "fft_c2c_axis1" else shape[-1]
        transforms = x.numel() // n
        nbytes = 16 * x.numel()                   # read x, write y
        flops = mixed_radix_flop_count(n, batch=transforms)
        twr, _ = K.stage_tables(n, DEFAULT_RADICES, x.device)
        nbytes += twr.numel() * 8                 # the stage twiddle table
        if tw is not None:
            nbytes += 8 * tw.numel()              # the four-step twiddle
            flops += 6 * x.numel()
        bound_ms, bound_by = bound(nbytes, flops)
        fft_ms = median_ms(lib)
        library_ms = fft_ms if tw is None else None
        lib_note = (lib_call if tw is None else
                    f"no single call; {lib_call} alone (no twiddle) "
                    f"{fft_ms:.4f} ms")
        row = {"name": name, "shape": list(shape),
               "twiddle": tw is not None, "max_abs_err": abs_err,
               "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        print(f"  {name} {tuple(shape)} twiddle={tw is not None}: "
              f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), bound "
              f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"library {library_ms if library_ms is None else round(library_ms, 4)}"
              f" ms [{lib_note}], max abs err {abs_err:.3e} "
              f"(rel {rel:.3e})")
        results.setdefault(name, row)
        del x, tw
        torch.cuda.empty_cache()
    return results


def phase4_main_path(gen: torch.Generator) -> dict[str, int]:
    """Drive plan_for_length(n)(x) at 2 GB batches; returns the launches
    of each kernel summed over the main-path runs."""
    launches = {name: 0 for name in K.LAUNCHES}
    for n in MAIN_LENGTHS:
        case = FFTCase(n)
        batch = case.n_fft
        plan = plan_for_length(n)
        x = randn(gen, batch, n)
        ledger = LaunchLedger()
        K.reset_launches()
        with ledger.capture():
            y = plan(x)
        torch.cuda.synchronize()
        run = dict(K.LAUNCHES)
        counts = ledger.counts()
        check(counts == EXPECTED_LEDGER[n],
              f"n={n}: ledger {counts} != {EXPECTED_LEDGER[n]}")
        for ledger_name, count in counts.items():
            kernel = LEDGER_TO_KERNEL[ledger_name]
            check(run[kernel] == count,
                  f"n={n}: {kernel} launched {run[kernel]} times, the "
                  f"ledger says {count}")
        for kernel, count in run.items():
            launches[kernel] += count
        check(tuple(y.shape) == (batch, n) and bool(torch.isfinite(
            torch.view_as_real(y)).all()), f"n={n}: bad output")
        ref = fft_ref(x)
        abs_err, rel = rel_err(y, ref)
        del y, ref
        torch.cuda.empty_cache()
        check(rel <= PLAN_RTOL[plan.algorithm],
              f"n={n}: plan vs torch.fft.fft rel err {rel:.3e}")
        ms = median_ms(lambda: plan(x))
        library_ms = median_ms(lambda: torch.fft.fft(x))
        nbytes = 16 * x.numel()
        res = sweep(fft_workload(case, TESLA_V100), TESLA_V100)
        print(f"phase 4: n={n} {plan.algorithm} passes={plan.passes} "
              f"batch={batch} ledger={counts} launches={run} "
              f"kernel_ms={ms:.4f} GB/s={nbytes / ms / 1e6:.1f} "
              f"bound_ms={ledger.total_bytes() / HBM_BYTES_PER_S * 1e3:.4f} "
              f"(ledger bytes {ledger.total_bytes()}; function bytes "
              f"{nbytes}: {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms) "
              f"library_ms={library_ms:.4f} max_abs_err={abs_err:.3e} "
              f"rel={rel:.3e} | V100 model: optimal {res.optimal.f:.1f} MHz "
              f"I_ef {res.i_ef_boost:.4f}")
        split = device_breakdown(lambda: plan(x))
        busy = sum(split.values())
        print(f"  n={n} device time by kernel (ms, one profiled run): "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
              + f"; busy {busy:.4f} of {ms:.4f} ms timed "
              f"(idle share {max(0.0, 1 - busy / ms):.3f})")
        del x
        torch.cuda.empty_cache()
    for kernel, count in launches.items():
        check(count > 0, f"{kernel} was never launched on the main path")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase1_build()
    phase2_card()
    measured = phase3_kernels(gen)
    launches = phase4_main_path(gen)
    kernels = []
    for name in ("fft_c2c", "fft_c2c_t", "fft_c2c_axis1"):
        row = measured[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "twiddle": row["twiddle"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
