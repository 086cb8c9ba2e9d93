#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. build every CUDA kernel of the port from ``src/repro_torch/csrc``
     (both libraries, ``fft_c2c`` and ``fft_real``, one ``nvcc`` each, in
     parallel);
  2. print the card's name and power limit (``nvidia-smi``);
  3. hold each kernel (the C2C variants: fft_c2c, fft_c2c_t with and
     without twiddle, fft_c2c_axis1 with and without twiddle, forward and
     inverse; and fft_r2c, fft_c2r) against its plain torch version on
     the card, at small shapes and at the shapes the main path gives it;
     time the kernel, the plain version and, where one call computes the
     same function, ``torch.fft``;
  4. drive the main path — ``plan_for_length(n)(x)`` on a 2 GB batch
     (``FFTCase(n).n_fft`` transforms) for n = 1024, 8192, 2**20 and
     19321 = 139**2, then ``plan_for_length(n, "r2c")`` and ``"c2r"`` on
     2 GB real batches for n = 1024, 16384 and 2**20 — with every launch
     count set to 0 just before each run and read just after; check the
     ledger and the launch counts, compare with ``torch.fft``, time it,
     and price it with the DVFS model;
  5. serve two waves of C2C and R2C requests through
     ``repro_torch.serving.FFTService`` on the card (counts set to 0
     before the phase and read after); check every result against
     ``torch.fft``, the receipts and the plan/sweep cache;
  6. print the ``kernels`` JSON line, then the final ``{"ok": true, ...}``.

Exits non-zero without printing a result when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import TESLA_V100, FFTCase, fft_workload, sweep  # noqa: E402
from repro_torch.fft.plan import plan_for_length  # noqa: E402
from repro_torch.fft.radix import (DEFAULT_RADICES,  # noqa: E402
                                   mixed_radix_flop_count, r2c_flop_count)
from repro_torch.kernels.common import build_all  # noqa: E402
from repro_torch.kernels.fft import fft_kernel as K  # noqa: E402
from repro_torch.kernels.fft import ops  # noqa: E402
from repro_torch.kernels.fft.ref import fft_ref, irfft_ref, rfft_ref  # noqa: E402
from repro_torch.obs.ledger import LaunchLedger  # noqa: E402
from repro_torch.obs.metrics import latency_summary  # noqa: E402
from repro_torch.serving import FFTService  # noqa: E402

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
REAL_LENGTHS = (1024, 16384, 2**20)
FOUR_STEP = {"fft-c2c-axis1": 1, "fft-c2c-t": 1}
#: At 2**20 the packed 2**19-point transform runs the four-step pair (the
#: c2r inverse through the conjugate trick); the split or merge is torch.
REAL_EXPECTED = {
    ("r2c", 1024): {"fft-r2c": 1}, ("r2c", 16384): {"fft-r2c": 1},
    ("r2c", 2**20): FOUR_STEP,
    ("c2r", 1024): {"fft-c2r": 1}, ("c2r", 16384): {"fft-c2r": 1},
    ("c2r", 2**20): FOUR_STEP,
}
LEDGER_TO_KERNEL = {"fft-c2c": "fft_c2c", "fft-c2c-t": "fft_c2c_t",
                    "fft-c2c-axis1": "fft_c2c_axis1", "fft-r2c": "fft_r2c",
                    "fft-c2r": "fft_c2r"}
KERNELS = ("fft_c2c", "fft_c2c_t", "fft_c2c_axis1", "fft_r2c", "fft_c2r")
SOURCES = {
    "fft_c2c": "src/repro_torch/csrc/fft_c2c.cu",
    "fft_c2c_t": "src/repro_torch/csrc/fft_c2c.cu",
    "fft_c2c_axis1": "src/repro_torch/csrc/fft_c2c.cu",
    "fft_r2c": "src/repro_torch/csrc/fft_real.cu",
    "fft_c2r": "src/repro_torch/csrc/fft_real.cu",
}
REPLACES = {
    "fft_c2c": "src/repro/kernels/fft/fft_kernel.py:360",
    "fft_c2c_t": "src/repro/kernels/fft/fft_kernel.py:413",
    "fft_c2c_axis1": "src/repro/kernels/fft/fft_kernel.py:515",
    "fft_r2c": "src/repro/kernels/fft/fft_kernel.py:386",
    "fft_c2r": "src/repro/kernels/fft/fft_kernel.py:606",
}
#: Serving phase: each wave submits 16 requests per stream, (4096, 4096)
#: complex64 and (8192, 4096) float32, about 2.1 GB of each, just over the
#: 2 GB batch budget, so each stream coalesces into two batches.  Request i
#: is one seeded payload rolled by i rows, so that every request's result
#: differs and a result handed to the wrong request fails its check.
SERVE_REQUESTS = 16
SERVE_WAVES = 2
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
        name = next((k for k in KERNELS if f"{k}_kernel" in ev.name),
                    "torch (other kernels)")
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


def phase3_real_kernels(gen: torch.Generator,
                        results: dict[str, dict]) -> None:
    """fft_r2c and fft_c2r against their plain versions on the card (both
    radix sets, ragged batches), then timed at the main path's shapes;
    adds one row per kernel to ``results``."""
    worst = 0.0
    checked = 0
    for n in (8, 64, 1024, 16384):
        b = 1001 if n < 16384 else 37
        for radices in ((4, 2), (8, 4, 2)):
            x = torch.randn(b, n, device="cuda", generator=gen)
            spec = randn(gen, b, n // 2 + 1)       # any input: same merge
            for name, out, plain in (
                    ("fft_r2c", ops.fft_kernel_r2c(x, radices=radices),
                     K.fft_r2c_plain(x, radices=radices)),
                    ("fft_c2r", ops.fft_kernel_c2r(spec, radices=radices),
                     K.fft_c2r_plain(spec, radices=radices))):
                _, rel = rel_err(out, plain)
                check(rel <= KERNEL_RTOL, f"{name} n={n} batch={b} "
                      f"radices={radices}: rel err {rel:.3e}")
                worst = max(worst, rel)
                checked += 1
    torch.cuda.synchronize()
    print(f"phase 3: {checked} real-kernel-vs-plain checks, max relative "
          f"error {worst:.3e} (limit {KERNEL_RTOL})")

    # The main path's shapes: FFTCase(n, transform="r2c").n_fft rows, 2 GB
    # of float32 input; the C2R input is a true half-spectrum (torch.fft's
    # irfft drops the imaginary parts of bins 0 and N/2, the merge reads
    # them).
    for name, n in (("fft_r2c", 1024), ("fft_r2c", 16384),
                    ("fft_c2r", 1024), ("fft_c2r", 16384)):
        b = FFTCase(n, transform="r2c").n_fft
        m = n // 2
        real = torch.randn(b, n, device="cuda", generator=gen)
        if name == "fft_r2c":
            x, shape = real, (b, n)
            fn, plain = ops.fft_kernel_r2c, K.fft_r2c_plain
            lib, lib_call = (lambda: torch.fft.rfft(x)), "torch.fft.rfft(x)"
        else:
            x, shape = torch.fft.rfft(real), (b, m + 1)
            fn, plain = ops.fft_kernel_c2r, K.fft_c2r_plain
            lib = lambda: torch.fft.irfft(x, n=n)  # noqa: E731
            lib_call = f"torch.fft.irfft(x, n={n})"
        del real
        y = fn(x)
        y_plain = plain(x)
        abs_err, rel = rel_err(y, y_plain)
        check(rel <= KERNEL_RTOL, f"{name} {shape}: rel err {rel:.3e}")
        del y_plain
        y_lib = lib()
        _, lib_rel = rel_err(y_lib, y)
        check(tuple(y_lib.shape) == tuple(y.shape)
              and lib_rel <= PLAN_RTOL["stockham"],
              f"{name} {shape}: {lib_call} differs, rel {lib_rel:.3e}")
        del y, y_lib
        torch.cuda.empty_cache()
        ms = median_ms(lambda: fn(x))
        plain_ms = median_ms(lambda: plain(x), reps=3)
        library_ms = median_ms(lib)
        # Read the input once, write the output once (4 bytes a real, 8 a
        # bin), plus the stage table of N/2 and the split table.
        nbytes = 4 * b * n + 8 * b * (m + 1)
        twr, _ = K.stage_tables(m, DEFAULT_RADICES, x.device)
        nbytes += twr.numel() * 8 + (m + 1) * 8
        flops = r2c_flop_count(n, DEFAULT_RADICES, batch=b)
        bound_ms, bound_by = bound(nbytes, flops)
        row = {"name": name, "shape": list(shape), "twiddle": False,
               "max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}
        print(f"  {name} {shape}: {ms:.4f} ms ({nbytes / ms / 1e6:.1f} "
              f"GB/s), bound {bound_ms:.4f} ms ({bound_by}), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms [{lib_call}, "
              f"rel diff {lib_rel:.3e}], max abs err {abs_err:.3e} "
              f"(rel {rel:.3e})")
        results.setdefault(name, row)
        del x
        torch.cuda.empty_cache()


def _drive(label: str, plan, x: torch.Tensor, expected: dict[str, int],
           ref_fn, lib_fn, nbytes: int, case: FFTCase, rtol: float,
           launches: dict[str, int]) -> torch.Tensor:
    """One main-path run of ``plan`` on ``x`` with every launch count set
    to 0 just before it and read just after; checks the ledger, the
    counts and the result against ``ref_fn``; times the plan and
    ``lib_fn``; prices ``case`` on the V100 model.  Adds the run's
    launches to ``launches`` and returns the plan's output."""
    ledger = LaunchLedger()
    K.reset_launches()
    with ledger.capture():
        y = plan(x)
    torch.cuda.synchronize()
    run = dict(K.LAUNCHES)
    counts = ledger.counts()
    check(counts == expected, f"{label}: ledger {counts} != {expected}")
    for ledger_name, count in counts.items():
        kernel = LEDGER_TO_KERNEL[ledger_name]
        check(run[kernel] == count,
              f"{label}: {kernel} launched {run[kernel]} times, the "
              f"ledger says {count}")
    for kernel, count in run.items():
        launches[kernel] += count
    values = torch.view_as_real(y) if y.is_complex() else y
    check(bool(torch.isfinite(values).all()), f"{label}: bad output")
    ref = ref_fn(x)
    check(tuple(y.shape) == tuple(ref.shape),
          f"{label}: shape {tuple(y.shape)} != {tuple(ref.shape)}")
    abs_err, rel = rel_err(y, ref)
    del ref
    torch.cuda.empty_cache()
    check(rel <= rtol, f"{label}: plan vs torch.fft rel err {rel:.3e}")
    ms = median_ms(lambda: plan(x))
    library_ms = median_ms(lib_fn)
    res = sweep(fft_workload(case, TESLA_V100), TESLA_V100)
    print(f"phase 4: {label} {plan.algorithm} passes={plan.passes} "
          f"batch={x.shape[0]} ledger={counts} "
          f"launches={ {k: v for k, v in run.items() if v} } "
          f"kernel_ms={ms:.4f} GB/s={nbytes / ms / 1e6:.1f} "
          f"bound_ms={ledger.total_bytes() / HBM_BYTES_PER_S * 1e3:.4f} "
          f"(ledger bytes {ledger.total_bytes()}; function bytes "
          f"{nbytes}: {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms) "
          f"library_ms={library_ms:.4f} max_abs_err={abs_err:.3e} "
          f"rel={rel:.3e} | V100 model of {case.name}: optimal "
          f"{res.optimal.f:.1f} MHz, {res.optimal.energy:.4f} J vs boost "
          f"{res.boost.energy:.4f} J, I_ef {res.i_ef_boost:.4f}")
    split = device_breakdown(lambda: plan(x))
    busy = sum(split.values())
    print(f"  {label} device time by kernel (ms, one profiled run): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
          + f"; busy {busy:.4f} of {ms:.4f} ms timed "
          f"(idle share {max(0.0, 1 - busy / ms):.3f})")
    return y


def phase4_main_path(gen: torch.Generator) -> dict[str, int]:
    """Drive plan_for_length(n)(x) at 2 GB batches, then the real plans at
    2 GB real batches; returns the launches of each kernel summed over the
    main-path runs."""
    launches = {name: 0 for name in K.LAUNCHES}
    for n in MAIN_LENGTHS:
        case = FFTCase(n)
        plan = plan_for_length(n)
        x = randn(gen, case.n_fft, n)
        y = _drive(f"n={n}", plan, x, EXPECTED_LEDGER[n], fft_ref,
                   lambda: torch.fft.fft(x), 16 * x.numel(), case,
                   PLAN_RTOL[plan.algorithm], launches)
        del x, y
        torch.cuda.empty_cache()
    for n in REAL_LENGTHS:
        batch = FFTCase(n, transform="r2c").n_fft
        m = n // 2
        nbytes = 4 * batch * n + 8 * batch * (m + 1)
        x = torch.randn(batch, n, device="cuda", generator=gen)
        r2c, c2r = plan_for_length(n, "r2c"), plan_for_length(n, "c2r")
        spec = _drive(f"r2c n={n}", r2c, x, REAL_EXPECTED["r2c", n],
                      rfft_ref, lambda: torch.fft.rfft(x), nbytes,
                      FFTCase(n, transform="r2c"),
                      PLAN_RTOL[r2c.algorithm], launches)
        # spec is the rfft of a real signal: a true half-spectrum.
        back = _drive(f"c2r n={n}", c2r, spec, REAL_EXPECTED["c2r", n],
                      irfft_ref, lambda: torch.fft.irfft(spec, n=n),
                      nbytes, FFTCase(n, transform="c2r"),
                      PLAN_RTOL[c2r.algorithm], launches)
        _, rel = rel_err(back, x)
        check(rel <= PLAN_RTOL["stockham"],
              f"n={n}: c2r(r2c(x)) vs x rel err {rel:.3e}")
        print(f"  n={n}: c2r(r2c(x)) vs x rel err {rel:.3e}")
        del x, spec, back
        torch.cuda.empty_cache()
    for kernel, count in launches.items():
        check(count > 0, f"{kernel} was never launched on the main path")
    return launches


def phase5_serving(gen: torch.Generator) -> dict[str, int]:
    """Serve SERVE_WAVES waves of C2C and R2C requests through
    FFTService(TESLA_V100) on cuda:0; returns the phase's launches."""
    rng = np.random.default_rng(SEED)
    xc = rng.standard_normal((4096, 8192), dtype=np.float32).view(
        np.complex64)                               # (4096, 4096) complex64
    xr = rng.standard_normal((8192, 4096), dtype=np.float32)
    device = torch.device("cuda", 0)
    refs = {"c2c": torch.fft.fft(torch.from_numpy(xc).to(device)),
            "r2c": torch.fft.rfft(torch.from_numpy(xr).to(device))}
    expected_kernel = {"c2c": "fft-c2c", "r2c": "fft-r2c"}
    execute_s: list[float] = []

    def timed_plan(n, kind="c2c"):
        """The plan, its function timed to the end of its device work."""
        plan = plan_for_length(n, kind)

        def fn(x, _fn=plan.fn):
            t0 = time.perf_counter()
            y = _fn(x)
            torch.cuda.synchronize(device)
            execute_s.append(time.perf_counter() - t0)
            return y
        return dataclasses.replace(plan, fn=fn)

    svc = FFTService(TESLA_V100, devices=[device], plan_fn=timed_plan)
    stack_s: list[float] = []
    stack = svc._stack

    def timed_stack(batch, device):
        t0 = time.perf_counter()
        x = stack(batch, device)
        stack_s.append(time.perf_counter() - t0)
        return x

    svc._stack = timed_stack
    K.reset_launches()
    for wave in range(SERVE_WAVES):
        hits, misses = svc.cache.stats.hits, svc.cache.stats.misses
        del execute_s[:], stack_s[:]
        reqs = [(svc.submit(np.roll(xc, i, axis=0)), "c2c", i)
                for i in range(SERVE_REQUESTS)]
        reqs += [(svc.submit(np.roll(xr, i, axis=0), transform="r2c"), "r2c",
                  i) for i in range(SERVE_REQUESTS)]
        t0 = time.perf_counter()
        receipts = svc.drain()
        wall = time.perf_counter() - t0
        check(len(receipts) == len(reqs), f"wave {wave}: "
              f"{len(receipts)} receipts for {len(reqs)} requests")
        worst = 0.0
        for (req, kind, i), r in zip(reqs, receipts):
            check(r.request is req, f"wave {wave}: receipts out of order")
            _, rel = rel_err(r.result, torch.roll(refs[kind], i, 0))
            check(rel <= PLAN_RTOL["stockham"],
                  f"wave {wave} {kind}: result vs torch.fft rel {rel:.3e}")
            worst = max(worst, rel)
            check(r.clock_mhz <= TESLA_V100.f_max
                  and r.energy_j <= r.boost_energy_j,
                  f"wave {wave} {kind}: clock {r.clock_mhz} MHz, energy "
                  f"{r.energy_j} J vs boost {r.boost_energy_j} J")
            check([rec.kernel for rec in r.launches]
                  == [expected_kernel[kind]],
                  f"wave {wave} {kind}: launches "
                  f"{[rec.kernel for rec in r.launches]}")
        batches = len({r.batch_id for r in receipts})
        stats = svc.cache.stats
        if wave == 0:
            check((stats.misses, stats.plan_builds, stats.sweeps)
                  == (2, 2, 2), f"wave 0: cache {stats}")
        else:
            check(stats.misses == misses and stats.hits - hits == batches,
                  f"wave {wave}: {batches} lookups, cache {stats}")
        lat = latency_summary(r.latency for r in receipts)
        transforms = sum(r.request.batch for r in receipts)
        energy = sum(r.energy_j for r in receipts)
        boost = sum(r.boost_energy_j for r in receipts)
        execute = sum(execute_s)
        print(f"phase 5: wave {wave}: {len(receipts)} requests, {batches} "
              f"batches, {transforms} transforms; drain {wall * 1e3:.1f} "
              f"ms = stack and copy to the card {sum(stack_s) * 1e3:.1f} "
              f"ms + execute {execute * 1e3:.1f} ms + the rest "
              f"{(wall - execute - sum(stack_s)) * 1e3:.1f} ms; "
              f"{transforms / wall:.1f} transforms/s; latency p50 "
              f"{lat.p50 * 1e3:.1f} ms p99 {lat.p99 * 1e3:.1f} ms; V100 "
              f"model {energy / transforms:.4e} J/transform, I_ef "
              f"{boost / energy:.4f}; max rel err {worst:.3e}; cache "
              f"{stats}")
    launches = dict(K.LAUNCHES)
    check(launches["fft_r2c"] > 0 and launches["fft_c2c"] > 0,
          f"serving launched {launches}")
    rep = svc.report()
    print(f"phase 5: report: {rep.n_requests} requests, {rep.n_batches} "
          f"batches, {rep.clock_locks} clock locks, "
          f"{rep.throughput_tps:.1f} transforms/s over execution, "
          f"J/transform {rep.joules_per_transform:.4e}, I_ef "
          f"{rep.i_ef:.4f}; launches {launches}")
    del svc, refs
    torch.cuda.empty_cache()
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
    phase3_real_kernels(gen, measured)
    launches = phase4_main_path(gen)
    for kernel, count in phase5_serving(gen).items():
        launches[kernel] += count
    kernels = []
    for name in KERNELS:
        row = measured[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
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
