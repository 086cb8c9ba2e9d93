#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. build every CUDA kernel of the port from ``src/repro_torch/csrc``
     (the three libraries ``fft_c2c``, ``fft_real`` and ``transpose``,
     one ``nvcc`` each, in parallel);
  2. print the card's name and power limit (``nvidia-smi``);
  3. hold each kernel (the C2C variants: fft_c2c, fft_c2c_t with and
     without twiddle, fft_c2c_axis1 with and without twiddle, forward and
     inverse; fft_r2c, fft_c2r; fft_r2c_t, transpose and fft_c2c_mul)
     against its plain torch version on the card, at small shapes and at
     the shapes the main path gives it; time the kernel, the plain
     version and, where one call computes the same function, that
     PyTorch call;
  4. drive the main path — ``plan_for_length(n)(x)`` on a 2 GB batch
     (``FFTCase(n).n_fft`` transforms) for n = 1024, 8192, 2**20 and
     19321 = 139**2, then ``plan_for_length(n, "r2c")`` and ``"c2r"`` on
     2 GB real batches for n = 1024, 16384 and 2**20, then the N-D plan
     graphs ``fft2``/``rfft2``/``fftn`` on 2 GB batches — with every
     launch count set to 0 just before each run and read just after;
     check the ledger and the launch counts, compare with ``torch.fft``,
     time it, and price it with the DVFS model;
  5. run ``fdas_search`` on 4 series of 2**22 points with the 85-template
     bank (counts set to 0 just before, read just after): recover the
     injected accelerated tone, hold one row's power plane against a
     direct ``torch.fft`` oracle, check the ledger, and time its stages;
  6. serve two waves of C2C, R2C, rank-2 and FDAS requests through
     ``repro_torch.serving.FFTService`` on the card (counts set to 0
     before the phase and read after); check every result against its
     own reference, the receipts and the plan/sweep cache;
  7. print the ``kernels`` JSON line, then the final ``{"ok": true, ...}``.

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
from repro_torch.fft import multidim  # noqa: E402
from repro_torch.fft.convolve import device_filter_spectra  # noqa: E402
from repro_torch.fft.plan import fft_mul, plan_for_length, pow2_fft  # noqa: E402
from repro_torch.fft.plan_nd import plan_nd  # noqa: E402
from repro_torch.fft.radix import (DEFAULT_RADICES,  # noqa: E402
                                   mixed_radix_flop_count, r2c_flop_count)
from repro_torch.kernels.common import build_all  # noqa: E402
from repro_torch.kernels.fft import fft_kernel as K  # noqa: E402
from repro_torch.kernels.fft import ops  # noqa: E402
from repro_torch.kernels.fft.ref import fft_ref, irfft_ref, rfft_ref  # noqa: E402
from repro_torch.obs.ledger import LaunchLedger  # noqa: E402
from repro_torch.obs.metrics import latency_summary  # noqa: E402
from repro_torch.search import (TemplateBank, extract_candidates,  # noqa: E402
                                fdas_conv_plan, fdas_search, power_plane,
                                serving_candidates)
from repro_torch.serving import KIND_FDAS, FFTService  # noqa: E402

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
#: N-D plans at 2 GB a batch: (label, function, input shape, complex input,
#: ledger counts, rtol against torch.fft).  The last is the paper's
#: Bluestein length on the last axis of a 2-D transform.
ND_CASES = (
    ("fft2 (16, 4096, 4096)", "fft2", (16, 4096, 4096), True,
     {"fft-c2c-t": 2}, 2e-5),
    ("rfft2 (16, 4096, 8192)", "rfft2", (16, 4096, 8192), False,
     {"fft-r2c-t": 1, "fft-c2c-t": 1}, 2e-5),
    ("fftn (2, 512, 512, 512)", "fftn", (2, 512, 512, 512), True,
     {"fft-c2c-t": 3}, 2e-5),
    ("fft2 (13, 1024, 19321)", "fft2", (13, 1024, 19321), True,
     {"fft-c2c-axis1": 2, "fft-c2c-t": 3, "transpose": 1}, 1e-4),
)
#: FDAS phase: 4 series of 2**22 points, the linear bank over z in
#: [-42, 42] (85 templates of 100 taps), one tone injected in row 0 as
#: benchmarks/run.py injects it at n = 8192 (amplitude 0.25 in noise of
#: 0.5), its start bin scaled to n, its drift (6 bins) kept in the bank.
FDAS_ROWS = 4
FDAS_N = 2**22
FDAS_ZMAX = 42
FDAS_K0 = 1200 * FDAS_N // 8192
FDAS_Z = 6.0
FDAS_RTOL = 1e-4
FDAS_LEDGER = {"fft-c2c-axis1": 1, "fft-c2c-t": 1, "fft-c2c-mul": 1,
               "fft-c2c": 1}
LEDGER_TO_KERNEL = {"fft-c2c": "fft_c2c", "fft-c2c-t": "fft_c2c_t",
                    "fft-c2c-axis1": "fft_c2c_axis1", "fft-r2c": "fft_r2c",
                    "fft-c2r": "fft_c2r", "fft-r2c-t": "fft_r2c_t",
                    "transpose": "transpose", "fft-c2c-mul": "fft_c2c_mul"}
KERNELS = ("fft_c2c", "fft_c2c_t", "fft_c2c_axis1", "fft_r2c", "fft_c2r",
           "fft_r2c_t", "transpose", "fft_c2c_mul")
SOURCES = {
    "fft_c2c": "src/repro_torch/csrc/fft_c2c.cu",
    "fft_c2c_t": "src/repro_torch/csrc/fft_c2c.cu",
    "fft_c2c_axis1": "src/repro_torch/csrc/fft_c2c.cu",
    "fft_r2c": "src/repro_torch/csrc/fft_real.cu",
    "fft_c2r": "src/repro_torch/csrc/fft_real.cu",
    "fft_r2c_t": "src/repro_torch/csrc/fft_real.cu",
    "transpose": "src/repro_torch/csrc/transpose.cu",
    "fft_c2c_mul": "src/repro_torch/csrc/fft_c2c.cu",
}
REPLACES = {
    "fft_c2c": "src/repro/kernels/fft/fft_kernel.py:360",
    "fft_c2c_t": "src/repro/kernels/fft/fft_kernel.py:413",
    "fft_c2c_axis1": "src/repro/kernels/fft/fft_kernel.py:515",
    "fft_r2c": "src/repro/kernels/fft/fft_kernel.py:386",
    "fft_c2r": "src/repro/kernels/fft/fft_kernel.py:606",
    "fft_r2c_t": "src/repro/kernels/fft/fft_kernel.py:547",
    "transpose": "src/repro/kernels/fft/fft_kernel.py:577",
    "fft_c2c_mul": "src/repro/kernels/fft/fft_kernel.py:243",
}
#: Serving phase: each wave submits 16 requests per stream, (4096, 4096)
#: complex64 and (8192, 4096) float32, about 2.1 GB of each, just over the
#: 2 GB batch budget, so each stream coalesces into two batches.  Request i
#: is one seeded payload rolled by i rows, so that every request's result
#: differs and a result handed to the wrong request fails its check.  Each
#: wave also submits SERVE_2D rank-2 requests of (8, 2048, 2048) complex64
#: (rolled the same way; 2.1 GB, two batches) and SERVE_FDAS FDAS requests
#: of one 2**20-point series each (85 templates), each with its own tone.
#: Wave 0 adds one 1-D request of 2**22 points, the 2-D key's total, which
#: must be a cache entry of its own.
SERVE_REQUESTS = 16
SERVE_2D = 8
SERVE_FDAS = 4
SERVE_FDAS_N = 2**20
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
        lib_contiguous = True
        if tw is None:
            # The library call must compute the kernel's function.
            y_lib = lib()
            _, lib_rel = rel_err(y_lib, y)
            check(tuple(y_lib.shape) == tuple(y.shape)
                  and lib_rel <= PLAN_RTOL["stockham"],
                  f"{name} {shape}: {lib_call} differs, rel {lib_rel:.3e}")
            lib_contiguous = y_lib.is_contiguous()
            lib_call += (f" (rel diff {lib_rel:.3e}, output contiguous "
                         f"{lib_contiguous})")
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
        lib_note = (lib_call + _contiguous_note(lib, lib_contiguous)
                    if tw is None else
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


def _timed_row(name: str, shape, fn, plain, lib, lib_call: str | None,
               yardstick: str | None, nbytes: float, flops: float,
               compare) -> dict:
    """Check ``fn`` against ``plain`` (and the library call against the
    kernel with ``compare``), time all three, print and return the row."""
    y = fn()
    y_plain = plain()
    abs_err, rel = rel_err(y, y_plain)
    check(compare(y, y_plain, rel, KERNEL_RTOL),
          f"{name} {shape}: kernel vs plain rel err {rel:.3e}")
    del y_plain
    torch.cuda.empty_cache()
    note, lib_contiguous = "", True
    if lib_call is not None:
        y_lib = lib()
        _, lib_rel = rel_err(y_lib, y)
        check(tuple(y_lib.shape) == tuple(y.shape)
              and compare(y_lib, y, lib_rel, PLAN_RTOL["stockham"]),
              f"{name} {shape}: {lib_call} differs, rel {lib_rel:.3e}")
        lib_contiguous = y_lib.is_contiguous()
        note = (f"{lib_call} (rel diff {lib_rel:.3e}, output contiguous "
                f"{lib_contiguous})")
        del y_lib
    del y
    torch.cuda.empty_cache()
    ms = median_ms(fn)
    plain_ms = median_ms(plain, reps=3)
    lib_ms = median_ms(lib)
    library_ms = lib_ms if lib_call is not None else None
    if lib_call is None:
        note = f"no single call; {yardstick} alone {lib_ms:.4f} ms"
    else:
        note += _contiguous_note(lib, lib_contiguous)
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"  {name} {tuple(shape)}: {ms:.4f} ms ({nbytes / ms / 1e6:.1f} "
          f"GB/s), bound {bound_ms:.4f} ms ({bound_by}), plain "
          f"{plain_ms:.4f} ms, library "
          f"{library_ms if library_ms is None else round(library_ms, 4)} ms "
          f"[{note}], max abs err {abs_err:.3e} (rel {rel:.3e})")
    return {"name": name, "shape": list(shape), "twiddle": False,
            "max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _contiguous_note(lib, contiguous: bool) -> str:
    """The library call timed again with ``.contiguous()`` when it
    returns a strided view: the kernel writes the packed layout, which the
    view leaves unwritten, so only this time covers the same store."""
    if contiguous:
        return ""
    ms = median_ms(lambda: lib().contiguous())
    return f"; with .contiguous() {ms:.4f} ms"


def _close(a, b, rel, rtol) -> bool:
    return rel <= rtol


def _equal(a, b, rel, rtol) -> bool:
    return bool(torch.equal(a, b))


def phase3_nd_kernels(gen: torch.Generator, results: dict[str, dict]) -> None:
    """fft_r2c_t, transpose and fft_c2c_mul against their plain versions
    (ragged shapes, every element width, a bank larger than shared
    memory), then timed at the main path's shapes; adds one row per
    kernel to ``results``."""
    checked = 0
    worst = 0.0
    for c, rows in ((4, 1001), (64, 1001), (1024, 37), (8192, 13),
                    (16384, 5)):
        for radices in ((4, 2), (8, 4, 2)):
            x = torch.randn(3, rows, c, device="cuda", generator=gen)
            _, rel = rel_err(ops.fft_kernel_r2c_t(x, radices=radices),
                             K.fft_r2c_t_plain(x, radices=radices))
            check(rel <= KERNEL_RTOL, f"fft_r2c_t c={c} rows={rows} "
                  f"radices={radices}: rel err {rel:.3e}")
            worst = max(worst, rel)
            checked += 1
    for dtype in (torch.float32, torch.complex64, torch.complex128):
        for shape in ((3, 37, 45), (2, 1, 100), (2, 100, 1), (1, 1000, 33)):
            x = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
            check(torch.equal(ops.transpose_kernel(x), K.transpose_plain(x)),
                  f"transpose {shape} {dtype}: not exact")
            checked += 1
    for n, t, rows in ((2048, 85, 37), (64, 1, 1001), (8192, 9, 5)):
        x, bank = randn(gen, rows, n), randn(gen, t, n)
        for inverse in (False, True):
            _, rel = rel_err(ops.fft_kernel_c2c_mul(x, bank, inverse=inverse),
                             K.fft_c2c_mul_plain(x, bank, inverse=inverse))
            check(rel <= KERNEL_RTOL, f"fft_c2c_mul n={n} T={t} rows={rows} "
                  f"inverse={inverse}: rel err {rel:.3e}")
            worst = max(worst, rel)
            checked += 1
    torch.cuda.synchronize()
    print(f"phase 3: {checked} N-D/FDAS kernel-vs-plain checks, max relative "
          f"error {worst:.3e} (limit {KERNEL_RTOL}; transposes exact)")

    # fft_r2c_t at the first pass of rfft2 (16, 4096, 8192).
    b, r, c = 16, 4096, 8192
    m = c // 2
    x = torch.randn(b, r, c, device="cuda", generator=gen)
    twr, _ = K.stage_tables(m, DEFAULT_RADICES, x.device)
    results["fft_r2c_t"] = _timed_row(
        "fft_r2c_t", (b, r, c), lambda: ops.fft_kernel_r2c_t(x),
        lambda: K.fft_r2c_t_plain(x),
        lambda: torch.fft.rfft(x.transpose(1, 2), dim=-2),
        "torch.fft.rfft(x.transpose(1, 2), dim=-2)", None,
        4 * b * r * c + 8 * b * (m + 1) * r + twr.numel() * 8 + (m + 1) * 8,
        r2c_flop_count(c, DEFAULT_RADICES, batch=b * r), _close)
    del x
    torch.cuda.empty_cache()
    # transpose at the Bluestein fft2's transpose node (13, 1024, 19321).
    x = randn(gen, 13, 1024, 19321)
    results["transpose"] = _timed_row(
        "transpose", tuple(x.shape), lambda: ops.transpose_kernel(x),
        lambda: K.transpose_plain(x),
        lambda: x.transpose(-1, -2).contiguous(),
        "x.transpose(-1, -2).contiguous()", None, 2 * 8 * x.numel(), 0.0,
        _equal)
    del x
    torch.cuda.empty_cache()
    # fft_c2c_mul at the FDAS forward pass: 4 rows x 1077 segments of 2048
    # points against the 85-template bank.
    n, t = 2048, 2 * FDAS_ZMAX + 1
    x, bank = randn(gen, FDAS_ROWS * 1077, n), randn(gen, t, n)
    twr, _ = K.stage_tables(n, DEFAULT_RADICES, x.device)
    rows = x.shape[0]
    results["fft_c2c_mul"] = _timed_row(
        "fft_c2c_mul", (rows, t, n), lambda: ops.fft_kernel_c2c_mul(x, bank),
        lambda: K.fft_c2c_mul_plain(x, bank), lambda: torch.fft.fft(x),
        None, "torch.fft.fft(x) (the FFT, no multiply)",
        8 * n * (rows + t + rows * t) + twr.numel() * 8,
        mixed_radix_flop_count(n, batch=rows) + 6 * rows * t * n, _close)
    del x, bank
    torch.cuda.empty_cache()


def phase3_rows_per_block(gen: torch.Generator) -> None:
    """The transposed-write kernels at the N-D plans' widest rows, timed
    with 1, 2 and 3 rows per block (the heuristic's 64 KB budget gives
    one): each row's output bins are written R apart, so one row a block
    stores 8-byte runs.  Each variant is checked against one row a block."""
    for name, shape, points in (("fft_c2c_t", (16, 4096, 4096), 4096),
                                ("fft_r2c_t", (16, 4096, 8192), 4096)):
        if name == "fft_c2c_t":
            x = randn(gen, *shape)
            launch = lambda p: K.fft_c2c_t(x, per_block=p)  # noqa: E731
        else:
            x = torch.randn(*shape, device="cuda", generator=gen)
            launch = lambda p: K.fft_r2c_t(x, per_block=p)  # noqa: E731
        y1 = launch(1)
        times = []
        for per_block in (1, 2, 3):
            check(K.transforms_per_block(points, shape[1], per_block)
                  == per_block, f"{name}: {per_block} rows do not fit")
            if per_block > 1:
                _, rel = rel_err(launch(per_block), y1)
                check(rel <= KERNEL_RTOL, f"{name} {shape} {per_block} rows "
                      f"a block: rel err {rel:.3e}")
            ms = median_ms(lambda: launch(per_block))
            times.append(f"{per_block} rows {ms:.4f} ms")
        print(f"  {name} {shape} rows per block: " + ", ".join(times))
        del x, y1
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
    for label, fn_name, shape, is_complex, expected, rtol in ND_CASES:
        kind = "c2c" if is_complex else "r2c"
        dims = tuple(range(1, len(shape)))
        user_fn = getattr(multidim, fn_name)
        # The entry point a user calls (multidim.fft2/rfft2/fftn), with the
        # plan graph it builds for its accounting.
        plan = dataclasses.replace(
            plan_nd(shape[1:], kind),
            fn=lambda v, _fn=user_fn, _dims=dims: _fn(v, axes=_dims))
        if is_complex:
            x = randn(gen, *shape)
            ref_fn = (lambda v, _d=dims: torch.fft.fftn(v, dim=_d))
            nbytes = 16 * x.numel()
        else:
            x = torch.randn(*shape, device="cuda", generator=gen)
            ref_fn = (lambda v, _d=dims: torch.fft.rfftn(v, dim=_d))
            nbytes = 4 * x.numel() + 8 * (x.numel() // shape[-1]) * (
                shape[-1] // 2 + 1)
        y = _drive(label, plan, x, expected, ref_fn, lambda: ref_fn(x),
                   nbytes, FFTCase(shape=shape[1:], transform=kind), rtol,
                   launches)
        print(f"  {label}: nodes {[nd.op for nd in plan.nodes]}, passes "
              f"{plan.passes} (per-axis chain {plan.chain_passes})")
        del x, y
        torch.cuda.empty_cache()
    return launches


def _fdas_series(gen: torch.Generator) -> torch.Tensor:
    """FDAS_ROWS noise series on the card, the accelerated tone in row 0."""
    x = 0.5 * torch.randn(FDAS_ROWS, FDAS_N, device="cuda", generator=gen)
    s = torch.arange(FDAS_N, device="cuda", dtype=torch.float64) / FDAS_N
    x[0] += (0.25 * torch.cos(2 * np.pi * (FDAS_K0 * s
                                           + 0.5 * FDAS_Z * s * s))).float()
    return x


def _fdas_oracle_plane(spec: torch.Tensor, bank: TemplateBank
                       ) -> torch.Tensor:
    """The matched-filter plane of one (1, nbins) spectrum by a direct
    pad-to-full-length torch.fft convolution (the reference's test
    oracle)."""
    nbins = spec.shape[-1]
    taps = torch.from_numpy(bank.time_domain()).to(spec.device,
                                                   torch.complex64)
    m = 1 << (nbins + bank.taps - 2).bit_length()
    full = torch.fft.ifft(torch.fft.fft(spec, m) * torch.fft.fft(taps, m))
    return full[:, bank.offset:bank.offset + nbins]


def _fdas_stages(x: torch.Tensor, bank: TemplateBank) -> tuple:
    """fdas_search's steps one by one, each timed with CUDA events: returns
    (stage name -> ms, power plane).  The same calls as fdas_search and
    overlap_save_conv, in the same order."""
    plan = fdas_conv_plan(x.shape[-1], bank)
    taps, nfft, step, nseg = bank.taps, plan.nfft, plan.step, plan.n_segments
    names = ("r2c", "forward+multiply", "inverse", "trim", "power", "top-k")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    ev[0].record()
    xm = x - x.mean(dim=-1, keepdim=True)
    spectrum = plan_for_length(x.shape[-1], "r2c")(xm)
    ev[1].record()
    nbins = spectrum.shape[-1]
    spectra = device_filter_spectra(bank.key, bank.time_domain(), nfft,
                                    x.device)
    total = (nseg - 1) * step + nfft
    xp = torch.nn.functional.pad(spectrum,
                                 (taps - 1, total - (taps - 1) - nbins))
    prod = fft_mul(xp.unfold(-1, nfft, step), spectra)
    ev[2].record()
    y = pow2_fft(prod, inverse=True)
    ev[3].record()
    del prod
    valid = y[..., taps - 1:].movedim(-3, -2)
    mf = valid.reshape(*valid.shape[:-2], nseg * step)[
        ..., bank.offset:bank.offset + nbins]
    ev[4].record()
    del y
    sigma2 = (spectrum.real ** 2 + spectrum.imag ** 2).mean(
        dim=-1, keepdim=True)[..., None]
    power = power_plane(mf, sigma2)
    ev[5].record()
    extract_candidates(power)
    ev[6].record()
    ev[6].synchronize()
    return ({name: ev[i].elapsed_time(ev[i + 1])
             for i, name in enumerate(names)}, power)


def phase5_fdas(gen: torch.Generator) -> dict[str, int]:
    """fdas_search on FDAS_ROWS series of FDAS_N points with the linear
    85-template bank; returns the run's launches."""
    bank = TemplateBank.linear(zmax=FDAS_ZMAX)
    plan = fdas_conv_plan(FDAS_N, bank)
    check((bank.n_templates, bank.taps) == (85, 100)
          and (plan.nfft, plan.step, plan.n_segments) == (2048, 1949, 1077),
          f"FDAS plan {plan}")
    x = _fdas_series(gen)
    ledger = LaunchLedger()
    K.reset_launches()
    with ledger.capture():
        res = fdas_search(x, bank)
    torch.cuda.synchronize()
    run = dict(K.LAUNCHES)
    counts = ledger.counts()
    check(counts == FDAS_LEDGER, f"fdas: ledger {counts} != {FDAS_LEDGER}")
    for ledger_name, count in counts.items():
        kernel = LEDGER_TO_KERNEL[ledger_name]
        check(run[kernel] == count, f"fdas: {kernel} launched {run[kernel]} "
              f"times, the ledger says {count}")
    (inverse,) = [r for r in ledger.records if r.kernel == "fft-c2c"]
    planes = FDAS_ROWS * plan.n_segments * bank.n_templates
    check(inverse.shape == (planes, plan.nfft),
          f"fdas: inverse launch {inverse.shape}, want ({planes}, "
          f"{plan.nfft}): one launch for all T planes")
    nbins = FDAS_N // 2 + 1
    check(tuple(res.power.shape) == (FDAS_ROWS, bank.n_templates, nbins)
          and bool(torch.isfinite(res.power).all()), "fdas: bad power plane")
    power0 = res.power[0]
    t_hit, b_hit = divmod(int(power0.argmax()), nbins)
    t_want = int(np.argmin(np.abs(np.array(bank.drifts) - FDAS_Z)))
    top = (int(res.candidates.template[0, 0]), int(res.candidates.bin[0, 0]))
    check(t_hit == t_want and abs(b_hit - FDAS_K0) <= 1 and top == (t_hit,
                                                                    b_hit),
          f"fdas: tone found at (template {t_hit}, bin {b_hit}), top "
          f"candidate {top}; injected at (template {t_want}, bin {FDAS_K0})")
    # One row's plane against the direct oracle, both from torch.fft's
    # spectrum of the row; then the served power plane end to end.
    xm = x[:1] - x[:1].mean(dim=-1, keepdim=True)
    spec = torch.fft.rfft(xm)
    want = _fdas_oracle_plane(spec, bank)
    from repro_torch.search import matched_filter_plane
    _, plane_rel = rel_err(matched_filter_plane(spec, bank)[0], want)
    check(plane_rel <= FDAS_RTOL,
          f"fdas: plane vs direct oracle rel err {plane_rel:.3e}")
    sigma2 = (spec.abs() ** 2).mean()
    _, power_rel = rel_err(power0, want.abs() ** 2 / sigma2)
    check(power_rel <= FDAS_RTOL,
          f"fdas: power plane vs direct oracle rel err {power_rel:.3e}")
    del want, spec
    torch.cuda.empty_cache()
    ms = median_ms(lambda: fdas_search(x, bank), reps=5)
    stage_runs = []
    for _ in range(3):
        stages, power = _fdas_stages(x, bank)
        stage_runs.append(stages)
    _, stage_rel = rel_err(power, res.power)
    check(stage_rel <= 1e-6, f"fdas: staged run differs, rel {stage_rel:.3e}")
    del power
    torch.cuda.empty_cache()
    stages = {k: statistics.median(r[k] for r in stage_runs)
              for k in stage_runs[0]}
    split = device_breakdown(lambda: fdas_search(x, bank))
    busy = sum(split.values())
    print(f"phase 5: fdas {FDAS_ROWS} x {FDAS_N} points, "
          f"{bank.n_templates} templates of {bank.taps} taps, nfft "
          f"{plan.nfft}, step {plan.step}, {plan.n_segments} segments; "
          f"ledger {counts}, inverse launch shape {inverse.shape}; tone at "
          f"(template {t_hit}, bin {b_hit}), power {float(power0.max()):.1f};"
          f" plane vs oracle rel {plane_rel:.3e}, power rel "
          f"{power_rel:.3e}; search {ms:.4f} ms (median of 5)")
    print("  fdas stages (ms, median of 3 staged runs): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f}")
    print("  fdas device time by kernel (ms, one profiled run): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
          + f"; busy {busy:.4f} of {ms:.4f} ms timed "
          f"(idle share {max(0.0, 1 - busy / ms):.3f})")
    del x, res
    torch.cuda.empty_cache()
    return run


def phase6_serving(gen: torch.Generator) -> dict[str, int]:
    """Serve SERVE_WAVES waves of C2C, R2C, rank-2 and FDAS requests
    through FFTService(TESLA_V100) on cuda:0; returns the phase's
    launches."""
    rng = np.random.default_rng(SEED)
    xc = rng.standard_normal((4096, 8192), dtype=np.float32).view(
        np.complex64)                               # (4096, 4096) complex64
    xr = rng.standard_normal((8192, 4096), dtype=np.float32)
    x2 = rng.standard_normal((8, 2048, 4096), dtype=np.float32).view(
        np.complex64)                               # (8, 2048, 2048)
    x1 = rng.standard_normal((2, 2 * 2048 * 2048), dtype=np.float32).view(
        np.complex64)                               # (2, 2**22): 1-D
    s = np.arange(SERVE_FDAS_N) / SERVE_FDAS_N
    # FDAS request i: its own tone (start bin, drift in the bank) in noise.
    tones = [(50000 + 40000 * i, float(4 * i - 6)) for i in range(SERVE_FDAS)]
    xf = [(0.25 * np.cos(2 * np.pi * (k0 * s + 0.5 * z * s * s))
           + 0.5 * rng.standard_normal(SERVE_FDAS_N)).astype(
               np.float32)[None] for k0, z in tones]
    device = torch.device("cuda", 0)
    bank = TemplateBank.linear(zmax=FDAS_ZMAX)
    refs = {"c2c": torch.fft.fft(torch.from_numpy(xc).to(device)),
            "r2c": torch.fft.rfft(torch.from_numpy(xr).to(device)),
            "2d": torch.fft.fft2(torch.from_numpy(x2).to(device))}
    fdas_refs = [serving_candidates(fdas_search(
        torch.from_numpy(x).to(device), bank)) for x in xf]
    four_step = ["fft-c2c-axis1", "fft-c2c-t"]
    expected_kernels = {"c2c": ["fft-c2c"], "r2c": ["fft-r2c"],
                        "2d": ["fft-c2c-t", "fft-c2c-t"], "1d": four_step,
                        "fdas": four_step + ["fft-c2c-mul", "fft-c2c"]}
    execute_s: list[tuple[str, float]] = []

    def stream_of(key) -> str:
        if key.kind == KIND_FDAS:
            return "fdas"
        if key.shape:
            return "2d"
        return key.transform if key.n == 4096 else "1d"

    svc = FFTService(TESLA_V100, devices=[device])
    build = svc.cache._build

    def timed_build(key):
        """The cache entry, its function timed to the end of its device
        work, by stream."""
        entry = build(key)

        def fn(x, _fn=entry.fn, _stream=stream_of(key)):
            t0 = time.perf_counter()
            y = _fn(x)
            torch.cuda.synchronize(device)
            execute_s.append((_stream, time.perf_counter() - t0))
            return y
        entry.fn = fn
        return entry

    svc.cache._build = timed_build
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
        reqs += [(svc.submit(np.roll(x2, i, axis=0), ndim=2), "2d", i)
                 for i in range(SERVE_2D)]
        reqs += [(svc.submit(x, kind=KIND_FDAS, templates=bank.n_templates),
                  "fdas", i) for i, x in enumerate(xf)]
        if wave == 0:
            reqs.append((svc.submit(x1), "1d", 0))
        t0 = time.perf_counter()
        receipts = svc.drain()
        wall = time.perf_counter() - t0
        check(len(receipts) == len(reqs), f"wave {wave}: "
              f"{len(receipts)} receipts for {len(reqs)} requests")
        worst = 0.0
        for (req, kind, i), r in zip(reqs, receipts):
            check(r.request is req, f"wave {wave}: receipts out of order")
            if kind == "fdas":
                # Its own unserved search: the same top cell, and the same
                # candidate powers (rows batched together differ from a
                # row alone by rounding only).
                want = fdas_refs[i][0]
                got = r.result[0]
                check(tuple(r.result.shape) == (1, 16, 3)
                      and torch.equal(got[0, :2], want[0, :2]),
                      f"wave {wave} fdas {i}: top cell {got[0, :2].tolist()}"
                      f" != {want[0, :2].tolist()}")
                _, rel = rel_err(got[:, 2].sort().values,
                                 want[:, 2].sort().values)
                check(rel <= 1e-4, f"wave {wave} fdas {i}: candidate powers "
                      f"rel {rel:.3e}")
            else:
                ref = (torch.fft.fft(torch.from_numpy(x1).to(device))
                       if kind == "1d" else torch.roll(refs[kind], i, 0))
                _, rel = rel_err(r.result, ref)
                check(rel <= PLAN_RTOL["stockham"],
                      f"wave {wave} {kind}: result vs torch.fft rel "
                      f"{rel:.3e}")
                del ref
            worst = max(worst, rel)
            check(r.clock_mhz <= TESLA_V100.f_max
                  and r.energy_j <= r.boost_energy_j,
                  f"wave {wave} {kind}: clock {r.clock_mhz} MHz, energy "
                  f"{r.energy_j} J vs boost {r.boost_energy_j} J")
            check([rec.kernel for rec in r.launches]
                  == expected_kernels[kind],
                  f"wave {wave} {kind}: launches "
                  f"{[rec.kernel for rec in r.launches]}")
        batches = len({r.batch_id for r in receipts})
        stats = svc.cache.stats
        if wave == 0:
            check((stats.misses, stats.plan_builds, stats.sweeps)
                  == (5, 5, 5) and len(svc.cache) == 5,
                  f"wave 0: cache {stats}, {len(svc.cache)} entries")
            key2d = reqs[2 * SERVE_REQUESTS][0].shape_key(TESLA_V100.name)
            key1d = reqs[-1][0].shape_key(TESLA_V100.name)
            e2d, e1d = svc.cache.peek(key2d), svc.cache.peek(key1d)
            check(key2d.n == key1d.n and key2d != key1d
                  and e2d is not None and e1d is not None and e2d is not e1d
                  and e2d.plan.algorithm == "plan-graph"
                  and e1d.plan.algorithm == "four-step",
                  f"wave 0: the 2-D and 1-D keys of {key2d.n} points are "
                  f"not distinct entries")
        else:
            check(stats.misses == misses and stats.hits - hits == batches,
                  f"wave {wave}: {batches} lookups, cache {stats}")
        lat = latency_summary(r.latency for r in receipts)
        transforms = sum(r.request.batch for r in receipts)
        energy = sum(r.energy_j for r in receipts)
        boost = sum(r.boost_energy_j for r in receipts)
        execute = sum(dt for _, dt in execute_s)
        print(f"phase 6: wave {wave}: {len(receipts)} requests, {batches} "
              f"batches, {transforms} transforms; drain {wall * 1e3:.1f} "
              f"ms = stack and copy to the card {sum(stack_s) * 1e3:.1f} "
              f"ms + execute {execute * 1e3:.1f} ms + the rest "
              f"{(wall - execute - sum(stack_s)) * 1e3:.1f} ms; "
              f"{transforms / wall:.1f} transforms/s; latency p50 "
              f"{lat.p50 * 1e3:.1f} ms p99 {lat.p99 * 1e3:.1f} ms; V100 "
              f"model {energy / transforms:.4e} J/transform, I_ef "
              f"{boost / energy:.4f}; max rel err {worst:.3e}; cache "
              f"{stats}")
        for kind in ("c2c", "r2c", "2d", "fdas", "1d"):
            mine = [r for (_, k, _), r in zip(reqs, receipts) if k == kind]
            if not mine:
                continue
            kl = latency_summary(r.latency for r in mine)
            service = {r.batch_id: r.service_latency for r in mine}
            execute = sum(dt for k, dt in execute_s if k == kind)
            print(f"  wave {wave} {kind}: {len(mine)} requests in "
                  f"{len(service)} batches, service (stack, copy, execute) "
                  f"{sum(service.values()) * 1e3:.1f} ms, execute "
                  f"{execute * 1e3:.1f} ms, latency p50 {kl.p50 * 1e3:.1f} ms")
    launches = dict(K.LAUNCHES)
    check(all(launches[k] > 0 for k in ("fft_c2c", "fft_r2c", "fft_c2c_t",
                                        "fft_c2c_mul")),
          f"serving launched {launches}")
    rep = svc.report()
    print(f"phase 6: report: {rep.n_requests} requests, {rep.n_batches} "
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
    phase3_nd_kernels(gen, measured)
    phase3_rows_per_block(gen)
    launches = phase4_main_path(gen)
    for phase in (phase5_fdas, phase6_serving):
        for kernel, count in phase(gen).items():
            launches[kernel] += count
    for kernel, count in launches.items():
        check(count > 0, f"{kernel} was never launched on the main path")
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
