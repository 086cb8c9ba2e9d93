"""Quickstart: the paper's result in seconds, on the PyTorch/CUDA port.

1. Run a batch of each swept length through the port's FFT plans on the
   device, against ``torch.fft``.
2. Sweep the V100 clock grid for a batched FFT (the paper's experiment).
3. Find the optimal and mean-optimal clocks (Table 3).
4. Apply the same machinery to an LLM decode step on the H100 SXM (bf16
   tensor-core peak), the card the port runs on.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises where
there is none.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (TESLA_V100, FFTCase, fft_workload,
                              mean_optimal, roofline_workload, sweep)
from repro_torch.core.hardware import H100_SXM_BF16
from repro_torch.fft.plan import plan_for_length
from repro_torch.models.api import resolve_device

LOG_LENGTHS = range(10, 21, 2)
BATCH = 2


def main(argv=None) -> dict:
    """Print the three parts; return the sweeps and the mean optimum."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. the transform itself, on the device -------------------------
    print(f"=== One batch of each length through the port's plans on "
          f"{device} ===")
    rng = np.random.default_rng(0)
    for logn in LOG_LENGTHS:
        n = 2**logn
        x = torch.from_numpy((rng.standard_normal((BATCH, n))
                              + 1j * rng.standard_normal((BATCH, n))
                              ).astype(np.complex64)).to(device)
        y = plan_for_length(n)(x)
        want = torch.fft.fft(x)
        err = float((y - want).abs().max() / want.abs().max())
        print(f"  N=2^{logn:<3} ({BATCH}, {n}) against torch.fft: max error "
              f"{err:.2e} of the largest |value|")

    # --- 2. the paper's measurement, analytically -----------------------
    print("\n=== FFT DVFS sweep on the V100 (paper Secs. 4-5) ===")
    sweeps = []
    for logn in LOG_LENGTHS:
        case = FFTCase(n=2**logn)
        res = sweep(fft_workload(case, TESLA_V100), TESLA_V100)
        sweeps.append(res)
        print(f"  N=2^{logn:<3} optimal={res.optimal.f:7.1f} MHz "
              f"({100*res.optimal_frequency_frac:5.1f}% of boost)  "
              f"power cut {100*res.power_reduction:4.1f}%  "
              f"slowdown {100*res.slowdown:5.2f}%  "
              f"I_ef {res.i_ef_boost:.2f}")

    # --- 3. Table 3: one clock for all lengths ---------------------------
    mo = mean_optimal(sweeps, TESLA_V100)
    print(f"\n  mean optimal clock = {mo.f_mean:.0f} MHz "
          f"(paper: 945 MHz); using it loses {mo.loss_pp:.1f} pp of I_ef")

    # --- 4. the same technique on an LLM decode step on the H100 ---------
    dev = H100_SXM_BF16
    print(f"\n=== The technique applied to an LLM decode step ({dev.name}) "
          f"===")
    # a memory-bound decode: weights + KV cache reads dominate
    prof = roofline_workload(
        "llm-decode", dev,
        hlo_flops=2 * 4e9 * 128,          # 4B params, 128 sequences
        hbm_bytes=4e9 * 2 + 40e9,         # weights bf16 + 40 GB cache read
        issue_efficiency=0.75)
    res = sweep(prof, dev, time_budget=0.10)
    print(f"  bound: memory   optimal={res.optimal.f:.0f} MHz "
          f"({100*res.optimal.f/dev.f_max:.0f}% of boost)")
    print(f"  predicted power cut {100*res.power_reduction:.0f}% "
          f"at {100*res.slowdown:.1f}% slowdown  (I_ef {res.i_ef_boost:.2f})")
    return {"sweeps": sweeps, "mean_optimal": mo, "decode": res}


if __name__ == "__main__":
    main()
