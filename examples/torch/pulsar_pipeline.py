"""The paper's Sec. 5.3 demonstration, end to end, on the PyTorch/CUDA
port — plus the FDAS stage.

Runs the pulsar-search pipeline (R2C FFT -> power spectrum -> stats ->
harmonic sum -> S/N) on synthetic data with an injected pulsar through
``repro_torch.fft.pipeline.pulsar_pipeline(real_input=True)`` — telescope
voltages are real, so the FFT stage does half the work, on the port's
kernels.  Then the Fourier-Domain Acceleration Search
(``repro_torch.search``) recovers an injected *accelerated* pulsar from
the same voltages, and the per-stage DVFS clock plan of the V100 model
reports the composite energy saving (Table 4).  The noise is drawn from
a seeded ``torch.Generator`` on the device.

Run:  PYTHONPATH=src python examples/torch/pulsar_pipeline.py
      [--device cpu]
"""
import argparse
import math

import numpy as np
import torch

from repro_torch.core.dvfs import sweep
from repro_torch.core.hardware import TESLA_V100
from repro_torch.core.scheduler import DVFSScheduler
from repro_torch.fft.pipeline import (PipelineShape, fft_time_share,
                                      pulsar_pipeline, stage_profiles)
from repro_torch.models.api import resolve_device
from repro_torch.search import TemplateBank, fdas_search


def main(argv=None) -> dict:
    """Run the three parts; return the strongest bin (``peak_bin``) and
    the FDAS candidates."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- run the pipeline on real voltages with an injected pulsar -------
    n, batch = 4096, 4
    t = torch.arange(n, dtype=torch.float32, device=device)
    f0 = 96 / n
    gen = torch.Generator(device=device).manual_seed(0)
    noise = torch.randn((batch, n), generator=gen, device=device)
    pulse = (torch.sin(2 * math.pi * f0 * t) > 0.97).float()
    x = noise + 3.0 * pulse[None, :]

    # R2C route: half the FFT work, n/2+1 bins downstream (Sec. 5.3).
    snr = pulsar_pipeline(x, n_harmonics=16, real_input=True)
    nbins = snr.shape[-1]
    inner = snr[:, :, 1:nbins - 1]
    best = inner.amax(dim=(1, 2)).cpu().numpy()
    peak_bin = int(inner[0].amax(dim=0).argmax()) + 1
    print(f"pulsar injected at bin 96 -> strongest S/N at bin {peak_bin}; "
          f"per-series peak S/N: {np.round(best, 1)}")

    # --- FDAS: recover an injected *accelerated* pulsar ------------------
    s = torch.arange(n, dtype=torch.float64, device=device) / n
    k0, z = 700, 4.0                       # start bin, drift in bins
    accel = (0.4 * torch.cos(2 * math.pi * (k0 * s + 0.5 * z * s * s))
             ).float()
    xa = noise + accel[None, :]
    bank = TemplateBank.linear(zmax=8, n_templates=9)
    res = fdas_search(xa, bank, threshold=8.0, max_candidates=4)
    print(f"\nFDAS: injected drift z={z:+.0f} bins at bin {k0}; "
          f"bank drifts {bank.drifts}")
    c = res.candidates
    rows_by_series = []
    for b in range(batch):
        rows = [(float(bank.drifts[int(ti)]), int(bi), float(p))
                for ti, bi, p in zip(c.template[b].tolist(),
                                     c.bin[b].tolist(), c.power[b].tolist())
                if ti >= 0]
        rows_by_series.append(rows)
        print(f"  series {b}: " + (", ".join(
            f"(z={zz:+.0f}, bin={bi}, P={p:.0f})" for zz, bi, p in rows)
            if rows else "no candidates above threshold"))

    # --- the paper's energy play: lock the FFT stage's clock -------------
    dev = TESLA_V100
    shape = PipelineShape(batch=32, n=2**20, n_harmonics=16, real_input=True)
    profs = stage_profiles(shape, dev)
    share = fft_time_share(shape, dev)
    sched = DVFSScheduler(dev)
    fft_opt = sweep(profs[0], dev).optimal.f
    stages = sched.plan(profs, locked={profs[0].name: fft_opt})
    rep = sched.evaluate_pipeline(stages)
    print(f"\nDVFS plan (V100 model): FFT stage locked to {fft_opt:.0f} MHz")
    for st in rep.stages:
        print(f"  {st.name:<14} f={st.f:7.1f} MHz  t={st.time*1e3:7.2f} ms"
              f"  P={st.power:6.1f} W")
    print(f"FFT time share {100*share:.0f}%  ->  composite I_ef "
          f"{rep.i_ef:.3f} at {100*rep.slowdown:.2f}% slowdown "
          f"(paper Table 4: 1.24-1.29)")

    # the sampled power trace of Fig. 19
    ts, ps, fs = sched.power_trace(stages)
    print(f"power trace: {len(ts)} samples, "
          f"P range [{ps.min():.0f}, {ps.max():.0f}] W, "
          f"clock range [{fs.min():.0f}, {fs.max():.0f}] MHz")
    return {"peak_bin": peak_bin, "fdas": rows_by_series}


if __name__ == "__main__":
    main()
