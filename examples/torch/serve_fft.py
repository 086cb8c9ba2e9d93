"""Serve a stream of FFT requests with energy-aware batching + DVFS, on
the PyTorch/CUDA port.

Walks the full request lifecycle from docs/serving.md:
enqueue -> batch -> plan-cache -> clock-plan -> execute -> account.
Requests run on the card (the port's kernels) and are priced on the
H100 SXM record.

Run:  PYTHONPATH=src python examples/torch/serve_fft.py [--device cpu]

It serves on the card unless ``--device cpu`` is given, and raises where
there is none.
"""
import argparse

import numpy as np

from repro_torch.core.hardware import H100_SXM
from repro_torch.models.api import resolve_device
from repro_torch.serving import FFTService


def main(argv=None):
    """Serve two waves; return the service (its receipts and report)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    svc = FFTService(H100_SXM, time_budget=0.10,
                     devices=[resolve_device(args.device)])

    # --- enqueue: three clients, two distinct shapes, one tight budget ---
    def payload(batch, n):
        return (rng.standard_normal((batch, n))
                + 1j * rng.standard_normal((batch, n))).astype(np.complex64)

    a = svc.submit(payload(4, 4096))
    b = svc.submit(payload(2, 4096))                       # coalesces with a
    c = svc.submit(payload(3, 1024), latency_budget=0.02)  # tight real-time

    # --- batch -> plan-cache -> clock-plan -> execute -> account ---------
    svc.drain()

    print("=== per-request receipts ===")
    for req in (a, b, c):
        r = svc.receipt(req)
        print(f"  request {req.request_id}: batch#{r.batch_id} "
              f"clock={r.clock_mhz:6.1f} MHz  "
              f"E={r.energy_j*1e6:7.2f} uJ ({r.joules_per_transform*1e6:.2f}"
              f" uJ/fft)  I_ef={r.i_ef_boost:.2f}  "
              f"latency={r.latency*1e3:.1f} ms")

    # A second wave of the same shapes: served entirely from the cache.
    for _ in range(4):
        svc.submit(payload(2, 4096))
    svc.drain()

    rep = svc.report()
    print("\n=== service report ===")
    print(f"  requests={rep.n_requests}  transforms={rep.n_transforms}  "
          f"batches={rep.n_batches}")
    print(f"  plan builds={rep.cache.plan_builds}  sweeps={rep.cache.sweeps}"
          f"  cache hits={rep.cache.hits} (hit rate "
          f"{100*rep.cache.hit_rate:.0f}%)")
    print(f"  joules/transform={rep.joules_per_transform*1e6:.2f} uJ  "
          f"service I_ef={rep.i_ef:.2f}")
    print(f"  p50={rep.p50_latency_s*1e3:.1f} ms  "
          f"p99={rep.p99_latency_s*1e3:.1f} ms  "
          f"clock locks={rep.clock_locks}")
    ts, fs = svc.clock.trace()
    print(f"  clock trace: {len(ts)} events, "
          f"f in [{fs.min():.0f}, {fs.max():.0f}] MHz")
    return svc


if __name__ == "__main__":
    main()
