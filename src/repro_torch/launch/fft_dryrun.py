"""Dry run of the paper's own workload on the production mesh (the
counterpart of ``repro.launch.fft_dryrun``): the distributed pencil FFT
(``configs.fft_bench``: batch x n1*n2-point C2C transforms, n1 sharded
over the ``model`` axis) on ``meta`` tensors, with the same artifact keys
as the model cells.

  PYTHONPATH=src python -m repro_torch.launch.fft_dryrun [--multi-pod]

One data replica's share of the batch runs through ``pencil_fft`` over
the mesh's ``model`` axis.  The FFT kernel wrappers take meta tensors
(their shape function: an empty result, a ledger record, no launch), so
the run counts:
  * collective bytes a device: what the mesh's ``collective_bytes``
    counter reads over the run, beside ``pencil_exchange_bytes`` and the
    reference's analytic ``pencil_collective_bytes``;
  * FLOPs: 5 N log2 N a transform, as the reference counts;
  * HBM bytes: the launch ledger's ``bytes_moved`` of the run (the
    kernels' reads and writes; the collectives' copies are the collective
    bytes).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

from repro_torch.configs.fft_bench import CONFIG
from repro_torch.core.hardware import H100_SXM
from repro_torch.fft.distributed import (pencil_collective_bytes,
                                         pencil_exchange_bytes, pencil_fft)
from repro_torch.launch.dryrun import ARTIFACT_DIR, mesh_name
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.obs.ledger import LaunchLedger


def lower_pencil(*, multi_pod: bool, batch: int | None = None) -> dict:
    """Count the pencil of ``batch`` transforms (default ``fft_bench``'s)
    on the meta production mesh; returns its artifact."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    c = CONFIG
    n1, n2 = c.pencil_n1, c.pencil_n2
    b = c.pencil_batch if batch is None else batch
    n = n1 * n2
    d = mesh.shape["model"]
    n_batch = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    if b % n_batch:
        raise ValueError(f"a batch of {b} does not split over the "
                         f"{n_batch} data replicas")
    local = b // n_batch
    x = torch.empty((local, n1, n2), dtype=torch.complex64, device="meta")
    ledger = LaunchLedger()
    mesh.reset_collective_bytes()
    t0 = time.monotonic()
    with ledger.capture():
        pencil_fft(x, mesh, n1=n1, n2=n2, axis="model")
    t_lower = time.monotonic() - t0
    moved = mesh.collective_bytes
    exchange = pencil_exchange_bytes(local, n1, n2, d)
    if moved != exchange:
        raise RuntimeError(f"the pencil's collectives moved {moved} bytes a "
                           f"shard, pencil_exchange_bytes says {exchange}")
    arg_bytes = local * n1 * n2 * 8 // d
    return {
        "arch": "fft-pencil", "shape": f"c2c_{n1}x{n2}_b{b}",
        "mesh": mesh_name(mesh), "chips": mesh.size, "kind": "fft",
        "flops_per_device": 5.0 * n * math.log2(n) * local / d,
        "hbm_bytes_per_device": ledger.total_bytes() / d,
        "collective_bytes_per_device": moved,
        "collective_breakdown": {"all-to-all": moved},
        "collective_by_axis": {"model": moved},
        "collective_bytes_analytic": pencil_collective_bytes(local, n1, n2,
                                                              d),
        "model_flops": 5.0 * n * math.log2(n) * b,
        "step_batch": local,
        "launches": ledger.counts(),
        "memory": {"argument_bytes": arg_bytes,
                   "fits_80gb": bool(arg_bytes * 1.15
                                     < H100_SXM.memory_bytes)},
        "lower_s": round(t_lower, 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)
    art = lower_pencil(multi_pod=args.multi_pod)
    tag = f"fft-pencil__{art['shape']}__{art['mesh']}"
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(art, f, indent=1)
    print(f"[fft-dryrun] {tag}: coll/dev="
          f"{art['collective_bytes_per_device']:.6e} (analytic "
          f"{art['collective_bytes_analytic']:.6e}) flops/dev="
          f"{art['flops_per_device']:.6e} hbm/dev="
          f"{art['hbm_bytes_per_device']:.6e} args="
          f"{art['memory']['argument_bytes'] / 1e9:.3f} GB "
          f"launches={art['launches']} lower={art['lower_s']:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
