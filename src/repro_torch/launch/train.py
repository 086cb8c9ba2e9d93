"""End-to-end training driver (the counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 100 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --batch 8 --seq 128 --steps 30 --dvfs-report
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --batch 8 --seq 128 --steps 30 --mesh 4x1
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --batch 8 --seq 128 --steps 8 --mesh 2x2 --dvfs-report

Wires together: config -> model -> train state -> synthetic data ->
fault-tolerant loop (checkpoint/restart) -> DVFS clock plan.  It runs on
the card (``--device cuda``, the default) and raises where there is none
unless ``--device cpu`` is given.

The DVFS integration is the paper's Sec. 5.3 made first-class: the
step's roofline profile (its FLOPs counted by
``torch.utils.flop_counter.FlopCounterMode`` over one step, the
counterpart of the reference's HLO analysis; its bytes the train state
read and written once) decides the energy-optimal clock of the H100 SXM
record with its bf16 tensor-core peak, reported beside the training
metrics.

``--mesh DxM`` is the (data, model) mesh.  ``1x1`` runs the unsharded
step (``train.step``); any other runs the sharded step
(``train.sharded``): ZeRO weight shards over D data replicas, each
taking a D-th of the batch, and tensor and expert parallelism over the
M model slots of each replica, for every architecture (attention and MLP
heads and widths, experts, mamba2's SSM heads; an MoE layer's routing
statistics the whole batch's).  The slots are every visible card when
their count is D M (the reference's ``jax.make_mesh``), else D M slots of
the ``--device`` card, or CPU slots with ``--device cpu``; the launcher
prints them.  A checkpoint holds the gathered state in the reference's
format, so one written on any mesh restores on any other
(``runtime.checkpoint``).  On a mesh, ``--dvfs-report`` prices one
slot's share: the step's FLOPs over D M, the slot's state read and
written, and the step's collective bytes (``Mesh.collective_record``)
by axis, ``model`` at the NVLink rate and ``data`` at the network rate
(``analysis.roofline.NVLINK_BANDWIDTH``, ``NETWORK_BANDWIDTH``; the
roofline's ``RooflineTerms.collective_s``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.roofline import (H100_ROOFLINE, NETWORK_BANDWIDTH,
                                           NVLINK_BANDWIDTH, RooflineTerms)
from repro_torch.configs import get_arch
from repro_torch.core.dvfs import sweep
from repro_torch.core.hardware import H100_SXM_BF16
from repro_torch.core.workloads import roofline_workload
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.fft.distributed import make_mesh
from repro_torch.models.api import build_model, resolve_device
from repro_torch.models.common import tree_leaves
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import FaultTolerantDriver
from repro_torch.train.sharded import (gather_state,
                                       make_sharded_train_step, shard_state,
                                       slot_state)
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_train_step)


def state_bytes(state: TrainState) -> int:
    """Bytes of the parameters, the moments and the step counters."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(
        [state.params, state.opt.m, state.opt.v])) + 8


def step_flops(step_fn, state: TrainState, inp, labels) -> int:
    """FLOPs of one step as ``FlopCounterMode`` counts them (the products
    of the forward, the rematerialised forward and the backward)."""
    with FlopCounterMode(display=False) as counter:
        step_fn(state, inp, labels)
    return counter.get_total_flops()


def parse_mesh(text: str) -> tuple[int, int]:
    """``"DxM"`` -> (D, M)."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DxM, e.g. 4x1") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {text!r}: sizes must be positive")
    return d, m


def mesh_slots(d: int, device: torch.device) -> list[torch.device]:
    """The mesh's ``d`` slots: every visible card when their count is
    ``d``, else ``d`` slots of ``device`` (a card or the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() == d:
        return [torch.device("cuda", i) for i in range(d)]
    return [device] * d


def main(argv=None, *, state: TrainState | None = None,
         log: list | None = None) -> TrainState:
    """Train and return the final state (gathered, on a mesh).

    ``state``, when given, replaces the seeded initial state (for example
    one carried across with ``train.step.state_from_reference``); ``log``,
    when given, receives the driver's metrics rows (``loss``,
    ``grad_norm``, ``lr``, ``wall``, ``step``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh", default="1x1",
                    help="data x model mesh: 1x1, or DxM for D data "
                         "replicas of M model slots")
    ap.add_argument("--dvfs-report", action="store_true",
                    help="print the energy-optimal clock plan for the step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    d, m = parse_mesh(args.mesh)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    mesh = None
    device = resolve_device(args.device)
    if state is None:
        state = init_train_state(
            model, torch.Generator(device=device).manual_seed(0), device)

    if (d, m) == (1, 1):
        train_step = make_train_step(model, microbatches=args.microbatches,
                                     peak_lr=args.lr)
    else:
        mesh = make_mesh((d, m), ("data", "model"),
                         devices=mesh_slots(d * m, device))
        print(f"[train] mesh {args.mesh} (data, model) on slots "
              f"{', '.join(str(s) for s in mesh.devices)}")
        state = shard_state(state, model, mesh)
        train_step = make_sharded_train_step(
            model, mesh, microbatches=args.microbatches, peak_lr=args.lr)

    cards = [s for s in dict.fromkeys(mesh.devices if mesh is not None
                                      else [device]) if s.type == "cuda"]

    def step_fn(st, inp, labels):
        out = train_step(st, inp, labels)
        for card in cards:            # the driver's wall covers the step
            torch.cuda.synchronize(card)
        return out

    ds = SyntheticTokens(cfg.vocab, args.seq, args.batch)

    def data(i):
        b = torch.from_numpy(ds.batch(i)).to(device=device, dtype=torch.long)
        return b[:, :-1], b[:, 1:]

    driver = FaultTolerantDriver(
        train_step=step_fn, state=state, data_iter_fn=data,
        ckpt=CheckpointManager(args.ckpt_dir), ckpt_every=args.ckpt_every,
    )
    final_state, rows, restarts = driver.run(args.steps)
    if log is not None:
        log.extend(rows)
    for mrow in rows[:: max(len(rows) // 20, 1)]:
        print(f"step {mrow['step']:5d}  loss {float(mrow['loss']):.4f}  "
              f"lr {float(mrow['lr']):.2e}  wall {mrow['wall']*1e3:.1f} ms")
    print(f"[train] done: {args.steps} steps, {restarts} restarts, "
          f"final loss {float(rows[-1]['loss']):.4f}")

    if args.dvfs_report:
        # Roofline profile of the step (one slot's share) -> optimal clock.
        device_spec = H100_SXM_BF16
        if mesh is None:
            flops = step_flops(train_step, final_state, *data(0))
            prof = roofline_workload(
                f"train-{cfg.name}", device_spec, hlo_flops=flops,
                hbm_bytes=2 * state_bytes(final_state), issue_efficiency=0.8)
        else:
            mesh.reset_collective_record()
            flops = step_flops(train_step, final_state, *data(0)) / (d * m)
            hbm = 2 * state_bytes(slot_state(final_state, 0))
            by_axis = mesh.collective_totals()[1]
            terms = RooflineTerms(
                arch=cfg.name, shape="train", mesh=args.mesh, chips=d * m,
                hlo_flops=flops, hbm_bytes=hbm,
                collective_bytes=sum(by_axis.values()), model_flops=0.0,
                device=H100_ROOFLINE, network_bytes=by_axis["data"])
            # One link rate prices the profile's collectives: the axes'
            # time as the bytes that take it at the network rate.
            device_spec = dataclasses.replace(
                device_spec, link_bandwidth=NETWORK_BANDWIDTH)
            prof = roofline_workload(
                f"train-{cfg.name}", device_spec, hlo_flops=flops,
                hbm_bytes=hbm,
                collective_bytes=terms.collective_s * NETWORK_BANDWIDTH,
                issue_efficiency=0.8)
            links = ", ".join(
                f"{by_axis[axis]:.0f} B of collectives "
                f"({by_axis[axis] / rate * 1e3:.4f} ms at {rate / 1e9:.0f} "
                f"GB/s) on {axis}"
                for axis, rate in (("data", NETWORK_BANDWIDTH),
                                   ("model", NVLINK_BANDWIDTH))
                if mesh.shape[axis] > 1)
            print(f"[dvfs] one slot of {args.mesh}: {flops:.4e} FLOP "
                  f"({prof.t_compute * 1e3:.4f} ms at the bf16 peak), "
                  f"{hbm} B of state read and written ({prof.t_mem * 1e3:.4f}"
                  f" ms), {links}")
        res = sweep(prof, device_spec)
        print(f"[dvfs] bound={prof.regime(device_spec)!r} "
              f"optimal={res.optimal.f:.0f} MHz "
              f"({100*res.optimal.f/device_spec.f_max:.0f}% of boost), "
              f"power cut {100*res.power_reduction:.0f}%, "
              f"slowdown {100*res.slowdown:.1f}%, I_ef {res.i_ef_boost:.2f}")
    return final_state if mesh is None else gather_state(final_state)


if __name__ == "__main__":
    main()
