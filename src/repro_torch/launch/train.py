"""End-to-end training driver (the counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 100 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --batch 8 --seq 128 --steps 30 --dvfs-report

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

``--mesh`` takes only ``1x1``: the port has no sharded executor yet.  The
sharded train state's specs exist (``train.step.train_state_specs``,
fixed for a mesh by ``launch.specs.fix_tree``; ``launch.dryrun`` prices
them); running it on a mesh is ROADMAP.md queue 1 item 12d.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_arch
from repro_torch.core.dvfs import sweep
from repro_torch.core.hardware import H100_SXM_BF16
from repro_torch.core.workloads import roofline_workload
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.models.api import build_model, resolve_device
from repro_torch.models.common import tree_leaves
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import FaultTolerantDriver
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


def main(argv=None, *, state: TrainState | None = None,
         log: list | None = None) -> TrainState:
    """Train and return the final state.

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
                    help="data x model mesh; only 1x1 until a sharded "
                         "executor (ROADMAP.md queue 1 item 12d)")
    ap.add_argument("--dvfs-report", action="store_true",
                    help="print the energy-optimal clock plan for the step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; running "
            "the sharded train state (train_state_specs) on a mesh is "
            "ROADMAP.md queue 1 item 12d")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if state is None:
        state = init_train_state(
            model, torch.Generator(device=device).manual_seed(0), device)

    train_step = make_train_step(model, microbatches=args.microbatches,
                                 peak_lr=args.lr)

    def step_fn(st, inp, labels):
        out = train_step(st, inp, labels)
        if device.type == "cuda":     # the driver's wall covers the step
            torch.cuda.synchronize(device)
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
        # Roofline profile of the step -> energy-optimal clock.
        flops = step_flops(train_step, final_state, *data(0))
        prof = roofline_workload(
            f"train-{cfg.name}", H100_SXM_BF16, hlo_flops=flops,
            hbm_bytes=2 * state_bytes(final_state), issue_efficiency=0.8)
        res = sweep(prof, H100_SXM_BF16)
        print(f"[dvfs] bound={prof.regime(H100_SXM_BF16)!r} "
              f"optimal={res.optimal.f:.0f} MHz "
              f"({100*res.optimal.f/H100_SXM_BF16.f_max:.0f}% of boost), "
              f"power cut {100*res.power_reduction:.0f}%, "
              f"slowdown {100*res.slowdown:.1f}%, I_ef {res.i_ef_boost:.2f}")
    return final_state


if __name__ == "__main__":
    main()
