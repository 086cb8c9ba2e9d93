"""Dry run of every (arch x shape x mesh) cell on the production mesh (the
counterpart of ``repro.launch.dryrun``), on ``meta`` tensors: no card, no
data, no device memory.

For each cell this produces a JSON artifact with:
  * memory: the argument and output bytes a device holds under the fixed
    spec trees, and whether the cell fits an 80 GB H100;
  * FLOPs and HBM bytes a device (``analysis.cost``);
  * collective bytes a device, by kind and by mesh axis, from the fixed
    spec trees (``analysis.cost.collective_accounting``);
  * MODEL_FLOPS (6*N*D accounting) for the roofline.

The reference lowers and compiles the step SPMD-partitioned and reads its
per-device HLO.  The port's stand-in for the partitioned module: the
step runs once on meta tensors at the batch that the fixed input spec
leaves a device (the global batch over the batch axes it keeps on the
batch dim), and its counts are divided by the ``model`` size and by the
batch axes it moves to the sequence.  A batch axis it drops replicates
the step: each replica runs it whole (``long_500k``'s batch of one).
No HLO text is written.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
      --multi-pod
  python -m repro_torch.launch.dryrun --all   # every cell, both meshes,
                                              # with the roofline table
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.analysis.cost import analyze_step
from repro_torch.analysis.roofline import (dvfs_plan, model_flops_for,
                                           roofline_from_artifact)
from repro_torch.configs import (ARCHS, ShapeSpec, get_arch, get_shape,
                                 shapes_for)
from repro_torch.core.hardware import H100_SXM
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.launch.specs import (fix_sharding, fix_tree, input_specs,
                                      meta)
from repro_torch.models.api import build_model
from repro_torch.models.common import (P, TensorSpec, dtype_of, tree_leaves,
                                       tree_map)
from repro_torch.obs.log import get_logger
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.step import (TrainState, make_train_step,
                                    train_state_specs)

log = get_logger("dryrun")

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

#: The --opt names: the first three change the cell, the last only adds a
#: sharding constraint in the reference, which changes no value here.
OPTS = ("serve_tp_only", "attn_tp_only", "moe_group_128", "moe_seq_combine")
NO_EFFECT = ("moe_seq_combine",)


def mesh_name(mesh) -> str:
    """``"32x8"``, ``"2x32x8"``: the mesh's axis sizes."""
    return "x".join(str(n) for n in mesh.shape.values())


def _state_sds(model) -> TrainState:
    """TensorSpecs of the full TrainState, nothing allocated."""
    params = model.param_shapes()
    f32 = lambda p: TensorSpec(p.shape, torch.float32)
    i32 = TensorSpec((), torch.int32)
    return TrainState(params=params,
                      opt=AdamWState(step=i32, m=tree_map(f32, params),
                                     v=tree_map(f32, params)),
                      step=i32)


def _strip_data_axis(spec_tree):
    """TP-only weights: remove the ZeRO/FSDP 'data' axis from param specs.

    Serving optimisation: at decode there is no optimizer state to shard
    and weights are read every step, so FSDP-style weight sharding only
    buys an all-gather per matmul.  Replicating over 'data' (keeping TP
    over 'model') removes that collective for more HBM a device.
    """
    def fix(s):
        parts = []
        for e in s:
            if e == "data":
                parts.append(None)
            elif isinstance(e, tuple):
                t = tuple(a for a in e if a != "data")
                parts.append(t if t else None)
            else:
                parts.append(e)
        return P(*parts)
    return tree_map(fix, spec_tree)


def _strip_attn(tree):
    """attn_tp_only: the 'attn' subtrees TP-only (no ZeRO sharding)."""
    if isinstance(tree, dict):
        return {k: (_strip_data_axis(v) if k == "attn" else _strip_attn(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_strip_attn(v) for v in tree]
    return tree


def _leaf_pairs(tree, specs) -> list:
    """(leaf, fixed spec) pairs; a TrainState or AdamWState by field."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, TensorSpec):
        return [pair for f in dataclasses.fields(tree)
                for pair in _leaf_pairs(getattr(tree, f.name),
                                        getattr(specs, f.name))]
    return list(zip(tree_leaves(tree), tree_leaves(specs)))


def _device_bytes(tree, specs, mesh) -> int:
    """Bytes a device holds of ``tree`` split by its fixed ``specs``."""
    total = 0.0
    for leaf, spec in _leaf_pairs(tree, specs):
        total += (math.prod(leaf.shape) * leaf.dtype.itemsize
                  / math.prod(mesh.shape[a] for a in spec.axes))
    return int(total)


def _meta_state(state: TrainState) -> TrainState:
    return TrainState(params=tree_map(meta, state.params),
                      opt=AdamWState(step=meta(state.opt.step),
                                     m=tree_map(meta, state.opt.m),
                                     v=tree_map(meta, state.opt.v)),
                      step=meta(state.step))


def _uses(cfg):
    """A weight's uses in one forward: a stacked weight once a layer, the
    shared block of a hybrid once a site, a token-embedding table once
    (not at all for an embeds-input model)."""
    n_sites = cfg.n_layers // max(cfg.shared_attn_every, 1)

    def uses(path: str, shape: tuple) -> int:
        if path == "embed":
            return 0 if cfg.input_mode == "embeds" else 1
        if path.startswith("shared_attn/"):
            return n_sites
        return math.prod(shape[:-2])
    return uses


def _local_input(cfg, batch: int, seq: int) -> torch.Tensor:
    if cfg.input_mode == "embeds":
        return meta(TensorSpec((batch, seq, cfg.d_model), dtype_of(cfg)))
    return meta(TensorSpec((batch, seq), torch.long))


def lower_cell(arch: str, shape_name, *, multi_pod: bool = False,
               opts: tuple[str, ...] = (), mesh=None) -> dict:
    """Count one cell on the meta production mesh (or on ``mesh``);
    returns its artifact.  ``shape_name`` names a shape of the registry,
    or is a ``ShapeSpec``."""
    unknown = set(opts) - set(OPTS)
    if unknown:
        raise ValueError(f"unknown --opt {sorted(unknown)}; have {OPTS}")
    cfg = get_arch(arch)
    if "moe_group_128" in opts and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, group_size=128))
    shape = (shape_name if isinstance(shape_name, ShapeSpec)
             else get_shape(shape_name))
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    model = build_model(cfg)
    specs = input_specs(cfg, shape, mesh)

    b, s = shape.global_batch, shape.seq_len
    # The fixed input spec places the batch axes: those on the batch dim
    # give the step's batch, those moved to the sequence split its work
    # further, and those dropped replicate it (each replica runs it whole).
    _, in_spec = specs["token" if shape.kind == "decode" else "inputs"]
    size = lambda axes: math.prod(mesh.shape[a] for a in axes)
    first = in_spec[0] if len(in_spec) else None
    on_batch = (() if first is None
                else (first,) if isinstance(first, str) else tuple(first))
    moved = [a for a in batch_axes(mesh)
             if a in in_spec.axes and a not in on_batch]
    run_b = b // size(on_batch)
    per_device = 1 / (mesh.shape["model"] * size(moved))
    seq = s if shape.kind in ("train", "prefill") else 1
    tokens = run_b * seq / size(moved)     # one data replica's tokens

    if shape.kind == "train":
        state = _state_sds(model)
        sspecs = train_state_specs(model)
        if "attn_tp_only" in opts:
            # attention weights TP-only (no ZeRO sharding): more optimizer
            # memory a device for no FSDP weight all-gathers
            sspecs = TrainState(
                params=_strip_attn(sspecs.params),
                opt=AdamWState(step=sspecs.opt.step,
                               m=_strip_attn(sspecs.opt.m),
                               v=_strip_attn(sspecs.opt.v)),
                step=sspecs.step)
        fixed = fix_tree(state, sspecs, mesh)
        params, pfixed = state.params, fixed.params
        fn = make_train_step(model)
        args = (_meta_state(state), _local_input(cfg, run_b, s),
                meta(TensorSpec((run_b, s), torch.long)))
        arg_bytes = (_device_bytes(state, fixed, mesh)
                     + sum(_device_bytes(t, sp, mesh)
                           for t, sp in specs.values()))
        out_bytes = _device_bytes(state, fixed, mesh) + 3 * 4
    else:
        params = model.param_shapes()
        pspecs = model.param_specs()
        if "serve_tp_only" in opts:
            pspecs = _strip_data_axis(pspecs)
        pfixed = fix_tree(params, pspecs, mesh)
        logits = (TensorSpec((b, 1, cfg.vocab), torch.float32),
                  fix_sharding((b, 1, cfg.vocab), P(batch_axes(mesh)), mesh))
        cache = input_specs(cfg, dataclasses.replace(shape, kind="decode"),
                            mesh)["cache"]
        cache_bytes = _device_bytes(*cache, mesh)
        local_params = tree_map(meta, params)
        if shape.kind == "prefill":
            fn = model.prefill
            args = (local_params, _local_input(cfg, run_b, s))
            arg_bytes = _device_bytes(*specs["inputs"], mesh)
        else:
            fn = model.decode
            args = (local_params,
                    tree_map(meta, model.cache_shapes(run_b, s)),
                    _local_input(cfg, run_b, 1))
            arg_bytes = (_device_bytes(*specs["token"], mesh) + cache_bytes)
        arg_bytes += _device_bytes(params, pfixed, mesh)
        out_bytes = _device_bytes(*logits, mesh) + cache_bytes

    t0 = time.monotonic()
    with torch.inference_mode(shape.kind != "train"):
        cost = analyze_step(
            fn, *args, mesh=mesh, params=params, specs=pfixed,
            kind=shape.kind, tokens=tokens,
            act_bytes=dtype_of(cfg).itemsize,
            top_k=cfg.moe.top_k if cfg.moe is not None else 0,
            uses=_uses(cfg))
    t_lower = time.monotonic() - t0

    # Scan-carry residency estimate (the reference's): per-layer hidden
    # saved for backward, sharded per the sequence-parallel activation
    # sharding (batch x seq over the whole mesh).
    if shape.kind == "train":
        carry_est = cfg.n_layers * b * s * cfg.d_model * 2 / chips
    else:
        carry_est = 0.0
    # train state / decode cache outputs are donated (alias their input
    # buffers), so arguments + scan carries bound the persistent footprint
    fits = (arg_bytes + carry_est) * 1.15 < H100_SXM.memory_bytes
    artifact = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name(mesh),
        "chips": int(chips), "kind": shape.kind,
        "flops_per_device": cost["flops"] * per_device,
        "hbm_bytes_per_device": cost["bytes"] * per_device,
        "collective_bytes_per_device": cost["collective_bytes"],
        "collective_breakdown": cost["collectives"],
        "collective_by_axis": cost["collective_by_axis"],
        "model_flops": model_flops_for(cfg, shape),
        "step_batch": run_b,
        "step_flops": cost["flops"],            # the meta step's own count
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "scan_carry_estimate": int(carry_est),
            "fits_80gb": bool(fits),
        },
        "lower_s": round(t_lower, 2),
    }
    if opts:
        artifact["opts"] = sorted(opts)
        artifact["opts_without_effect"] = sorted(set(opts) & set(NO_EFFECT))
    return artifact


def cell_tag(arch: str, shape_name: str, multi_pod: bool,
             opts=()) -> str:
    tag = f"{arch}__{shape_name}__{'2x32x8' if multi_pod else '32x8'}"
    return tag + ("__" + "+".join(sorted(opts)) if opts else "")


def run_one(arch, shape_name, multi_pod, out_dir, opts=()) -> str:
    """Write one cell's artifact; returns its path."""
    art = lower_cell(arch, shape_name, multi_pod=multi_pod, opts=tuple(opts))
    os.makedirs(out_dir, exist_ok=True)
    tag = cell_tag(arch, shape_name, multi_pod, opts)
    path = os.path.join(out_dir, tag + ".json")
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    log.info("lowered", tag=tag,
             args_gb=art["memory"]["argument_bytes"] / 1e9,
             fits=art["memory"]["fits_80gb"],
             flops_per_dev=art["flops_per_device"],
             coll_per_dev=art["collective_bytes_per_device"],
             lower_s=art["lower_s"])
    return path


def report_row(path: str) -> str:
    """One cell's roofline row and DVFS plan, as a line of text."""
    t = roofline_from_artifact(path)
    r = t.row()
    plan = dvfs_plan(t)
    with open(path) as f:
        art = json.load(f)
    return (f"{t.arch} {t.shape} {t.mesh}: compute {r['compute_ms']} ms, "
            f"memory {r['memory_ms']} ms, collective {r['collective_ms']} "
            f"ms, bound {r['bound']}, useful {r['useful_ratio']}, mfu "
            f"{r['mfu_roofline']}; fits_80gb {art['memory']['fits_80gb']} "
            f"(args {art['memory']['argument_bytes'] / 1e9:.2f} GB); dvfs "
            f"opt {plan.optimal.f:.0f} MHz, power cut "
            f"{100 * plan.power_reduction:.0f}%, slowdown "
            f"{100 * plan.slowdown:.1f}%")


def run_all(out_dir: str) -> list[str]:
    """Every cell on both meshes, in this process (meta holds no device
    state); prints each cell's roofline row and DVFS plan.  A cell whose
    artifact exists is read, not counted again.  Returns the failed
    cells' tags."""
    t0 = time.monotonic()
    failures = []
    for cfg in ARCHS.values():
        for shp in shapes_for(cfg):
            for mp in (False, True):
                tag = cell_tag(cfg.name, shp.name, mp)
                path = os.path.join(out_dir, tag + ".json")
                try:
                    if not os.path.exists(path):
                        run_one(cfg.name, shp.name, mp, out_dir)
                    print(report_row(path), flush=True)
                except Exception:               # one cell; go on
                    failures.append(tag)
                    log.error("cell-failed", tag=tag,
                              error=traceback.format_exc())
    print(f"[dryrun] {len(failures)} failures "
          f"({','.join(failures) or '-'}); wall time "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS))
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    ap.add_argument("--opt", action="append", default=[], choices=OPTS,
                    help="enable a named optimisation (repeatable)")
    args = ap.parse_args(argv)
    if args.all:
        return 1 if run_all(args.out) else 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    path = run_one(args.arch, args.shape, args.multi_pod, args.out, args.opt)
    print(report_row(path))
    return 0


if __name__ == "__main__":
    sys.exit(main())
