"""Batched serving driver: prefill + greedy decode loop with a DVFS clock
plan (the counterpart of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 8 --prompt-len 512 --gen 32 --dvfs-report
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --reduced --device cpu

It runs on the card (``--device cuda``, the default) and raises where
there is none unless ``--device cpu`` is given.  ``--dvfs-report`` prints
the per-phase (prefill vs decode) clock plan of the paper's DVFS model,
priced on the H100 SXM record with its bf16 tensor-core peak.

:func:`generate` runs the reference's loop as it is, faults included:
  * the cache is padded by ``gen`` slots after prefill, and every decode
    step writes its token at the last slot, at position S - 1, and
    attends every slot, the zero padding too; so each token after the
    first is not the model's greedy continuation (see ROADMAP.md);
  * unlike the reference, which pads the first axis of each cache leaf
    whose length equals ``prompt_len`` (an SSM state's head axis or a
    layer axis when they happen to match), the port pads only the
    sequence axes that ``cache_shapes`` names: the axes whose length
    differs between ``cache_shapes(batch, p)`` and ``(batch, p + 1)``.
    That gives the reference's result wherever the reference runs.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.dvfs import SweepResult, sweep
from repro_torch.core.hardware import H100_SXM_BF16, DeviceSpec
from repro_torch.core.perf_model import WorkloadProfile
from repro_torch.core.scheduler import (DVFSScheduler, PipelineReport,
                                        Stage)
from repro_torch.core.workloads import roofline_workload
from repro_torch.models.api import Model, build_model, resolve_device
from repro_torch.models.common import tree_map


def _grow(a: torch.Tensor, short, long, gen: int) -> torch.Tensor:
    """Pad ``a`` by ``gen`` zero slots on each axis where the two cache
    specs differ (the sequence axes)."""
    for ax, (m, n) in enumerate(zip(short.shape, long.shape)):
        if m != n:
            pad = list(a.shape)
            pad[ax] = gen
            a = torch.cat([a, a.new_zeros(pad)], dim=ax)
    return a


def grow_cache(model: Model, cache, batch: int, prompt_len: int, gen: int):
    """The prefilled cache grown by ``gen`` slots on its sequence axes."""
    return tree_map(lambda a, s, l: _grow(a, s, l, gen), cache,
                    model.cache_shapes(batch, prompt_len),
                    model.cache_shapes(batch, prompt_len + 1))


def generate(model: Model, params, prompt: torch.Tensor, gen: int
             ) -> torch.Tensor:
    """The reference's serving loop: prefill, grow the cache by ``gen``
    slots, then ``gen - 1`` greedy decode steps.  Returns the (B, gen)
    tokens on the prompt's device."""
    batch, prompt_len = prompt.shape[:2]
    logits, cache = model.prefill(params, prompt)
    cache = grow_cache(model, cache, batch, prompt_len, gen)
    tok = logits[:, -1, :].argmax(-1)[:, None]
    generated = [tok]
    for _ in range(gen - 1):
        logits, cache = model.decode(params, cache, tok)
        tok = logits[:, -1, :].argmax(-1)[:, None]
        generated.append(tok)
    return torch.cat(generated, dim=1)


def seeded_prompt(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    """The prompt ``main`` serves: embeddings for an embeds-input model,
    else tokens, drawn from a generator seeded with 1."""
    gen = torch.Generator(device=device).manual_seed(1)
    if cfg.input_mode == "embeds":
        return torch.randn((batch, prompt_len, cfg.d_model), generator=gen,
                           device=device)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=device)


def dvfs_report(arch: str, batch: int, prompt_len: int, gen: int,
                dev: DeviceSpec = H100_SXM_BF16
                ) -> tuple[list[tuple[WorkloadProfile, SweepResult]],
                           PipelineReport]:
    """The reference's analytic per-phase profiles of the full config
    (bf16 weights read once a step; decode adds the KV cache of
    ``prompt_len + gen`` tokens), each swept on ``dev``, and the serve
    pipeline at each phase's optimal clock."""
    full = get_arch(arch)
    nbytes = full.param_count() * 2
    prefill_prof = roofline_workload(
        "prefill", dev,
        hlo_flops=2 * full.param_count() * batch * prompt_len,
        hbm_bytes=nbytes, issue_efficiency=0.8)
    cache_bytes = (full.n_layers * 2 * full.n_kv_heads
                   * full.resolved_head_dim * (prompt_len + gen) * batch * 2)
    decode_prof = roofline_workload(
        "decode", dev, hlo_flops=2 * full.param_count() * batch,
        hbm_bytes=nbytes + cache_bytes, issue_efficiency=0.8)
    phases = [(prof, sweep(prof, dev)) for prof in (prefill_prof,
                                                    decode_prof)]
    plan = [Stage(prof, res.optimal.f) for prof, res in phases]
    return phases, DVFSScheduler(dev).evaluate_pipeline(plan)


def main(argv=None, *, params=None, prompt=None) -> np.ndarray:
    """Serve one batch and return the (batch, gen) generated tokens.

    ``params`` and ``prompt``, when given, replace the seeded ones (for
    example weights carried across with
    ``models.convert.params_from_reference``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--dvfs-report", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device)
    if prompt is None:
        prompt = seeded_prompt(cfg, args.batch, args.prompt_len, device)

    with torch.inference_mode():
        out = generate(model, params, prompt.to(device), args.gen)
    out = out.cpu().numpy()
    print(f"[serve] generated {out.shape} tokens; first row: {out[0][:12]}")

    if args.dvfs_report:
        phases, rep = dvfs_report(args.arch, args.batch, args.prompt_len,
                                  args.gen)
        for prof, res in phases:
            print(f"[dvfs] {prof.name}: bound={prof.regime(H100_SXM_BF16)!r}"
                  f" optimal={res.optimal.f:.0f} MHz, "
                  f"power cut {100*res.power_reduction:.0f}%, "
                  f"slowdown {100*res.slowdown:.1f}%")
        print(f"[dvfs] serve pipeline I_ef={rep.i_ef:.2f} "
              f"(slowdown {100*rep.slowdown:.1f}%)")
    return out


if __name__ == "__main__":
    main()
