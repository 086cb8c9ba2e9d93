"""AdamW with decoupled weight decay and global-norm clipping (the
counterpart of ``repro.optim.adamw``, the same arithmetic on trees of
torch tensors: nested dicts and lists, as ``models.common.tree_map``
walks them).

The moments are float32 whatever the parameter's dtype, each update is
computed in float32 and cast back to the leaf's dtype, and decay skips
the leaves with fewer than two axes in the reference's stacked layout (a
stacked norm scale (L, d) is decayed, as in the reference).
``torch.optim.AdamW`` differs on all three counts (bf16 moments for bf16
parameters, no global clip, decay on every leaf).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.common import P, tree_leaves, tree_map
from repro_torch.runtime.checkpoint import tree_dataclass


@tree_dataclass
@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor          # int32, 0-d
    m: Any                      # float32 tree shaped like the params
    v: Any


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(params, grads, state: AdamWState, *,
                 lr: float | torch.Tensor = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float | None = 1.0,
                 grad_norm: torch.Tensor | None = None):
    """-> (new params, new state, global norm of ``grads`` before the
    clip).  The inputs are left as they are.  ``grad_norm``, when given,
    is the global norm to clip by in place of ``grads``' own: a data
    replica's slot updates its shards of the tree by the whole tree's
    norm (``train.sharded``)."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    # A bf16 gradient is cast to float32 before it is scaled: in JAX the
    # bf16 x f32 product promotes to float32, in torch it would stay bf16.
    grads = tree_map(lambda g: g.float(), grads)
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = tree_map(lambda g: g * scale, grads)

    step = state.step + 1
    b1c = 1.0 - b1 ** step.float()
    b2c = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        update = (m2 / b1c) / (torch.sqrt(v2 / b2c) + eps)
        # decoupled decay (skip 1-D params: norms/biases)
        if p.ndim >= 2:
            update = update + weight_decay * p.float()
        return (p.float() - lr * update).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state.m, state.v)
    # ``out`` holds a (param, m, v) triple where ``params`` holds a leaf.
    pick = lambda i: tree_map(lambda _, triple: triple[i], params, out)
    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2)), gnorm


def optimizer_specs(param_specs) -> AdamWState:
    """PartitionSpecs of the optimizer state (m and v mirror the params)."""
    return AdamWState(step=P(), m=param_specs, v=param_specs)
