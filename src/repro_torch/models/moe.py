"""GShard-style top-k mixture of experts (the counterpart of
``repro.models.moe``, the same dispatch in plain torch ops).

Tokens split into groups of ``group_size`` that route independently.
Each expert takes at most ``capacity = max(int(Tg * K / E * cf), K)``
tokens a group; a (token, k) pair's slot is the cumulative count of its
expert along the group, and a pair over capacity is dropped.  Router:
softmax top-k, probabilities renormalised over the selected experts, with
the Switch auxiliary load-balancing loss.  Shared experts (DeepSeek) run
on every token.

``torch.topk`` may order tied probabilities differently from
``jax.lax.top_k``; the slots do not depend on the order within a token
(its K experts differ), the aux loss reads ``topi[..., 0]``.  Router
probabilities are float32, so ties do not occur in practice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import dense_init


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, dtype
             ) -> dict:
    e = cfg.n_experts
    ff = cfg.d_ff_expert
    p = {
        "router": dense_init(gen, (d_model, e), torch.float32),
        "w_gate": dense_init(gen, (e, d_model, ff), dtype),
        "w_up": dense_init(gen, (e, d_model, ff), dtype),
        "w_down": dense_init(gen, (e, ff, d_model), dtype),
    }
    if cfg.n_shared:
        p["shared_gate"] = dense_init(gen, (d_model, ff * cfg.n_shared),
                                      dtype)
        p["shared_up"] = dense_init(gen, (d_model, ff * cfg.n_shared), dtype)
        p["shared_down"] = dense_init(gen, (ff * cfg.n_shared, d_model),
                                      dtype)
    return p


def moe_block(params, x: torch.Tensor, cfg: MoEConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]
    gs = min(cfg.group_size, t)
    while t % gs:
        gs //= 2
    g = t // gs
    tg = tokens.reshape(g, gs, d)                         # (G, Tg, d)
    e, k = cfg.n_experts, cfg.top_k
    cap = max(int(gs * k / e * cfg.capacity_factor), k)

    logits = torch.einsum("gtd,de->gte", tg.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)                 # (G, Tg, E)
    topv, topi = torch.topk(probs, k, dim=-1)             # (G, Tg, K)
    topv = topv / topv.sum(-1, keepdim=True)

    # Switch aux loss: fraction-of-tokens x mean router prob per expert.
    frac = F.one_hot(topi[..., 0], e).float().mean((0, 1))
    aux = e * (frac * probs.mean((0, 1))).sum()

    # Capacity positions: cumulative count of each expert along the group.
    onehot = F.one_hot(topi, e)                           # (G, Tg, K, E)
    pos = onehot.reshape(g, gs * k, e).cumsum(1) - 1      # position per slot
    slot = (pos.reshape(g, gs, k, e) * onehot).sum(-1)    # (G, Tg, K)
    keep = slot < cap
    gate = topv * keep

    # Dispatch tensor (G, Tg, E, C) — the GShard one-hot pair.  A dropped
    # pair's slot is ``cap``, whose one-hot column is cut away.
    slot_oh = F.one_hot(torch.where(keep, slot, cap), cap + 1)[..., :cap]
    expert_oh = onehot.to(x.dtype)
    disp = (expert_oh[..., None] * slot_oh.to(x.dtype)[..., None, :]
            ).sum(2)                                      # (G, Tg, E, C)
    expert_in = torch.einsum("gtec,gtd->egcd", disp, tg)  # (E, G, C, d)

    h = F.silu(torch.einsum("egcd,edf->egcf", expert_in, params["w_gate"])
               ) * torch.einsum("egcd,edf->egcf", expert_in, params["w_up"])
    expert_out = torch.einsum("egcf,efd->egcd", h, params["w_down"])

    combine = (gate[..., None, None] * expert_oh[..., None]
               * slot_oh.to(x.dtype)[..., None, :])
    combine = combine.sum(2).to(x.dtype)                  # (G, Tg, E, C)
    out = torch.einsum("gtec,egcd->gtd", combine, expert_out)

    if "shared_gate" in params:
        sh = F.silu(tg @ params["shared_gate"]) * (tg @ params["shared_up"])
        out = out + sh @ params["shared_down"]
    return out.reshape(b, s, d), aux
