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


def _group_size(tokens: int, cfg: MoEConfig) -> int:
    """The tokens a group: ``group_size``, halved until it divides the
    step's ``tokens``."""
    gs = min(cfg.group_size, tokens)
    while tokens % gs:
        gs //= 2
    return gs


def _dispatch(params, tg: torch.Tensor, cfg: MoEConfig, *,
              valid: torch.Tensor | None = None,
              offset: torch.Tensor | None = None,
              experts: slice | None = None):
    """Route the (G, Tg, d) groups ``tg`` and run the experts: (their
    combined output (G, Tg, d), the router's probabilities (G, Tg, E),
    the top-k experts (G, Tg, K), the one-hot (G, Tg, K, E) of the routed
    pairs).  ``valid`` (G, Tg): the tokens to route, the others neither
    take a capacity position nor reach an expert; ``offset`` (G, E): the
    positions of each group's experts that tokens before these took;
    ``experts``: the experts to run (``params``' expert weights are
    theirs), whose share of the combine the output then is."""
    g, gs, d = tg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(int(gs * k / e * cfg.capacity_factor), k)

    logits = torch.einsum("gtd,de->gte", tg.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)                 # (G, Tg, E)
    topv, topi = torch.topk(probs, k, dim=-1)             # (G, Tg, K)
    topv = topv / topv.sum(-1, keepdim=True)

    # Capacity positions: cumulative count of each expert along the group.
    onehot = F.one_hot(topi, e)                           # (G, Tg, K, E)
    if valid is not None:
        onehot = onehot * valid[..., None, None]
    pos = onehot.reshape(g, gs * k, e).cumsum(1) - 1      # position per slot
    if offset is not None:
        pos = pos + offset[:, None, :]
    slot = (pos.reshape(g, gs, k, e) * onehot).sum(-1)    # (G, Tg, K)
    keep = slot < cap
    if valid is not None:
        keep = keep & valid[..., None]
    gate = topv * keep

    # Dispatch tensor (G, Tg, E, C) — the GShard one-hot pair.  A dropped
    # pair's slot is ``cap``, whose one-hot column is cut away.
    slot_oh = F.one_hot(torch.where(keep, slot, cap), cap + 1)[..., :cap]
    expert_oh = onehot.to(tg.dtype)
    disp = (expert_oh[..., None] * slot_oh.to(tg.dtype)[..., None, :]
            ).sum(2)                                      # (G, Tg, E, C)
    if experts is not None:
        disp = disp[:, :, experts]
    expert_in = torch.einsum("gtec,gtd->egcd", disp, tg)  # (E, G, C, d)

    h = F.silu(torch.einsum("egcd,edf->egcf", expert_in, params["w_gate"])
               ) * torch.einsum("egcd,edf->egcf", expert_in, params["w_up"])
    expert_out = torch.einsum("egcf,efd->egcd", h, params["w_down"])

    combine = (gate[..., None, None] * expert_oh[..., None]
               * slot_oh.to(tg.dtype)[..., None, :])
    combine = combine.sum(2).to(tg.dtype)                 # (G, Tg, E, C)
    if experts is not None:
        combine = combine[:, :, experts]
    out = torch.einsum("gtec,egcd->gtd", combine, expert_out)
    return out, probs, topi, onehot


def _shared(params, tg: torch.Tensor) -> torch.Tensor:
    """The shared experts on every token."""
    sh = F.silu(tg @ params["shared_gate"]) * (tg @ params["shared_up"])
    return sh @ params["shared_down"]


def moe_block(params, x: torch.Tensor, cfg: MoEConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    gs = _group_size(b * s, cfg)
    tg = tokens.reshape(-1, gs, d)                        # (G, Tg, d)
    e = cfg.n_experts
    out, probs, topi, _ = _dispatch(params, tg, cfg)

    # Switch aux loss: fraction-of-tokens x mean router prob per expert.
    frac = F.one_hot(topi[..., 0], e).float().mean((0, 1))
    aux = e * (frac * probs.mean((0, 1))).sum()

    if "shared_gate" in params:
        out = out + _shared(params, tg)
    return out.reshape(b, s, d), aux


def moe_block_slots(params, xs: list[torch.Tensor], cfg: MoEConfig, line,
                    routing, layer: int):
    """``moe_block`` of one data replica on its model slots (``line``, a
    ``fft.distributed.MeshLine``; ``params`` a tree of
    ``models.common.Slots``, ``xs`` slot m's tokens at index m, the same
    on every slot): (the output on each slot, the mean router
    probability a expert over the replica's tokens, on slot 0, and the
    fraction of its tokens whose first expert each is, without a
    gradient).

    Every slot routes the replica's tokens alike.  With the experts split
    over ``model`` (expert parallelism) slot m runs its E/M experts, and
    its share of the combine, plus its shared experts' partial sum (or,
    on slot 0, the whole shared experts), is all-reduced once over the
    line; else every slot runs every expert.  The groups are those of
    the whole step's tokens (``routing``: ``group_size``, ``lead``, the
    tokens of the replica's first group that earlier replicas hold, and
    ``offset(layer)`` / ``report(layer, counts)``, the capacity positions
    those tokens took, handed from replica to replica), so a group may
    begin before the replica's first token or end after its last: those
    positions are padding, routed nowhere.  Expert FFNs work row by row,
    so whether a pair is kept is all the offset changes."""
    b, s, d = xs[0].shape
    t = b * s
    e, m_size = cfg.n_experts, line.size
    gs, lead = routing.group_size, routing.lead
    n = -(-(lead + t) // gs)                              # groups touched
    pad = (lead, n * gs - lead - t)
    valid = None
    if any(pad):
        valid = torch.zeros(n * gs, dtype=torch.bool, device=xs[0].device)
        valid[lead:lead + t] = True
        valid = valid.reshape(n, gs)
    offsets = routing.offset(layer)
    split = params["w_gate"].split
    shared = "shared_gate" in params
    reduce = split or (shared and params["shared_down"].split)
    outs, counts = [], []
    for m, x in enumerate(xs):
        p = {k: v[m] for k, v in params.items()}
        tg = x.reshape(t, d)
        if any(pad):
            tg = F.pad(tg, (0, 0, *pad))
        tg = tg.reshape(n, gs, d)
        off = None
        if offsets is not None:
            off = torch.zeros((n, e), dtype=torch.long, device=x.device)
            off[0] = offsets[m]
        width = e // m_size
        out, probs, topi, onehot = _dispatch(
            p, tg, cfg, valid=None if valid is None else valid.to(x.device),
            offset=off,
            experts=slice(m * width, (m + 1) * width) if split else None)
        if reduce and not split and m:
            out = torch.zeros_like(out)       # the whole experts: slot 0's
        if shared and (params["shared_down"].split or not reduce or m == 0):
            out = out + _shared(p, tg)
        outs.append(out.reshape(n * gs, d)[lead:lead + t].reshape(b, s, d))
        counts.append(onehot.sum((1, 2)))                 # (n, E)
        if m == 0:
            top1 = F.one_hot(topi[..., 0], e).float()
            if valid is None:
                frac, mean_prob = top1.mean((0, 1)), probs.mean((0, 1))
            else:
                mask = valid[..., None].to(probs.dtype)
                frac = (top1 * mask).sum((0, 1)) / t
                mean_prob = (probs * mask).sum((0, 1)) / t
    routing.report(layer, counts)
    if reduce:
        outs = line.all_reduce(outs)
    return outs, mean_prob, frac.detach()
