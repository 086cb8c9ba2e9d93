"""Zamba2 — Mamba2 backbone with a SHARED attention block
[arXiv:2411.15242] (the counterpart of ``repro.models.zamba2``).

One transformer block's weights are shared across all its application
sites (every ``shared_attn_every`` SSM layers); each site has its own
output projection, and the block reads concat(hidden, original
embedding).

Layout: n_layers = head + n_sites * every (38 = 2 + 6 * 6).  The head
layers run first; then each site runs ``every`` mamba layers and the
shared block.  Each site keeps its own KV cache, stacked as
(n_sites, B, S, KV, hd).  Where autograd records, each site (its mamba
layers and the shared block) is rematerialised in backward, as the
reference's ``jax.checkpoint`` scan body is; the head layers are not.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models import common as cm
from repro_torch.models.common import (SHAPES_ONLY, P, TensorSpec, at_slot,
                                       dense_init, dtype_of, matmul_f32,
                                       remat, rms_norm, rope, stack,
                                       stack_specs, tree_items, tree_map,
                                       unstack)
from repro_torch.models.mamba2 import (init_mamba_block, mamba_block,
                                       mamba_block_slots, mamba_block_specs,
                                       mamba_blocks, mamba_cache_shapes,
                                       mamba_cache_specs, mamba_decode)
from repro_torch.models.transformer import (_attn_slots, _mlp, _positions,
                                            attn_blocks, mlp_blocks)


#: The top-level keys of the parameter tree (the sites' mamba layers and
#: projections) whose leaves are used only inside a rematerialised site
#: (``remat``): the sharded train step (``train.sharded``) all-gathers a
#: sharded one there, and again in the recompute; it gathers every other
#: sharded leaf once.
REMAT_PARAMS = ("site_layers", "site_proj")


def _site_layout(cfg: ArchConfig) -> tuple[int, int]:
    every = cfg.shared_attn_every
    n_sites = cfg.n_layers // every
    head = cfg.n_layers - n_sites * every
    return head, n_sites


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dtype = dtype_of(cfg)
    head, n_sites = _site_layout(cfg)
    every = cfg.shared_attn_every
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dev = gen.device
    blocks = [init_mamba_block(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    stacked = tree_map(lambda x: x.reshape(n_sites, every, *x.shape[1:]),
                       stack(blocks[head:]))
    shared_attn = {
        "ln": torch.zeros(2 * d, dtype=dtype, device=dev),
        "w_q": dense_init(gen, (2 * d, cfg.n_heads * hd), dtype),
        "w_k": dense_init(gen, (2 * d, cfg.n_kv_heads * hd), dtype),
        "w_v": dense_init(gen, (2 * d, cfg.n_kv_heads * hd), dtype),
        "w_o": dense_init(gen, (cfg.n_heads * hd, d), dtype),
        "ln_mlp": torch.zeros(d, dtype=dtype, device=dev),
        "w_gate": dense_init(gen, (d, cfg.d_ff), dtype),
        "w_up": dense_init(gen, (d, cfg.d_ff), dtype),
        "w_down": dense_init(gen, (cfg.d_ff, d), dtype),
    }
    return {
        "embed": dense_init(gen, (cfg.vocab, d), dtype, scale=1.0),
        "head_layers": blocks[:head],
        "site_layers": stacked,
        "shared_attn": shared_attn,
        "site_proj": dense_init(gen, (n_sites, d, d), dtype, scale=0.02),
        "final_norm": torch.zeros(d, dtype=dtype, device=dev),
        "lm_head": dense_init(gen, (d, cfg.vocab), dtype),
    }


def param_shapes(cfg: ArchConfig) -> dict:
    """:class:`TensorSpec` tree of :func:`init_params`, nothing drawn."""
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype),
                    init_params(SHAPES_ONLY, cfg))


def param_specs(cfg: ArchConfig) -> dict:
    head, _ = _site_layout(cfg)
    block = mamba_block_specs(cfg)
    return {
        "embed": cm.spec_embed(),
        "head_layers": [dict(block) for _ in range(head)],
        "site_layers": stack_specs(block, 2),
        "shared_attn": {
            "ln": P(), "w_q": cm.spec_in_proj(), "w_k": cm.spec_in_proj(),
            "w_v": cm.spec_in_proj(), "w_o": cm.spec_out_proj(),
            "ln_mlp": P(), "w_gate": cm.spec_in_proj(),
            "w_up": cm.spec_in_proj(), "w_down": cm.spec_out_proj(),
        },
        "site_proj": P(None, "data", "model"),
        "final_norm": P(),
        "lm_head": P("data", "model"),
    }


def _sites(params, cfg: ArchConfig):
    """Per site: (its ``every`` mamba blocks, its projection)."""
    _, n_sites = _site_layout(cfg)
    every = cfg.shared_attn_every
    return [(unstack(blocks, every), proj) for blocks, proj in zip(
        unstack(params["site_layers"], n_sites),
        params["site_proj"].unbind(0))]


def _qkv(sp, h, emb0, positions, cfg: ArchConfig):
    """The shared block's q, k, v over concat(hidden, embedding)."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    xin = rms_norm(torch.cat([h, emb0], dim=-1), sp["ln"], cfg.norm_eps)
    q = rope((xin @ sp["w_q"]).reshape(b, s, cfg.n_heads, hd), positions,
             cfg.rope_theta)
    k = rope((xin @ sp["w_k"]).reshape(b, s, cfg.n_kv_heads, hd), positions,
             cfg.rope_theta)
    v = (xin @ sp["w_v"]).reshape(b, s, cfg.n_kv_heads, hd)
    return q, k, v


def _shared_out(sp, proj, h, a, cfg: ArchConfig):
    """Residual adds of the shared block after attention output ``a``."""
    b, s, _ = h.shape
    h = h + (a.reshape(b, s, -1) @ sp["w_o"]) @ proj
    y = rms_norm(h, sp["ln_mlp"], cfg.norm_eps)
    return h + (F.silu(y @ sp["w_gate"]) * (y @ sp["w_up"])) @ sp["w_down"]


def _run(params, tokens, cfg: ArchConfig, *, with_cache: bool):
    x = params["embed"][tokens]
    emb0 = x
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    sp = params["shared_attn"]
    head_caches, site_mc, ks, vs = [], [], [], []

    def block(blk, h, caches):
        if not with_cache:
            return mamba_block(blk, h, cfg)
        h, (conv_tail, state) = mamba_block(blk, h, cfg, return_state=True)
        caches.append({"conv": conv_tail, "state": state})
        return h

    def site(blocks, proj, h, mcs):
        for blk in blocks:
            h = block(blk, h, mcs)
        q, k, v = _qkv(sp, h, emb0, positions, cfg)
        return _shared_out(sp, proj, h, attention(q, k, v), cfg), k, v

    for blk in params["head_layers"]:
        x = block(blk, x, head_caches)
    for blocks, proj in _sites(params, cfg):
        if not with_cache:
            x = remat(site, blocks, proj, x, None)[0]
            continue
        mcs: list = []
        x, k, v = site(blocks, proj, x, mcs)
        site_mc.append(stack(mcs))
        ks.append(k)
        vs.append(v)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache = None
    if with_cache:
        cache = {"head": head_caches, "sites_mamba": stack(site_mc),
                 "attn_k": torch.stack(ks), "attn_v": torch.stack(vs)}
    return h, cache


def forward_hidden(params, tokens, cfg: ArchConfig):
    h, _ = _run(params, tokens, cfg, with_cache=False)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def unembed(params, h, cfg: ArchConfig):
    return matmul_f32(h, params["lm_head"])


def forward(params, tokens, cfg: ArchConfig):
    h, aux = forward_hidden(params, tokens, cfg)
    return unembed(params, h, cfg), aux


def prefill_step(params, tokens, cfg: ArchConfig):
    """Forward collecting SSM states + per-site KV caches."""
    h, cache = _run(params, tokens, cfg, with_cache=True)
    return unembed(params, h[:, -1:, :], cfg), cache


def cache_shapes(cfg: ArchConfig, batch: int, seq: int) -> dict:
    head, n_sites = _site_layout(cfg)
    every = cfg.shared_attn_every
    per_mamba = mamba_cache_shapes(cfg, batch)
    kv = TensorSpec((n_sites, batch, seq, cfg.n_kv_heads,
                     cfg.resolved_head_dim), dtype_of(cfg))
    return {
        "head": [dict(per_mamba) for _ in range(head)],
        "sites_mamba": tree_map(
            lambda s: TensorSpec((n_sites, every, *s.shape), s.dtype),
            per_mamba),
        "attn_k": kv, "attn_v": kv,
    }


def cache_specs(cfg: ArchConfig) -> dict:
    head, _ = _site_layout(cfg)
    per = mamba_cache_specs(cfg)
    kv = P(None, "data", None, "model", None)
    return {"head": [dict(per) for _ in range(head)],
            "sites_mamba": stack_specs(per, 2), "attn_k": kv, "attn_v": kv}


def decode_step(params, cache, token, cfg: ArchConfig):
    """One decode step; each site's new key and value go at slot S - 1, at
    position S - 1, of a copy of its cache."""
    x = params["embed"][token]
    emb0 = x
    b = x.shape[0]
    sk = cache["attn_k"].shape[2]
    positions = torch.full((b, 1), sk - 1, dtype=torch.int32,
                           device=x.device)
    every = cfg.shared_attn_every
    _, n_sites = _site_layout(cfg)
    sp = params["shared_attn"]

    new_head = []
    for blk, c in zip(params["head_layers"], cache["head"]):
        x, c2 = mamba_decode(blk, x, c, cfg)
        new_head.append(c2)

    new_k = cache["attn_k"].clone()
    new_v = cache["attn_v"].clone()
    new_sites = []
    for (blocks, proj), mcache, kc, vc in zip(
            _sites(params, cfg), unstack(cache["sites_mamba"], n_sites),
            new_k.unbind(0), new_v.unbind(0)):
        new_mc = []
        for blk, c in zip(blocks, unstack(mcache, every)):
            x, c2 = mamba_decode(blk, x, c, cfg)
            new_mc.append(c2)
        q, k, v = _qkv(sp, x, emb0, positions, cfg)
        kc[:, sk - 1:sk] = k
        vc[:, sk - 1:sk] = v
        x = _shared_out(sp, proj, x, decode_attention(q, kc, vc), cfg)
        new_sites.append(stack(new_mc))

    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, h, cfg), {
        "head": new_head, "sites_mamba": stack(new_sites),
        "attn_k": new_k, "attn_v": new_v}


# ---------------------------------------------------------------------------
# Tensor parallelism: one data replica on its model slots (``train.sharded``
# on a mesh with a ``model`` axis).  The head layers and each site's mamba
# layers run ``mamba2.mamba_block_slots``; the shared block is Megatron's
# layout over concat(hidden, embedding): ``w_q``/``w_k``/``w_v`` and the
# MLP's gate and up column-parallel by attention head and width, ``w_o``
# and ``w_down`` row-parallel, their partial sums all-reduced; each site's
# ``site_proj`` is used whole (its blocks split the residual update's
# columns, which every slot needs whole).
# ---------------------------------------------------------------------------

def tp_blocks(cfg: ArchConfig, params, specs, m: int) -> dict[str, bool]:
    """For each leaf of ``params`` whose fixed spec (``specs``, on a mesh
    with a ``model`` axis of ``m`` slots) names ``model``: whether the
    model slots use their blocks of it (True) or the whole leaf, which
    is all-gathered over ``model`` before use (False): each mamba block's
    ``mamba2.mamba_blocks``, the shared block's attention and MLP
    (``transformer.attn_blocks``, ``mlp_blocks``), ``site_proj`` whole,
    the vocabulary rows of the embedding and ``lm_head``."""
    if m == 1:
        return {}
    major = cm.major_of(params, specs)
    paths = {p for p, _ in tree_items(params)}
    head, _ = _site_layout(cfg)
    out = cm.vocab_blocks(params, major)
    for parent in [f"head_layers/{i}" for i in range(head)] + ["site_layers"]:
        out.update(mamba_blocks(cfg, parent, major, m))
    out.update(attn_blocks(cfg, "shared_attn", paths, major, m))
    out.update(mlp_blocks(cfg, "shared_attn", paths, major, m))
    out["site_proj"] = False
    return cm.naming_model(out, specs)


def _shared_slots(sp, proj, hs: list, emb0: list, positions: list,
                  cfg: ArchConfig, line) -> list:
    """The shared block on the model slots after one site's mamba layers
    (:func:`_qkv` and :func:`_shared_out` on each slot's heads and MLP
    width); ``proj`` the site's projection, whole on every slot."""
    eps = cfg.norm_eps
    ys = [rms_norm(torch.cat([h, e], dim=-1), g, eps)
          for h, e, g in zip(hs, emb0, sp["ln"])]
    a = _attn_slots(sp, ys, positions, cfg, window=None, line=line)
    hs = [h + o @ w for h, o, w in zip(hs, a, proj)]
    ys = [rms_norm(h, g, eps) for h, g in zip(hs, sp["ln_mlp"])]
    f = [_mlp(at_slot(sp, m), y) for m, y in enumerate(ys)]
    if sp["w_down"].split:
        f = line.all_reduce(f)
    return [h + y for h, y in zip(hs, f)]


def forward_loss_slots(params, inp: list, labels: list, cfg: ArchConfig,
                       line, routing=None):
    """The mean token cross-entropy of one data replica over its model
    slots (``line``, a ``fft.distributed.MeshLine``), on slot 0, and no
    MoE statistics: ``models.transformer.forward_loss_slots``' contract
    (``routing`` unused).  Each site is rematerialised, the head layers
    are not, as in :func:`_run`; on one slot the arithmetic is the
    unsharded forward's."""
    xs = cm.embed_slots(params, inp, cfg, line)
    emb0 = xs
    positions = [_positions(x) for x in xs]
    sp = params["shared_attn"]
    for blk in params["head_layers"]:
        xs = mamba_block_slots(blk, xs, cfg, line)

    def site(blocks, proj, hs):
        for blk in blocks:
            hs = mamba_block_slots(blk, hs, cfg, line)
        return _shared_slots(sp, proj, hs, emb0, positions, cfg, line)

    for blocks, proj in _sites(params, cfg):
        xs = remat(site, blocks, proj, xs)
    return cm.lm_loss_slots(params, xs, labels, cfg, line), []
