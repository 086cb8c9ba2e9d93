"""Config-driven decoder-only transformer LM (the counterpart of
``repro.models.transformer``).

Covers the dense (qwen2/codeqwen/qwen1.5), sliding-window (gemma3),
audio-token (musicgen), VLM-backbone (pixtral) and MoE (dbrx,
deepseek-v2-lite with MLA) architectures from one implementation, in the
reference's parameter layout:
  * homogeneous layers are stacked (leading L axis); ``jax.lax.scan``
    over them becomes a Python loop over the stacked axis;
  * gemma3's 5:1 local:global pattern stacks layers as (groups, 6, ...),
    the 6-layer pattern unrolled within a group;
  * deepseek's first dense layer is kept outside the MoE stack.
Where autograd records, each stacked layer (gemma3: each 5:1 group) is
rematerialised in backward, as the reference's ``jax.checkpoint`` scan
bodies are; the dense layers are not, as in the reference.
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
from repro_torch.models.mla import (init_mla, mla_attention, mla_cache_shape,
                                    mla_decode, mla_heads)
from repro_torch.models.moe import init_moe, moe_block, moe_block_slots


#: The top-level key of the parameter tree (the stacked layers) whose
#: leaves are used only inside a rematerialised layer or 5:1 group
#: (``remat``): the sharded train step (``train.sharded``) all-gathers a
#: sharded one there, and again in the recompute; it gathers every other
#: sharded leaf once.
REMAT_PARAMS = ("layers",)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _init_attn(gen, cfg: ArchConfig, dtype) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    p = {
        "w_q": dense_init(gen, (d, cfg.n_heads * hd), dtype),
        "w_k": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "w_v": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "w_o": dense_init(gen, (cfg.n_heads * hd, d), dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("b_q", cfg.n_heads), ("b_k", cfg.n_kv_heads),
                            ("b_v", cfg.n_kv_heads)):
            p[name] = torch.zeros(width * hd, dtype=dtype, device=gen.device)
    return p


def _init_mlp(gen, d: int, ff: int, dtype) -> dict:
    return {
        "w_gate": dense_init(gen, (d, ff), dtype),
        "w_up": dense_init(gen, (d, ff), dtype),
        "w_down": dense_init(gen, (ff, d), dtype),
    }


def _init_layer(gen, cfg: ArchConfig, dtype, *, moe_layer: bool,
                dense_ff: int | None = None) -> dict:
    zeros = torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)
    p: dict = {"ln_attn": zeros, "ln_mlp": zeros.clone()}
    p["attn"] = (init_mla(gen, cfg, dtype) if cfg.mla is not None
                 else _init_attn(gen, cfg, dtype))
    if moe_layer:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.moe, dtype)
    else:
        p["mlp"] = _init_mlp(gen, cfg.d_model, dense_ff or cfg.d_ff, dtype)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """The parameter tree, drawn from ``gen`` on its device."""
    dtype = dtype_of(cfg)
    params: dict = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dtype, scale=1.0),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dtype)
    n_scan = cfg.n_layers - cfg.n_dense_layers
    moe_layer = cfg.moe is not None
    layers = stack([_init_layer(gen, cfg, dtype, moe_layer=moe_layer)
                    for _ in range(n_scan)])
    if cfg.local_per_global:
        group = cfg.local_per_global + 1
        assert n_scan % group == 0, (n_scan, group)
        layers = tree_map(
            lambda x: x.reshape(n_scan // group, group, *x.shape[1:]), layers)
    params["layers"] = layers
    if cfg.n_dense_layers:
        params["dense_layers"] = [
            _init_layer(gen, cfg, dtype, moe_layer=False,
                        dense_ff=cfg.dense_d_ff)
            for _ in range(cfg.n_dense_layers)]
    return params


def param_shapes(cfg: ArchConfig) -> dict:
    """:class:`TensorSpec` tree of :func:`init_params`, nothing drawn."""
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype),
                    init_params(SHAPES_ONLY, cfg))


def param_specs(cfg: ArchConfig) -> dict:
    """:class:`~repro_torch.models.common.PartitionSpec` tree matching
    :func:`init_params` (the reference's specs, leaf for leaf)."""
    if cfg.mla is not None:
        attn_spec = {
            "w_q": cm.spec_in_proj(), "w_dkv": cm.spec_in_proj(),
            "w_krope": P("data", None), "w_uk": P(None, "model"),
            "w_uv": P(None, "model"), "w_o": cm.spec_out_proj()}
    else:
        attn_spec = {
            "w_q": cm.spec_in_proj(), "w_k": cm.spec_in_proj(),
            "w_v": cm.spec_in_proj(), "w_o": cm.spec_out_proj()}
        if cfg.qkv_bias:
            attn_spec.update(b_q=P("model"), b_k=P("model"), b_v=P("model"))

    def layer_spec(moe_layer: bool) -> dict:
        p = {"ln_attn": P(), "ln_mlp": P(), "attn": attn_spec}
        if moe_layer:
            moe = {"router": P("data", None), "w_gate": cm.spec_expert_in(),
                   "w_up": cm.spec_expert_in(),
                   "w_down": cm.spec_expert_out()}
            if cfg.moe.n_shared:
                moe.update(shared_gate=cm.spec_in_proj(),
                           shared_up=cm.spec_in_proj(),
                           shared_down=cm.spec_out_proj())
            p["moe"] = moe
        else:
            p["mlp"] = {"w_gate": cm.spec_in_proj(),
                        "w_up": cm.spec_in_proj(),
                        "w_down": cm.spec_out_proj()}
        return p

    specs: dict = {"embed": cm.spec_embed(), "final_norm": P()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P("data", "model")
    specs["layers"] = stack_specs(layer_spec(cfg.moe is not None),
                                  2 if cfg.local_per_global else 1)
    if cfg.n_dense_layers:
        specs["dense_layers"] = [layer_spec(False)
                                 for _ in range(cfg.n_dense_layers)]
    return specs


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mlp(m, y):
    return (F.silu(y @ m["w_gate"]) * (y @ m["w_up"])) @ m["w_down"]


def _qkv(p, x, positions, cfg: ArchConfig, heads: int, kv_heads: int):
    """The roped queries and keys and the values of ``heads`` query and
    ``kv_heads`` key/value heads (every head, or a model slot's)."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = rope(q.reshape(b, s, heads, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, kv_heads, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, kv_heads, hd)


def _attn_forward(p, x, positions, cfg: ArchConfig, *, window,
                  with_cache: bool = False):
    if cfg.mla is not None:
        return mla_attention(p, x, positions, cfg, with_cache=with_cache)
    b, s, d = x.shape
    q, k, v = _qkv(p, x, positions, cfg, cfg.n_heads, cfg.n_kv_heads)
    out = attention(q, k, v, window=window)
    out = out.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim) @ p["w_o"]
    if with_cache:
        return out, {"k": k, "v": v}
    return out


def _layer_forward(p, x, positions, cfg: ArchConfig, *, window,
                   moe_layer: bool, with_cache: bool = False):
    a = _attn_forward(p["attn"], rms_norm(x, p["ln_attn"], cfg.norm_eps),
                      positions, cfg, window=window, with_cache=with_cache)
    kv = None
    if with_cache:
        a, kv = a
    h = x + a
    y = rms_norm(h, p["ln_mlp"], cfg.norm_eps)
    if moe_layer:
        f, aux = moe_block(p["moe"], y, cfg.moe)
    else:
        f = _mlp(p["mlp"], y)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return h + f, aux, kv


def _stacked(params, cfg: ArchConfig):
    """(layer params, window) of the stacked layers, in order; gemma3's
    (groups, 6, ...) stack as group-major order with its 5:1 windows."""
    layers = params["layers"]
    if cfg.local_per_global:
        group = cfg.local_per_global + 1
        n_groups = (cfg.n_layers - cfg.n_dense_layers) // group
        out = []
        for gp in unstack(layers, n_groups):
            for i, sub in enumerate(unstack(gp, group)):
                win = cfg.sliding_window if i < cfg.local_per_global else None
                out.append((sub, win))
        return out
    n_scan = cfg.n_layers - cfg.n_dense_layers
    return [(lp, cfg.sliding_window or None) for lp in unstack(layers, n_scan)]


def _stack_cache(caches: list, cfg: ArchConfig):
    """Per-layer caches in :func:`_stacked` order -> the reference's stacked
    (L, ...) or (groups, 6, ...) tree."""
    out = stack(caches)
    if cfg.local_per_global:
        group = cfg.local_per_global + 1
        out = tree_map(lambda x: x.reshape(-1, group, *x.shape[1:]), out)
    return out


def _flat_cache(cache, cfg: ArchConfig):
    """The stacked cache viewed as (L, ...) per leaf."""
    if cfg.local_per_global:
        return tree_map(lambda x: x.flatten(0, 1), cache)
    return cache


def embed_input(params, inp, cfg: ArchConfig):
    if cfg.input_mode == "embeds":
        return inp.to(dtype_of(cfg))
    return params["embed"][inp]


def unembed(params, h, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return matmul_f32(h, params["embed"].t())
    return matmul_f32(h, params["lm_head"])


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def _run(params, inp, cfg: ArchConfig, *, with_cache: bool):
    """Embedded input through every layer: (hidden before the final norm,
    aux, per-layer caches of the stack, dense-layer caches)."""
    x = embed_input(params, inp, cfg)
    positions = _positions(x)
    moe_layer = cfg.moe is not None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    dense_caches = []
    for p in params.get("dense_layers", []):
        x, _, kv = _layer_forward(p, x, positions, cfg, window=None,
                                  moe_layer=False, with_cache=with_cache)
        dense_caches.append(kv)
    caches = []
    stacked = _stacked(params, cfg)
    if with_cache:
        for lp, win in stacked:
            x, a, kv = _layer_forward(lp, x, positions, cfg, window=win,
                                      moe_layer=moe_layer, with_cache=True)
            aux_total = aux_total + a
            caches.append(kv)
        return x, aux_total, caches, dense_caches

    def body(layers, h, aux):
        for lp, win in layers:
            h, a, _ = _layer_forward(lp, h, positions, cfg, window=win,
                                     moe_layer=moe_layer)
            aux = aux + a
        return h, aux

    group = cfg.local_per_global + 1 if cfg.local_per_global else 1
    for i in range(0, len(stacked), group):
        x, aux_total = remat(body, stacked[i:i + group], x, aux_total)
    return x, aux_total, caches, dense_caches


def forward_hidden(params, inp, cfg: ArchConfig):
    """(B, S) tokens or (B, S, d) embeds -> final hidden states, aux."""
    x, aux, _, _ = _run(params, inp, cfg, with_cache=False)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def forward(params, inp, cfg: ArchConfig):
    """Full-sequence forward: (B, S) tokens or (B, S, d) embeds -> logits."""
    h, aux = forward_hidden(params, inp, cfg)
    return unembed(params, h, cfg), aux


def prefill_step(params, inp, cfg: ArchConfig):
    """Forward that also materialises the KV cache (serving prefill)."""
    x, _, caches, dense_caches = _run(params, inp, cfg, with_cache=True)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, h[:, -1:, :], cfg)
    out = {"layers": _stack_cache(caches, cfg)}
    if cfg.n_dense_layers:
        out["dense_layers"] = dense_caches
    return logits, out


# ---------------------------------------------------------------------------
# KV-cache decode path
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """:class:`TensorSpec` tree of the decode cache (stacked over layers)."""
    dtype = dtype_of(cfg)
    n_scan = cfg.n_layers - cfg.n_dense_layers
    if cfg.mla is not None:
        per = mla_cache_shape(cfg, batch, seq, dtype)
    else:
        hd = cfg.resolved_head_dim
        kv = TensorSpec((batch, seq, cfg.n_kv_heads, hd), dtype)
        per = {"k": kv, "v": kv}

    def stk(s: TensorSpec) -> TensorSpec:
        if cfg.local_per_global:
            group = cfg.local_per_global + 1
            return TensorSpec((n_scan // group, group, *s.shape), s.dtype)
        return TensorSpec((n_scan, *s.shape), s.dtype)
    out = {"layers": tree_map(stk, per)}
    if cfg.n_dense_layers:
        out["dense_layers"] = [dict(per) for _ in range(cfg.n_dense_layers)]
    return out


def cache_specs(cfg: ArchConfig) -> dict:
    """Caches split over batch (data) and kv-heads (model)."""
    if cfg.mla is not None:
        per = {"c_kv": P("data", None, "model"),
               "k_rope": P("data", None, None, None)}
    else:
        per = {"k": P("data", None, "model", None),
               "v": P("data", None, "model", None)}
    out = {"layers": stack_specs(per, 2 if cfg.local_per_global else 1)}
    if cfg.n_dense_layers:
        out["dense_layers"] = [dict(per) for _ in range(cfg.n_dense_layers)]
    return out


def _attn_decode(p, x, cache, cfg: ArchConfig, *, window, out=None):
    """x: (B, 1, d); cache k/v: (B, S, KV, hd).  Writes the new key and
    value at slot S - 1, at position S - 1, into ``out`` (buffers holding
    a copy of the cache) or a fresh copy."""
    if cfg.mla is not None:
        return mla_decode(p, x, cache, cfg, out=out)
    b = x.shape[0]
    sk = cache["k"].shape[1]
    hd = cfg.resolved_head_dim
    positions = torch.full((b, 1), sk - 1, dtype=torch.int32,
                           device=x.device)
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = rope(q.reshape(b, 1, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, 1, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    v = v.reshape(b, 1, cfg.n_kv_heads, hd)
    if out is None:
        out = {"k": cache["k"].clone(), "v": cache["v"].clone()}
    kc, vc = out["k"], out["v"]
    kc[:, sk - 1:sk] = k
    vc[:, sk - 1:sk] = v
    o = decode_attention(q, kc, vc, window=window)
    return o.reshape(b, 1, cfg.n_heads * hd) @ p["w_o"], {"k": kc, "v": vc}


def _layer_decode(p, x, cache, cfg: ArchConfig, *, window, moe_layer,
                  out=None):
    a, cache = _attn_decode(p["attn"], rms_norm(x, p["ln_attn"],
                                                cfg.norm_eps),
                            cache, cfg, window=window, out=out)
    h = x + a
    y = rms_norm(h, p["ln_mlp"], cfg.norm_eps)
    if moe_layer:
        f, _ = moe_block(p["moe"], y, cfg.moe)
    else:
        f = _mlp(p["mlp"], y)
    return h + f, cache


def decode_step(params, cache, token, cfg: ArchConfig):
    """One decode step: token (B, 1) (or (B, 1, d) embeds) -> logits, cache.

    The input cache is left as it is: the stacked cache is copied once a
    leaf, and each layer writes its new slot into its view of the copy."""
    x = embed_input(params, token, cfg)
    moe_layer = cfg.moe is not None
    new_dense = []
    for p, c in zip(params.get("dense_layers", []),
                    cache.get("dense_layers", [])):
        x, c2 = _layer_decode(p, x, c, cfg, window=None, moe_layer=False)
        new_dense.append(c2)

    new_cache = tree_map(lambda t: t.clone(), cache["layers"])
    layers = _stacked(params, cfg)
    flat = _flat_cache(new_cache, cfg)
    for (lp, win), lc in zip(layers, unstack(flat, len(layers))):
        x, _ = _layer_decode(lp, x, lc, cfg, window=win, moe_layer=moe_layer,
                             out=lc)

    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, h, cfg)
    out_cache = {"layers": new_cache}
    if cfg.n_dense_layers:
        out_cache["dense_layers"] = new_dense
    return logits, out_cache


# ---------------------------------------------------------------------------
# Tensor and expert parallelism: one data replica on its model slots
# (``train.sharded`` on a mesh with a ``model`` axis), Megatron's layout as
# the reference's specs imply.  Activations are replicated over ``model``;
# the column-parallel weights (``spec_in_proj``: q/k/v and their biases,
# the MLP's and shared experts' gate and up, MLA's w_uk and w_uv) give
# each slot its own features, the row-parallel ones (``spec_out_proj``:
# w_o, w_down, shared_down) a partial sum that one all-reduce over
# ``model`` completes; attention runs on the slot's own heads; experts are
# split by expert; the embedding and the unembedding by vocabulary.
# ---------------------------------------------------------------------------

def attn_blocks(cfg: ArchConfig, parent: str, paths, major, m: int
                ) -> dict:
    """``tp_blocks``' entries of the attention leaves under ``parent``
    (``paths``: the tree's leaf paths; ``major``: ``common.major_of``)
    on ``m`` model slots: query heads that divide over the slots are
    each slot's, their key/value heads with them, so that each GQA group
    stays on one slot; fewer key/value heads than slots are each used
    whole by the slots of their group; ``w_o``'s rows are the slots'
    where ``model`` is their major axis."""
    leaves = lambda *names: [f"{parent}/{n}" for n in names
                             if f"{parent}/{n}" in paths]
    h, kv = cfg.n_heads, cfg.n_kv_heads
    queries = leaves("w_q", "w_uk", "w_uv", "b_q")
    keys = leaves("w_k", "b_k", "w_v", "b_v")
    q = h % m == 0 and all(major(p, -1) for p in queries)
    kv_split = q and kv % m == 0 and all(major(p, -1) for p in keys)
    q = q and (not keys or kv_split or (h // kv) % (h // m) == 0)
    out = dict.fromkeys(queries, q) | dict.fromkeys(keys, kv_split)
    out[f"{parent}/w_o"] = major(f"{parent}/w_o", -2)
    return out


def mlp_blocks(cfg: ArchConfig, parent: str, paths, major, m: int, *,
               experts: bool = False) -> dict:
    """``tp_blocks``' entries of the gate/up/down triples under ``parent``
    (the MLP's ``w_*``, the shared experts' ``shared_*``): their widths
    split over ``model``, or, for ``experts``, whole experts that divide
    over the slots."""
    out: dict[str, bool] = {}
    for prefix in ("w_", "shared_"):
        triple = [f"{parent}/{prefix}{n}" for n in ("gate", "up", "down")
                  if f"{parent}/{prefix}{n}" in paths]
        if not triple:
            continue
        gate, up, down = triple
        if experts and prefix == "w_":            # experts, by expert
            ok = cfg.moe.n_experts % m == 0 and all(
                major(p, -3) for p in (gate, up, down))
        else:
            ok = major(gate, -1) and major(up, -1) and major(down, -2)
        out.update(dict.fromkeys((gate, up, down), ok))
    return out


def tp_blocks(cfg: ArchConfig, params, specs, m: int) -> dict[str, bool]:
    """For each leaf of ``params`` whose fixed spec (``specs``, on a mesh
    with a ``model`` axis of ``m`` slots) names ``model``: whether the
    model slots use their blocks of it (True) or the whole leaf, which
    is all-gathered over ``model`` before use (False).  A slot uses its
    block where the block is the slot's share of the family's split:
    query heads that divide over ``m`` (:func:`attn_blocks`), MLP and
    shared-expert widths, whole experts (:func:`mlp_blocks`), vocabulary
    rows; and where the fixed spec keeps ``model`` the major axis of that
    dim (``launch.specs.fix_sharding`` may move it off).  MLA's ``w_dkv``
    is used whole: its latent feeds every head."""
    if m == 1:
        return {}
    major = cm.major_of(params, specs)
    paths = {p for p, _ in tree_items(params)}
    out = cm.vocab_blocks(params, major)
    for parent in dict.fromkeys(p.rsplit("/", 1)[0] for p, _ in
                                tree_items(params) if "/" in p):
        kind = parent.rsplit("/", 1)[-1]
        if kind == "attn":
            out.update(attn_blocks(cfg, parent, paths, major, m))
        elif kind in ("mlp", "moe"):
            out.update(mlp_blocks(cfg, parent, paths, major, m,
                                  experts=kind == "moe"))
    return cm.naming_model(out, specs)


def _attn_slots(p, ys, positions, cfg: ArchConfig, *, window, line) -> list:
    """Attention on each model slot's heads, then ``w_o``: a slot that
    holds rows of ``w_o`` (its heads' rows, or, where every slot runs
    every head, its share of them) makes a partial sum, and one
    all-reduce sums them."""
    hd = cfg.resolved_head_dim
    outs = []
    for m, (y, pos) in enumerate(zip(ys, positions)):
        ps = at_slot(p, m)
        b, s, _ = y.shape
        if cfg.mla is not None:
            heads = ps["w_q"].shape[-1] // (cfg.mla.qk_nope_head_dim
                                            + cfg.mla.qk_rope_head_dim)
            o = mla_heads(ps, y, pos, cfg, heads)[0]
        else:
            heads, kv = ps["w_q"].shape[-1] // hd, ps["w_k"].shape[-1] // hd
            q, k, v = _qkv(ps, y, pos, cfg, heads, kv)
            if heads < cfg.n_heads and kv == cfg.n_kv_heads:
                # Fewer key/value heads than slots: the slot's query heads
                # are one group's, whose key/value head it uses.
                g = m * heads // (cfg.n_heads // cfg.n_kv_heads)
                k, v = k[:, :, g:g + 1], v[:, :, g:g + 1]
            o = attention(q, k, v, window=window).reshape(b, s, heads * hd)
        rows = ps["w_o"].shape[0]
        if o.shape[-1] != rows:
            o = o[..., m * rows:(m + 1) * rows]
        outs.append(o @ ps["w_o"])
    return line.all_reduce(outs) if p["w_o"].split else outs


def _layer_slots(p, xs, positions, cfg: ArchConfig, *, window,
                 moe_layer: bool, line, routing, layer: int):
    """One layer of a replica on its model slots: (the hidden states on
    each slot, the MoE layer's (mean router probability, token fraction)
    or None)."""
    eps = cfg.norm_eps
    ys = [rms_norm(x, g, eps) for x, g in zip(xs, p["ln_attn"])]
    a = _attn_slots(p["attn"], ys, positions, cfg, window=window, line=line)
    hs = [x + y for x, y in zip(xs, a)]
    ys = [rms_norm(h, g, eps) for h, g in zip(hs, p["ln_mlp"])]
    stats = None
    if moe_layer:
        f, prob, frac = moe_block_slots(p["moe"], ys, cfg.moe, line,
                                        routing, layer)
        stats = (prob, frac)
    else:
        f = [_mlp(at_slot(p["mlp"], m), y) for m, y in enumerate(ys)]
        if p["mlp"]["w_down"].split:
            f = line.all_reduce(f)
    return [h + y for h, y in zip(hs, f)], stats


def forward_loss_slots(params, inp: list, labels: list, cfg: ArchConfig,
                       line, routing=None):
    """The mean token cross-entropy of one data replica over its model
    slots (``line``, a ``fft.distributed.MeshLine``), on slot 0, and each
    MoE layer's (mean router probability, token fraction), slot 0's.

    ``params`` is the parameter tree with a ``models.common.Slots`` a leaf
    (the stacked layers' leaves ``LazyLeaf``s that make theirs inside the
    rematerialised layer); ``inp`` and ``labels`` hold slot m's at index
    m; ``routing`` gives the MoE layers' groups over the data replicas
    (``models.moe.moe_block_slots``).  The layers are
    :func:`_run`'s, rematerialised alike; on one slot the arithmetic is
    the unsharded forward's."""
    xs = cm.embed_slots(params, inp, cfg, line)
    positions = [_positions(x) for x in xs]
    moe_layer = cfg.moe is not None
    for p in params.get("dense_layers", []):
        xs, _ = _layer_slots(p, xs, positions, cfg, window=None,
                             moe_layer=False, line=line, routing=routing,
                             layer=-1)

    def body(layers, hs):
        stats = []
        for lp, win, i in layers:
            hs, st = _layer_slots(lp, hs, positions, cfg, window=win,
                                  moe_layer=moe_layer, line=line,
                                  routing=routing, layer=i)
            stats += [st] if st else []
        return hs, stats

    stats = []
    stacked = [(lp, win, i) for i, (lp, win) in
               enumerate(_stacked(params, cfg))]
    group = cfg.local_per_global + 1 if cfg.local_per_global else 1
    for i in range(0, len(stacked), group):
        xs, st = remat(body, stacked[i:i + group], xs)
        stats += st
    return cm.lm_loss_slots(params, xs, labels, cfg, line), stats
