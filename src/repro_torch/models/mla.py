"""Multi-head latent attention (DeepSeek-V2) with its compressed KV cache
(the counterpart of ``repro.models.mla``).

Tokens project down to a ``kv_lora_rank`` latent ``c_kv`` plus a small
decoupled RoPE key shared across heads; per-head keys and values are
up-projections of the latent.  The decode cache holds only ``(c_kv,
k_rope)``.  Prefill materialises per-head K/V and attends through the
chunked kernel of ``models.attention`` (nope and rope parts folded into
one MHA call); decode uses the weight-absorption form, attending in the
latent space, in float32 as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import attention
from repro_torch.models.common import TensorSpec, dense_init, rope


def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_q": dense_init(gen, (d, h * qk), dtype),
        "w_dkv": dense_init(gen, (d, m.kv_lora_rank), dtype),
        "w_krope": dense_init(gen, (d, m.qk_rope_head_dim), dtype),
        "w_uk": dense_init(gen, (m.kv_lora_rank, h * m.qk_nope_head_dim),
                           dtype),
        "w_uv": dense_init(gen, (m.kv_lora_rank, h * m.v_head_dim), dtype),
        "w_o": dense_init(gen, (h * m.v_head_dim, d), dtype),
    }


def _project_q(params, x, positions, cfg: ArchConfig, h: int | None = None):
    m, h = cfg.mla, h or cfg.n_heads
    b, s, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = (x @ params["w_q"]).reshape(b, s, h, qk)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(params, x, positions, cfg: ArchConfig):
    c_kv = x @ params["w_dkv"]                            # (B, S, rank)
    k_rope = rope((x @ params["w_krope"])[:, :, None, :], positions,
                  cfg.rope_theta)                         # (B, S, 1, rope)
    return c_kv, k_rope


def mla_heads(params, x, positions, cfg: ArchConfig, h: int | None = None):
    """Full-sequence MLA of ``h`` heads (default every head; fewer where
    ``w_q``, ``w_uk`` and ``w_uv`` hold a model slot's heads) via the
    chunked GQA kernel, before ``w_o``: (the heads' output (B, S, h *
    v_head_dim), c_kv, k_rope).  The latent and the rope key are every
    head's."""
    m, h = cfg.mla, h or cfg.n_heads
    b, s, _ = x.shape
    q_nope, q_rope = _project_q(params, x, positions, cfg, h)
    c_kv, k_rope = _project_kv_latent(params, x, positions, cfg)
    k_nope = (c_kv @ params["w_uk"]).reshape(b, s, h, m.qk_nope_head_dim)
    v = (c_kv @ params["w_uv"]).reshape(b, s, h, m.v_head_dim)
    # Fold the decoupled rope key into a single MHA call: concatenate the
    # nope and rope parts (rope key broadcast across heads).
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat(
        [k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)], dim=-1)
    out = attention(q_full, k_full, v)                    # kv == h heads
    return out.reshape(b, s, h * m.v_head_dim), c_kv, k_rope


def mla_attention(params, x, positions, cfg: ArchConfig,
                  with_cache: bool = False):
    """Full-sequence MLA (prefill) via the chunked GQA kernel."""
    out, c_kv, k_rope = mla_heads(params, x, positions, cfg)
    out = out @ params["w_o"]
    if with_cache:
        return out, {"c_kv": c_kv, "k_rope": k_rope}
    return out


def mla_decode(params, x, cache: dict, cfg: ArchConfig, *, out=None):
    """One-token decode in latent space (weight absorption).  The new
    latent goes at slot S - 1, at position S - 1.  ``out`` (optional) is
    ``{"c_kv", "k_rope"}`` buffers holding a copy of the cache, written in
    place; by default the cache is copied."""
    m, h = cfg.mla, cfg.n_heads
    b = x.shape[0]
    sk = cache["c_kv"].shape[1]
    positions = torch.full((b, 1), sk - 1, dtype=torch.int32,
                           device=x.device)
    q_nope, q_rope = _project_q(params, x, positions, cfg)
    c_new, kr_new = _project_kv_latent(params, x, positions, cfg)
    if out is None:
        out = {k: cache[k].clone() for k in ("c_kv", "k_rope")}
    c_kv, k_rope = out["c_kv"], out["k_rope"]
    c_kv[:, sk - 1:sk] = c_new
    k_rope[:, sk - 1:sk] = kr_new
    # Absorb W_uk: q_lat[b,h,r] = sum_d q_nope[b,h,d] * W_uk[r, h*d]
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bhr", q_nope, w_uk)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    c32 = c_kv.float()
    s = (torch.einsum("bhr,bjr->bhj", q_lat.float(), c32)
         + torch.einsum("bqhd,bjxd->bhj", q_rope.float(),
                        k_rope.float())) * scale
    p = torch.softmax(s, dim=-1)                          # (B, H, Sk)
    out_lat = torch.einsum("bhj,bjr->bhr", p, c32)
    # Absorb W_uv on the way out.
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bhr,rhd->bhd", out_lat, w_uv.float())
    o = o.reshape(b, 1, h * m.v_head_dim).to(x.dtype)
    return o @ params["w_o"], {"c_kv": c_kv, "k_rope": k_rope}


def mla_cache_shape(cfg: ArchConfig, batch: int, seq: int, dtype) -> dict:
    m = cfg.mla
    return {
        "c_kv": TensorSpec((batch, seq, m.kv_lora_rank), dtype),
        "k_rope": TensorSpec((batch, seq, 1, m.qk_rope_head_dim), dtype),
    }
