"""Memory-efficient GQA attention with sliding-window and KV-cache support
(the counterpart of ``repro.models.attention``, the same algorithm in
plain torch ops).

Prefill uses the reference's chunked online softmax: a running (max, sum,
acc) reduction over KV chunks, so the (S, S) score matrix never
materialises.  ``jax.lax.scan`` over the chunks becomes a Python loop;
causal and sliding-window masks are applied per chunk.

Decode attends one query position against the cached KV.

Precision: the reference takes float32 scores and PV sums of bf16
operands (``preferred_element_type``).  Here q, k and the probabilities
(rounded to v's dtype first, as the reference rounds them) are cast to
float32 before each product, which is exact for the products of bf16
values and accumulates in float32 as the reference does.  At full width
that costs a float32 copy of each KV chunk (decode: of the layer's
cache) a call.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _chunk_attn(q, k, v, *, q_offset: int, window: int | None, chunk: int):
    """Online-softmax attention.

    q: (B, Sq, H, D); k/v: (B, Sk, KV, D).  Causal w.r.t. absolute
    positions (q position = q_offset + i, k position = j).
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    groups = h // kv
    qg = q.reshape(b, sq, kv, groups, d).float()
    scale = d ** -0.5

    n_chunks = max(sk // chunk, 1)
    csize = sk // n_chunks
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]

    acc = torch.zeros((b, sq, kv, groups, dv), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, sq, kv, groups), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, kv, groups), dtype=torch.float32,
                    device=q.device)
    for idx in range(n_chunks):
        start = idx * csize
        kc = k[:, start:start + csize]
        vc = v[:, start:start + csize]
        s = torch.einsum("bqkgd,bjkd->bqkgj", qg, kc.float()) * scale
        jpos = start + torch.arange(csize, device=q.device)[None, :]
        mask = qpos >= jpos                                   # causal
        if window is not None:
            mask &= (qpos - jpos) < window
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgj,bjkd->bqkgd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def attention(q, k, v, *, causal_offset: int = 0,
              window: int | None = None, chunk: int = 1024) -> torch.Tensor:
    """Chunked causal (optionally windowed) GQA attention."""
    sk = k.shape[1]
    chunk = min(chunk, sk)
    # make chunk divide sk (halve until it does)
    while sk % chunk:
        chunk //= 2
    return _chunk_attn(q, k, v, q_offset=causal_offset, window=window,
                       chunk=max(chunk, 1))


def decode_attention(q, k_cache, v_cache, *, cache_len: int | None = None,
                     window: int | None = None) -> torch.Tensor:
    """One-token attention against a (B, S_cache, KV, D) cache.

    q: (B, 1, H, D).  ``cache_len`` is the current valid length (None:
    the whole cache, as the reference's decode path calls it).
    """
    b, _, h, d = q.shape
    sk, kv = k_cache.shape[1], k_cache.shape[2]
    groups = h // kv
    qg = q.reshape(b, kv, groups, d).float()
    s = torch.einsum("bkgd,bjkd->bkgj", qg, k_cache.float()) * d ** -0.5
    valid_len = cache_len if cache_len is not None else sk
    jpos = torch.arange(sk, device=q.device)
    mask = jpos < valid_len
    if window is not None:
        mask &= jpos >= (valid_len - window)
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
