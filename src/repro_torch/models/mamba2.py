"""Mamba2 — SSD (state-space duality) backbone [arXiv:2405.21060] (the
counterpart of ``repro.models.mamba2``).

Chunked SSD forward: the sequence splits into chunks of Q tokens; within
a chunk the output is a masked quadratic form (the attention-like dual),
across chunks a linear recurrence carries (H, P, N) states.  Decode is a
single O(1) state update.

Shapes: inner = expand * d_model = H * P heads; B/C share one state group
(ngroups = 1, the published 370M config).

Precision: the reference computes the SSD einsums in float32 (float32
scores of its operands, float32 decays and states); the port casts their
operands to float32, exact for bf16 values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models.common import (SHAPES_ONLY, P, TensorSpec, at_slot,
                                       dense_init, dtype_of, matmul_f32,
                                       remat, rms_norm, stack, stack_specs,
                                       tree_map, unstack)


#: The top-level key of the parameter tree (the stacked layers) whose
#: leaves are used only inside a rematerialised layer (``remat``): the
#: sharded train step (``train.sharded``) all-gathers a sharded one
#: there, and again in the recompute; it gathers every other sharded leaf
#: once.
REMAT_PARAMS = ("layers",)


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    n_heads = inner // s.head_dim
    return inner, n_heads, s.head_dim, s.state_dim


def init_mamba_block(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    inner, h, _, n = _dims(cfg)
    conv_dim = inner + 2 * n
    dev = gen.device
    return {
        "ln": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
        "in_proj": dense_init(gen, (cfg.d_model, 2 * inner + 2 * n + h),
                              dtype),
        "conv_w": dense_init(gen, (cfg.ssm.conv_width, conv_dim), dtype,
                             scale=0.5),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "A_log": torch.zeros(h, dtype=torch.float32, device=dev),
        "D": torch.ones(h, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(h, dtype=torch.float32, device=dev),
        "gate_norm": torch.zeros(inner, dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (inner, cfg.d_model), dtype),
    }


def mamba_block_specs(cfg: ArchConfig) -> dict:
    return {
        "ln": P(), "in_proj": cm.spec_in_proj(), "conv_w": P(None, "model"),
        "conv_b": P("model"), "A_log": P(), "D": P(), "dt_bias": P(),
        "gate_norm": P("model"), "out_proj": cm.spec_out_proj(),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv via shifted adds (width is small & static)."""
    width = w.shape[0]
    s = xbc.shape[1]
    out = xbc * w[-1]
    for i in range(1, width):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :s, :]
        out = out + shifted * w[width - 1 - i]
    return F.silu(out + b)


def _segsum(dacum: torch.Tensor) -> torch.Tensor:
    """L[l, s] = exp(dacum[l] - dacum[s]) masked to l >= s; (..., Q).

    The difference is masked to -inf before the ``exp``, so a masked entry
    is exactly 0 and its gradient 0.  The reference masks after the
    ``exp``: where a chunk's decay exceeds about 88 in log, a masked entry
    is inf there and its gradient 0 * inf = NaN.  The forward values are
    the same bits either way."""
    q = dacum.shape[-1]
    diff = dacum[..., :, None] - dacum[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=dacum.device))
    return torch.exp(torch.where(mask, diff, -torch.inf))


def _ssd_chunked(xs, dt, bmat, cmat, a_log, chunk: int):
    """Chunked SSD scan.

    xs: (B, S, H, P)  dt: (B, S, H)  bmat/cmat: (B, S, N)
    Returns y (B, S, H, P) and the final state (B, H, P, N), float32.
    """
    b, s, h, p = xs.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q
    a = -torch.exp(a_log)                                 # (H,)
    da = dt * a                                           # (B, S, H)

    xs_c = xs.reshape(b, nc, q, h, p)
    dt_c = dt.reshape(b, nc, q, h)
    da_c = da.reshape(b, nc, q, h)
    b_c = bmat.reshape(b, nc, q, n).float()
    c_c = cmat.reshape(b, nc, q, n).float()

    dacum = torch.cumsum(da_c, dim=2)                     # (B, C, Q, H)
    xdt = (xs_c * dt_c[..., None]).float()                # (B, C, Q, H, P)

    # ---- intra-chunk (quadratic dual) --------------------------------
    lmat = _segsum(dacum.movedim(-1, -2))                 # (B, C, H, Q, Q)
    scores = torch.einsum("bcln,bcsn->bcls", c_c, b_c)
    y_diag = torch.einsum("bcls,bchls,bcshp->bclhp", scores, lmat, xdt)

    # ---- chunk states + inter-chunk recurrence ------------------------
    decay_out = torch.exp(dacum[:, :, -1:, :] - dacum)    # (B, C, Q, H)
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn", b_c, decay_out, xdt)
    chunk_decay = torch.exp(dacum[:, :, -1, :])           # (B, C, H)

    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=xs.device)
    prev = []
    for c in range(nc):                                   # emit PRE-state
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (B, C, H, P, N)

    decay_in = torch.exp(dacum)                           # (B, C, Q, H)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", c_c, prev_states,
                         decay_in)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(xs.dtype), carry


def _split_proj(proj, cfg: ArchConfig):
    inner, h, _, n = _dims(cfg)
    return (proj[..., :inner], proj[..., inner:inner + inner + 2 * n],
            proj[..., -h:])


def _head_columns(w: torch.Tensor, cfg: ArchConfig, lo: int, hi: int
                  ) -> torch.Tensor:
    """The columns of ``in_proj`` (..., [z | x | B | C | dt]) that SSM
    heads [lo, hi) read: their ``z``, ``x`` and ``dt``, all of ``B`` and
    ``C`` (one state group); ``w`` itself for every head."""
    inner, h, p, n = _dims(cfg)
    if (lo, hi) == (0, h):
        return w
    end = 2 * inner + 2 * n
    return torch.cat([w[..., lo * p:hi * p],
                      w[..., inner + lo * p:inner + hi * p],
                      w[..., 2 * inner:end], w[..., end + lo:end + hi]], -1)


def _conv_channels(w: torch.Tensor, cfg: ArchConfig, lo: int, hi: int
                   ) -> torch.Tensor:
    """The conv channels (..., [x | B | C]) of SSM heads [lo, hi): their
    ``x``, all of ``B`` and ``C``; ``w`` itself for every head."""
    inner, h, p, _ = _dims(cfg)
    if (lo, hi) == (0, h):
        return w
    return torch.cat([w[..., lo * p:hi * p], w[..., inner:]], -1)


def _ssm_heads(params, x, cfg: ArchConfig, lo: int, hi: int):
    """SSM heads [lo, hi) of a block on its input ``x`` (B, S, d): their
    gated output y * silu(z) (B, S, (hi - lo) P) before ``gate_norm``,
    the conv's input and the final state (B, hi - lo, P, N).  ``params``
    holds ``in_proj``, ``conv_w`` and ``conv_b`` whole and every head's
    ``A_log``, ``D`` and ``dt_bias``."""
    _, _, p_dim, n = _dims(cfg)
    k = hi - lo
    width = k * p_dim
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    proj = xn @ _head_columns(params["in_proj"], cfg, lo, hi)
    z, pre_conv, dt_raw = (proj[..., :width],
                           proj[..., width:2 * width + 2 * n], proj[..., -k:])
    xbc = _causal_conv(pre_conv,
                       _conv_channels(params["conv_w"], cfg, lo, hi),
                       _conv_channels(params["conv_b"], cfg, lo, hi))
    xs = xbc[..., :width].reshape(*xbc.shape[:2], k, p_dim)
    bmat = xbc[..., width:width + n]
    cmat = xbc[..., width + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"][lo:hi])
    y, state = _ssd_chunked(xs, dt, bmat, cmat, params["A_log"][lo:hi],
                            cfg.ssm.chunk)
    y = y + (params["D"][lo:hi, None] * xs.float()).to(y.dtype)
    y = y.reshape(*y.shape[:2], width)
    return y * F.silu(z), pre_conv, state


def mamba_block(params, x, cfg: ArchConfig, *, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d) [+ (conv_tail, state) when prefilling]."""
    _, h, _, _ = _dims(cfg)
    g, pre_conv, state = _ssm_heads(params, x, cfg, 0, h)
    y = rms_norm(g, params["gate_norm"], cfg.norm_eps)
    out = x + y @ params["out_proj"]
    if return_state:
        w = cfg.ssm.conv_width
        return out, (pre_conv[:, -(w - 1):, :], state)
    return out


def mamba_decode(params, x, cache, cfg: ArchConfig):
    """One-token state update.  cache = {"conv": (B, W-1, CD), "state":
    (B, H, P, N)}; returns the new cache (the input is left as it is)."""
    inner, h, p_dim, n = _dims(cfg)
    res = x
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    proj = xn @ params["in_proj"]                         # (B, 1, ...)
    z, xbc_new, dt_raw = _split_proj(proj, cfg)
    # conv over [cached, new]
    window = torch.cat([cache["conv"], xbc_new], dim=1)   # (B, W, CD)
    xbc = F.silu(torch.einsum("bwc,wc->bc", window, params["conv_w"])
                 + params["conv_b"])[:, None, :]
    xs = xbc[..., :inner].reshape(-1, 1, h, p_dim)
    bmat = xbc[..., inner:inner + n]
    cmat = xbc[..., inner + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    da = torch.exp(dt[:, 0, :] * a)                       # (B, H)
    state = cache["state"] * da[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", bmat[:, 0].float(),
        (xs[:, 0] * dt[:, 0, :, None]).float())
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), state)
    y = y + params["D"][:, None] * xs[:, 0].float()
    y = y.reshape(-1, 1, inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["gate_norm"], cfg.norm_eps)
    out = res + y @ params["out_proj"]
    return out, {"conv": window[:, 1:, :], "state": state}


def mamba_cache_shapes(cfg: ArchConfig, batch: int) -> dict:
    inner, h, p_dim, n = _dims(cfg)
    conv_dim = inner + 2 * n
    w = cfg.ssm.conv_width
    return {
        "conv": TensorSpec((batch, w - 1, conv_dim), dtype_of(cfg)),
        "state": TensorSpec((batch, h, p_dim, n), torch.float32),
    }


def mamba_cache_specs(cfg: ArchConfig) -> dict:
    return {"conv": P("data", None, "model"),
            "state": P("data", "model", None, None)}


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dtype = dtype_of(cfg)
    return {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dtype, scale=1.0),
        "layers": stack([init_mamba_block(gen, cfg, dtype)
                         for _ in range(cfg.n_layers)]),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype,
                                  device=gen.device),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab), dtype),
    }


def param_shapes(cfg: ArchConfig) -> dict:
    """:class:`TensorSpec` tree of :func:`init_params`, nothing drawn."""
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype),
                    init_params(SHAPES_ONLY, cfg))


def param_specs(cfg: ArchConfig) -> dict:
    return {
        "embed": cm.spec_embed(),
        "layers": stack_specs(mamba_block_specs(cfg)),
        "final_norm": P(),
        "lm_head": P("data", "model"),
    }


def forward_hidden(params, tokens, cfg: ArchConfig):
    """Final hidden states; each layer rematerialised in backward."""
    x = params["embed"][tokens]
    for lp in unstack(params["layers"], cfg.n_layers):
        x = remat(mamba_block, lp, x, cfg)
    return (rms_norm(x, params["final_norm"], cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


def unembed(params, h, cfg: ArchConfig):
    return matmul_f32(h, params["lm_head"])


def forward(params, tokens, cfg: ArchConfig):
    h, aux = forward_hidden(params, tokens, cfg)
    return unembed(params, h, cfg), aux


def prefill_step(params, tokens, cfg: ArchConfig):
    """Forward that also returns the (conv tail, SSM state) caches."""
    x = params["embed"][tokens]
    caches = []
    for lp in unstack(params["layers"], cfg.n_layers):
        x, (conv_tail, state) = mamba_block(lp, x, cfg, return_state=True)
        caches.append({"conv": conv_tail, "state": state})
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, h[:, -1:, :], cfg), {"layers": stack(caches)}


def cache_shapes(cfg: ArchConfig, batch: int, seq: int) -> dict:
    per = mamba_cache_shapes(cfg, batch)
    return {"layers": tree_map(
        lambda s: TensorSpec((cfg.n_layers, *s.shape), s.dtype), per)}


def cache_specs(cfg: ArchConfig) -> dict:
    return {"layers": stack_specs(mamba_cache_specs(cfg))}


def decode_step(params, cache, token, cfg: ArchConfig):
    x = params["embed"][token]
    new = []
    for lp, lc in zip(unstack(params["layers"], cfg.n_layers),
                      unstack(cache["layers"], cfg.n_layers)):
        x, c2 = mamba_decode(lp, x, lc, cfg)
        new.append(c2)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, h, cfg), {"layers": stack(new)}


# ---------------------------------------------------------------------------
# Tensor parallelism: one data replica on its model slots (``train.sharded``
# on a mesh with a ``model`` axis).  Activations are replicated over
# ``model``; slot m runs SSM heads [m H / M, (m + 1) H / M) where the heads
# divide over the slots: from ``in_proj``, ``conv_w`` and ``conv_b``, used
# whole (their blocks split [z | x | B | C | dt] off the head boundaries),
# the columns of its heads and all of B and C; its heads' ``A_log``, ``D``
# and ``dt_bias``; ``gate_norm`` over the whole inner width from one
# all-reduce of the slots' sums of squares; ``out_proj`` row-parallel, its
# partial sums all-reduced; the embedding and the unembedding by
# vocabulary (``models.common``).
# ---------------------------------------------------------------------------

def mamba_blocks(cfg: ArchConfig, parent: str, major, m: int) -> dict:
    """``tp_blocks``' entries of the mamba block under ``parent`` on ``m``
    model slots (``major``: ``common.major_of``): ``in_proj``, ``conv_w``
    and ``conv_b`` used whole; ``gate_norm``'s block where the SSM heads
    divide over the slots (each slot its heads'); ``out_proj``'s rows
    where ``model`` is their major axis (each slot's heads' rows, or,
    where every slot runs every head, its share of them)."""
    _, h, _, _ = _dims(cfg)
    leaf = lambda name: f"{parent}/{name}"
    rows = major(leaf("out_proj"), -2)
    return {leaf("in_proj"): False, leaf("conv_w"): False,
            leaf("conv_b"): False, leaf("out_proj"): rows,
            leaf("gate_norm"): (h % m == 0 and rows
                                and major(leaf("gate_norm"), -1))}


def tp_blocks(cfg: ArchConfig, params, specs, m: int) -> dict[str, bool]:
    """For each leaf of ``params`` whose fixed spec (``specs``, on a mesh
    with a ``model`` axis of ``m`` slots) names ``model``: whether the
    model slots use their blocks of it (True) or the whole leaf, which
    is all-gathered over ``model`` before use (False): the stacked
    layers' :func:`mamba_blocks`, the vocabulary rows of the embedding
    and ``lm_head``."""
    if m == 1:
        return {}
    major = cm.major_of(params, specs)
    out = cm.vocab_blocks(params, major) | mamba_blocks(cfg, "layers",
                                                        major, m)
    return cm.naming_model(out, specs)


def mamba_block_slots(p, xs: list, cfg: ArchConfig, line) -> list:
    """One mamba block of a replica on its model slots (``p`` a tree of
    ``models.common.Slots``; ``xs`` the hidden states on each slot): each
    slot's heads, or every head on each slot where ``gate_norm`` is used
    whole; on one slot the arithmetic of :func:`mamba_block`."""
    inner, h, _, _ = _dims(cfg)
    split = p["gate_norm"].split
    k = h // len(xs) if split else h
    gs = [_ssm_heads(at_slot(p, m), x, cfg, m * k if split else 0,
                     m * k + k if split else h)[0]
          for m, x in enumerate(xs)]
    if split:
        ys = cm.rms_norm_slots(gs, p["gate_norm"], cfg.norm_eps, inner, line)
    else:
        ys = [rms_norm(g, w, cfg.norm_eps) for g, w in zip(gs, p["gate_norm"])]
    outs = []
    for m, (y, w) in enumerate(zip(ys, p["out_proj"])):
        rows = w.shape[0]
        if y.shape[-1] != rows:
            y = y[..., m * rows:(m + 1) * rows]
        outs.append(y @ w)
    if p["out_proj"].split:
        outs = line.all_reduce(outs)
    return [x + o for x, o in zip(xs, outs)]


def forward_loss_slots(params, inp: list, labels: list, cfg: ArchConfig,
                       line, routing=None):
    """The mean token cross-entropy of one data replica over its model
    slots (``line``, a ``fft.distributed.MeshLine``), on slot 0, and no
    MoE statistics: ``models.transformer.forward_loss_slots``' contract
    (``routing`` unused).  Each layer is rematerialised, as in
    :func:`forward_hidden`; on one slot the arithmetic is the unsharded
    forward's."""
    xs = cm.embed_slots(params, inp, cfg, line)
    for lp in unstack(params["layers"], cfg.n_layers):
        xs = remat(mamba_block_slots, lp, xs, cfg, line)
    return cm.lm_loss_slots(params, xs, labels, cfg, line), []
