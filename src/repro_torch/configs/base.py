"""Architecture & shape configuration schema (the counterpart of
``repro.configs.base``: the same dataclasses, fields, defaults and
methods, copied field for field).

One :class:`ArchConfig` per assigned architecture (exact published
configs).  ``reduced()`` produces the small same-family float32 config
used by the CPU parity tests; ``chip_smoke.py`` phase 13 runs the full
widths on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int               # per-expert FFN width
    n_shared: int = 0              # always-on shared experts (DeepSeek)
    # GShard-style dispatch group size: every ``group_size`` tokens route
    # independently, keeping the one-hot dispatch tensor O(T * E * C/group)
    # instead of O(T^2) — the standard GShard/Switch trick.
    group_size: int = 256
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128           # N (SSD state size per head)
    head_dim: int = 64             # P
    expand: int = 2                # inner width = expand * d_model
    chunk: int = 256               # SSD chunk length
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None            # None -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # Sliding-window pattern (gemma3): window size + one global layer per
    # ``local_per_global`` locals.  None -> all-global attention.
    sliding_window: int | None = None
    local_per_global: int = 0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid (zamba2): a shared attention block after every k SSM layers.
    shared_attn_every: int = 0
    # First N layers use a dense FFN even in MoE models (DeepSeek).
    n_dense_layers: int = 0
    dense_d_ff: int | None = None
    input_mode: Literal["tokens", "embeds"] = "tokens"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"                # activation/param dtype (dry-run)
    max_context: int | None = None         # documented context limit
    # Sub-quadratic decode? (drives long_500k applicability)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def param_count(self) -> float:
        """Approximate total parameters (for 6ND roofline accounting)."""
        d, l = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        if self.ssm is not None and self.family == "ssm":
            inner = self.ssm.expand * d
            per_layer = d * (2 * inner) + inner * d + inner * (
                2 * self.ssm.state_dim) + inner
            return l * per_layer + 2 * self.vocab * d
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (d * m.kv_lora_rank + d * m.qk_rope_head_dim
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim
                                                       + m.v_head_dim)
                    + d * self.n_heads * qk
                    + self.n_heads * m.v_head_dim * d)
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        ffn_dense = 3 * d * (self.dense_d_ff or self.d_ff)
        if self.moe is not None:
            ffn_moe = 3 * d * self.moe.d_ff_expert * (
                self.moe.n_experts + self.moe.n_shared) + d * self.moe.n_experts
            n_moe = l - self.n_dense_layers
            ffn_total = self.n_dense_layers * ffn_dense + n_moe * ffn_moe
        else:
            ffn_total = l * 3 * d * self.d_ff
        total = l * attn + ffn_total + 2 * self.vocab * d
        if self.shared_attn_every:
            # hybrid: SSM backbone + one shared attention block
            inner = self.ssm.expand * d
            ssm_per_layer = d * (2 * inner) + inner * d + inner * (
                2 * self.ssm.state_dim) + inner
            total = l * ssm_per_layer + attn + l * 2 * d * d // 8 \
                + 2 * self.vocab * d
        return float(total)

    def active_param_count(self) -> float:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (d * m.kv_lora_rank + d * m.qk_rope_head_dim
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim
                                                       + m.v_head_dim)
                    + d * self.n_heads * qk
                    + self.n_heads * m.v_head_dim * d)
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        act_ffn = 3 * d * self.moe.d_ff_expert * (self.moe.top_k
                                                  + self.moe.n_shared)
        dense_ffn = 3 * d * (self.dense_d_ff or self.d_ff)
        n_moe = l - self.n_dense_layers
        return float(l * attn + self.n_dense_layers * dense_ffn
                     + n_moe * act_ffn + 2 * self.vocab * d)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 4) if
            self.n_kv_heads < self.n_heads else 4,
            head_dim=16, d_ff=128, vocab=256, dtype="float32",
        )
        if self.n_kv_heads == self.n_heads:
            kw["n_kv_heads"] = 4
        else:
            kw["n_kv_heads"] = 2
        upd: dict = dict(kw)
        if self.moe is not None:
            upd["moe"] = MoEConfig(
                n_experts=4, top_k=2, d_ff_expert=32,
                n_shared=min(self.moe.n_shared, 1), group_size=8,
            )
            upd["n_dense_layers"] = min(self.n_dense_layers, 1)
            upd["dense_d_ff"] = 128 if self.dense_d_ff else None
            upd["n_layers"] = 3
        if self.mla is not None:
            upd["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                                   qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm is not None:
            upd["ssm"] = SSMConfig(state_dim=16, head_dim=8, expand=2,
                                   chunk=16)
        if self.sliding_window:
            upd["sliding_window"] = 8
        if self.local_per_global:
            upd["local_per_global"] = 1
            upd["n_layers"] = 4                 # 2 groups of (1 local + 1 global)
        if self.shared_attn_every:
            upd["shared_attn_every"] = 2
            upd["n_layers"] = 5
        return dataclasses.replace(self, **upd)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: what gets lowered for an architecture."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ArchConfig) -> tuple[ShapeSpec, ...]:
    """long_500k only for sub-quadratic (SSM/hybrid) archs."""
    if cfg.subquadratic:
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)
