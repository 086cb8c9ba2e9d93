"""DBRX-132B [hf:databricks/dbrx-base; unverified] — fine-grained MoE,
16 experts top-4, GQA kv=8."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, head_dim=128,
    rope_theta=5e5,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
)
