"""Zamba2-1.2B [arXiv:2411.15242; hf] — Mamba2 backbone with a SHARED
attention block applied every 6 SSM layers; runs long_500k."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
    shared_attn_every=6,
    subquadratic=True,
)
