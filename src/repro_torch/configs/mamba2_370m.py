"""Mamba2-370M [arXiv:2405.21060; unverified] — SSD (state-space duality),
attention-free; runs the long_500k cell (O(1)/token decode)."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256),
    subquadratic=True,
)
