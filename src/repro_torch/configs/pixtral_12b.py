"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409; unverified] — VLM.

Backbone only (mistral-nemo-style decoder); the pixtral-ViT vision
frontend is the STUB: ``input_specs`` supplies precomputed patch
embeddings (batch, seq, d_model)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128,
    rope_theta=1e6,
    input_mode="embeds",
)
