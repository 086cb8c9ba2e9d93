"""Gemma3-12B [hf:google/gemma-3 family; unverified] — 5:1 local:global
sliding-window attention, 128k context, 262k vocab."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144, head_dim=256,
    rope_theta=1e6,
    sliding_window=1024, local_per_global=5,
    max_context=131072, tie_embeddings=True,
)
