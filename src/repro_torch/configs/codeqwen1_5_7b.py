"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] — qwen1.5 arch, MHA-like GQA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
)
