"""MusicGen-medium [arXiv:2306.05284; hf] — decoder-only transformer over
EnCodec tokens.  The EnCodec audio frontend is the STUB: ``input_specs``
supplies the discrete codec tokens (vocab 2048) directly."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048, head_dim=64,
    rope_theta=10000.0,
)
