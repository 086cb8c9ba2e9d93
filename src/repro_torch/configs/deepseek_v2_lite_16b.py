"""DeepSeek-V2-Lite-16B [arXiv:2405.04434; hf] — MLA (kv_lora=512) + MoE.

The assignment line reads "MoE 64e top-6 ... 2 shared+160 routed top-6";
the published V2-Lite config is 64 routed + 2 shared experts, top-6 (160
routed is the full V2) — we implement the published Lite values and note
the discrepancy here.  First layer uses a dense FFN (d_ff 10944); routed
experts have d_ff 1408.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, head_dim=None,
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  group_size=256),
    n_dense_layers=1, dense_d_ff=10944,
)
