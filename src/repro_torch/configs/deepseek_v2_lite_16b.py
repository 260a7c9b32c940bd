"""DeepSeek-V2-Lite 16B — MoE + MLA [arXiv:2405.04434; hf].

The hf Lite config: 64 routed experts, top-6, plus 2 shared experts (the
160 routed experts belong to the full V2), MLA with a 512-wide latent and
64-wide rope key, one leading dense layer.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="lm",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,          # dense FFN (first layer)
    vocab_size=102400,
    mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    head_dim=192,        # qk_nope + qk_rope
    moe=True,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_k_dense=1,
)

TINY = CONFIG.replace(
    name="tiny-deepseek-v2-lite-16b",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    kv_lora_rank=32,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    head_dim=24,
    n_experts=4,
    top_k=2,
    n_shared_experts=1,
    moe_d_ff=32,
    dtype="float32",
)
