"""Qwen3-MoE 30B-A3B [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="lm",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,  # per-expert intermediate; all layers MoE
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=True,
    n_experts=128,
    top_k=8,
    n_shared_experts=0,
    moe_d_ff=768,
)

TINY = CONFIG.replace(
    name="tiny-qwen3-moe-30b-a3b",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=48,
    vocab_size=512,
    n_experts=4,
    top_k=2,
    moe_d_ff=48,
    dtype="float32",
)
