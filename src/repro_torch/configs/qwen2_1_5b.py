"""Qwen2-1.5B — dense GQA, QKV bias, tied embeddings [arXiv:2407.10671; hf]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="lm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

TINY = CONFIG.replace(
    name="tiny-qwen2-1.5b",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    dtype="float32",
)
