"""Llama-3.2-Vision-90B — text backbone with cross-attn image layers
[hf:meta-llama/Llama-3.2-Vision family; unverified].

100 layers total; every 5th layer is a gated cross-attention block over
stubbed image patch embeddings (B, n_image_tokens, d_frontend)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="lm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_image_tokens=1600,
    d_frontend=1280,
)

TINY = CONFIG.replace(
    name="tiny-llama-3.2-vision-90b",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    cross_attn_every=5,
    n_image_tokens=16,
    d_frontend=32,
    dtype="float32",
)
