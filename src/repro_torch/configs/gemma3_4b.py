"""Gemma3-4B — dense, 5 local (window 1024) : 1 global, qk-norm, tied
embeddings [hf:google/gemma-3 family; unverified]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="lm",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    act="gelu",
    qk_norm=True,
    tie_embeddings=True,
    window=1024,
    local_global_pattern=5,  # 5 local : 1 global
    rope_theta=1_000_000.0,
)

TINY = CONFIG.replace(
    name="tiny-gemma3-4b",
    n_layers=6,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    window=16,
    local_global_pattern=2,
    dtype="float32",
)
