"""Qwen1.5-32B — dense, QKV bias [hf:Qwen/Qwen1.5 family; hf].

Assignment pins kv=40 (MHA); we follow the assignment.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="lm",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

TINY = CONFIG.replace(
    name="tiny-qwen1.5-32b",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=512,
    dtype="float32",
)
