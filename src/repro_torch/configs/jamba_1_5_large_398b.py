"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7, MoE 16e top-2
[arXiv:2403.19887; hf].

Layer pattern: one attention layer per 8 (hybrid_period=8, attention at
layer index ≡ 4 mod 8 matching the published block layout); MoE FFN every
other layer (moe_every=2), dense FFN otherwise.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="lm",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    pos_type="none",  # jamba uses no positional encoding (mamba carries order)
    hybrid_period=8,
    ssm=False,
    d_inner=16384,
    ssm_state=128,
    ssm_headdim=64,
    ssm_ngroups=1,
    d_conv=4,
    moe=True,
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_d_ff=24576,
)

TINY = CONFIG.replace(
    name="tiny-jamba-1.5-large-398b",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    hybrid_period=4,
    d_inner=128,
    ssm_state=16,
    ssm_headdim=32,
    n_experts=4,
    top_k=2,
    moe_d_ff=128,
    dtype="float32",
)
