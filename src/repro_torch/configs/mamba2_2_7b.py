"""Mamba2-2.7B — attention-free SSD [arXiv:2405.21060; unverified]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="lm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    pos_type="none",
    ssm=True,
    d_inner=5120,
    ssm_state=128,
    ssm_headdim=64,
    ssm_ngroups=1,
    d_conv=4,
)

TINY = CONFIG.replace(
    name="tiny-mamba2-2.7b",
    n_layers=3,
    d_model=64,
    vocab_size=512,
    d_inner=128,
    ssm_state=16,
    ssm_headdim=32,
    dtype="float32",
)
