"""SeamlessM4T-large-v2 — enc-dec multimodal backbone [arXiv:2308.11596; hf].

Assignment specifies the transformer BACKBONE only (24L d1024 16H d_ff 8192);
we build 24 encoder + 24 decoder layers at those dims. The speech frontend
is a STUB: ``input_specs()`` provides precomputed frame embeddings
(B, frames, d_frontend).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,  # 24 enc + 24 dec
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    act="gelu",
    pos_type="rope",
    d_frontend=1024,
)

TINY = CONFIG.replace(
    name="tiny-seamless-m4t-large-v2",
    n_layers=4,
    n_enc_layers=2,
    n_dec_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    d_frontend=64,
    dtype="float32",
)
