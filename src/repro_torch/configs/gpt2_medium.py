"""GPT2-medium — the paper's own decoder-only NLP model (345M)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="gpt2-medium",
    family="lm",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=50257,
    norm_type="ln",
    act="gelu",
    pos_type="learned",
    max_position=1024,
    tie_embeddings=True,
    n_classes=2,  # paper serves GPT2 for sentiment analysis (2-way)
)

TINY = CONFIG.replace(
    name="tiny-gpt2-medium",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    max_position=512,
    dtype="float32",
)
