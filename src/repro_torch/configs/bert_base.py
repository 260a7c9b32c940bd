"""BERT-base — the paper's own encoder classifier (sentiment, 2 classes)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="bert-base",
    family="encoder_cls",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    norm_type="ln",
    act="gelu",
    pos_type="learned",
    max_position=512,
    n_classes=2,
)

TINY = CONFIG.replace(
    name="tiny-bert-base",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    max_position=128,
    n_classes=2,
    dtype="float32",
)
