"""DeepSeek-67B — dense llama-arch GQA [arXiv:2401.02954; hf]."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="lm",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
)

TINY = CONFIG.replace(
    name="tiny-deepseek-67b",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    dtype="float32",
)
