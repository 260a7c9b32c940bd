"""ResNet-18 — the paper's own CV family (basic residual blocks)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="resnet18",
    family="resnet",
    n_layers=8,  # residual blocks
    d_model=0,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=0,
    resnet_blocks=(2, 2, 2, 2),
    resnet_widths=(16, 32, 64, 128),  # thin stack — CPU-trainable
    resnet_bottleneck=False,
    n_classes=10,
    img_size=32,
    dtype="float32",
)

TINY = CONFIG.replace(
    name="tiny-resnet18",
    resnet_blocks=(1, 1),
    resnet_widths=(8, 16),
    n_layers=2,
    img_size=16,
)
