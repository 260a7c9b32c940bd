"""ResNet-50 — the paper's own CV family (bottleneck residual blocks)."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="resnet50",
    family="resnet",
    n_layers=16,  # number of residual blocks (ramp sites)
    d_model=0,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=0,
    resnet_blocks=(3, 4, 6, 3),
    resnet_widths=(64, 128, 256, 512),
    resnet_bottleneck=True,
    n_classes=10,
    img_size=32,
    dtype="float32",
)

TINY = CONFIG.replace(
    name="tiny-resnet50",
    resnet_blocks=(1, 1),
    resnet_widths=(8, 16),
    n_layers=2,
    img_size=16,
)
