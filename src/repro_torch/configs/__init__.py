"""Architecture config registry (the port's copy).

A field-for-field copy of the JAX package's ``ArchConfig``, so every port
config pairs with its reference config. The port registers the two dense
decoder LMs of the generative main path, the MLA + MoE decoder
DeepSeek-V2-Lite, the attention-free SSD stack Mamba2-2.7B and the paper's
classifiers (ResNet-18/50, BERT-base): ``CONFIG`` is the published shape,
``TINY`` a reduced same-family config for CPU tests, and ``get_bench``
the reference's paper-shape, tiny-width benchmark stand-ins.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

from repro_torch.models.common import pad_vocab


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # 'lm' | 'encdec' | 'resnet'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # --- norm / act / positional ---
    norm_type: str = "rms"  # 'rms' | 'ln'
    act: str = "silu"  # 'silu' | 'gelu'
    pos_type: str = "rope"  # 'rope' | 'learned' | 'none'
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    max_position: int = 1_048_576
    # --- attention pattern ---
    window: Optional[int] = None  # sliding window for local layers
    local_global_pattern: Optional[int] = None  # N local : 1 global period
    cross_attn_every: Optional[int] = None  # VLM: cross-attn each k-th layer
    n_image_tokens: int = 1600
    d_frontend: int = 1280  # stubbed modality embedding width
    # --- MLA ---
    mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert intermediate
    first_k_dense: int = 0  # leading dense layers (deepseek-v2)
    moe_every: int = 1  # MoE each k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm: bool = False  # pure SSM (mamba2)
    hybrid_period: int = 0  # jamba: 1 attn per `period` layers
    d_inner: int = 0
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    d_conv: int = 4
    # --- enc-dec ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- resnet (paper CV family) ---
    resnet_blocks: Tuple[int, ...] = ()
    resnet_widths: Tuple[int, ...] = ()
    resnet_bottleneck: bool = False
    n_classes: int = 0
    img_size: int = 32
    # --- dtype ---
    dtype: str = "bfloat16"
    # --- early exits ---
    ramp_budget_slots: int = 4  # max simultaneously-active ramps (K)
    ramp_style: str = "fc"  # 'fc' (paper default: pool+final-FC) | 'mlp' (heavier, Fig 9)
    ramp_hidden: int = 256  # hidden width for 'mlp' ramp style
    mla_absorbed: bool = False  # latent-space MLA decode (beyond-paper perf)
    scan_unroll: bool = False  # fully unroll layer scans (metric lowerings)
    kv_seq_shard: bool = False  # shard KV-cache seq dim over `model` (flash-decode layout)
    windowed_cache: bool = False  # ring caches sized `window` for local layers
    # 'off' (dense logits + softmax stats) | 'kernel' (the streaming
    # exit-record kernel of kernels/ramp_head; its plain version on CPU
    # tensors). The name is the JAX package's, kept so configs pair field
    # for field.
    pallas_head: str = "off"
    # single-token decode attention against the KV cache: 'dense' (masked
    # sdpa) | 'ref' (kernels/decode_attention plain version) | 'kernel'
    # (the CUDA flash-decode kernel on CUDA tensors, its plain version on
    # CPU tensors); on the paged pool 'paged' (plain) | 'paged-kernel'.
    decode_attn: str = "dense"
    train_remat: bool = True  # activation checkpointing in train_step
    remat_policy: str = "full"  # 'full' (save nothing) | 'dots' (save matmul outputs)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.d_inner else 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mamba2-2.7b": "mamba2_2_7b",
    "qwen2-1.5b": "qwen2_1_5b",
    "gpt2-medium": "gpt2_medium",
    "bert-base": "bert_base",
    "resnet50": "resnet50",
    "resnet18": "resnet18",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_tiny(name: str) -> ArchConfig:
    return _module(name).TINY


# Benchmark stand-ins: PAPER-SHAPE (same layer count => same ramp sites as
# the full model, so the full model's latency profile applies), tiny widths
# (CPU-trainable); the reference's, for the configs the port has.
_BENCH_REPL = {
    "gpt2-medium": dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                        vocab_size=512, max_position=64, dtype="float32"),
    "bert-base": dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                      vocab_size=512, max_position=64, dtype="float32"),
    "resnet18": dict(resnet_widths=(16, 32, 64, 128), img_size=16),
    "resnet50": dict(resnet_widths=(8, 8, 16, 16), img_size=16),
    "qwen2-1.5b": dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab_size=512, dtype="float32"),
}


def get_bench(name: str) -> ArchConfig:
    base = get_config(name)
    repl = _BENCH_REPL.get(name)
    if repl is None:
        raise KeyError(f"no bench variant for {name}")
    return base.replace(name=f"bench-{name}", **repl)
