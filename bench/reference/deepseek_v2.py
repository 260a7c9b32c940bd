"""DeepSeek-V2's plain reference: the shared decoder's latent attention
and MoE, no bias on any projection (``attention_bias``)."""
from bench.reference.decoder import Decoder as Reference  # noqa: F401


def traits(c: dict) -> dict:
    return {"qkv_bias": bool(c.get("attention_bias", False))}
