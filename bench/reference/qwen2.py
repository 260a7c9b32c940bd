"""Qwen2's plain reference: the shared decoder, with biases on the q, k
and v projections, which Qwen2 always has and its config.json does not
state."""
from bench.reference.decoder import Decoder as Reference  # noqa: F401


def traits(c: dict) -> dict:
    return {"qkv_bias": True}
