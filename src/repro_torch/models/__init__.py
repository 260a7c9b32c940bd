"""Model construction dispatch (the port runs decoder LMs only so far)."""
from __future__ import annotations


def build_model(cfg):
    if cfg.family == "lm":
        from repro_torch.models.transformer import LM

        return LM(cfg)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
