"""Model construction dispatch (the port runs decoder LMs only so far)."""
from __future__ import annotations


def build_model(cfg, **kw):
    """The model of ``cfg``; ``kw`` goes to its constructor (``LM``'s
    ``prefill_attn`` and ``ssd_impl``)."""
    if cfg.family == "lm":
        from repro_torch.models.transformer import LM

        return LM(cfg, **kw)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
