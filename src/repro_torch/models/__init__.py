"""Model construction dispatch: decoder LMs, the encoder-decoder, ResNets
and the BERT-style encoder classifier."""
from __future__ import annotations


def build_model(cfg, **kw):
    """The model of ``cfg``; ``kw`` goes to its constructor (``LM``'s
    ``prefill_attn`` and ``ssd_impl``, ``EncDecLM``'s and
    ``EncoderClassifier``'s ``prefill_attn``; a ResNet takes none)."""
    if cfg.family == "lm":
        from repro_torch.models.transformer import LM

        return LM(cfg, **kw)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg, **kw)
    if cfg.family == "resnet":
        from repro_torch.models.resnet import ResNet

        return ResNet(cfg, **kw)
    if cfg.family == "encoder_cls":
        from repro_torch.models.encdec import EncoderClassifier

        return EncoderClassifier(cfg, **kw)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
