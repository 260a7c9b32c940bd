"""Encoder classifier (BERT): the port's counterpart of ``EncoderClassifier``
in the JAX package's ``models/encdec.py``.

Ramps attach after every encoder block but the last, with CLS-pool +
classifier-FC ramps: the paper's BERT recipe (§3.1). Params keep the
reference's schema and leaf paths; the encoder's layers carry a leading
``n_layers`` axis, as the reference's scanned params do, and the scan is a
loop over views. The encoder-decoder backbone (SeamlessM4T) is not ported.

``prefill_attn`` ('sdpa' | 'kernel') is the port's choice, as ``LM``'s:
'kernel' runs the encoder's attention, which has no mask, through the
flash-attention kernel with ``causal=False`` (its plain version on CPU
tensors).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as LY
from repro_torch.models.common import ParamInfo, init_from_schema


def _enc_layer_schema(cfg, L):
    return {
        "ln1": LY.norm_schema(cfg, L),
        "attn": LY.gqa_schema(cfg, L),
        "ln2": LY.norm_schema(cfg, L),
        "ffn": LY.ffn_schema(cfg, cfg.d_ff, L),
    }


class EncoderClassifier:
    """BERT-style encoder + CLS classifier; ramps = CLS-pool + FC per block."""

    def __init__(self, cfg, *, prefill_attn: str = "sdpa"):
        if prefill_attn not in ("sdpa", "kernel"):
            raise ValueError(f"prefill_attn={prefill_attn!r}: the port takes 'sdpa' | 'kernel'")
        self.cfg = cfg
        self.prefill_attn = prefill_attn
        self.sites = tuple(range(cfg.n_layers - 1))

    def schema(self) -> dict:
        cfg = self.cfg
        S = len(self.sites)
        return {
            "tok": LY.embed_schema(cfg),
            "enc": _enc_layer_schema(cfg, cfg.n_layers),
            "final_norm": LY.norm_schema(cfg),
            "cls": ParamInfo((cfg.d_model, cfg.n_classes), torch.float32, "normal:0.02"),
            "ramps": {
                "norm_w": ParamInfo((S, cfg.d_model), torch.float32, "zeros"),
                "head": ParamInfo((S, cfg.d_model, cfg.n_classes), torch.float32,
                                  "normal:0.02"),
            },
        }

    def init(self, seed: int = 0, device="cuda") -> dict:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_from_schema(self.schema(), gen, device)

    def forward(self, params, tokens, *, active_sites=None, prefill_attn=None):
        """tokens: (B, S). Returns {'final': stats, 'final_logits'} over
        n_classes logits (CLS position pooling, the paper's BERT recipe) and,
        with ``active_sites`` (host site indices), 'ramps' stats and
        'ramp_logits' (K, B, n_classes). ``prefill_attn`` overrides the
        model's choice for this call ('sdpa' for the loss)."""
        from repro_torch.models.transformer import _layer, _stats

        cfg = self.cfg
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None, :]
        h = LY.embed_apply(cfg, params["tok"], tokens, positions)
        cls = []
        for l in range(cfg.n_layers):
            p = _layer(params["enc"], l)
            x = LY.apply_norm(cfg, p["ln1"], h)
            out, _ = LY.attn_apply(cfg, p["attn"], x, positions=positions, mask=None,
                                   prefill_attn=prefill_attn or self.prefill_attn,
                                   causal=False)
            h = h + out
            x = LY.apply_norm(cfg, p["ln2"], h)
            h = h + LY.ffn_apply(cfg, p["ffn"], x)
            cls.append(h[:, 0])  # CLS pool
        hf = LY.apply_norm(cfg, params["final_norm"], h[:, 0:1])[:, 0]
        logits = hf.float() @ params["cls"]
        outs = {"final": _stats(logits), "final_logits": logits}
        if active_sites is not None:
            si = [int(s) for s in active_sites]
            if si:
                hs = torch.stack([cls[s] for s in si])  # (K, B, d)
                nw = params["ramps"]["norm_w"][si]
                hs = LY.rms_norm(hs, nw[:, None, :])
                rl = torch.einsum("kbd,kdc->kbc", hs.float(), params["ramps"]["head"][si])
            else:
                rl = logits.new_zeros((0, B, cfg.n_classes))
            outs["ramps"] = _stats(rl)
            outs["ramp_logits"] = rl
        return outs

    def loss(self, params, batch, **kw):
        """Classification CE + per-ramp CE over every site, through ``sdpa``
        (the kernel has no backward). The reference's
        ``stop_gradient(0.0) + ramp_logits`` stops nothing, so in 'full'
        training the ramp loss reaches the encoder; the port computes the
        same gradients (ROADMAP.md, Queue 3)."""
        tokens, labels = batch["tokens"], batch["labels"].long()
        outs = self.forward(params, tokens, active_sites=list(range(len(self.sites))),
                            prefill_attn="sdpa")
        return _cls_losses(outs, labels)


def _cls_losses(outs, labels):
    """(CE of the final logits + mean CE of every ramp's, metrics): the
    reference's classifier losses, labels (B,) int64."""
    lf = outs["final_logits"]
    ce = -torch.mean(torch.gather(torch.log_softmax(lf, -1), 1, labels[:, None]))
    rl = outs["ramp_logits"]
    idx = labels[None, :, None].expand(rl.shape[0], -1, 1)
    rce = -torch.mean(torch.gather(torch.log_softmax(rl, -1), 2, idx))
    return ce + rce, {"cls_loss": ce, "ramp_loss": rce}
