"""ResNet, the paper's CV family: the port's counterpart of the JAX
package's ``models/resnet.py``.

Residual blocks are the cut vertices; a ramp is global-average-pool + the
classifier FC (the paper's default CV ramp, §3.1). GroupNorm replaces
BatchNorm, as in the reference. Params keep the reference's schema and
leaf paths, so ``models/bridge.py`` carries a JAX tree over unchanged:
conv weights stay HWIO ``(k, k, cin, cout)`` in the tree and are viewed
OIHW for ``F.conv2d``. Images arrive NHWC, as the reference takes them,
and run NCHW inside.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ParamInfo,
    init_from_schema,
    meta_from_schema,
    specs_from_schema,
)


def _conv_info(cin, cout, k):
    return ParamInfo((k, k, cin, cout), torch.float32, f"normal:{1.0 / math.sqrt(cin * k * k)}")


def _gn_info(c):
    return {"w": ParamInfo((c,), torch.float32, "ones"),
            "b": ParamInfo((c,), torch.float32, "zeros")}


def same_padding(n: int, k: int, stride: int):
    """XLA's ``"SAME"`` padding of one spatial dim of size ``n``: (before,
    after). The odd pixel goes after, so a 3x3 stride-2 conv of an even
    size pads (0, 1), where ``padding=1`` would shift it by a pixel."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1):
    """x (B, C, H, W); w HWIO (kh, kw, cin, cout): the reference's
    ``conv_general_dilated(x, w, stride, "SAME")``."""
    (ht, hb), (wl, wr) = (same_padding(x.shape[2], w.shape[0], stride),
                          same_padding(x.shape[3], w.shape[1], stride))
    w = w.permute(3, 2, 0, 1)
    if ht == hb and wl == wr:
        return F.conv2d(x, w, stride=stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride)


def group_norm(x, p, groups=8):
    """GroupNorm over ``min(groups, C)`` groups, lowered until it divides C;
    biased variance, eps 1e-5, as the reference's ``group_norm``."""
    C = x.shape[1]
    g = min(groups, C)
    while C % g:
        g -= 1
    return F.group_norm(x, g, p["w"], p["b"], eps=1e-5)


def shortcut(x, blk, stride):
    """The residual branch: the block's 1x1 projection, else the identity;
    at stride 2 the reference's identity is ``conv(x, eye, 2)``, a strided
    subsample (each stride-2 block of the configs projects, so none
    reaches it)."""
    if "proj" in blk:
        return conv(x, blk["proj"], stride)
    return x[:, :, ::stride, ::stride]


class ResNet:
    """cfg.resnet_blocks: blocks per stage; widths per stage; stride 2 between
    stages. n_layers == total residual blocks == ramp-feasible sites + 1."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.block_widths: List[int] = []
        for n, w in zip(cfg.resnet_blocks, cfg.resnet_widths):
            self.block_widths += [w * (4 if cfg.resnet_bottleneck else 1)] * n
        self.sites = tuple(range(len(self.block_widths) - 1))

    def schema(self) -> dict:
        cfg = self.cfg
        w0 = cfg.resnet_widths[0]
        sch = {"stem": {"conv": _conv_info(3, w0, 3), "gn": _gn_info(w0)}, "blocks": []}
        cin = w0
        for stage, (n, w) in enumerate(zip(cfg.resnet_blocks, cfg.resnet_widths)):
            wout = w * (4 if cfg.resnet_bottleneck else 1)
            for b in range(n):
                if cfg.resnet_bottleneck:
                    blk = {"c1": _conv_info(cin, w, 1), "g1": _gn_info(w),
                           "c2": _conv_info(w, w, 3), "g2": _gn_info(w),
                           "c3": _conv_info(w, wout, 1), "g3": _gn_info(wout)}
                else:
                    blk = {"c1": _conv_info(cin, w, 3), "g1": _gn_info(w),
                           "c2": _conv_info(w, wout, 3), "g2": _gn_info(wout)}
                if cin != wout or (b == 0 and stage > 0):
                    blk["proj"] = _conv_info(cin, wout, 1)
                sch["blocks"].append(blk)
                cin = wout
        sch["fc"] = ParamInfo((cin, cfg.n_classes), torch.float32, "normal:0.02")
        sch["ramps"] = {"head": [ParamInfo((bw, cfg.n_classes), torch.float32, "normal:0.02")
                                 for bw in self.block_widths[:-1]]}
        return sch

    def init(self, seed: int = 0, device="cuda") -> dict:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_from_schema(self.schema(), gen, device)

    def abstract(self) -> dict:
        """The params as meta tensors (``meta_from_schema``)."""
        return meta_from_schema(self.schema())

    def pspecs(self, axes=None):
        """Every leaf whole (the reference's: its schema's specs, unresolved)."""
        return specs_from_schema(self.schema())

    def forward(self, params, images, *, active_sites=None):
        """images: (B, H, W, 3) f32. Returns {'final': stats, 'final_logits'}
        and, with ``active_sites`` (host site indices), 'ramps' stats and
        'ramp_logits' (K, B, n_classes)."""
        from repro_torch.models.transformer import _stats

        cfg = self.cfg
        x = images.permute(0, 3, 1, 2)
        x = F.relu(group_norm(conv(x, params["stem"]["conv"]), params["stem"]["gn"]))
        pooled = []
        i = 0
        for stage, n in enumerate(cfg.resnet_blocks):
            for b in range(n):
                blk = params["blocks"][i]
                stride = 2 if (b == 0 and stage > 0) else 1
                if cfg.resnet_bottleneck:
                    h = F.relu(group_norm(conv(x, blk["c1"]), blk["g1"]))
                    h = F.relu(group_norm(conv(h, blk["c2"], stride), blk["g2"]))
                    h = group_norm(conv(h, blk["c3"]), blk["g3"])
                else:
                    h = F.relu(group_norm(conv(x, blk["c1"], stride), blk["g1"]))
                    h = group_norm(conv(h, blk["c2"]), blk["g2"])
                x = F.relu(h + shortcut(x, blk, stride))
                pooled.append(torch.mean(x, dim=(2, 3)))  # GAP (the paper's CV pooling)
                i += 1
        logits = pooled[-1].float() @ params["fc"]
        outs = {"final": _stats(logits), "final_logits": logits}
        if active_sites is not None:
            heads = params["ramps"]["head"]
            rl = [pooled[s].float() @ heads[s] for s in map(int, active_sites)]
            rl = (torch.stack(rl) if rl else
                  logits.new_zeros((0, images.shape[0], cfg.n_classes)))
            outs["ramps"] = _stats(rl)
            outs["ramp_logits"] = rl
        return outs

    def loss(self, params, batch, *, mesh=None, **kw):
        """Classification CE + per-ramp CE over every site. No stop-grad: the
        ramps read pooled features that also carry backbone gradients; ramp
        training freezes the backbone through the optimizer mask. With
        ``mesh`` the batch is this rank's data shard (``_cls_losses``)."""
        from repro_torch.models.encdec import _cls_losses, _data_group

        outs = self.forward(params, batch["images"], active_sites=list(self.sites))
        return _cls_losses(outs, batch["labels"].long(), _data_group(mesh))
