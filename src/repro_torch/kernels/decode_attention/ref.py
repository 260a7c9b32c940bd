"""Plain PyTorch version of flash-decode (mirrors the JAX package's ref)."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k, v, pos):
    """q: (B,H,hd); k,v: (B,KH,S,hd); attend to cache slots <= pos.
    `pos` is an int scalar or a (B,) tensor of per-row cache lengths - 1
    (batched slot caches at staggered decode positions)."""
    B, H, hd = q.shape
    KH, S = k.shape[1], k.shape[2]
    G = H // KH
    kk = torch.repeat_interleave(k, G, dim=1)
    vv = torch.repeat_interleave(v, G, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kk.float())
    s = s / math.sqrt(hd)
    mask = (torch.arange(S, device=q.device)[None, None]
            <= torch.as_tensor(pos, device=q.device).reshape(-1, 1, 1))
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vv.float()).to(q.dtype)
