"""Plain PyTorch version of flash attention (mirrors the JAX package's
``kernels/flash_attention/ref.py``)."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B,H,Sq,hd); k,v: (B,KH,Sk,hd); GQA broadcast; f32 softmax. Query i
    and key j are positions from 0: causal keeps j <= i, ``window`` keeps
    j > i - window."""
    B, H, Sq, hd = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    kk = torch.repeat_interleave(k, G, dim=1)
    vv = torch.repeat_interleave(v, G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float())
    s = s / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)
