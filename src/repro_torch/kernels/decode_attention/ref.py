"""Plain PyTorch versions of flash-decode, contiguous and paged (mirror the
JAX package's refs)."""
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


def paged_decode_attention_ref(q, k_pool, v_pool, block_table, pos):
    """Paged plain version. q: (B,H,hd); k_pool/v_pool: (P, bs, KH, hd)
    block pools; block_table: int (B, nb) mapping virtual block j of row b
    to a pool block. Gathers each row's blocks back into the contiguous
    (B, KH, nb*bs, hd) layout and defers to ``decode_attention_ref``."""
    B = q.shape[0]
    P, bs, KH, hd = k_pool.shape
    nb = block_table.shape[1]
    tab = block_table.long()
    k = k_pool[tab].reshape(B, nb * bs, KH, hd).transpose(1, 2)
    v = v_pool[tab].reshape(B, nb * bs, KH, hd).transpose(1, 2)
    return decode_attention_ref(q, k, v, pos)
