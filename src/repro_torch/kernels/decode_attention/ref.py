"""Plain PyTorch versions of flash-decode, contiguous and paged, and of the
paged MLA latent decode (mirror the JAX package's refs)."""
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


def paged_mla_decode_attention_ref(q_lat, q_pe, c_pool, kpe_pool, block_table, pos, *,
                                   scale):
    """Paged MLA (absorbed latent) plain version. q_lat: (B,H,r); q_pe:
    (B,H,dr); c_pool: (P, bs, r) latent pool (keys AND values); kpe_pool:
    (P, bs, dr) shared rope-key pool; block_table: int (B, nb). Gathers
    each row's latent blocks back into the virtually-contiguous
    (B, nb*bs, .) layout and applies the absorbed decode math."""
    B, H, r = q_lat.shape
    P, bs, _ = c_pool.shape
    nb = block_table.shape[1]
    tab = block_table.long()
    c = c_pool[tab].reshape(B, nb * bs, r).float()
    kp = kpe_pool[tab].reshape(B, nb * bs, -1).float()
    s = (
        torch.einsum("bhr,bsr->bhs", q_lat.float(), c)
        + torch.einsum("bhn,bsn->bhs", q_pe.float(), kp)
    ) * scale
    mask = (torch.arange(nb * bs, device=q_lat.device)[None, None]
            <= torch.as_tensor(pos, device=q_lat.device).reshape(-1, 1, 1))
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bsr->bhr", p, c).to(q_lat.dtype)
