"""Shared neural-net building blocks (plain functions on tensors).

The port's counterpart of the JAX package's ``models/layers.py``, for the
generative main path: norms, activations, RoPE, the dense FFN, GQA
attention on a contiguous KV cache (prefill write, then single-token decode
with per-row positions) or on a paged block pool (single-token decode that
walks a per-row block table), MLA (DeepSeek-V2's latent attention) on
both layouts, and the embedding. Params are nested dicts of tensors under
the reference's leaf paths; compute happens in the config's dtype with f32
softmax and norms. Ring, local-window, cross-attention and tensor-parallel
branches are not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamInfo, torch_dtype

# ---------------------------------------------------------------------------
# norms / activations


def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def norm_schema(cfg, L=None) -> dict:
    d = cfg.d_model
    shp = (d,) if L is None else (L, d)
    if cfg.norm_type == "ln":
        return {
            "w": ParamInfo(shp, torch.float32, "ones"),
            "b": ParamInfo(shp, torch.float32, "zeros"),
        }
    return {"w": ParamInfo(shp, torch.float32, "zeros")}


def apply_norm(cfg, p, x):
    if cfg.norm_type == "ln":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_sincos(positions, dim: int, theta: float):
    """positions: int[...]. Returns (sin, cos) of shape positions.shape+(dim/2,)."""
    dev = positions.device
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim))
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (..., S, n, dim) ; sin/cos: (..., S, dim/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU / MLP)


def ffn_schema(cfg, d_ff: int, L=None) -> dict:
    d = cfg.d_model
    dt = torch_dtype(cfg.dtype)
    pre = () if L is None else (L,)
    sc = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "w_gate": ParamInfo(pre + (d, d_ff), dt, "normal:0.02"),
        "w_up": ParamInfo(pre + (d, d_ff), dt, "normal:0.02"),
        "w_down": ParamInfo(pre + (d_ff, d), dt, f"normal:{sc}"),
    }


def ffn_apply(cfg, p, x):
    a = act_fn(cfg.act)
    h = a(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# attention


def gqa_schema(cfg, L=None) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = torch_dtype(cfg.dtype)
    pre = () if L is None else (L,)
    sc = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    sch = {
        "wq": ParamInfo(pre + (d, H * hd), dt, "normal:0.02"),
        "wk": ParamInfo(pre + (d, K * hd), dt, "normal:0.02"),
        "wv": ParamInfo(pre + (d, K * hd), dt, "normal:0.02"),
        "wo": ParamInfo(pre + (H * hd, d), dt, f"normal:{sc}"),
    }
    if cfg.qkv_bias:
        sch["bq"] = ParamInfo(pre + (H * hd,), dt, "zeros")
        sch["bk"] = ParamInfo(pre + (K * hd,), dt, "zeros")
        sch["bv"] = ParamInfo(pre + (K * hd,), dt, "zeros")
    if cfg.qk_norm:
        sch["qnorm"] = ParamInfo(pre + (hd,), torch.float32, "zeros")
        sch["knorm"] = ParamInfo(pre + (hd,), torch.float32, "zeros")
    return sch


def sdpa(q, k, v, mask, scale=None):
    """q: (B,Sq,H,hd) k,v: (B,Sk,K,hd); GQA expansion; f32 softmax.
    mask: broadcastable to (B, H, Sq, Sk) (bool, True = attend)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh = q.reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh, k).float() * scale
    if mask is not None:
        m = mask if mask.dim() == 4 else mask[:, None]
        m = m.reshape(B, K, G, Sq, -1) if m.shape[1] == H else m[:, :, None]
        logits = torch.where(m, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def causal_mask(Sq: int, Sk: int, q_offset, device=None) -> torch.Tensor:
    """(1, 1, Sq, Sk) True where key position <= query position."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    return (kpos <= qpos)[None, None]


def _update_cache_rows(cache_leaf, new, idx, gate=None):
    """Write `new` (B, S_new, ...) into `cache_leaf` (B, S, ...) IN PLACE at
    sequence offset `idx` — an int (all rows at the same position) or an
    int tensor (B,) of per-row positions, scattered at (arange(B), pos).
    Starts are clamped to [0, S - S_new] as JAX's dynamic_update_slice
    clamps them. `gate` (a bool tensor, scalar or (B,)) keeps the old rows
    where False, so a write can be switched off on device without a host
    read. Returns `cache_leaf`."""
    new = new.to(cache_leaf.dtype)
    B, Sn = new.shape[0], new.shape[1]
    Sc = cache_leaf.shape[1]
    if not torch.is_tensor(idx):
        if gate is not None:
            raise ValueError("a gated cache write needs per-row positions")
        i = min(max(int(idx), 0), Sc - Sn)
        cache_leaf[:, i:i + Sn] = new
        return cache_leaf
    rows = torch.arange(B, device=new.device)[:, None]
    cols = torch.clamp(idx.reshape(-1, 1), 0, Sc - Sn) + torch.arange(Sn, device=new.device)
    if gate is not None:
        keep = gate.reshape((-1,) + (1,) * (new.dim() - 1))
        new = torch.where(keep, new, cache_leaf[rows, cols])
    cache_leaf[rows, cols] = new
    return cache_leaf


def _paged_slots(block_table, idx, bs):
    """Pool (block, offset) of each row's write at position ``idx``. A row
    whose ``idx // bs`` lies past its table (a FREE padding row keeps the
    stale pos of a slot freed earlier) writes to the trash block 0, never
    out of range; the reference drops such a write."""
    j = idx // bs
    inside = j < block_table.shape[1]
    j = torch.clamp(j, max=block_table.shape[1] - 1)[:, None]
    blk = torch.where(inside, torch.gather(block_table.long(), 1, j)[:, 0], 0)
    return blk, idx % bs


def _update_pool(pool, new, blk, off, gate=None):
    """Scatter one token per row into a (P, bs, K, hd) pool IN PLACE at
    (blk, off). Duplicate rows (bucket padding) write identical values and
    padding rows all land in the trash block 0. `gate` keeps the old values
    where False, as in ``_update_cache_rows``."""
    new = new.to(pool.dtype)
    if gate is not None:
        keep = gate.reshape((-1,) + (1,) * (new.dim() - 1))
        new = torch.where(keep, new, pool[blk, off])
    pool[blk, off] = new
    return pool


def attn_apply(cfg, p, x, *, positions, mask, cache=None, cache_index=None,
               rope_theta=None, decode_impl: str = "dense", write_gate=None,
               block_table=None, prefill_attn: str = "sdpa", causal: bool = True):
    """GQA attention. If `cache` (dict k,v: (B, S, K, hd)) is given, the new
    k/v are written into it in place at `cache_index` (an int, or a per-row
    int tensor (B,)) and attention runs against the cache. `decode_impl`
    selects the single-token cache-attention path: 'dense' (masked sdpa),
    'ref' (the flash-decode plain version) or 'kernel' (the CUDA
    flash-decode kernel; its plain version on CPU tensors). `write_gate`
    gates the cache write (see ``_update_cache_rows``).

    With `block_table` (int (B, nb)), `cache` is a PAGED block pool (k/v:
    (P, bs, K, hd)): the single decode token is written to pool slot
    ``(block_table[b, pos // bs], pos % bs)`` and attention walks the
    table; `decode_impl` must be 'paged' (the plain version) or
    'paged-kernel' (the CUDA paged kernel; its plain version on CPU
    tensors).

    `prefill_attn` selects a whole-prompt prefill's attention (S > 1 written
    at cache index 0, or no cache): 'sdpa' under `mask`, or 'kernel', the
    flash-attention kernel (its plain version on CPU tensors), which reads
    `causal` in place of `mask`: True, the causal mask from query 0 that
    ``LM.prefill`` builds; False, no mask, the encoder's (its `mask` is
    None). Returns (out, cache)."""
    B, S, d = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"])
        k = rms_norm(k, p["knorm"])
    if cfg.pos_type == "rope":
        theta = rope_theta if rope_theta is not None else cfg.rope_theta
        sin, cos = rope_sincos(positions, hd, theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    if block_table is not None:
        if cache is None or S != 1:
            raise ValueError("paged attention is a single-token decode path "
                             "over a block pool")
        if not decode_impl.startswith("paged"):
            raise ValueError(f"block_table given but decode_impl={decode_impl!r}")
        from repro_torch.kernels.decode_attention import attend_decode_paged

        idx = cache_index.reshape(-1).long()
        blk, off = _paged_slots(block_table, idx, cache["k"].shape[1])
        _update_pool(cache["k"], k[:, 0], blk, off, write_gate)
        _update_pool(cache["v"], v[:, 0], blk, off, write_gate)
        out = attend_decode_paged(q[:, 0], cache["k"], cache["v"], block_table, idx,
                                  use_kernel=decode_impl == "paged-kernel")[:, None]
        return out.reshape(B, S, H * hd) @ p["wo"], cache
    if cache is not None:
        k = _update_cache_rows(cache["k"], k, cache_index, write_gate)
        v = _update_cache_rows(cache["v"], v, cache_index, write_gate)
    if decode_impl != "dense" and cache is not None and S == 1:
        # flash-decode path: one query token against the whole cache,
        # masked by position. The (B, KH, S, hd) views read the cache in
        # its (B, S, KH, hd) storage by stride: no transpose copy.
        from repro_torch.kernels.decode_attention import attend_decode

        out = attend_decode(
            q[:, 0], k.transpose(1, 2), v.transpose(1, 2), cache_index,
            use_kernel=decode_impl == "kernel",
        )[:, None]
    elif prefill_attn == "kernel" and S > 1 and not torch.is_tensor(cache_index) \
            and not cache_index:
        from repro_torch.kernels.flash_attention import attention

        # (B, H, S, hd) views of the projections and the cache: no copies
        out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal).transpose(1, 2)
    else:
        out = sdpa(q, k, v, mask)
    out = out.reshape(B, S, H * hd)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)


def mla_schema(cfg, L=None) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = torch_dtype(cfg.dtype)
    pre = () if L is None else (L,)
    sc = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "wq": ParamInfo(pre + (d, H * (dn + dr)), dt, "normal:0.02"),
        "w_dkv": ParamInfo(pre + (d, r + dr), dt, "normal:0.02"),
        "kv_norm": ParamInfo(pre + (r,), torch.float32, "zeros"),
        "w_uk": ParamInfo(pre + (r, H * dn), dt, "normal:0.02"),
        "w_uv": ParamInfo(pre + (r, H * dv), dt, "normal:0.02"),
        "wo": ParamInfo(pre + (H * dv, d), dt, f"normal:{sc}"),
    }


def mla_apply(cfg, p, x, *, positions, mask, cache=None, cache_index=None,
              absorbed: bool = False, decode_impl: str = "dense", write_gate=None,
              block_table=None):
    """MLA attention. The cache holds the compressed kv latent ``c`` (B, S, r)
    and the shared rope key ``k_pe`` (B, S, dr), written IN PLACE at
    `cache_index` (gated by `write_gate`, see ``_update_cache_rows``).
    `absorbed=True` scores the query against the latent directly (the
    latent-space decode; math-equivalent to the unabsorbed path).

    With `block_table` (int (B, nb)) the cache is a PAGED pool over the
    latent streams (``c`` (P, bs, r), ``k_pe`` (P, bs, dr)) and
    `cache_index` is each row's true position: the decode token's latents
    go to ``(table[b, pos // bs], pos % bs)`` (a stale pos past the table
    to the trash block 0, see ``_paged_slots``). With `absorbed` and
    `decode_impl='paged-kernel'` the walk runs in
    ``attend_decode_paged_mla`` (the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors); otherwise the table is gathered back into a
    contiguous stream and the contiguous math below runs on it. Returns
    (out, cache)."""
    B, S, d = x.shape
    H = cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = x @ p["w_dkv"]  # (B,S,r+dr)
    c, k_pe = ckv[..., :r], ckv[..., r:]
    c = rms_norm(c, p["kv_norm"])
    sin, cos = rope_sincos(positions, dr, cfg.rope_theta)
    q_pe = apply_rope(q_pe, sin, cos)
    k_pe = apply_rope(k_pe[:, :, None, :], sin, cos)[:, :, 0]  # single shared head
    scale = 1.0 / math.sqrt(dn + dr)
    if block_table is not None:
        if cache is None or S != 1:
            raise ValueError("paged MLA is a single-token decode path over "
                             "a latent block pool")
        if not decode_impl.startswith("paged"):
            raise ValueError(f"block_table given but decode_impl={decode_impl!r}")
        bsz = cache["c"].shape[1]
        idx = cache_index.reshape(-1).long()
        blk, off = _paged_slots(block_table, idx, bsz)
        _update_pool(cache["c"], c[:, 0], blk, off, write_gate)
        _update_pool(cache["k_pe"], k_pe[:, 0], blk, off, write_gate)
        if absorbed and decode_impl == "paged-kernel":
            from repro_torch.kernels.decode_attention import attend_decode_paged_mla

            wuk = p["w_uk"].reshape(r, H, dn)
            q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wuk)[:, 0]  # (B,H,r)
            ctx = attend_decode_paged_mla(q_lat, q_pe[:, 0], cache["c"], cache["k_pe"],
                                          block_table, idx, scale=scale)  # (B,H,r)
            wuv = p["w_uv"].reshape(r, H, dv)
            out = torch.einsum("bhr,rhv->bhv", ctx, wuv)[:, None]
            return out.reshape(B, S, H * dv) @ p["wo"], cache
        # the plain oracle (and the unabsorbed paged path): gather the table
        # back into a contiguous latent stream, mask kpos <= pos, and fall
        # through to the contiguous math
        nb = block_table.shape[1]
        tab = block_table.long()
        c = cache["c"][tab].reshape(B, nb * bsz, r)
        k_pe = cache["k_pe"][tab].reshape(B, nb * bsz, dr)
        kpos = torch.arange(nb * bsz, device=x.device)[None, :]
        mask = (kpos <= idx[:, None])[:, None, None, :]
    elif cache is not None:
        c = _update_cache_rows(cache["c"], c, cache_index, write_gate)
        k_pe = _update_cache_rows(cache["k_pe"], k_pe, cache_index, write_gate)
    Sk = c.shape[1]
    if absorbed:
        # q_nope' = q_nope @ w_uk^T: score against the latent directly
        wuk = p["w_uk"].reshape(r, H, dn)
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wuk)
        s_nope = torch.einsum("bqhr,bsr->bhqs", q_lat, c)
        s_pe = torch.einsum("bqhn,bsn->bhqs", q_pe, k_pe)
        logits = (s_nope + s_pe).float() * scale
        if mask is not None:
            logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(c.dtype)
        ctx = torch.einsum("bhqs,bsr->bqhr", probs, c)
        wuv = p["w_uv"].reshape(r, H, dv)
        out = torch.einsum("bqhr,rhv->bqhv", ctx, wuv)
    else:
        k_nope = (c @ p["w_uk"]).reshape(B, Sk, H, dn)
        v = (c @ p["w_uv"]).reshape(B, Sk, H, dv)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(B, Sk, H, dr)], dim=-1)
        qq = torch.cat([q_nope, q_pe], dim=-1)
        out = sdpa(qq, k, v, mask, scale=scale)
    out = out.reshape(B, S, H * dv)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# embedding / unembedding


def embed_schema(cfg) -> dict:
    Vp, d = cfg.padded_vocab, cfg.d_model
    dt = torch_dtype(cfg.dtype)
    sch = {"embed": ParamInfo((Vp, d), dt, "embed:0.02")}
    if cfg.pos_type == "learned":
        sch["pos_embed"] = ParamInfo((cfg.max_position, d), dt, "embed:0.02")
    if not cfg.tie_embeddings:
        sch["lm_head"] = ParamInfo((d, Vp), dt, "normal:0.02")
    return sch


def embed_apply(cfg, p, tokens, positions=None):
    h = p["embed"][tokens]
    if cfg.pos_type == "learned":
        h = h + p["pos_embed"][positions]
    return h


def unembed(cfg, p, h):
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return h @ w
