"""Shared neural-net building blocks (plain functions on tensors).

The port's counterpart of the JAX package's ``models/layers.py``, for the
generative main path: norms, activations, RoPE, the dense FFN, GQA
attention on a contiguous KV cache (prefill write, then single-token decode
with per-row positions) or on a paged block pool (single-token decode that
walks a per-row block table), MLA (DeepSeek-V2's latent attention) on
both layouts, and the embedding. Params are nested dicts of tensors under
the reference's leaf paths; compute happens in the config's dtype with f32
softmax and norms. Local sliding-window layers (Gemma3) run on a full
cache, on a W-row ring cache or as ring pages on the pool. The gated
cross-attention of Llama-3.2-Vision attends image memory, or its k/v as
a cache holds them. Tensor-parallel decode runs a rank's heads and
hidden units on column slices (``ffn_apply_tp``, ``out_proj=False``); the
loss runs them on Megatron's column and row slices (``ModelSplit``).

Every schema leaf carries the reference's partition spec (a plain tuple,
``models/common.py``) with the placeholders ``"data"`` and ``"model"``;
``MeshAxes`` and ``resolve_schema`` map them onto a mesh's axes, as the
reference's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamInfo, torch_dtype, tree_map


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Mesh axis naming + sharding policy (the reference's).

    data: axis (or tuple of axes) for batch / FSDP sharding.
    model: axis for tensor/expert parallelism.
    fsdp: if True, parameters are additionally sharded over `data`
          (training); if False they are sharded over `model` only (serving).
    """

    data: Tuple[str, ...] = ("data",)
    model: Optional[str] = "model"
    fsdp: bool = True

    @property
    def d(self):  # data spec entry
        return self.data if len(self.data) > 1 else self.data[0]

    def wspec(self, *entries) -> tuple:
        """Weight spec: replace 'data' by the data axes iff fsdp, 'model' by
        the model axis (or None when the mesh has no model axis)."""
        out = []
        for e in entries:
            if e == "data":
                out.append(self.d if self.fsdp else None)
            elif e == "model":
                out.append(self.model)
            else:
                out.append(e)
        return tuple(out)

    def aspec(self, *entries) -> tuple:
        """Activation spec: 'data' always maps to the data axes."""
        out = []
        for e in entries:
            if e == "data":
                out.append(self.d)
            elif e == "model":
                out.append(self.model)
            else:
                out.append(e)
        return tuple(out)


TEST_AXES = MeshAxes(data=("data",), model="model", fsdp=False)

# The reference's ``constrain`` (``with_sharding_constraint`` on an
# activation) has no counterpart: it only tells XLA's partitioner where an
# activation should live. Here each rank holds its activations as its code
# computes them, and a param is gathered where it is used
# (``distributed.fsdp_gather_ad``).


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """A rank's place in its model group when the loss computes the rank's
    slice of a sublayer, where the reference's GSPMD splits it over
    ``model`` (Megatron's design, which the storage specs give): the
    products into the sublayer take column slices (``wq``/``wk``/``wv``,
    ``w_gate``/``w_up``: the rank's heads or hidden units), the product out
    of it a row slice (``wo``/``w_down``), and the heads the vocabulary's
    columns. ``enter`` goes before the column products (identity; the
    gradient summed over the group), ``row`` is the row product, its
    partials summed over the group in f32 and rounded once (gradient
    identity); ``sum`` and ``max`` reduce a vocabulary-parallel term.

    m: ranks of the model group; index: this rank's place in it; group:
    the model group (``torch.distributed``)."""

    m: int
    index: int
    group: Any

    def enter(self, x):
        from repro_torch.distributed import to_model_region

        return to_model_region(x, self.group)

    def sum(self, y):
        from repro_torch.distributed import from_model_region

        return from_model_region(y, self.group)

    def max(self, t):
        from repro_torch.distributed import max_over

        return max_over(t, self.group)

    def row(self, h, w):
        """``h @ w`` over the rank's rows of ``w``, summed over the group:
        each rank's partial a GEMM in the dtype (accumulated in f32), the
        partials summed in f32 and rounded once to the dtype."""
        return self.sum(h @ w)

    def heads(self, cfg, p):
        """The rank's attention: the config of its ``H / m`` query heads on
        the kv heads they read (``head_dim`` pinned, as ``LM._tp_cfg`` pins
        it), and ``p`` with ``wk``/``wv`` (``bk``/``bv``) cut to that kv
        head where they are whole: ``m`` is then a multiple of KH
        (``fsdp_use``), so a rank's heads read one kv head."""
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        Kl = p["wk"].shape[-1] // hd
        if Kl == K:
            j = self.index * K // self.m
            cols = slice(j * hd, (j + 1) * hd)
            p = {k: v[..., cols] if k in ("wk", "wv", "bk", "bv") else v for k, v in p.items()}
            Kl = 1
        return cfg.replace(n_heads=H // self.m, n_kv_heads=Kl, head_dim=hd), p


def _resolve_spec(info: ParamInfo, axes: MeshAxes) -> ParamInfo:
    """Rewrite placeholder axis names 'data'/'model' in a spec via axes."""
    return dataclasses.replace(info, spec=axes.wspec(*info.spec))


def resolve_schema(schema, axes: MeshAxes):
    return tree_map(lambda i: _resolve_spec(i, axes), schema)

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
            "w": ParamInfo(shp, torch.float32, "ones", ()),
            "b": ParamInfo(shp, torch.float32, "zeros", ()),
        }
    return {"w": ParamInfo(shp, torch.float32, "zeros", ())}


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
    pfx = (None,) * len(pre)
    sc = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "w_gate": ParamInfo(pre + (d, d_ff), dt, "normal:0.02", (*pfx, "data", "model")),
        "w_up": ParamInfo(pre + (d, d_ff), dt, "normal:0.02", (*pfx, "data", "model")),
        "w_down": ParamInfo(pre + (d_ff, d), dt, f"normal:{sc}", (*pfx, "model", "data")),
    }


def ffn_apply(cfg, p, x, ms: Optional[ModelSplit] = None):
    """The gated FFN. With ``ms`` ``p`` holds the rank's hidden units:
    column slices of ``w_gate``/``w_up`` and a row slice of ``w_down``."""
    a = act_fn(cfg.act)
    if ms is not None:
        x = ms.enter(x)
    h = a(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"] if ms is None else ms.row(h, p["w_down"])


def ffn_apply_tp(cfg, p, x, gather):
    """Tensor-parallel FFN over column-sliced params (the reference's
    ``ffn_apply_tp``): ``p`` holds this rank's column slice of
    ``w_gate``/``w_up`` (d, d_ff/m) and of ``w_down`` along its OUTPUT dim
    (d_ff, d/m); ``gather(y)`` concatenates the ranks' slices along the last
    axis (a tiled all-gather over the model group; plain tiling under the
    meta audit). Each output column of a product is computed on its own, so
    the composition is ``ffn_apply`` on the full weights column by column,
    with no sum across ranks (a row split + all-reduce would reassociate
    the contraction)."""
    a = act_fn(cfg.act)
    h = gather(a(x @ p["w_gate"]) * (x @ p["w_up"]))
    return gather(h @ p["w_down"])


# ---------------------------------------------------------------------------
# attention


def gqa_schema(cfg, L=None) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = torch_dtype(cfg.dtype)
    pre = () if L is None else (L,)
    pfx = (None,) * len(pre)
    sc = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    sch = {
        "wq": ParamInfo(pre + (d, H * hd), dt, "normal:0.02", (*pfx, "data", "model")),
        "wk": ParamInfo(pre + (d, K * hd), dt, "normal:0.02", (*pfx, "data", "model")),
        "wv": ParamInfo(pre + (d, K * hd), dt, "normal:0.02", (*pfx, "data", "model")),
        "wo": ParamInfo(pre + (H * hd, d), dt, f"normal:{sc}", (*pfx, "model", "data")),
    }
    if cfg.qkv_bias:
        sch["bq"] = ParamInfo(pre + (H * hd,), dt, "zeros", (*pfx, "model"))
        sch["bk"] = ParamInfo(pre + (K * hd,), dt, "zeros", (*pfx, "model"))
        sch["bv"] = ParamInfo(pre + (K * hd,), dt, "zeros", (*pfx, "model"))
    if cfg.qk_norm:
        sch["qnorm"] = ParamInfo(pre + (hd,), torch.float32, "zeros", ())
        sch["knorm"] = ParamInfo(pre + (hd,), torch.float32, "zeros", ())
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
        m = m.reshape(B, K, G, Sq, -1) if m.shape[1] == H > 1 else m[:, :, None]
        logits = torch.where(m, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def causal_mask(Sq: int, Sk: int, q_offset, device=None) -> torch.Tensor:
    """(1, 1, Sq, Sk) True where key position <= query position."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    return (kpos <= qpos)[None, None]


def window_mask(Sq: int, Sk: int, q_offset, window: int, device=None) -> torch.Tensor:
    """(1, 1, Sq, Sk) True where query - window < key position <= query."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    return ((kpos <= qpos) & (kpos > qpos - window))[None, None]


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
               rope_theta=None, ring_window=None, local_window=None,
               decode_impl: str = "dense", write_gate=None, block_table=None,
               prefill_attn: str = "sdpa", causal: bool = True, out_proj: bool = True,
               ms: Optional[ModelSplit] = None):
    """GQA attention. If `cache` (dict k,v: (B, S, K, hd)) is given, the new
    k/v are written into it in place at `cache_index` (an int, or a per-row
    int tensor (B,)) and attention runs against the cache. `decode_impl`
    selects the single-token cache-attention path: 'dense' (masked sdpa),
    'ref' (the flash-decode plain version) or 'kernel' (the CUDA
    flash-decode kernel; its plain version on CPU tensors). `write_gate`
    gates the cache write (see ``_update_cache_rows``).

    Local sliding-window layers, as the reference runs them:
    `ring_window=W` stores only the last W tokens (slot = pos % W; the
    caller passes ``cache_index = pos % W`` at decode); a prefill fills the
    ring with the newest token of each slot and attends its in-flight k/v
    under `mask` (the window mask). `local_window=W` marks a local layer on
    a FULL cache: its prefill writes every token but attends the in-flight
    k/v too. A local decode step gathers the W window rows in chronological
    order (positions pos-W+1..pos) and attends them through masked ``sdpa``
    with the pre-window columns masked, so full, ring and paged local
    decode reduce over the same W columns in the same order; no kernel
    runs there, as in the reference.

    With `block_table` (int (B, nb)), `cache` is a PAGED block pool (k/v:
    (P, bs, K, hd)): the single decode token is written to pool slot
    ``(block_table[b, pos // bs], pos % bs)`` and attention walks the
    table; `decode_impl` must be 'paged' (the plain version) or
    'paged-kernel' (the CUDA paged kernel; its plain version on CPU
    tensors). A paged local layer passes `ring_window` and the TRUE
    position: the write goes to virtual row ``pos % W`` (the first
    ``ceil(W / bs)`` table entries), then the W live rows are gathered in
    order as above.

    `prefill_attn` selects a whole-prompt prefill's attention (S > 1 written
    at cache index 0, or no cache): 'sdpa' under `mask`, or 'kernel', the
    flash-attention kernel (its plain version on CPU tensors), which reads
    `causal` in place of `mask`: True, the causal mask from query 0 that
    ``LM.prefill`` builds; False, no mask, the encoder's (its `mask` is
    None); a local layer adds its window. `out_proj=False` returns the
    concatenated head outputs (B, S, H*hd) without ``wo``: tensor-parallel
    decode applies ``wo`` after gathering the heads.

    With ``ms`` (the loss: no cache) ``p`` holds the rank's ``H / m`` query
    heads, column slices of ``wq`` (``bq``) and a row slice of ``wo``, and
    the rank's column slices of ``wk``/``wv`` or, where they are whole, the
    leaves whole (``ModelSplit.heads``); ``x`` enters the model region and
    ``wo``'s partials are summed over it. Returns (out, cache)."""
    if ms is not None:
        if cache is not None:
            raise ValueError("a model-split attention is the loss's: no cache")
        cfg, p = ms.heads(cfg, p)
        x = ms.enter(x)
    B, S, d = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def proj(o):
        o = o.reshape(B, S, H * hd)
        if not out_proj:
            return o
        return o @ p["wo"] if ms is None else ms.row(o, p["wo"])

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
    W = ring_window if ring_window is not None else local_window
    if block_table is not None:
        if cache is None or S != 1:
            raise ValueError("paged attention is a single-token decode path "
                             "over a block pool")
        if not decode_impl.startswith("paged"):
            raise ValueError(f"block_table given but decode_impl={decode_impl!r}")
        bsz = cache["k"].shape[1]
        idx = cache_index.reshape(-1).long()
        if ring_window is not None:
            # write virtual row pos % W through the table, then gather the W
            # live rows in chronological order (virtual row tpos % W of the
            # first ceil(W / bs) entries): the contiguous ring's arithmetic
            blk, off = _paged_slots(block_table, idx % W, bsz)
            _update_pool(cache["k"], k[:, 0], blk, off, write_gate)
            _update_pool(cache["v"], v[:, 0], blk, off, write_gate)
            tpos = idx[:, None] - (W - 1) + torch.arange(W, device=x.device)[None, :]
            slot = tpos % W
            # pre-window columns (tpos < 0) are masked: where their rows
            # would lie past the table they read its last entry instead
            nbw = min(-(-W // bsz), block_table.shape[1])
            sblk = torch.gather(block_table.long(), 1, torch.clamp(slot // bsz, max=nbw - 1))
            out = sdpa(q, cache["k"][sblk, slot % bsz], cache["v"][sblk, slot % bsz],
                       (tpos >= 0)[:, None, None, :])
            return proj(out), cache
        from repro_torch.kernels.decode_attention import attend_decode_paged

        blk, off = _paged_slots(block_table, idx, bsz)
        _update_pool(cache["k"], k[:, 0], blk, off, write_gate)
        _update_pool(cache["v"], v[:, 0], blk, off, write_gate)
        out = attend_decode_paged(q[:, 0], cache["k"], cache["v"], block_table, idx,
                                  use_kernel=decode_impl == "paged-kernel")[:, None]
        return proj(out), cache
    if cache is not None:
        if ring_window is not None and S > 1:
            # prefill into a ring: slot j holds the newest token t = j (mod
            # W); a ring shorter than W (a cache shorter than the window)
            # keeps its first rows, the prompt's tokens
            j = torch.arange(W, device=x.device)
            t = torch.clamp((S - 1) - ((S - 1 - j) % W), min=0)[:cache["k"].shape[1]]
            cache["k"].copy_(k[:, t])
            cache["v"].copy_(v[:, t])
        else:
            ck = _update_cache_rows(cache["k"], k, cache_index, write_gate)
            cv = _update_cache_rows(cache["v"], v, cache_index, write_gate)
            if local_window is None or S == 1:
                k, v = ck, cv
            # a local prefill on a full cache attends the in-flight (S-long)
            # k/v, as the ring prefill does
        if W is not None and S == 1:
            tpos = positions.reshape(-1, 1) - (W - 1) + torch.arange(W, device=x.device)
            # slots stay inside the cache: a ring shorter than W (see above),
            # or a row whose stale pos lies past the cache (a FREE padding
            # row, a gated step past the window's end) reads its last row
            last = cache["k"].shape[1] - 1
            slot = torch.clamp(tpos % W if ring_window is not None else tpos, 0, last)
            rows = torch.arange(B, device=x.device)[:, None]
            slot = slot.expand(B, W)
            k, v = cache["k"][rows, slot], cache["v"][rows, slot]  # (B, W, KH, hd)
            # pre-window columns gather arbitrary live rows: exact-zero probs
            mask = (tpos >= 0).expand(B, W)[:, None, None, :]
    if decode_impl != "dense" and cache is not None and S == 1 and W is None:
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
                        causal=causal, window=W).transpose(1, 2)
    else:
        out = sdpa(q, k, v, mask)
    return proj(out), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)


def mla_schema(cfg, L=None) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = torch_dtype(cfg.dtype)
    pre = () if L is None else (L,)
    pfx = (None,) * len(pre)
    sc = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "wq": ParamInfo(pre + (d, H * (dn + dr)), dt, "normal:0.02", (*pfx, "data", "model")),
        "w_dkv": ParamInfo(pre + (d, r + dr), dt, "normal:0.02", (*pfx, "data", None)),
        "kv_norm": ParamInfo(pre + (r,), torch.float32, "zeros", ()),
        "w_uk": ParamInfo(pre + (r, H * dn), dt, "normal:0.02", (*pfx, "data", "model")),
        "w_uv": ParamInfo(pre + (r, H * dv), dt, "normal:0.02", (*pfx, "data", "model")),
        "wo": ParamInfo(pre + (H * dv, d), dt, f"normal:{sc}", (*pfx, "model", "data")),
    }


def mla_apply(cfg, p, x, *, positions, mask, cache=None, cache_index=None,
              absorbed: bool = False, decode_impl: str = "dense", write_gate=None,
              block_table=None, ms: Optional[ModelSplit] = None):
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
    contiguous stream and the contiguous math below runs on it.

    With ``ms`` (the loss: no cache) ``p`` holds the rank's ``H / m`` heads:
    head-major column slices of ``wq``, ``w_uk`` and ``w_uv`` and a row
    slice of ``wo``; ``w_dkv`` and ``kv_norm`` are whole, so the latent
    ``c`` and the rope key are computed whole and then enter the model
    region. Returns (out, cache)."""
    B, S, d = x.shape
    H = cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if ms is not None:
        if cache is not None:
            raise ValueError("a model-split MLA is the loss's: no cache")
        H = p["wq"].shape[-1] // (dn + dr)
    q = ((x if ms is None else ms.enter(x)) @ p["wq"]).reshape(B, S, H, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = x @ p["w_dkv"]  # (B,S,r+dr)
    c, k_pe = ckv[..., :r], ckv[..., r:]
    c = rms_norm(c, p["kv_norm"])
    sin, cos = rope_sincos(positions, dr, cfg.rope_theta)
    q_pe = apply_rope(q_pe, sin, cos)
    k_pe = apply_rope(k_pe[:, :, None, :], sin, cos)[:, :, 0]  # single shared head
    if ms is not None:
        c, k_pe = ms.enter(c), ms.enter(k_pe)
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
    return (out @ p["wo"] if ms is None else ms.row(out, p["wo"])), cache


# ---------------------------------------------------------------------------
# cross-attention (Llama-3.2-Vision's image layers)


def cross_attn_schema(cfg, L=None) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = torch_dtype(cfg.dtype)
    pre = () if L is None else (L,)
    pfx = (None,) * len(pre)
    sc = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "wq": ParamInfo(pre + (d, H * hd), dt, "normal:0.02", (*pfx, "data", "model")),
        "wk": ParamInfo(pre + (d, K * hd), dt, "normal:0.02", (*pfx, "data", "model")),
        "wv": ParamInfo(pre + (d, K * hd), dt, "normal:0.02", (*pfx, "data", "model")),
        "wo": ParamInfo(pre + (H * hd, d), dt, f"normal:{sc}", (*pfx, "model", "data")),
        "gate": ParamInfo(pre, torch.float32, "zeros", pfx),
    }


def cross_attn_apply(cfg, p, x, memory=None, kv_cache=None, ms: Optional[ModelSplit] = None):
    """x: (B, S, d); memory (B, M, d), whose k/v are projected here, or
    k/v (B, M, KH, hd) taken as they are from ``kv_cache``. Unmasked
    ``sdpa`` over the M memory tokens (the reference calls its plain sdpa
    here, no kernel), then the tanh-gated residual branch of Llama-vision
    (an f32 gate, zero at init). Returns (out, {"k", "v"}); with ``ms``
    (the loss, over ``memory``) the rank's heads, as ``attn_apply`` runs
    them."""
    if ms is not None:
        cfg, p = ms.heads(cfg, p)
        x, memory = ms.enter(x), ms.enter(memory)
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if memory is not None:
        M = memory.shape[1]
        k = (memory @ p["wk"]).reshape(B, M, K, hd)
        v = (memory @ p["wv"]).reshape(B, M, K, hd)
    elif kv_cache is not None:
        k, v = kv_cache["k"], kv_cache["v"]
    else:
        raise ValueError("cross-attention needs image memory or a cache holding its k/v")
    out = sdpa(q, k, v, None).reshape(B, S, H * hd)
    out = out @ p["wo"] if ms is None else ms.row(out, p["wo"])
    return torch.tanh(p["gate"].float()).to(out.dtype) * out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# embedding / unembedding


def embed_schema(cfg) -> dict:
    # vocab-parallel (Megatron): vocab over `model`, `data` FSDP on the d dim
    Vp, d = cfg.padded_vocab, cfg.d_model
    dt = torch_dtype(cfg.dtype)
    sch = {"embed": ParamInfo((Vp, d), dt, "embed:0.02", ("model", "data"))}
    if cfg.pos_type == "learned":
        sch["pos_embed"] = ParamInfo((cfg.max_position, d), dt, "embed:0.02", (None, "model"))
    if not cfg.tie_embeddings:
        sch["lm_head"] = ParamInfo((d, Vp), dt, "normal:0.02", ("data", "model"))
    return sch


def embed_apply(cfg, p, tokens, positions=None, ms: Optional[ModelSplit] = None):
    """The token (and learned position) embedding. With ``ms`` ``embed``
    holds the rank's rows of the vocabulary: a token outside them reads
    zeros, and the sum over the model group is exact (one term nonzero)."""
    if ms is None:
        h = p["embed"][tokens]
    else:
        n = p["embed"].shape[0]
        loc = tokens - ms.index * n
        mine = (loc >= 0) & (loc < n)
        h = ms.sum(p["embed"][torch.where(mine, loc, 0)] * mine[..., None].to(p["embed"].dtype))
    if cfg.pos_type == "learned":
        h = h + p["pos_embed"][positions]
    return h


def head_logits(h, w, ms: Optional[ModelSplit] = None):
    """A head's logits ``h @ w``; with ``ms`` ``w`` holds the rank's
    vocabulary columns, and ``h`` enters the model region."""
    return (h if ms is None else ms.enter(h)) @ w


def unembed(cfg, p, h, ms: Optional[ModelSplit] = None):
    """The LM head's logits; with ``ms`` the rank's vocabulary columns (the
    rank's rows of ``embed``, or its columns of ``lm_head``)."""
    return head_logits(h, p["embed"].T if cfg.tie_embeddings else p["lm_head"], ms)
