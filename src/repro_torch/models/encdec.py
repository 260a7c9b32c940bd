"""Encoder-decoder backbone (SeamlessM4T) and encoder classifier (BERT):
the port's counterparts of ``EncDecLM`` and ``EncoderClassifier`` in the
JAX package's ``models/encdec.py``.

``EncDecLM``: the speech frontend is a stub, as in the reference. The
encoder takes precomputed frame embeddings (B, M, d_frontend), projects
them and runs unmasked self-attention with RoPE at positions 0..M-1; the
decoder adds a tanh-gated cross-attention over that memory to every
layer. Ramps attach after every decoder layer but the last (enc-only
intermediates have no output semantics); they are 'fc' ramps. Decode runs
on contiguous rows or on the paged pool, where the cross layers read the
memory's k/v from read-only pinned pages in the trailing
``paged_xkv_blocks`` columns of every table. The sync window is the
decoder-only LM's (``MultiStepDecodeMixin``); the ramp heads and the
cross branch are ``LM``'s code.

A deliberate difference from the reference: its ``prefill`` with a cache
attends the zero ``xkv`` it starts from whatever the frames hold (its
``cross_attn_apply`` prefers the cache to the memory), so the frames reach
only its cacheless prefill and its loss; here a cached prefill projects
the memory, writes its k/v into ``xkv`` and attends them (ROADMAP.md,
Queue 3). Frames are cast to the params' dtype before the projection, as
``LM`` casts image memory.

``EncoderClassifier``: ramps attach after every encoder block but the
last, with CLS-pool + classifier-FC ramps: the paper's BERT recipe (§3.1).

Params keep the reference's schema and leaf paths; stacked layers carry a
leading layer axis, as the reference's scanned params do, and the scan is
a loop over views. The port's kernel choices, which the configs do not
carry: ``prefill_attn`` ('sdpa' | 'kernel') runs a whole-sequence
attention (the encoder's, with no mask; the decoder's causal prefill)
through the flash-attention kernel; ``cfg.decode_attn`` 'kernel' runs
contiguous decode through the flash-decode kernel (the reference
hardwires its dense path there, the same masked softmax) and
'paged-kernel' the pool's; ``cfg.pallas_head`` 'kernel' streams the final
head and the ramp heads through the ramp-head kernels. Each takes its
plain version on CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import layers as LY
from repro_torch.models.common import (
    ParamInfo,
    init_from_schema,
    meta_from_schema,
    specs_from_schema,
    torch_dtype,
    zeros_from_schema,
)
from repro_torch.models.moe import global_value
from repro_torch.models.transformer import (
    LM,
    MultiStepDecodeMixin,
    _gathered,
    _kept,
    _layer,
    _layer_specs,
    _masked_ce,
    _split_of,
    _stats,
    fsdp_use,
    model_split,
    paged_leaf_kinds,
)


def _enc_layer_schema(cfg, L):
    return {
        "ln1": LY.norm_schema(cfg, L),
        "attn": LY.gqa_schema(cfg, L),
        "ln2": LY.norm_schema(cfg, L),
        "ffn": LY.ffn_schema(cfg, cfg.d_ff, L),
    }


def _dec_layer_schema(cfg, L):
    return {
        "ln1": LY.norm_schema(cfg, L),
        "attn": LY.gqa_schema(cfg, L),
        "lnx": LY.norm_schema(cfg, L),
        "xattn": LY.cross_attn_schema(cfg, L),
        "ln2": LY.norm_schema(cfg, L),
        "ffn": LY.ffn_schema(cfg, cfg.d_ff, L),
    }


def ramp_positions(S: int, npos: int) -> np.ndarray:
    """The reference loss's ramp positions, ``jnp.linspace(max(S // npos -
    1, 0), S - 1, npos).astype(int32)``, formed as JAX forms it: in f32,
    ``start * (1 - step) + stop * step`` with the end point appended."""
    lo, hi = np.float32(max(S // npos - 1, 0)), np.float32(S - 1)
    if npos == 1:
        return np.asarray([lo]).astype(np.int32)
    div = npos - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = lo * (np.float32(1.0) - step) + hi * step
    return np.append(out, hi).astype(np.int32)


class EncDecLM(MultiStepDecodeMixin):
    """SeamlessM4T-style backbone: frame-embedding encoder + token decoder
    (module docstring)."""

    # LM's code, which reads only ``cfg`` and ``sites``: the 'fc' ramp
    # features and heads, the head statistics (dense or through the
    # ramp-head kernels) and the gated cross branch over memory, ``xkv``
    # rows or pinned pages
    _ramp_hidden = LM._ramp_hidden
    ramp_head = LM.ramp_head
    ramp_outputs = LM.ramp_outputs
    _head_stats = LM._head_stats
    _head_stats_kernel = LM._head_stats_kernel
    _cross = LM._cross
    _ramp_loss = LM._ramp_loss
    abstract = LM.abstract

    def __init__(self, cfg, *, prefill_attn: str = "sdpa"):
        if prefill_attn not in ("sdpa", "kernel"):
            raise ValueError(f"prefill_attn={prefill_attn!r}: the port takes 'sdpa' | 'kernel'")
        if cfg.ramp_style != "fc":
            raise NotImplementedError(f"ramp_style={cfg.ramp_style!r}: the enc-dec ramps are "
                                      "'fc', as the reference builds them")
        if cfg.decode_attn not in ("dense", "ref", "kernel", "paged", "paged-kernel"):
            raise NotImplementedError(f"decode_attn={cfg.decode_attn!r} is not ported")
        if cfg.pallas_head not in ("off", "kernel"):
            raise ValueError(f"pallas_head={cfg.pallas_head!r}: the port takes 'off' | 'kernel'")
        self.cfg = cfg
        self.prefill_attn = prefill_attn
        self.sites = tuple(range(cfg.n_dec_layers - 1))  # ramps on decoder blocks

    def schema(self) -> dict:
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        S = len(self.sites)
        return {
            "frontend_proj": ParamInfo((cfg.d_frontend, cfg.d_model), dt, "normal:0.02",
                                       (None, "model")),
            "tok": LY.embed_schema(cfg),
            "enc": _enc_layer_schema(cfg, cfg.n_enc_layers),
            "enc_norm": LY.norm_schema(cfg),
            "dec": _dec_layer_schema(cfg, cfg.n_dec_layers),
            "final_norm": LY.norm_schema(cfg),
            "ramps": {
                "norm_w": ParamInfo((S, cfg.d_model), torch.float32, "zeros", ()),
                "head": ParamInfo((S, cfg.d_model, cfg.padded_vocab), dt, "normal:0.02",
                                  (None, "data", "model")),
            },
        }

    def pspecs(self, axes: LY.MeshAxes) -> dict:
        """Every param leaf's partition spec on ``axes`` (the reference's)."""
        return specs_from_schema(LY.resolve_schema(self.schema(), axes))

    def init(self, seed: int = 0, device="cuda") -> dict:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_from_schema(self.schema(), gen, device)

    # -- caches ---------------------------------------------------------------

    def cache_schema(self, B: int, S: int, M: int) -> dict:
        """Contiguous decoder caches: self-attention k/v ``(L, B, S, KH,
        hd)`` and the memory's k/v ``xkv`` ``(L, B, M, KH, hd)``, M the
        frames."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        L, K, hd = cfg.n_dec_layers, cfg.n_kv_heads, cfg.hd

        def info(rows):
            return ParamInfo((L, B, rows, K, hd), dt, "zeros")

        return {"k": info(S), "v": info(S), "xkv": {"k": info(M), "v": info(M)}}

    def init_cache(self, B: int, S: int, M: int, device="cuda") -> dict:
        return zeros_from_schema(self.cache_schema(B, S, M), device)

    def cache_abstract(self, B: int, S: int, M: int) -> dict:
        return meta_from_schema(self.cache_schema(B, S, M))

    def paged_cache_schema(self, n_blocks: int, block_size: int) -> dict:
        """The paged layout: self-attention k/v token pools and read-only
        pinned ``xkv`` pools for the encoder memory, every leaf ``(L, P,
        bs, KH, hd)``. The xkv block ids ride in the LAST
        ``paged_xkv_blocks`` table columns; the memory's token count is
        ``cfg.n_image_tokens`` (the config's frontend-memory knob: speech
        frames here)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        shp = (cfg.n_dec_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.hd)
        hspec = "model" if cfg.hd % 16 == 0 else None

        def info():
            return ParamInfo(shp, dt, "zeros", (None, None, None, None, hspec))

        return {"k": info(), "v": info(), "xkv": {"k": info(), "v": info()}}

    def init_paged_cache(self, n_blocks: int, block_size: int, device="cuda") -> dict:
        return zeros_from_schema(self.paged_cache_schema(n_blocks, block_size), device)

    def paged_cache_kinds(self, n_blocks: int, block_size: int) -> list:
        return paged_leaf_kinds(self.paged_cache_schema(n_blocks, block_size))

    def paged_xkv_blocks(self, block_size: int) -> int:
        """Trailing table columns holding the pinned encoder-memory pages."""
        return -(-self.cfg.n_image_tokens // block_size)

    @property
    def paged_sharing_ok(self) -> bool:
        """Prefix sharing moves token pages between tables; the pinned
        per-slot xkv pages do not share, so a runner refuses
        ``prefix_cache`` for this family, as the reference's does."""
        return False

    # -- encoder --------------------------------------------------------------

    def encode(self, params, frames, *, plain=False, fsdp=None, mesh=None, ms=None):
        """frames: (B, M, d_frontend) -> memory (B, M, d). ``plain`` (the
        loss) runs attention through ``sdpa``. With ``fsdp`` (each leaf's
        use spec, ``fsdp_use``) ``params`` are the rank's parts, each
        gathered where it is used, and with ``ms`` the layers the specs
        split run on the rank's model slice (``LM.loss``)."""
        cfg = self.cfg
        sp = _Specs(fsdp)
        proj = _gathered(params["frontend_proj"], sp["frontend_proj"], mesh)
        h = frames.to(proj.dtype) @ proj
        M = h.shape[1]
        positions = torch.arange(M, device=h.device)[None, :]
        attn = "sdpa" if plain else self.prefill_attn
        enc_sp = sp.layer(params["enc"], "enc")
        split = _split_of(enc_sp, ms)
        for l in range(cfg.n_enc_layers):
            p = _gathered(_layer(params["enc"], l), enc_sp, mesh)
            x = LY.apply_norm(cfg, p["ln1"], h)
            out, _ = LY.attn_apply(cfg, p["attn"], x, positions=positions, mask=None,
                                   prefill_attn=attn, causal=False, ms=split.get("attn"))
            h = h + out
            x = LY.apply_norm(cfg, p["ln2"], h)
            h = h + LY.ffn_apply(cfg, p["ffn"], x, split.get("ffn"))
        return LY.apply_norm(cfg, _gathered(params["enc_norm"], sp["enc_norm"], mesh), h)

    # -- decoder --------------------------------------------------------------

    def _dec_stack(self, params, h, *, positions, mask, memory, caches, cache_index,
                   pool_idx, write_gate=None, block_tables=None, xkv_tables=None,
                   plain=False, fsdp=None, mesh=None, ms=None):
        """Every decoder layer: self-attention, the gated cross-attention
        (``_cross``: over ``memory``, writing its k/v into the ``xkv`` rows
        when there is a cache, else over the ``xkv`` rows or the pinned
        pages at ``xkv_tables``), the FFN. Caches are updated in place.
        With ``fsdp`` each layer gathers its parts and with ``ms`` runs the
        sublayers they split on the rank's model slice (``encode``). Returns
        (h, pooled (L, B, npos, d)), pooled after every layer."""
        cfg = self.cfg
        pooled = []
        dec_sp = _Specs(fsdp).layer(params["dec"], "dec")
        split = _split_of(dec_sp, ms)
        for l in range(cfg.n_dec_layers):
            p = _gathered(_layer(params["dec"], l), dec_sp, mesh)
            c = _layer(caches, l) if caches is not None else None
            x = LY.apply_norm(cfg, p["ln1"], h)
            sub = {k: c[k] for k in ("k", "v")} if c is not None else None
            out, _ = LY.attn_apply(cfg, p["attn"], x, positions=positions, mask=mask, cache=sub,
                                   cache_index=cache_index, decode_impl=cfg.decode_attn,
                                   write_gate=write_gate, block_table=block_tables,
                                   prefill_attn="sdpa" if plain else self.prefill_attn,
                                   ms=split.get("attn"))
            h = h + out
            h = h + self._cross(p, h, c, memory, xkv_tables, ms=split.get("xattn"))
            x = LY.apply_norm(cfg, p["ln2"], h)
            h = h + LY.ffn_apply(cfg, p["ffn"], x, split.get("ffn"))
            pooled.append(h[:, pool_idx])
        return h, torch.stack(pooled)

    # -- public entry points --------------------------------------------------

    def prefill(self, params, frames, tokens, *, active_sites=None, cache_len=None,
                with_cache=True):
        """Encode ``frames``, run the decoder on ``tokens`` (B, S) causally
        over ``cache_len`` keys, and return (caches | None, outs): outs
        carries final + per-active-ramp stats for the LAST position; the
        caches hold the prompt's self-attention k/v and the memory's k/v
        in ``xkv`` (module docstring)."""
        cfg = self.cfg
        B, S = tokens.shape
        dev = tokens.device
        cache_len = cache_len or S
        memory = self.encode(params, frames)
        positions = torch.arange(S, device=dev)[None, :]
        h = LY.embed_apply(cfg, params["tok"], tokens, positions)
        mask = LY.causal_mask(S, cache_len if with_cache else S, 0, device=dev)
        caches = (self.init_cache(B, cache_len, memory.shape[1], device=dev) if with_cache
                  else None)
        h, pooled = self._dec_stack(params, h, positions=positions, mask=mask, memory=memory,
                                    caches=caches, cache_index=0, pool_idx=slice(S - 1, S))
        outs = self._head_stats(params, h[:, -1:], pooled, active_sites)
        return caches, outs

    def decode(self, params, cache, tokens, pos, *, active_sites=None, exit_thresholds=None,
               write_gate=None, block_tables=None):
        """One decoder step. tokens: (B, 1); ``pos`` a 0-d int (every row at
        one write index, as the reference takes it) or an int tensor (B,)
        of per-row indices. On contiguous rows attention masks ``kpos <=
        pos``. With ``block_tables`` (int (B, nb + nbx)) the cache is the
        paged pool of ``init_paged_cache``: self-attention writes and walks
        the token columns, and the cross layers read the memory's
        ``cfg.n_image_tokens`` rows from the pinned pages of the trailing
        ``paged_xkv_blocks`` columns and never write them. ``write_gate``
        switches the self-attention cache write off on device. Returns
        (cache, outs); the cache is updated in place."""
        cfg = self.cfg
        B = tokens.shape[0]
        if block_tables is not None and (not torch.is_tensor(pos) or pos.dim() < 1):
            raise ValueError("paged decode requires per-row pos: int[B]")
        pos = torch.as_tensor(pos, device=tokens.device).to(torch.int64).reshape(-1)
        pos = pos.expand(B).contiguous()
        pc = pos[:, None]
        h = LY.embed_apply(cfg, params["tok"], tokens, pc)
        mask = xkv_tables = None
        if block_tables is not None:
            nbx = self.paged_xkv_blocks(cache["xkv"]["k"].shape[2])
            block_tables, xkv_tables = block_tables[:, :-nbx], block_tables[:, -nbx:]
        else:
            Sc = cache["k"].shape[2]
            mask = (torch.arange(Sc, device=tokens.device)[None, :] <= pc)[:, None, None, :]
        h, pooled = self._dec_stack(params, h, positions=pc, mask=mask, memory=None,
                                    caches=cache, cache_index=pos, pool_idx=slice(0, 1),
                                    write_gate=write_gate, block_tables=block_tables,
                                    xkv_tables=xkv_tables)
        outs = self._head_stats(params, h, pooled, active_sites,
                                exit_thresholds=exit_thresholds)
        return cache, outs

    def loss(self, params, batch, *, mesh=None, fsdp=None, **kw):
        """batch: {'frames': (B, M, d_frontend), 'tokens': (B, S) int,
        'labels': (B, S) int (-1 = pad)}. Returns (lm + ramp loss, metrics):
        the reference's objective, the ramp CE over every site at the
        reference's 16 positions (``ramp_positions``) with the gradient
        stopped at the pooled hidden. Reaches no kernel: attention through
        ``sdpa``, the ramps a site at a time (``LM._ramp_loss``). With
        ``mesh`` the batch is this rank's data shard and the means are the
        global batch's, and with ``fsdp`` (each leaf's sanitized spec) the
        params are the rank's parts, each gathered where it is used, and the
        compute splits over ``model`` (``LM.loss``)."""
        group = _data_group(mesh)
        cfg = self.cfg
        frames, tokens, labels = batch["frames"], batch["tokens"], batch["labels"]
        B, S = tokens.shape
        dev = tokens.device
        use = None if fsdp is None else fsdp_use(cfg, fsdp, mesh)
        ms = None if use is None else model_split(mesh)
        sp = _Specs(use)
        memory = self.encode(params, frames, plain=True, fsdp=use, mesh=mesh, ms=ms)
        positions = torch.arange(S, device=dev)[None, :]
        h = LY.embed_apply(cfg, _gathered(params["tok"], sp["tok"], mesh, ("embed", "pos_embed")),
                           tokens, positions, ms=_kept(sp["tok"], "embed", ms))
        mask = LY.causal_mask(S, S, 0, device=dev)
        npos = min(16, S)
        pool_idx = torch.from_numpy(ramp_positions(S, npos).astype(np.int64)).to(dev)
        h, pooled = self._dec_stack(params, h, positions=positions, mask=mask, memory=memory,
                                    caches=None, cache_index=None, pool_idx=pool_idx,
                                    plain=True, fsdp=use, mesh=mesh, ms=ms)
        h = LY.apply_norm(cfg, _gathered(params["final_norm"], sp["final_norm"], mesh), h)
        head = ("embed",) if cfg.tie_embeddings else ("lm_head",)
        vms = _kept(sp["tok"], head[0], ms)
        lm = _masked_ce(cfg, LY.unembed(cfg, _gathered(params["tok"], sp["tok"], mesh, head), h,
                                        vms), labels, group, vms)
        rloss = self._ramp_loss(params, pooled, labels[:, pool_idx], group=group, mesh=mesh,
                                specs=use, ms=ms)
        return lm + rloss, {"lm_loss": lm, "ramp_loss": rloss}


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
            "cls": ParamInfo((cfg.d_model, cfg.n_classes), torch.float32, "normal:0.02", ()),
            "ramps": {
                "norm_w": ParamInfo((S, cfg.d_model), torch.float32, "zeros", ()),
                "head": ParamInfo((S, cfg.d_model, cfg.n_classes), torch.float32,
                                  "normal:0.02", ()),
            },
        }

    pspecs = EncDecLM.pspecs

    def init(self, seed: int = 0, device="cuda") -> dict:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_from_schema(self.schema(), gen, device)

    abstract = LM.abstract

    def forward(self, params, tokens, *, active_sites=None, prefill_attn=None, fsdp=None,
                mesh=None):
        """tokens: (B, S). Returns {'final': stats, 'final_logits'} over
        n_classes logits (CLS position pooling, the paper's BERT recipe) and,
        with ``active_sites`` (host site indices), 'ramps' stats and
        'ramp_logits' (K, B, n_classes). ``prefill_attn`` overrides the
        model's choice for this call ('sdpa' for the loss). With ``fsdp``
        (each leaf's sanitized spec) ``params`` are the rank's parts, each
        gathered where it is used (the classifier and ramp heads are whole
        in the reference's specs)."""
        cfg = self.cfg
        B, S = tokens.shape
        sp = _Specs(fsdp)
        positions = torch.arange(S, device=tokens.device)[None, :]
        h = LY.embed_apply(cfg, _gathered(params["tok"], sp["tok"], mesh), tokens, positions)
        cls = []
        enc_sp = sp.layer(params["enc"], "enc")
        for l in range(cfg.n_layers):
            p = _gathered(_layer(params["enc"], l), enc_sp, mesh)
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

    def loss(self, params, batch, *, mesh=None, **kw):
        """Classification CE + per-ramp CE over every site, through ``sdpa``
        (the kernel has no backward). The reference's
        ``stop_gradient(0.0) + ramp_logits`` stops nothing, so in 'full'
        training the ramp loss reaches the encoder; the port computes the
        same gradients (ROADMAP.md, Queue 3). With ``mesh`` the batch is
        this rank's data shard (``_cls_losses``)."""
        tokens, labels = batch["tokens"], batch["labels"].long()
        outs = self.forward(params, tokens, active_sites=list(range(len(self.sites))),
                            prefill_attn="sdpa", fsdp=kw.get("fsdp"), mesh=mesh)
        return _cls_losses(outs, labels, _data_group(mesh))


class _Specs:
    """The FSDP specs of a tree of parts, or nothing (every leaf whole)."""

    def __init__(self, specs):
        self.specs = specs

    def __getitem__(self, key):
        return None if self.specs is None else self.specs[key]

    def layer(self, stack, key):
        """One layer's specs of the stacked subtree ``key``."""
        return None if self.specs is None else _layer_specs(stack, self.specs[key])


def _data_group(mesh):
    """The data group of a mesh whose ranks hold shards of the rows, or None."""
    return mesh.data_group if mesh is not None and mesh.data_size > 1 else None


def _cls_losses(outs, labels, group=None):
    """(CE of the final logits + mean CE of every ramp's, metrics): the
    reference's classifier losses, labels (B,) int64. With ``group`` (a
    data group whose ranks hold equal shards of the rows) the means are
    over every shard's rows: values global, gradients this shard's share
    (``global_value``)."""
    lf = outs["final_logits"]
    rl = outs["ramp_logits"]
    idx = labels[None, :, None].expand(rl.shape[0], -1, 1)
    ll = torch.gather(torch.log_softmax(lf, -1), 1, labels[:, None])
    rll = torch.gather(torch.log_softmax(rl, -1), 2, idx)
    if group is None:
        ce, rce = -torch.mean(ll), -torch.mean(rll)
    else:
        D = dist.get_world_size(group)
        ce = global_value(-torch.sum(ll) / (ll.numel() * D), group)
        rce = global_value(-torch.sum(rll) / (rll.numel() * D), group)
    return ce + rce, {"cls_loss": ce, "ramp_loss": rce}
