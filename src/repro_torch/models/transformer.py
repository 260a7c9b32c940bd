"""Decoder-only LM for the generative main path: attention + dense-FFN
stacks, MLA + MoE stacks with leading dense layers (DeepSeek-V2), and
attention-free Mamba2 (SSD) stacks.

The port's counterpart of the JAX package's ``models/transformer.py``. The
layer stack follows the same *plan* (a period of slots repeated
``n_periods`` times); params of the period's slots carry a leading
``n_periods`` axis, as the reference's scanned params do, and the scan
becomes a loop over views ``p[l]``. Early-exit ramps attach at block
boundaries: pooled hidden -> per-ramp RMSNorm -> per-ramp LM head
(``ramp_style`` 'fc'), with a GELU MLP residual before the head ('mlp'),
or onto the model's own LM head ('tied').

Differences from the reference that are PyTorch idiom, not semantics:
``active_sites`` is a host sequence of site indices (there is no
recompile to avoid, and a host index keeps ``head[site]`` a view instead
of a 472 MB gather); the KV cache is updated in place; ``decode_multi``'s
``lax.while_loop`` is a Python loop whose writes past the window's end are
switched off on device, so the host reads nothing inside a window and the
runner can capture the window as one CUDA graph. Decode
runs on a contiguous cache or on a paged block pool (full attention, MLA
latents, or one mamba state page a slot). Serving runs MoE on the dense
dispatch (the reference's ``moe_impl='dense'``, what its serving runner
passes); ``loss`` takes ``moe_impl`` 'ep' (the default, as in the
reference) or 'dense'. Ring, local, hybrid (jamba) and cross-attention
slots are not ported.

``loss`` is the training objective. Like the reference's, it reaches no
kernel: attention through ``sdpa``, the mamba scan through ``ssd_ref``,
the ramps through the dense ``ramp_outputs`` (the kernel dispatchers have
no backward and raise under autograd). An 'mlp' ramp is served as it is
trained: the kernel head path applies its residual before the head, as
the reference's dense path does (the reference's Pallas head path skips
it; ROADMAP.md, Queue 3).

Two choices of the port that the configs do not carry (so that they stay
field-for-field the reference's): ``prefill_attn`` ('sdpa' | 'kernel')
runs a whole-prompt prefill's attention through the flash-attention
kernel, and ``ssd_impl`` ('ref' | 'kernel') a mamba prefill's chunk scan
through the SSD kernel; each takes its plain version on CPU tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.models import layers as LY
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models.common import (
    ParamInfo,
    init_from_schema,
    torch_dtype,
    tree_map,
    zeros_from_schema,
)


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    mixer: str = "attn"  # 'attn' | 'mla' | 'mamba'
    ffn: str = "dense"  # 'dense' | 'moe' | 'none'
    is_local: bool = False
    cross: bool = False


@dataclasses.dataclass(frozen=True)
class Plan:
    prefix: Tuple[SlotSpec, ...]
    period: Tuple[SlotSpec, ...]
    n_periods: int
    suffix: Tuple[SlotSpec, ...]

    @property
    def n_layers(self) -> int:
        return len(self.prefix) + self.n_periods * len(self.period) + len(self.suffix)

    def layer_specs(self) -> List[SlotSpec]:
        return (
            list(self.prefix)
            + [s for _ in range(self.n_periods) for s in self.period]
            + list(self.suffix)
        )


def build_plan(cfg) -> Plan:
    L = cfg.n_layers
    if cfg.ssm and not cfg.hybrid_period:  # mamba2
        return Plan((), (SlotSpec("mamba", "none"),), L, ())
    if cfg.hybrid_period:  # jamba
        p = cfg.hybrid_period
        period = tuple(
            SlotSpec(
                mixer=("attn" if i == p // 2 else "mamba"),
                ffn=("moe" if (cfg.moe and i % cfg.moe_every == 1) else "dense"),
            )
            for i in range(p)
        )
        assert L % p == 0, (L, p)
        return Plan((), period, L // p, ())
    if cfg.local_global_pattern:  # gemma3
        pat = cfg.local_global_pattern
        period = tuple(SlotSpec("attn", "dense", is_local=(i < pat)) for i in range(pat + 1))
        n = L // (pat + 1)
        rem = L - n * (pat + 1)
        suffix = tuple(SlotSpec("attn", "dense", is_local=True) for _ in range(rem))
        return Plan((), period, n, suffix)
    if cfg.cross_attn_every:  # llama-vision
        k = cfg.cross_attn_every
        period = tuple(
            SlotSpec("attn", "dense", cross=(i == k - 1)) for i in range(k)
        )
        assert L % k == 0, (L, k)
        return Plan((), period, L // k, ())
    mixer = "mla" if cfg.mla else "attn"
    ffn = "moe" if cfg.moe else "dense"
    prefix = tuple(SlotSpec(mixer, "dense") for _ in range(cfg.first_k_dense))
    return Plan(prefix, (SlotSpec(mixer, ffn),), L - cfg.first_k_dense, ())


# ---------------------------------------------------------------------------
# schema assembly


def _slot_schema(cfg, slot: SlotSpec, L=None) -> dict:
    mixers = {"attn": LY.gqa_schema, "mla": LY.mla_schema, "mamba": MB.mamba_schema}
    sch = {"ln1": LY.norm_schema(cfg, L), "mixer": mixers[slot.mixer](cfg, L)}
    if slot.ffn != "none":
        sch["ln2"] = LY.norm_schema(cfg, L)
        sch["ffn"] = (MOE.moe_schema(cfg, L) if slot.ffn == "moe"
                      else LY.ffn_schema(cfg, cfg.d_ff, L))
    return sch


def _slot_cache_schema(cfg, slot: SlotSpec, rows: tuple, L=None) -> dict:
    """One slot's cache leaves over ``rows``: (B, S) for the contiguous
    cache, (P, bs) for the paged pool. Attention keeps per-head k/v
    ``rows + (KH, hd)``; MLA one shared latent stream ``c`` ``rows + (r,)``
    and rope key ``k_pe`` ``rows + (dr,)``; mamba one recurrent state per
    row (contiguous) or per pool block (paged: a slot's state page is its
    first table entry), ``conv`` and ``ssm``, whatever the tokens."""
    dt = torch_dtype(cfg.dtype)
    pre = () if L is None else (L,)
    if slot.mixer == "mamba":
        return MB.mamba_cache_schema(cfg, rows[0], L)
    if slot.mixer == "mla":
        return {"c": ParamInfo(pre + rows + (cfg.kv_lora_rank,), dt, "zeros"),
                "k_pe": ParamInfo(pre + rows + (cfg.qk_rope_dim,), dt, "zeros")}
    shp = pre + rows + (cfg.n_kv_heads, cfg.hd)
    return {"k": ParamInfo(shp, dt, "zeros"), "v": ParamInfo(shp, dt, "zeros")}


_PORTED_SLOTS = (SlotSpec("attn", "dense"), SlotSpec("mla", "dense"), SlotSpec("mla", "moe"),
                 SlotSpec("mamba", "none"))


def ramp_sites(cfg, max_sites: int = 12) -> Tuple[int, ...]:
    """Feasible ramp sites = block boundaries (cut vertices); thinned to at
    most `max_sites`, never including the final layer (that's the model)."""
    L = cfg.n_layers
    n = min(L - 1, max_sites)
    if n <= 0:
        return ()
    stride = (L - 1) / n
    sites = sorted({int(math.floor((i + 1) * stride)) - 1 for i in range(n)})
    return tuple(s for s in sites if 0 <= s < L - 1) or (0,)


def ramp_schema(cfg) -> dict:
    S = len(ramp_sites(cfg))
    d, Vp = cfg.d_model, cfg.padded_vocab
    dt = torch_dtype(cfg.dtype)
    sch = {"norm_w": ParamInfo((S, d), torch.float32, "zeros")}
    if cfg.ramp_style != "tied":  # 'tied' shares the model's own LM head
        sch["head"] = ParamInfo((S, d, Vp), dt, "normal:0.02")
    if cfg.ramp_style == "mlp":  # heavier ramps (paper Fig 9 comparison)
        sch["w1"] = ParamInfo((S, d, cfg.ramp_hidden), dt, "normal:0.02")
        sch["w2"] = ParamInfo((S, cfg.ramp_hidden, d), dt, "normal:0.02")
    return sch


def paged_leaf_kinds(schema) -> List[str]:
    """Per-leaf kind labels for a paged cache schema, in flatten order
    (dicts iterate sorted keys): ``"tokens"`` for per-token pages
    ``(P, bs, ...)``, ``"state"`` for per-slot recurrent pages (mamba
    ``conv``/``ssm``), ``"xkv"`` for pinned cross-attention pages. The
    serving runner branches on them."""
    out: List[str] = []

    def walk(node, kind):
        if isinstance(node, dict):
            for kk in sorted(node):
                nk = "xkv" if kk == "xkv" else ("state" if kk in ("conv", "ssm") else kind)
                walk(node[kk], nk)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, kind)
        else:
            out.append(kind)

    walk(schema, "tokens")
    return out


def _layer(tree, l: int):
    """Views of one layer's params or cache out of the stacked tree."""
    return tree_map(lambda t: t[l], tree)


class LM:
    """Functional decoder LM (attention + dense-FFN, MLA + MoE or mamba
    slots, a prefix of leading slots; 'fc', 'mlp' or 'tied' ramps).
    ``prefill_attn`` and ``ssd_impl`` pick the prefill's kernels (module
    docstring)."""

    def __init__(self, cfg, *, prefill_attn: str = "sdpa", ssd_impl: str = "kernel"):
        self.cfg = cfg
        self.plan = build_plan(cfg)
        self.sites = ramp_sites(cfg)
        plan = self.plan
        if (plan.suffix or cfg.window or cfg.qk_norm
                or any(s not in _PORTED_SLOTS for s in plan.layer_specs())):
            raise NotImplementedError(
                f"{cfg.name}: the port runs attention + dense-FFN, MLA + MoE and "
                "mamba stacks only")
        if prefill_attn not in ("sdpa", "kernel"):
            raise ValueError(f"prefill_attn={prefill_attn!r}: the port takes 'sdpa' | 'kernel'")
        if ssd_impl not in ("ref", "kernel"):
            raise ValueError(f"ssd_impl={ssd_impl!r}: the port takes 'ref' | 'kernel'")
        if cfg.ssm and cfg.ssm_ngroups != 1:
            raise NotImplementedError(f"ssm_ngroups={cfg.ssm_ngroups}: the SSD scan takes "
                                      "one group")
        self.prefill_attn, self.ssd_impl = prefill_attn, ssd_impl
        if cfg.ramp_style not in ("fc", "mlp", "tied"):
            raise NotImplementedError(f"ramp_style={cfg.ramp_style!r}: the port takes 'fc' | "
                                      "'mlp' | 'tied'")
        if cfg.decode_attn not in ("dense", "ref", "kernel", "paged", "paged-kernel"):
            raise NotImplementedError(f"decode_attn={cfg.decode_attn!r} is not ported")
        if cfg.pallas_head not in ("off", "kernel"):
            raise ValueError(f"pallas_head={cfg.pallas_head!r}: the port takes 'off' | 'kernel'")

    # -- schema / init ------------------------------------------------------

    def schema(self) -> dict:
        cfg, plan = self.cfg, self.plan
        sch = {"tok": LY.embed_schema(cfg)}
        if plan.prefix:
            sch["prefix"] = [_slot_schema(cfg, s) for s in plan.prefix]
        sch["blocks"] = [_slot_schema(cfg, s, L=plan.n_periods) for s in plan.period]
        sch["final_norm"] = LY.norm_schema(cfg)
        sch["ramps"] = ramp_schema(cfg)
        return sch

    def init(self, seed: int = 0, device="cuda") -> dict:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_from_schema(self.schema(), gen, device)

    # -- cache --------------------------------------------------------------

    def _cache_tree(self, rows: tuple) -> dict:
        cfg, plan = self.cfg, self.plan
        sch = {}
        if plan.prefix:
            sch["prefix"] = [_slot_cache_schema(cfg, s, rows) for s in plan.prefix]
        sch["blocks"] = [_slot_cache_schema(cfg, s, rows, L=plan.n_periods)
                         for s in plan.period]
        return sch

    def cache_schema(self, B: int, S: int) -> dict:
        return self._cache_tree((B, S))

    def init_cache(self, B: int, S: int, device="cuda") -> dict:
        return zeros_from_schema(self.cache_schema(B, S), device)

    def paged_cache_schema(self, n_blocks: int, block_size: int) -> dict:
        """The paged layout: the same tree as ``cache_schema``, but every
        leaf is a block pool shared by all slots: ``(L, P, bs, KH, hd)`` for
        attention, ``(L, P, bs, r)``/``(L, P, bs, dr)`` for MLA latents (the
        pool axis at 1; prefix leaves have no L axis, the pool axis at 0);
        virtual token ``t`` of a row lives at ``(table[b, t // bs], t % bs)``.
        Mamba state pages ``(L, P, d_conv-1, conv_dim)`` and ``(L, P, H, hp,
        N)`` hold a slot's state at its first table entry."""
        return self._cache_tree((n_blocks, block_size))

    def init_paged_cache(self, n_blocks: int, block_size: int, device="cuda") -> dict:
        return zeros_from_schema(self.paged_cache_schema(n_blocks, block_size), device)

    def paged_cache_kinds(self, n_blocks: int, block_size: int) -> list:
        return paged_leaf_kinds(self.paged_cache_schema(n_blocks, block_size))

    @property
    def paged_sharing_ok(self) -> bool:
        """Prefix sharing / copy-on-write move token pages between tables:
        sound for plain full attention only, so false for MLA and mamba, as
        in the reference."""
        return all(s.mixer == "attn" and not s.cross and not s.is_local
                   for s in self.plan.layer_specs())

    # -- forward ------------------------------------------------------------

    def _block(self, slot: SlotSpec, p, h, *, positions, mask, cache, cache_index,
               write_gate=None, block_tables=None, moe_impl="dense", plain=False):
        """One layer. ``plain`` (the loss) runs attention through ``sdpa``
        and the mamba scan through ``ssd_ref``. Returns (h, the MoE aux loss
        or None)."""
        cfg = self.cfg
        x = LY.apply_norm(cfg, p["ln1"], h)
        kw = dict(positions=positions, mask=mask, cache=cache, cache_index=cache_index,
                  decode_impl=cfg.decode_attn, write_gate=write_gate,
                  block_table=block_tables)
        if slot.mixer == "mamba":
            out = self._mamba(p["mixer"], x, cache, write_gate, block_tables,
                              ssd_impl="ref" if plain else self.ssd_impl)
        elif slot.mixer == "mla":
            out, _ = LY.mla_apply(cfg, p["mixer"], x, absorbed=cfg.mla_absorbed, **kw)
        else:
            # prefill_attn applies to a whole-prompt prefill only (S > 1 at
            # cache index 0); a decode step keeps decode_impl's path
            out, _ = LY.attn_apply(cfg, p["mixer"], x,
                                   prefill_attn="sdpa" if plain else self.prefill_attn, **kw)
        h = h + out
        if slot.ffn == "none":
            return h, None
        x = LY.apply_norm(cfg, p["ln2"], h)
        if slot.ffn == "moe":
            out, aux = MOE.moe_apply(cfg, p["ffn"], x, impl=moe_impl)
            return h + out, aux
        return h + LY.ffn_apply(cfg, p["ffn"], x), None

    def _mamba(self, p, x, cache, write_gate, block_tables, ssd_impl):
        """The mamba mixer. With a cache, the new state is stored in place:
        in the row's own cache (contiguous) or in the state page at the
        row's FIRST table entry (paged; duplicate bucket-padding rows write
        identical values and FREE rows, whose tables are zeroed, the trash
        block 0), kept as it was where ``write_gate`` is False, so a step
        past a window's end leaves conv and ssm unchanged."""
        cfg = self.cfg
        if cache is None:
            return MB.mamba_apply(cfg, p, x, ssd_impl=ssd_impl)[0]
        if block_tables is not None:
            blk0 = block_tables[:, 0].long()
            view = {k: cache[k][blk0] for k in ("conv", "ssm")}
        else:
            view = {k: cache[k] for k in ("conv", "ssm")}
        out, st = MB.mamba_apply(cfg, p, x, cache=view, ssd_impl=ssd_impl)
        for k in ("conv", "ssm"):
            new = st[k].to(cache[k].dtype)
            if write_gate is not None:
                keep = write_gate.reshape((-1,) + (1,) * (new.dim() - 1))
                new = torch.where(keep, new, view[k])
            if block_tables is not None:
                cache[k][blk0] = new
            else:
                cache[k].copy_(new)
        return out

    def _stack(self, params, h, *, positions, mask, caches, cache_index, pool_idx,
               write_gate=None, block_tables=None, moe_impl="dense", plain=False,
               remat=False):
        """Run the prefix slots, then the periods layer by layer; caches are
        updated in place. ``pool_idx`` is a slice of positions (serving: a
        view, so no index tensor crosses to the device) or an index tensor
        (the loss's ``ramp_positions``). ``remat`` recomputes each layer in
        the backward (``torch.utils.checkpoint``): memory only, the same
        numbers. Returns (h, pooled (L, B, npos, d), the summed MoE aux
        loss or None), prefix layers first, as the reference assembles
        them."""
        plan = self.plan
        kw = dict(positions=positions, mask=mask, cache_index=cache_index,
                  write_gate=write_gate, block_tables=block_tables, moe_impl=moe_impl,
                  plain=plain)
        pooled, aux = [], None

        def run(slot, p, hh, c):
            if not remat:
                return self._block(slot, p, hh, cache=c, **kw)
            return torch.utils.checkpoint.checkpoint(
                lambda x: self._block(slot, p, x, cache=c, **kw), hh, use_reentrant=False)

        def layer(slot, p, hh, c):
            nonlocal aux
            hh, a = run(slot, p, hh, c)
            if a is not None:
                aux = a if aux is None else aux + a
            pooled.append(hh[:, pool_idx])
            return hh

        for i, slot in enumerate(plan.prefix):
            c = caches["prefix"][i] if caches else None
            h = layer(slot, params["prefix"][i], h, c)
        for l in range(plan.n_periods):
            for s, slot in enumerate(plan.period):
                c = _layer(caches["blocks"][s], l) if caches else None
                h = layer(slot, _layer(params["blocks"][s], l), h, c)
        return h, torch.stack(pooled), aux

    # -- ramp heads ----------------------------------------------------------

    def _ramp_hidden(self, params, pooled, active_sites: Sequence[int], stop_grad=False):
        """What each active site's head reads: the normed pooled hidden, with
        the 'mlp' style's GELU residual ``hs + gelu(hs @ w1) @ w2`` added:
        (K, B, npos, d). ``stop_grad`` detaches the pooled features."""
        hs = torch.stack([pooled[self.sites[i]] for i in active_sites])
        if stop_grad:
            hs = hs.detach()
        nw = torch.stack([params["ramps"]["norm_w"][i] for i in active_sites])
        hs = LY.rms_norm(hs, nw[:, None, None, :])
        if self.cfg.ramp_style == "mlp":
            w1 = torch.stack([params["ramps"]["w1"][i] for i in active_sites])
            w2 = torch.stack([params["ramps"]["w2"][i] for i in active_sites])
            act = LY.act_fn("gelu")  # jax.nn.gelu's default (tanh) form
            hs = hs + torch.einsum("kbnh,khd->kbnd",
                                   act(torch.einsum("kbnd,kdh->kbnh", hs, w1)), w2)
        return hs

    def ramp_head(self, params, i: int):
        """The (d, Vp) head site ``i`` reads: its own (a view of the stack),
        or with 'tied' the model's final head (the tied embed^T view or
        lm_head)."""
        if self.cfg.ramp_style == "tied":
            tok = params["tok"]
            return tok["embed"].T if self.cfg.tie_embeddings else tok["lm_head"]
        return params["ramps"]["head"][i]

    def ramp_outputs(self, params, pooled, site_idx: Optional[Sequence[int]] = None,
                     stop_grad=True):
        """pooled: (L,B,npos,d). site_idx: host site indices or None = all
        sites. Returns ramp logits (K,B,npos,Vp) in f32. Ramp features are
        stop-grad (the reference's default): the ramp loss trains the ramps
        and, with 'tied', the final head, never the backbone."""
        if site_idx is None:
            site_idx = range(len(self.sites))
        site_idx = list(site_idx)
        hs = self._ramp_hidden(params, pooled, site_idx, stop_grad=stop_grad)
        if site_idx == list(range(len(self.sites))) and self.cfg.ramp_style != "tied":
            # every site (the loss): one batched product with the whole head
            # stack, whose gradient is then one (S, d, Vp) tensor, not the
            # sum of S full-size select gradients
            K, B, n, d = hs.shape
            out = torch.matmul(hs.reshape(K, B * n, d), params["ramps"]["head"])
            return out.reshape(K, B, n, -1).float()
        return torch.stack([(hs[j] @ self.ramp_head(params, i)).float()
                            for j, i in enumerate(site_idx)])

    # -- public entry points --------------------------------------------------

    def loss(self, params, batch, *, moe_impl="ep", remat=False, ramp_positions=16,
             train_mode="full"):
        """batch: {'tokens': (B,S) int, 'labels': (B,S) int (-1 = pad)}.
        Returns (loss, metrics). Ramp losses use stop-grad features at
        ``ramp_positions`` positions spread over the sequence (the paper:
        backbone frozen w.r.t. ramps; ramps trained on every input).
        ``train_mode`` 'full' is ``lm + ramp + 0.01 * moe aux``,
        'ramps_only' is ``ramp + 0.0 * lm``. Runs without a cache, so it
        writes none, and reaches no kernel (module docstring)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        dev = tokens.device
        positions = torch.arange(S, device=dev)[None, :]
        h = LY.embed_apply(cfg, params["tok"], tokens, positions)
        mask = LY.causal_mask(S, S, 0, device=dev)
        npos = min(ramp_positions, S)
        # the reference's f32 linspace truncated to int, formed on the host
        pool_idx = torch.linspace(S // npos - 1, S - 1, npos,
                                  dtype=torch.float32).to(torch.int64).to(dev)
        h, pooled, aux = self._stack(
            params, h, positions=positions, mask=mask, caches=None, cache_index=None,
            pool_idx=pool_idx, moe_impl=moe_impl, plain=True, remat=remat)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=dev)
        h = LY.apply_norm(cfg, params["final_norm"], h)
        lm = _masked_ce(cfg, LY.unembed(cfg, params["tok"], h), labels)
        if len(self.sites):
            ramp_logits = self.ramp_outputs(params, pooled)
            R = ramp_logits.shape[0]
            ramp_labels = labels[:, pool_idx]  # (B,npos)
            rloss = _masked_ce(cfg, ramp_logits.reshape(R * B, npos, -1),
                               ramp_labels.repeat(R, 1))
        else:  # reduced-depth configs can have zero ramp sites
            rloss = torch.zeros((), dtype=torch.float32, device=dev)
        if train_mode == "ramps_only":
            loss = rloss + 0.0 * lm
        else:
            loss = lm + rloss + 0.01 * aux
        return loss, {"lm_loss": lm, "ramp_loss": rloss, "moe_aux": aux}

    def prefill(self, params, tokens, *, cache_len=None, active_sites=None,
                with_cache=True):
        """tokens: (B,S). Returns (cache|None, outs) where outs carries final
        + per-active-ramp stats for the LAST position (the generated token).
        Attention attends the S prompt queries to the ``cache_len`` keys
        under the causal mask from query 0: through ``sdpa``, or with
        ``prefill_attn='kernel'`` through the flash-attention kernel."""
        B, S = tokens.shape
        dev = tokens.device
        cache_len = cache_len or S
        positions = torch.arange(S, device=dev)[None, :]
        h = LY.embed_apply(self.cfg, params["tok"], tokens, positions)
        mask = LY.causal_mask(S, cache_len if with_cache else S, 0, device=dev)
        caches = self.init_cache(B, cache_len, device=dev) if with_cache else None
        h, pooled, _ = self._stack(params, h, positions=positions, mask=mask, caches=caches,
                                   cache_index=0, pool_idx=slice(S - 1, S))
        outs = self._head_stats(params, h[:, -1:], pooled, active_sites)
        return caches, outs

    def decode(self, params, cache, tokens, pos, *, active_sites=None,
               exit_thresholds=None, write_gate=None, block_tables=None):
        """One decode step. tokens: (B,1); pos: int tensor (B,) of per-row
        write indices (continuous batching leaves every row at its own
        position). The cache is updated in place; ``write_gate`` (bool
        tensor) switches that write off on device.

        With ``block_tables`` (int (B, max_blocks)) the cache is the paged
        pool of ``init_paged_cache``: each row's token is written to
        ``(block_tables[b, pos[b] // bs], pos[b] % bs)`` and attention walks
        the table (``cfg.decode_attn`` must be 'paged' or 'paged-kernel');
        the paged attention masks by position itself, so no mask is built.
        Returns (cache, outs)."""
        cfg = self.cfg
        B, S = tokens.shape
        assert S == 1
        if block_tables is not None and (not torch.is_tensor(pos) or pos.dim() < 1):
            raise ValueError("paged decode requires per-row pos: int[B]")
        pos = pos.to(torch.int64).reshape(-1)
        pc = pos[:, None]
        h = LY.embed_apply(cfg, params["tok"], tokens, pc)
        mask = None
        Sc = _cache_len(cache) if block_tables is None else None
        if Sc is not None:  # a mamba-only cache has no sequence to mask
            mask = (torch.arange(Sc, device=tokens.device)[None, :] <= pc)[:, None, None, :]
        h, pooled, _ = self._stack(
            params, h, positions=pc, mask=mask, caches=cache, cache_index=pos,
            pool_idx=slice(0, 1), write_gate=write_gate,
            block_tables=block_tables,
        )
        outs = self._head_stats(params, h, pooled, active_sites,
                                exit_thresholds=exit_thresholds)
        return cache, outs

    def decode_multi(self, params, cache, tokens, pos, n_steps: int, *, n_max: int,
                     active_sites=None, thresholds=None, row_valid=None,
                     block_tables=None):
        """Up to ``n_steps`` greedy decode steps with the exit decision taken
        ON DEVICE from a resident threshold vector: the host reads nothing
        until the window returns.

        tokens: (B, 1) int; pos: int tensor (B,) per-row write indices.
        ``thresholds`` is the (K,) f32 device threshold vector aligned with
        ``active_sites`` (strict ``<``). ``row_valid`` (B,) bool masks
        bucket-padding rows out of the all-exited test. ``block_tables``
        runs every step on the paged pool (see ``decode``); the window's
        blocks are claimed before it starts, so one table serves all steps.

        The reference's ``lax.while_loop`` stops after the first step where
        every valid row exited. Here the loop runs ``n_steps`` times and a
        device flag ``running`` switches off each later step's cache write,
        so the cache ends as the reference leaves it; ``n_done`` counts the
        steps that ran with ``running`` set. The serving runner captures
        the whole window in one CUDA graph (``serving/graphs.py``), so steps
        past ``n_done`` still run there, gated; a conditional while-node
        could skip them, which would be the reference's early stop.

        Returns ``(cache, (ramp_label (n_max,K,B), ramp_maxprob (n_max,K,B),
        final_label (n_max,B), exit_site (n_max,B), n_done))``; entries past
        ``n_done`` are garbage the caller slices off."""
        B = tokens.shape[0]
        dev = tokens.device
        if not torch.is_tensor(pos) or pos.dim() < 1:
            raise ValueError("decode_multi requires per-row pos: int[B]")
        act = list(active_sites) if active_sites is not None else []
        K = len(act)
        if K and thresholds is None:
            raise ValueError("decode_multi with active ramps needs thresholds")
        if row_valid is None:
            row_valid = torch.ones(B, dtype=torch.bool, device=dev)
        thr = thresholds[:K].float() if K else None
        # act[j] for each ramp row j, built on device (no host->device copy)
        site_of = (torch.stack([torch.full((), i, dtype=torch.int32, device=dev) for i in act])
                   if K else None)
        rl = torch.zeros((n_max, K, B), dtype=torch.int32, device=dev)
        rm = torch.zeros((n_max, K, B), dtype=torch.float32, device=dev)
        fl = torch.zeros((n_max, B), dtype=torch.int32, device=dev)
        ex = torch.full((n_max, B), -1, dtype=torch.int32, device=dev)
        running = torch.ones((), dtype=torch.bool, device=dev)
        n_done = torch.zeros((), dtype=torch.int32, device=dev)
        tok, p = tokens, pos
        for i in range(int(n_steps)):
            cache, outs = self.decode(params, cache, tok, p, active_sites=act or None,
                                      exit_thresholds=thr, write_gate=running,
                                      block_tables=block_tables)
            f = outs["final"]["label"].reshape(-1).to(torch.int32)
            if K:
                mask = outs["ramps"]["exit"].to(torch.bool)  # (K, B)
                anyx = mask.any(dim=0)
                first = torch.argmax(mask.to(torch.int32), dim=0)  # shallowest firing
                site = torch.where(anyx, site_of[first], -1).to(torch.int32)
                rl[i] = outs["ramps"]["label"].to(torch.int32)
                rm[i] = outs["ramps"]["maxprob"].float()
            else:
                site = torch.full((B,), -1, dtype=torch.int32, device=dev)
            fl[i] = f
            ex[i] = site
            all_ex = torch.all(torch.logical_or(~row_valid, site >= 0))
            n_done += running.to(torch.int32)
            running = running & ~all_ex
            tok, p = f.reshape(-1, 1).to(tokens.dtype), p + 1
        return cache, (rl, rm, fl, ex, n_done)

    # -- head statistics ------------------------------------------------------

    def _head_stats(self, params, h_last, pooled, active_sites, exit_thresholds=None):
        """Final + ramp confidence stats for serving. h_last: (B,1,d).

        With cfg.pallas_head == 'kernel' the stats stream through the ramp
        head kernel (its plain version on CPU tensors): (B,V) logits are
        never written. The kernel reads each ramp's features as the dense
        path forms them ('mlp': the residual included) and its head by
        stride ('tied': the final head). With ``exit_thresholds`` (K,) f32 the ramps output
        also carries ``exit`` (K,B) int32, the on-device exit decision
        ``(1 - maxprob) < threshold`` (strict); the dense path applies the
        identical f32 formula."""
        cfg = self.cfg
        h = LY.apply_norm(cfg, params["final_norm"], h_last)
        if cfg.pallas_head != "off":
            return self._head_stats_kernel(params, h, pooled, active_sites,
                                           exit_thresholds=exit_thresholds)
        logits = LY.unembed(cfg, params["tok"], h)[:, 0].float()
        logits = _mask_pad_vocab(cfg, logits)
        outs = {"final": _stats(logits)}
        if active_sites is not None:
            rl = self.ramp_outputs(params, pooled, site_idx=active_sites)
            rl = _mask_pad_vocab(cfg, rl[:, :, 0])  # (K,B,V)
            outs["ramps"] = _stats(rl)
            if exit_thresholds is not None:
                thr = exit_thresholds.float()
                unc = 1.0 - outs["ramps"]["maxprob"].float()
                outs["ramps"]["exit"] = (unc < thr[:, None]).to(torch.int32)
        return outs

    def _head_stats_kernel(self, params, h_normed, pooled, active_sites,
                           exit_thresholds=None):
        from repro_torch.kernels.ramp_head import ramp_confidence, ramp_exit_decision

        cfg = self.cfg
        # the tied head is embed.T: a strided view the kernel reads in place
        wf = params["tok"]["embed"].T if cfg.tie_embeddings else params["tok"]["lm_head"]
        v_limit = cfg.vocab_size

        def stats_of(hb, w, thr=None):
            if thr is None:
                r = ramp_confidence(hb, w, v_limit=v_limit)
            else:
                r = ramp_exit_decision(hb, w, thr, v_limit=v_limit)
            return {k: r[k] for k in ("label", "maxprob", "entropy", "exit") if k in r}

        outs = {"final": stats_of(h_normed[:, 0], wf)}
        if active_sites is not None:
            act = list(active_sites)
            hs = self._ramp_hidden(params, pooled, act)[:, :, 0]  # (K,B,d)
            B = hs.shape[1]
            per = []
            for kk, i in enumerate(act):  # K is small (ramp budget slots)
                thr = (exit_thresholds[kk].float().expand(B)
                       if exit_thresholds is not None else None)
                per.append(stats_of(hs[kk], self.ramp_head(params, i), thr))
            outs["ramps"] = {key: torch.stack([p[key] for p in per]) for key in per[0]}
        return outs


def _cache_len(cache) -> Optional[int]:
    """Sequence length of a contiguous cache, from any attention leaf: k
    ``(.., B, S, KH, hd)`` or MLA's c ``(.., B, S, r)``, stacked or prefix.
    None when the plan has no attention: a mamba-only cache holds one
    recurrent state a row and no sequence (the reference skips the mask)."""
    for blk in list(cache.get("prefix", [])) + list(cache["blocks"]):
        if "k" in blk:
            return blk["k"].shape[-3]
        if "c" in blk:
            return blk["c"].shape[-2]
    return None


def _stats(logits):
    """logits: (..., V) f32 -> {label, maxprob, entropy} (paper's ~1KB
    per-ramp record: top-1 result + error score)."""
    lse = torch.logsumexp(logits, dim=-1)
    label = torch.argmax(logits, dim=-1).to(torch.int32)
    maxprob = torch.exp(torch.max(logits, dim=-1).values - lse)
    p = torch.softmax(logits, dim=-1)
    plogp = torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-30)), 0.0)
    entropy = -torch.sum(plogp, dim=-1)
    return {"label": label, "maxprob": maxprob, "entropy": entropy}


def _mask_pad_vocab(cfg, logits):
    V = cfg.vocab_size
    if logits.shape[-1] == V:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < V, logits, -1e30)


def _masked_ce(cfg, logits, labels):
    """Cross-entropy with -1 padding labels and padded-vocab masking (the
    reference's formula: max-shifted log-sum-exp, mean over valid labels)."""
    logits = logits.float()
    if logits.shape[-1] > cfg.vocab_size:
        logits = _mask_pad_vocab(cfg, logits)
    valid = labels >= 0
    lab = torch.clamp(labels, min=0).long()
    m = torch.max(logits, dim=-1).values
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    ll = torch.gather(logits, -1, lab[..., None])[..., 0]
    nll = (lse - ll) * valid
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)
