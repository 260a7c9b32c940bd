"""Decoder-only LM: every plan of the JAX package's ``build_plan``.
Attention + dense-FFN stacks (qwen2, qwen1.5, DeepSeek-67B), attention +
MoE (Qwen3-MoE), MLA + MoE with leading dense layers (DeepSeek-V2),
attention-free Mamba2 (SSD) stacks, Gemma3's local/global periods, the
Jamba hybrid (one attention layer a period among mamba layers, MoE every
other layer, no positional encoding) and Llama-3.2-Vision's periods that
end in a gated cross-attention layer over image memory.

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
latents, or one mamba state page a slot; a hybrid's attention pages and
state pages share one pool). Serving runs MoE on the dense dispatch (the
reference's ``moe_impl='dense'``, what its serving runner passes);
``loss`` takes ``moe_impl`` 'ep' (the default, as in the reference) or
'dense'. Gemma3's local sliding-window slots run on a full cache, on W-row
ring caches (``windowed_cache``) or as ring pages on the pool, with the
reference's unrolled ``suffix`` of local layers after the periods.

A cross slot's image memory (``image_embeds @ frontend.proj``) enters
through ``prefill(image_embeds=)`` and ``loss``. Its k/v live in the slot's
``xkv`` cache leaves: ``(B, M, KH, hd)`` rows, or on the pool M rows of
pinned pages whose ids ride in the trailing ``paged_xkv_blocks`` columns of
every table; decode reads them and never writes them. A deliberate
difference from the reference: its ``prefill`` with a cache attends the
zero ``xkv`` of ``init_cache`` whatever ``image_embeds`` holds (its
``cross_attn_apply`` prefers the cache to the memory), so image memory
there reaches only the cacheless prefill and the loss; here a cached
prefill projects the memory, writes its k/v into ``xkv`` and attends them
(ROADMAP.md, Queue 3). Without ``image_embeds`` (the serving runner's
prefill, which takes no image, as the reference's takes none) both
attend the zeros.

``loss`` is the training objective. Like the reference's, it reaches no
kernel: attention through ``sdpa``, the mamba scan through ``ssd_ref``,
the ramps a site at a time through plain products (``_ramp_loss``; the
kernel dispatchers have no backward and raise under autograd). An 'mlp'
ramp is served as it is trained: the kernel head path applies its
residual before the head, as the reference's dense path does (the
reference's Pallas head path skips it; ROADMAP.md, Queue 3).

Tensor-parallel decode (``decode_sharded``, ``decode_sharded_multi``,
``prefill_sharded``) runs one rank's shard inside a ``torch.distributed``
job: each rank is a process (the reference's one ``shard_map`` body),
``TpCtx`` carries its model group's tiled all-gather, and ``_block`` runs
the rank's heads and hidden units on column slices of the weights
(``tp_param_specs``) with its kv-head block of the cache. The loss over a
rank's FSDP parts (``loss(mesh=, fsdp=)``) splits its compute over
``model`` as the reference's GSPMD does, by Megatron's column- then
row-parallel products instead (``fsdp_use``, ``layers.ModelSplit``): a
gather of ``wo`` whole over ``model``, which decode's output-column design
needs, is the gather that split removes.

Two choices of the port that the configs do not carry (so that they stay
field-for-field the reference's): ``prefill_attn`` ('sdpa' | 'kernel')
runs a whole-prompt prefill's attention through the flash-attention
kernel, and ``ssd_impl`` ('ref' | 'kernel') a mamba prefill's chunk scan
through the SSD kernel; each takes its plain version on CPU tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch import trace
from repro_torch.models import layers as LY
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models.common import (
    ParamInfo,
    init_from_schema,
    meta_from_schema,
    specs_from_schema,
    torch_dtype,
    tree_leaves,
    tree_map,
    tree_map2,
    zeros_from_schema,
)


@dataclasses.dataclass(frozen=True)
class TpCtx:
    """Tensor-parallel context threaded through ``_block``/``decode`` when a
    rank runs its shard of ``decode_sharded`` (the reference's ``TpCtx``).

    The decomposition keeps activations whole at sublayer boundaries:
    wq/wk/wv (and w_gate/w_up) are COLUMN-sliced, so each rank computes a
    contiguous block of heads (hidden units) as the same columns of the
    dense product; wo/w_down are column-sliced along their OUTPUT dim, so
    the final projections are column slices of the dense result too. The
    combines are tiled all-gathers, pure concatenation with no arithmetic
    (a row split + all-reduce would reassociate the contraction). Whether
    a library product rounds a column slice as it rounds the same columns
    of the whole product is its own affair: the port holds sharded decode
    to single-rank decode within tolerance, not bit for bit.

    m: ranks of the model group; gather: the tiled all-gather over it
    (``distributed.tp_gather``; plain tiling under the meta audit);
    data_group: the data group when rows also shard over ``data``
    (contiguous caches only), to reduce the window's all-exited test
    across row shards; group, index: the model group and this rank's place
    in it, for the expert-parallel all-to-alls."""

    m: int
    gather: Any
    data_group: Any = None
    group: Any = None
    index: int = 0


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
    if slot.cross:
        sch["lnx"] = LY.norm_schema(cfg, L)
        sch["xattn"] = LY.cross_attn_schema(cfg, L)
    if slot.ffn != "none":
        sch["ln2"] = LY.norm_schema(cfg, L)
        sch["ffn"] = (MOE.moe_schema(cfg, L) if slot.ffn == "moe"
                      else LY.ffn_schema(cfg, cfg.d_ff, L))
    return sch


def _slot_cache_schema(cfg, slot: SlotSpec, rows: tuple, xrows: tuple, L=None, *,
                       paged=False, shard_batch=True) -> dict:
    """One slot's cache leaves over ``rows``: (B, S) for the contiguous
    cache, (P, bs) for the paged pool (``paged``). Attention keeps per-head
    k/v ``rows + (KH, hd)``; MLA one shared latent stream ``c`` ``rows +
    (r,)`` and rope key ``k_pe`` ``rows + (dr,)``; mamba one recurrent state
    per row (contiguous) or per pool block (paged: a slot's state page is
    its first table entry), ``conv`` and ``ssm``, whatever the tokens. A
    cross slot adds the image memory's k/v, ``xkv`` over ``xrows``: (B, M)
    contiguous, (P, bs) pinned pages on the pool. The specs are the
    reference's: contiguous rows over ``data`` (``shard_batch``; else the
    sequence over ``data``), kv heads over ``model``; pool pages whole."""
    dt = torch_dtype(cfg.dtype)
    pre = () if L is None else (L,)
    pfx = (None,) * len(pre)
    bspec, sspec = ("data", None) if shard_batch else (None, "data")
    if cfg.kv_seq_shard:
        # flash-decode layout: seq sharded over `model`
        sspec = ("data", "model") if not shard_batch else "model"
    if paged:
        bspec = sspec = None
    if slot.mixer == "mamba":
        sch = MB.mamba_cache_schema(cfg, rows[0], L, bspec=None if paged else "data")
    elif slot.mixer == "mla":
        sp = (*pfx, bspec, sspec, None)
        sch = {"c": ParamInfo(pre + rows + (cfg.kv_lora_rank,), dt, "zeros", sp),
               "k_pe": ParamInfo(pre + rows + (cfg.qk_rope_dim,), dt, "zeros", sp)}
    else:
        hspec = "model" if cfg.hd % 16 == 0 and (paged or not cfg.kv_seq_shard) else None
        shp, sp = pre + rows + (cfg.n_kv_heads, cfg.hd), (*pfx, bspec, sspec, None, hspec)
        sch = {"k": ParamInfo(shp, dt, "zeros", sp), "v": ParamInfo(shp, dt, "zeros", sp)}
    if slot.cross:
        hspec = "model" if cfg.hd % 16 == 0 else None
        shp, sp = pre + xrows + (cfg.n_kv_heads, cfg.hd), (*pfx, bspec, None, None, hspec)
        sch["xkv"] = {"k": ParamInfo(shp, dt, "zeros", sp), "v": ParamInfo(shp, dt, "zeros", sp)}
    return sch


ROPE_THETA_LOCAL = 10_000.0  # the RoPE base of local slots (the reference's rope_theta_local)


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
    sch = {"norm_w": ParamInfo((S, d), torch.float32, "zeros", ())}
    if cfg.ramp_style != "tied":  # 'tied' shares the model's own LM head
        sch["head"] = ParamInfo((S, d, Vp), dt, "normal:0.02", (None, "data", "model"))
    if cfg.ramp_style == "mlp":  # heavier ramps (paper Fig 9 comparison)
        sch["w1"] = ParamInfo((S, d, cfg.ramp_hidden), dt, "normal:0.02", (None, "data", None))
        sch["w2"] = ParamInfo((S, cfg.ramp_hidden, d), dt, "normal:0.02", (None, None, "data"))
    return sch


def paged_leaf_kinds(schema) -> List[str]:
    """Per-leaf kind labels for a paged cache schema, in flatten order
    (dicts iterate sorted keys): ``"tokens"`` for per-token pages
    ``(P, bs, ...)``, ``"state"`` for per-slot recurrent pages (mamba
    ``conv``/``ssm``), ``"xkv"`` for pinned cross-attention pages. The
    serving runner branches on them; ``LM.paged_cache_kinds`` marks a local
    slot's token pages ``"ring"``."""
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


def _layer_specs(stack, specs):
    """The specs of one layer of a stacked tree: each leaf's without its
    first (layer) entry, which is whole (a use spec keeps its kind)."""
    return tree_map2(lambda _, sp: type(sp)(sp[1:]), stack, specs)


def fsdp_use(cfg, specs, mesh):
    """The use specs of a loss over the rank's parts (``specs``: each leaf's
    sanitized storage spec; ``LM.loss(fsdp=)``, ``EncDecLM.loss``): how
    ``_gathered`` gathers each leaf where it is used. On a mesh whose
    ``model`` axis has m > 1 ranks a sublayer that the reference's specs
    split over ``model`` runs on the rank's slice (``layers.ModelSplit``),
    and its model-split leaves are ``KeepModel``: gathered over the data
    axes only. Those sublayers are attention and cross-attention (``wq``'s
    columns, by whole heads: ``H % m == 0``; ``wk``/``wv`` kept too where
    ``KH % m == 0``, else, where ``m % KH == 0`` and so a rank's heads read
    one kv head, gathered whole as ``SumModel``, as qk-norm's weights are),
    MLA (``wq``, ``w_uk``, ``w_uv``, ``wo``; ``w_dkv`` and
    ``kv_norm`` whole), the dense FFN and the shared experts (hidden
    units), the embedding, the LM head and the ramp heads (vocabulary). A
    MoE slot's experts are ``KeepModel``, as the expert-parallel dispatch
    takes them. Every other leaf is gathered whole where it is used, as
    are the leaves of a sublayer whose heads do not divide over ``model``,
    and a mamba mixer's: its ``in_proj`` packs ``[z | x B C | dt]`` in its
    columns, so a contiguous model split cuts ``z``, not heads (ROADMAP.md,
    Queue 1). With ``fsdp=False`` (``layout_specs``) only the experts
    carry ``model``, so nothing else splits."""
    from repro_torch.distributed import KeepModel, SumModel
    from repro_torch.models.common import entry_axes

    m, H, K = mesh.model_size, cfg.n_heads, cfg.n_kv_heads

    def has(sp):
        return any("model" in entry_axes(e) for e in sp)

    def wrap(node, kind, names):
        for k in names:
            if k in node:
                node[k] = kind(node[k])

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return node
        node = {k: walk(v) for k, v in node.items()}
        if m == 1:
            return node
        if "router" in node:  # a MoE slot: the experts over model
            for k in ("w_gate", "w_up", "w_down"):
                if node[k][len(node[k]) - 3] != "model":
                    raise ValueError(f"ffn/{k}: {cfg.n_experts} experts do not split over "
                                     f"{m} model ranks")
            wrap(node, KeepModel, ("w_gate", "w_up", "w_down"))
        elif "w_dkv" in node:  # MLA
            if has(node["wq"]) and H % m == 0:
                wrap(node, KeepModel, ("wq", "w_uk", "w_uv", "wo"))
        elif "wq" in node:  # attention, cross-attention
            if has(node["wq"]) and H % m == 0 and (K % m == 0 or m % K == 0):
                wrap(node, KeepModel, ("wq", "bq", "wo"))
                kv = KeepModel if has(node["wk"]) and K % m == 0 else SumModel
                wrap(node, kv, ("wk", "wv", "bk", "bv"))
                wrap(node, SumModel, ("qnorm", "knorm"))
        elif "w_gate" in node:  # a dense FFN, the shared experts
            if has(node["w_gate"]) and has(node["w_down"]):
                wrap(node, KeepModel, ("w_gate", "w_up", "w_down"))
        else:  # the vocabulary: the embedding, the LM head, the ramp heads
            wrap(node, KeepModel, [k for k in ("embed", "lm_head", "head")
                                   if k in node and has(node[k])])
        return node

    return walk(specs)


def _split_of(sp, ms):
    """{sublayer: ``ms``} for each sublayer of one layer's use specs
    (``fsdp_use``) that runs on the rank's model slice: "mixer" (or an
    enc-dec layer's "attn"), "xattn", "ffn" (a dense FFN) and "shared" (a
    MoE slot's shared experts). Empty without ``ms``."""
    from repro_torch.distributed import KeepModel

    if ms is None or sp is None:
        return {}
    out = {k: ms for k in ("mixer", "attn", "xattn")
           if k in sp and isinstance(sp[k].get("wq"), KeepModel)}
    f = sp.get("ffn")
    if f is not None:
        if "router" in f:
            if "shared" in f and isinstance(f["shared"]["w_gate"], KeepModel):
                out["shared"] = ms
        elif isinstance(f["w_gate"], KeepModel):
            out["ffn"] = ms
    return out


def _kept(sp, key, ms):
    """``ms`` where the use specs ``sp`` keep leaf ``key`` the rank's model
    slice (``KeepModel``), else None."""
    from repro_torch.distributed import KeepModel

    return ms if ms is not None and sp is not None and isinstance(sp[key], KeepModel) else None


def model_split(mesh):
    """The loss's ``layers.ModelSplit`` on ``mesh``, or None when its model
    axis has one rank."""
    if mesh is None or mesh.model_size == 1:
        return None
    return LY.ModelSplit(mesh.model_size, mesh.model_rank, mesh.model_group)


def _gathered(p, specs, mesh, keys=None):
    """The whole leaves of the rank's parts ``p`` (``fsdp_gather_tree``;
    only the entries ``keys`` of a dict, where given), or ``p`` itself
    when ``specs`` is None (the leaves are whole already)."""
    if keys is not None:
        p = {k: p[k] for k in keys if k in p}
    if specs is None:
        return p
    from repro_torch.distributed import fsdp_gather_tree

    return fsdp_gather_tree(p, specs, mesh)


def _remat(fn, x, remat: bool):
    """``fn(x)``, recomputed in the backward with ``remat``
    (``torch.utils.checkpoint``)."""
    if not remat:
        return fn(x)
    return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)


class MultiStepDecodeMixin:
    """The sync window, shared by every model class with a ``decode(params,
    cache, tokens, pos, *, active_sites, exit_thresholds, write_gate,
    block_tables)`` step: the decoder-only ``LM`` and the enc-dec
    decoder (``models/encdec.py``), as in the reference. Every row advances
    ``n_done`` steps together, so recurrent state, ring wraparound and
    read-only cross caches stay consistent across an early end."""

    def decode_multi(self, params, cache, tokens, pos, n_steps: int, *, n_max: int,
                     active_sites=None, thresholds=None, row_valid=None,
                     block_tables=None, tp=None, moe_impl="dense"):
        """Up to ``n_steps`` greedy decode steps with the exit decision taken
        ON DEVICE from a resident threshold vector: the host reads nothing
        until the window returns.

        tokens: (B, 1) int; pos: int tensor (B,) per-row write indices.
        ``thresholds`` is the (K,) f32 device threshold vector aligned with
        ``active_sites`` (strict ``<``). ``row_valid`` (B,) bool masks
        bucket-padding rows out of the all-exited test. ``block_tables``
        runs every step on the paged pool (see ``decode``); the window's
        blocks are claimed before it starts, so one table serves all steps.
        ``tp`` (a ``TpCtx``; ``decode_sharded_multi``) runs each step on the
        rank's shard; with rows sharded over ``data`` the all-exited test is
        summed over the data group, so every row shard ends together.
        ``moe_impl`` reaches every step's ``decode``.

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
        # the enc-dec decoder's decode takes neither: it is given them only
        # when set, so asking it for a sharded or 'ep' window raises there
        kw = {"tp": tp} if tp is not None else {}
        if moe_impl != "dense":
            kw["moe_impl"] = moe_impl
        tok, p = tokens, pos
        for i in range(int(n_steps)):
            cache, outs = self.decode(params, cache, tok, p, active_sites=act or None,
                                      exit_thresholds=thr, write_gate=running,
                                      block_tables=block_tables, **kw)
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
            if tp is not None and tp.data_group is not None:
                from repro_torch.distributed import sum_over

                all_ex = sum_over((~all_ex).to(torch.int32), tp.data_group) == 0
            n_done += running.to(torch.int32)
            running = running & ~all_ex
            tok, p = f.reshape(-1, 1).to(tokens.dtype), p + 1
        return cache, (rl, rm, fl, ex, n_done)


class LM(MultiStepDecodeMixin):
    """Functional decoder LM over the slots of ``build_plan`` ('fc', 'mlp'
    or 'tied' ramps). ``prefill_attn`` and ``ssd_impl`` pick the
    prefill's kernels (module docstring)."""

    def __init__(self, cfg, *, prefill_attn: str = "sdpa", ssd_impl: str = "kernel"):
        self.cfg = cfg
        self.plan = build_plan(cfg)
        self.sites = ramp_sites(cfg)
        if prefill_attn not in ("sdpa", "kernel"):
            raise ValueError(f"prefill_attn={prefill_attn!r}: the port takes 'sdpa' | 'kernel'")
        if ssd_impl not in ("ref", "kernel"):
            raise ValueError(f"ssd_impl={ssd_impl!r}: the port takes 'ref' | 'kernel'")
        if cfg.ssm and cfg.ssm_ngroups != 1:
            raise NotImplementedError(f"ssm_ngroups={cfg.ssm_ngroups}: the SSD scan takes "
                                      "one group")
        self.prefill_attn, self.ssd_impl = prefill_attn, ssd_impl
        self._tp_cfgs, self._tp_models = {}, {}  # per model-group size (_tp_cfg)
        self._tp_passed = set()  # the mesh shapes tp_check let through (_tp_check_once)
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
        if plan.suffix:
            sch["suffix"] = [_slot_schema(cfg, s) for s in plan.suffix]
        sch["final_norm"] = LY.norm_schema(cfg)
        sch["ramps"] = ramp_schema(cfg)
        if cfg.cross_attn_every:
            sch["frontend"] = {"proj": ParamInfo((cfg.d_frontend, cfg.d_model),
                                                 torch_dtype(cfg.dtype), "normal:0.02",
                                                 (None, "model"))}
        return sch

    def pspecs(self, axes: LY.MeshAxes) -> dict:
        """Every param leaf's partition spec on ``axes`` (the reference's)."""
        return specs_from_schema(LY.resolve_schema(self.schema(), axes))

    def init(self, seed: int = 0, device="cuda") -> dict:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_from_schema(self.schema(), gen, device)

    def abstract(self) -> dict:
        """The params as meta tensors (``meta_from_schema``): the support
        audit and the dry run trace the full-width model on them."""
        return meta_from_schema(self.schema())

    # -- cache --------------------------------------------------------------

    def _slot_tree(self, fn) -> dict:
        """``fn(slot, L)`` for every slot of the plan, in the cache tree's
        layout: prefix and suffix slots unstacked, period slots with
        ``L = n_periods``."""
        plan = self.plan
        sch = {}
        if plan.prefix:
            sch["prefix"] = [fn(s, None) for s in plan.prefix]
        sch["blocks"] = [fn(s, plan.n_periods) for s in plan.period]
        if plan.suffix:
            sch["suffix"] = [fn(s, None) for s in plan.suffix]
        return sch

    def cache_schema(self, B: int, S: int, shard_batch: bool = True) -> dict:
        """Contiguous rows (B, S); with ``windowed_cache`` a local slot keeps
        a ring of ``min(W, S)`` rows (slot ``pos % W``). ``shard_batch``
        chooses the specs only (``_slot_cache_schema``)."""
        cfg = self.cfg
        ring = min(cfg.window, S) if cfg.windowed_cache and cfg.window else S
        return self._slot_tree(lambda s, L: _slot_cache_schema(
            cfg, s, (B, ring if s.is_local else S), (B, cfg.n_image_tokens), L,
            shard_batch=shard_batch))

    def cache_pspecs(self, B, S, axes: LY.MeshAxes, shard_batch=True) -> dict:
        """Every contiguous cache leaf's partition spec on ``axes``."""
        return specs_from_schema(LY.resolve_schema(self.cache_schema(B, S, shard_batch), axes))

    def init_cache(self, B: int, S: int, device="cuda") -> dict:
        return zeros_from_schema(self.cache_schema(B, S), device)

    def cache_abstract(self, B: int, S: int) -> dict:
        return meta_from_schema(self.cache_schema(B, S))

    def paged_cache_schema(self, n_blocks: int, block_size: int) -> dict:
        """The paged layout: the same tree as ``cache_schema``, but every
        leaf is a block pool shared by all slots: ``(L, P, bs, KH, hd)`` for
        attention, ``(L, P, bs, r)``/``(L, P, bs, dr)`` for MLA latents (the
        pool axis at 1; prefix leaves have no L axis, the pool axis at 0);
        virtual token ``t`` of a row lives at ``(table[b, t // bs], t % bs)``.
        Mamba state pages ``(L, P, d_conv-1, conv_dim)`` and ``(L, P, H, hp,
        N)`` hold a slot's state at its first table entry. A local slot's
        k/v pages hold its window as a ring: virtual row ``pos % W`` of the
        row's first ``ceil(W / bs)`` table entries. A cross slot's ``xkv``
        pages ``(L, P, bs, KH, hd)`` hold its M image rows in the pinned
        blocks of the trailing ``paged_xkv_blocks`` table columns."""
        rows = (n_blocks, block_size)
        return self._slot_tree(lambda s, L: _slot_cache_schema(self.cfg, s, rows, rows, L,
                                                               paged=True))

    def init_paged_cache(self, n_blocks: int, block_size: int, device="cuda") -> dict:
        return zeros_from_schema(self.paged_cache_schema(n_blocks, block_size), device)

    def paged_cache_kinds(self, n_blocks: int, block_size: int) -> list:
        """``paged_leaf_kinds`` of the paged schema, with a local slot's
        token pages marked ``"ring"``: the prefill scatter writes its last W
        prompt tokens at virtual rows ``t % W``, where the paged ring decode
        reads them."""
        def slot_kinds(s, L):
            rows = (n_blocks, block_size)
            sub = _slot_cache_schema(self.cfg, s, rows, rows, L, paged=True)
            ring = s.is_local and self.cfg.window
            kinds = iter(["ring" if ring and k == "tokens" else k
                          for k in paged_leaf_kinds(sub)])
            return tree_map(lambda _: next(kinds), sub)

        return tree_leaves(self._slot_tree(slot_kinds))

    def paged_xkv_blocks(self, block_size: int) -> int:
        """The trailing table columns that hold a slot's pinned xkv pages,
        ``ceil(M / bs)`` (0 for a plan without cross slots): the serving
        runner widens every table it ships by them."""
        if not any(s.cross for s in self.plan.layer_specs()):
            return 0
        return -(-self.cfg.n_image_tokens // block_size)

    def _split_tables(self, cache, block_tables):
        """(the token columns, the trailing xkv columns or None) of a paged
        table: attention walks only its token pages."""
        for part in ("prefix", "blocks", "suffix"):
            for blk in cache.get(part, []):
                if "xkv" in blk:
                    nbx = self.paged_xkv_blocks(blk["xkv"]["k"].shape[-3])
                    return block_tables[:, :-nbx], block_tables[:, -nbx:]
        return block_tables, None

    @property
    def paged_sharing_ok(self) -> bool:
        """Prefix sharing / copy-on-write move token pages between tables:
        sound for plain full attention only, so false for MLA, mamba and
        local ring pages (position-aliased mod W), as in the reference."""
        return all(s.mixer == "attn" and not s.cross and not (s.is_local and self.cfg.window)
                   for s in self.plan.layer_specs())

    # -- forward ------------------------------------------------------------

    def _block(self, slot: SlotSpec, p, h, *, positions, mask, mask_local, cache,
               cache_index, write_gate=None, block_tables=None, xkv_tables=None,
               memory=None, moe_impl="dense", plain=False, tp=None, mesh=None,
               rows_sharded=True, split=None, layer=None):
        """One layer (``layer``: its number, for its spans). ``plain`` (the
        loss) runs attention through ``sdpa`` and the mamba scan through
        ``ssd_ref``. A local slot reads
        ``mask_local`` and RoPE base ``ROPE_THETA_LOCAL``, and runs as a ring
        (``windowed_cache``, or any paged local layer: the pool always
        ring-pages local windows) or as a window over a full contiguous
        cache. A cross slot adds its gated cross-attention after the mixer
        (``_cross``). With ``tp`` (a ``TpCtx``) ``p`` and ``cache`` are the
        rank's shards: attention runs the rank's heads (``_tp_cfg``), then
        ``wo`` on the gathered heads; the FFN is ``ffn_apply_tp``; a MoE slot
        with ``moe_impl='ep'`` is ``moe_apply_ep_device``. With ``mesh`` (a
        ``make_mesh`` view; ``loss``/``prefill``) a MoE slot runs the
        mesh-level ``moe_apply_ep`` on the rank's expert slice, the tokens
        the rank's data shard when ``rows_sharded``. ``split`` (the loss over
        FSDP parts: ``_split_of``) names the sublayers that run on the
        rank's model slice: attention, MLA, the gated
        cross-attention, the dense FFN and the shared experts. Returns (h,
        the MoE aux loss or None)."""
        cfg = self.cfg
        split = split or {}
        x = LY.apply_norm(cfg, p["ln1"], h)
        kw = dict(positions=positions, mask=mask, cache=cache, cache_index=cache_index,
                  decode_impl=cfg.decode_attn, write_gate=write_gate,
                  block_table=block_tables)
        if slot.mixer == "mamba":
            with trace.span("model/mamba", layer=layer):
                out = self._mamba(p["mixer"], x, cache, write_gate, block_tables,
                                  ssd_impl="ref" if plain else self.ssd_impl)
        elif slot.mixer == "mla":
            with trace.span("model/mla", layer=layer):
                out, _ = LY.mla_apply(cfg, p["mixer"], x, absorbed=cfg.mla_absorbed,
                                      ms=split.get("mixer"), **kw)
        else:
            if slot.is_local:
                kw.update(mask=mask_local, rope_theta=ROPE_THETA_LOCAL)
                if cfg.window and (cfg.windowed_cache or block_tables is not None):
                    kw["ring_window"] = cfg.window
                    if cache_index is not None and block_tables is None:
                        kw["cache_index"] = cache_index % cfg.window  # the ring slot
                elif cfg.window:
                    kw["local_window"] = cfg.window
            # prefill_attn applies to a whole-prompt prefill only (S > 1 at
            # cache index 0); a global decode step keeps decode_impl's path
            kw["prefill_attn"] = "sdpa" if plain else self.prefill_attn
            with trace.span("model/attn", layer=layer):
                if tp is not None:
                    # the rank's contiguous block of heads; wo after the head
                    # gather, as an output-column slice
                    out, _ = LY.attn_apply(self._tp_cfg(tp.m), p["mixer"], x, out_proj=False,
                                           **kw)
                    out = tp.gather(tp.gather(out) @ p["mixer"]["wo"])
                else:
                    out, _ = LY.attn_apply(cfg, p["mixer"], x, ms=split.get("mixer"), **kw)
        h = h + out
        if slot.cross:
            h = h + self._cross(p, h, cache, memory, xkv_tables, ms=split.get("xattn"))
        if slot.ffn == "none":
            return h, None
        x = LY.apply_norm(cfg, p["ln2"], h)
        if slot.ffn == "moe":
            with trace.span("model/moe", layer=layer):
                if tp is not None and moe_impl == "ep":
                    out, aux = MOE.moe_apply_ep_device(cfg, p["ffn"], x, tp.m, tp.index,
                                                       tp.group)
                else:
                    out, aux = MOE.moe_apply(cfg, p["ffn"], x, impl=moe_impl, mesh=mesh,
                                             data_sharded=rows_sharded, ms=split.get("shared"))
            return h + out, aux
        with trace.span("model/ffn", layer=layer):
            if tp is not None:
                out = LY.ffn_apply_tp(cfg, p["ffn"], x, tp.gather)
            else:
                out = LY.ffn_apply(cfg, p["ffn"], x, split.get("ffn"))
        return h + out, None

    def _cross(self, p, h, cache, memory, xkv_tables, ms=None):
        """A cross slot's gated cross-attention: over ``memory`` (its k/v
        projected, and written into the slot's contiguous ``xkv`` rows when
        there is a cache), else over the k/v the cache holds: the ``xkv``
        rows, or on the pool the M rows of the pinned pages at
        ``xkv_tables`` (the table's trailing columns), read and never
        written. ``ms`` (the loss) runs the rank's heads over ``memory``."""
        cfg = self.cfg
        x = LY.apply_norm(cfg, p["lnx"], h)
        if ms is not None:
            return LY.cross_attn_apply(cfg, p["xattn"], x, memory=memory, ms=ms)[0]
        kvc = cache["xkv"] if cache is not None else None
        if memory is None and xkv_tables is not None:
            tab = xkv_tables.long()
            kvc = {k: pool[tab].flatten(1, 2)[:, :cfg.n_image_tokens]
                   for k, pool in kvc.items()}
        out, kv = LY.cross_attn_apply(cfg, p["xattn"], x, memory=memory, kv_cache=kvc)
        if memory is not None and kvc is not None:
            for k in ("k", "v"):
                kvc[k].copy_(kv[k])
        return out

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
               mask_local=None, write_gate=None, block_tables=None, xkv_tables=None,
               memory=None, moe_impl="dense", plain=False, remat=False, tp=None, mesh=None,
               rows_sharded=True, fsdp=None, ms=None):
        """Run the prefix slots, the periods layer by layer, then the suffix
        slots; caches are updated in place. ``pool_idx`` is a slice of positions (serving: a
        view, so no index tensor crosses to the device) or an index tensor
        (the loss's ``ramp_positions``). ``remat`` recomputes each layer in
        the backward (``torch.utils.checkpoint``): memory only, the same
        numbers. With ``fsdp`` (the use specs of ``fsdp_use``) ``params``
        hold the rank's parts, and each layer gathers its own params where
        it runs, inside its remat region, so the backward gathers them again
        and no gathered layer outlives its use; with ``ms`` (a
        ``layers.ModelSplit``) the sublayers whose leaves those specs keep
        split run on the rank's model slice (``_split_of``). Returns (h,
        pooled (L, B, npos, d), the summed MoE aux loss or None), prefix layers first and
        suffix layers last, as the reference assembles them, so ramp sites
        keep their layer numbers."""
        plan = self.plan
        kw = dict(positions=positions, mask=mask, mask_local=mask_local,
                  cache_index=cache_index, write_gate=write_gate, block_tables=block_tables,
                  xkv_tables=xkv_tables, memory=memory, moe_impl=moe_impl, plain=plain, tp=tp,
                  mesh=mesh, rows_sharded=rows_sharded)
        pooled, aux = [], None

        def run(slot, p, sp, hh, c, l):
            def body(x):
                return self._block(slot, _gathered(p, sp, mesh), x, cache=c,
                                   split=_split_of(sp, ms), layer=l, **kw)

            return _remat(body, hh, remat)

        def layer(slot, p, sp, hh, c):
            nonlocal aux
            hh, a = run(slot, p, sp, hh, c, len(pooled))
            if a is not None:
                aux = a if aux is None else aux + a
            pooled.append(hh[:, pool_idx])
            return hh

        def specs(part, i):
            return None if fsdp is None else fsdp[part][i]

        for i, slot in enumerate(plan.prefix):
            c = caches["prefix"][i] if caches else None
            h = layer(slot, params["prefix"][i], specs("prefix", i), h, c)
        # a stacked leaf's layer axis is whole: layer l's part is part[l]
        period_sp = [None if fsdp is None else _layer_specs(params["blocks"][s], fsdp["blocks"][s])
                     for s in range(len(plan.period))]
        for l in range(plan.n_periods):
            for s, slot in enumerate(plan.period):
                c = _layer(caches["blocks"][s], l) if caches else None
                h = layer(slot, _layer(params["blocks"][s], l), period_sp[s], h, c)
        for i, slot in enumerate(plan.suffix):
            c = caches["suffix"][i] if caches else None
            h = layer(slot, params["suffix"][i], specs("suffix", i), h, c)
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
            # every site: one batched product with the whole head stack
            K, B, n, d = hs.shape
            out = torch.matmul(hs.reshape(K, B * n, d), params["ramps"]["head"])
            return out.reshape(K, B, n, -1).float()
        return torch.stack([(hs[j] @ self.ramp_head(params, i)).float()
                            for j, i in enumerate(site_idx)])

    # -- public entry points --------------------------------------------------

    def loss(self, params, batch, *, moe_impl="ep", remat=False, ramp_positions=16,
             train_mode="full", mesh=None, fsdp=None):
        """batch: {'tokens': (B,S) int, 'labels': (B,S) int (-1 = pad)}; a
        cross plan also reads 'image_embeds' (B, M, d_frontend).
        Returns (loss, metrics). Ramp losses use stop-grad features at
        ``ramp_positions`` positions spread over the sequence (the paper:
        backbone frozen w.r.t. ramps; ramps trained on every input).
        ``train_mode`` 'full' is ``lm + ramp + 0.01 * moe aux``,
        'ramps_only' is ``ramp + 0.0 * lm``. Runs without a cache, so it
        writes none, and reaches no kernel (module docstring).

        With ``mesh`` (a ``launch.mesh.make_mesh`` view) the batch is this
        rank's data shard of the rows, alike on every rank of its model
        group, and ``params`` hold the rank's slice of the experts
        (``ep_param_specs``); MoE slots run expert-parallel
        (``moe_apply_ep``). Every term is then the global batch's: the CE
        means divide the shards' summed losses by the mesh's count of valid
        labels, the aux loss takes its router means over every shard. Each
        value is the global one and each gradient this rank's share, so the
        data group's summed gradients are the global loss's.

        With ``fsdp`` as well (each leaf's sanitized spec:
        ``training.train_loop.layout_specs``) ``params`` hold the rank's part
        of every leaf, the reference's FSDP layout, and each is gathered
        where it is used (``fsdp_gather_ad``): a layer's params in its remat
        region, the embedding at the lookup, the head at the LM loss and
        each ramp head at its site, one site at a time. Each gradient is
        then the rank's part of the data group's sum. The compute splits
        over ``model`` as the reference's GSPMD splits it (``fsdp_use``): a
        leaf split over ``model`` is gathered over the data axes only, and
        the rank computes its heads, hidden units and vocabulary columns
        (``layers.ModelSplit``: column- then row-parallel products, a
        vocabulary-parallel lookup and cross-entropy, ``_nll_sum``). Values
        are alike over the model group, and a leaf whole over ``model`` gets
        the whole gradient on every rank of it."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        dev = tokens.device
        positions = torch.arange(S, device=dev)[None, :]
        use = None if fsdp is None else fsdp_use(cfg, fsdp, mesh)
        ms = None if use is None else model_split(mesh)
        tok, tok_sp = params["tok"], None if use is None else use["tok"]
        h = LY.embed_apply(cfg, _gathered(tok, tok_sp, mesh, ("embed", "pos_embed")), tokens,
                           positions, ms=_kept(tok_sp, "embed", ms))
        mask = LY.causal_mask(S, S, 0, device=dev)
        mask_local = LY.window_mask(S, S, 0, cfg.window, device=dev) if cfg.window else mask
        npos = min(ramp_positions, S)
        # the reference's f32 linspace truncated to int, formed on the host
        pool_idx = torch.linspace(S // npos - 1, S - 1, npos,
                                  dtype=torch.float32).to(torch.int64).to(dev)
        memory = None
        if cfg.cross_attn_every:
            fe = _gathered(params["frontend"], None if use is None else use["frontend"], mesh)
            memory = self._memory({"frontend": fe}, batch["image_embeds"])
        h, pooled, aux = self._stack(
            params, h, positions=positions, mask=mask, mask_local=mask_local, caches=None,
            cache_index=None, pool_idx=pool_idx, memory=memory, moe_impl=moe_impl,
            plain=True, remat=remat, mesh=mesh, fsdp=use, ms=ms)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=dev)
        group = mesh.data_group if mesh is not None and mesh.data_size > 1 else None
        h = LY.apply_norm(cfg, params["final_norm"], h)
        head = ("embed",) if cfg.tie_embeddings else ("lm_head",)
        vms = _kept(tok_sp, head[0], ms)
        # with remat the head's product (and its gather) is done again in the backward
        lm = _remat(lambda x: _masked_ce(cfg, LY.unembed(cfg, _gathered(tok, tok_sp, mesh, head),
                                                         x, vms), labels, group, vms), h, remat)
        rloss = self._ramp_loss(params, pooled, labels[:, pool_idx], group=group, mesh=mesh,
                                specs=use, remat=remat, ms=ms)
        if train_mode == "ramps_only":
            loss = rloss + 0.0 * lm
        else:
            loss = lm + rloss + 0.01 * aux
        return loss, {"lm_loss": lm, "ramp_loss": rloss, "moe_aux": aux}

    def _ramp_loss(self, params, pooled, labels, *, group=None, mesh=None, specs=None,
                   remat=False, ms=None):
        """The ramp loss of ``loss``: at each site the stop-grad pooled
        features through the site's norm (and 'mlp' residual) and head,
        reduced there to the summed NLL of the valid ``labels``; the sum
        over the sites over their count of valid labels (``_masked_ce`` over
        the sites' stacked logits, summed in another order; with ``group``
        the global count and mean). With ``specs`` (the gather specs of
        ``loss(fsdp=)``) each site gathers its own head (and 'mlp' weights)
        where it runs; with ``remat`` each site is a remat region, so
        neither its gathered head nor its logits outlive it. The stacked
        leaves are unbound once, so each one's gradient is stacked once, not
        summed from a full-size select gradient a site. With ``ms`` and a
        head the specs keep split (``KeepModel``) a site computes the rank's
        vocabulary columns (``_nll_sum``)."""
        cfg = self.cfg
        if not len(self.sites):  # reduced-depth configs can have zero ramp sites
            return torch.zeros((), dtype=torch.float32, device=pooled.device)
        one = {k: None if specs is None else type(v)(v[1:])  # a site's slice of a stacked leaf
               for k, v in (specs or params)["ramps"].items()}
        rp = {k: torch.unbind(v) for k, v in params["ramps"].items()}
        head = ("embed",) if cfg.tie_embeddings else ("lm_head",)
        tok_sp = None if specs is None else specs["tok"]
        vms = _kept(tok_sp, head[0], ms) if cfg.ramp_style == "tied" else _kept(one, "head", ms)
        hs = pooled.detach()  # stop-grad ramp features
        total = None
        for i, s in enumerate(self.sites):
            def site(x, i=i):
                x = LY.rms_norm(x, rp["norm_w"][i])
                if cfg.ramp_style == "mlp":
                    w1, w2 = (_gathered(rp[k][i], one[k], mesh) for k in ("w1", "w2"))
                    x = x + LY.act_fn("gelu")(x @ w1) @ w2
                if cfg.ramp_style == "tied":
                    logits = LY.unembed(cfg, _gathered(params["tok"], tok_sp, mesh, head), x, vms)
                else:
                    logits = LY.head_logits(x, _gathered(rp["head"][i], one["head"], mesh), vms)
                return _nll_sum(cfg, logits, labels, vms)[0]

            part = _remat(site, hs[s], remat)
            total = part if total is None else total + part
        return _mean_over(total, torch.sum(labels >= 0) * len(self.sites), group)

    def _memory(self, params, image_embeds):
        """A cross plan's image memory: ``image_embeds @ frontend.proj`` in
        the config's dtype."""
        proj = params["frontend"]["proj"]
        return image_embeds.to(proj.dtype) @ proj

    def prefill(self, params, tokens, *, cache_len=None, active_sites=None,
                with_cache=True, image_embeds=None, tp=None, moe_impl="dense", mesh=None):
        """tokens: (B,S). Returns (cache|None, outs) where outs carries final
        + per-active-ramp stats for the LAST position (the generated token).
        Attention attends the S prompt queries to the ``cache_len`` keys
        under the causal mask from query 0: through ``sdpa``, or with
        ``prefill_attn='kernel'`` through the flash-attention kernel. A
        local layer attends the S in-flight keys under the window mask,
        whatever its cache holds (full rows or a ring). A cross plan's
        ``image_embeds`` (B, M, d_frontend) give the cross layers their
        memory, whose k/v the cache keeps (module docstring). ``tp`` (a
        ``TpCtx``; ``prefill_sharded``) runs the rank's shard and returns
        the rank's cache shard. With ``mesh`` (a ``make_mesh`` view) and
        ``moe_impl='ep'`` the tokens are the whole batch alike on every
        rank and MoE slots run expert-parallel on the rank's expert slice
        (``moe_apply_ep`` with ``data_sharded=False``: the reference's
        prefill on a mesh); the rest runs whole on every rank."""
        cfg = self.cfg
        B, S = tokens.shape
        dev = tokens.device
        cache_len = cache_len or S
        positions = torch.arange(S, device=dev)[None, :]
        h = LY.embed_apply(cfg, params["tok"], tokens, positions)
        mask = LY.causal_mask(S, cache_len if with_cache else S, 0, device=dev)
        mask_local = LY.window_mask(S, S, 0, cfg.window, device=dev) if cfg.window else mask
        shard = self._tp_model(tp.m) if tp is not None else self
        caches = shard.init_cache(B, cache_len, device=dev) if with_cache else None
        memory = (self._memory(params, image_embeds)
                  if cfg.cross_attn_every and image_embeds is not None else None)
        h, pooled, _ = self._stack(params, h, positions=positions, mask=mask,
                                   mask_local=mask_local, caches=caches, cache_index=0,
                                   pool_idx=slice(S - 1, S), memory=memory, tp=tp,
                                   moe_impl=moe_impl, mesh=mesh, rows_sharded=False)
        outs = self._head_stats(params, h[:, -1:], pooled, active_sites)
        return caches, outs

    def decode(self, params, cache, tokens, pos, *, active_sites=None,
               exit_thresholds=None, write_gate=None, block_tables=None, tp=None,
               moe_impl="dense"):
        """One decode step. tokens: (B,1); pos: int tensor (B,) of per-row
        write indices (continuous batching leaves every row at its own
        position). The cache is updated in place; ``write_gate`` (bool
        tensor) switches that write off on device.

        With ``block_tables`` (int (B, max_blocks)) the cache is the paged
        pool of ``init_paged_cache``: each row's token is written to
        ``(block_tables[b, pos[b] // bs], pos[b] % bs)`` and attention walks
        the table (``cfg.decode_attn`` must be 'paged' or 'paged-kernel');
        the paged attention masks by position itself, so no mask is built.
        A cross plan's tables end in the pinned xkv columns, which attention
        does not walk (``_split_tables``).
        A local layer builds its own window mask over the W rows it
        gathers, so none is built for it either. ``tp`` (a ``TpCtx``;
        ``decode_sharded``) runs the rank's shard of params and cache.
        Returns (cache, outs)."""
        cfg = self.cfg
        B, S = tokens.shape
        assert S == 1
        if block_tables is not None and (not torch.is_tensor(pos) or pos.dim() < 1):
            raise ValueError("paged decode requires per-row pos: int[B]")
        pos = pos.to(torch.int64).reshape(-1)
        pc = pos[:, None]
        h = LY.embed_apply(cfg, params["tok"], tokens, pc)
        mask = xkv_tables = None
        if block_tables is not None:
            block_tables, xkv_tables = self._split_tables(cache, block_tables)
        Sc = _cache_len(cache) if block_tables is None else None
        if Sc is not None:  # a mamba-only cache has no sequence to mask
            mask = (torch.arange(Sc, device=tokens.device)[None, :] <= pc)[:, None, None, :]
        h, pooled, _ = self._stack(
            params, h, positions=pc, mask=mask, caches=cache, cache_index=pos,
            pool_idx=slice(0, 1), write_gate=write_gate,
            block_tables=block_tables, xkv_tables=xkv_tables, tp=tp, moe_impl=moe_impl,
        )
        outs = self._head_stats(params, h, pooled, active_sites,
                                exit_thresholds=exit_thresholds)
        return cache, outs

    # -- sharded (tensor-parallel) decode --------------------------------------

    def tp_check(self, tp: int, *, dp: int = 1, paged: bool = True, batch=None):
        """Raise ``NotImplementedError`` (with a why-note the support
        matrix surfaces verbatim) when this plan/config cannot run the
        tensor-parallel sharded-decode path at the given mesh shape."""
        cfg = self.cfg
        if tp <= 1 and dp <= 1:
            return
        for slot in self.plan.layer_specs():
            if slot.mixer == "mamba":
                raise NotImplementedError(
                    "tensor-parallel decode cannot shard the mamba mixer: the "
                    "SSM recurrence is per-row/per-channel with conv and state "
                    "fused, so no head axis divides across devices"
                )
            if slot.mixer == "mla":
                raise NotImplementedError(
                    "MLA shares one compressed latent stream across all heads; "
                    "every head shard still needs the full latent cache, so "
                    "sharding gives no per-device KV scaling"
                )
            if slot.cross:
                raise NotImplementedError(
                    "cross-attention slots pin per-slot read-only encoder "
                    "pages that sit outside the TP-sharded KV pool"
                )
        if tp > 1:
            if cfg.n_heads % tp:
                raise NotImplementedError(
                    f"n_heads={cfg.n_heads} not divisible by tp={tp}"
                )
            if cfg.n_kv_heads % tp:
                raise NotImplementedError(
                    f"n_kv_heads={cfg.n_kv_heads} not divisible by tp={tp} "
                    "(the KV pool shards by kv head, one contiguous block per "
                    "device)"
                )
            if cfg.d_ff % tp:
                raise NotImplementedError(
                    f"d_ff={cfg.d_ff} not divisible by tp={tp}"
                )
            if cfg.d_model % tp:
                raise NotImplementedError(
                    f"d_model={cfg.d_model} not divisible by tp={tp}"
                )
            if cfg.moe and cfg.n_experts % tp:
                raise NotImplementedError(
                    f"n_experts={cfg.n_experts} not divisible by tp={tp} "
                    "(expert-parallel MoE owns E/tp experts per device)"
                )
        if dp > 1:
            if paged:
                raise NotImplementedError(
                    "paged pools cannot shard rows over data: per-shard pool "
                    "scatters would diverge the replicated pool copies; "
                    "paged sharded decode is tensor-parallel only"
                )
            if batch is not None and batch % dp:
                raise NotImplementedError(
                    f"decode batch {batch} not divisible by data-parallel "
                    f"degree {dp}"
                )

    def _tp_check_once(self, tp: int, *, dp: int, paged: bool, batch=None):
        """``tp_check``, run once for each shape a sharded step is called
        at: the checks walk every layer, and a step is host-bound."""
        key = (tp, dp, paged, batch)
        if key not in self._tp_passed:
            self.tp_check(tp, dp=dp, paged=paged, batch=batch)
            self._tp_passed.add(key)

    def _tp_cfg(self, m: int):
        """The config of one rank's heads: ``n_heads/m`` on ``n_kv_heads/m``
        with ``head_dim`` pinned (``hd`` would re-derive it from the sliced
        heads), so each kv head keeps its group of query heads."""
        if m not in self._tp_cfgs:
            c = self.cfg
            self._tp_cfgs[m] = c.replace(n_heads=c.n_heads // m, n_kv_heads=c.n_kv_heads // m,
                                         head_dim=c.hd)
        return self._tp_cfgs[m]

    def _tp_model(self, m: int) -> "LM":
        """An LM of one rank's heads (``_tp_cfg``): its cache schemas are
        the rank's cache shard."""
        if m not in self._tp_models:
            self._tp_models[m] = LM(self._tp_cfg(m), prefill_attn=self.prefill_attn,
                                    ssd_impl=self.ssd_impl)
        return self._tp_models[m]

    def tp_param_specs(self, *, moe_ep: bool = False) -> dict:
        """For each param leaf, the axis it splits over the model group (a
        negative index), or None where it is whole on every rank: wq/wk/wv
        and their biases and w_gate/w_up column-sliced (contiguous head and
        hidden blocks), wo/w_down column-sliced on their OUTPUT dim, and
        with ``moe_ep`` the experts' w_gate/w_up/w_down split on the expert
        axis. Ramp heads, the final head, embeddings, the router, shared
        experts and every norm stay whole, so exit masks are computed alike
        on every rank."""
        specs = tree_map(lambda _: None, self.schema())

        def fix_slot(slot: SlotSpec, sp):
            if slot.mixer == "attn":
                for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
                    if k in sp["mixer"]:
                        sp["mixer"][k] = -1
            if slot.ffn == "dense":
                for k in ("w_gate", "w_up", "w_down"):
                    sp["ffn"][k] = -1
            elif slot.ffn == "moe" and moe_ep:
                for k in ("w_gate", "w_up", "w_down"):
                    sp["ffn"][k] = -3

        plan = self.plan
        for part, slots in (("prefix", plan.prefix), ("blocks", plan.period),
                            ("suffix", plan.suffix)):
            for i, slot in enumerate(slots):
                fix_slot(slot, specs[part][i])
        return specs

    def tp_shard_params(self, params, rank: int, m: int, *, moe_ep: bool = False,
                        specs=None) -> dict:
        """Rank ``rank``'s shard of a whole param tree (views: no copy), split
        by ``specs`` (default ``tp_param_specs(moe_ep=)``)."""
        if specs is None:
            specs = self.tp_param_specs(moe_ep=moe_ep)
        return tree_map2(lambda x, ax: x if ax is None else
                     x.narrow(ax, rank * (x.shape[ax] // m), x.shape[ax] // m), params, specs)

    def ep_param_specs(self) -> dict:
        """The split of the mesh-level loss (``loss(mesh=)``): the experts'
        w_gate/w_up/w_down on the expert axis over ``model``, every other
        leaf whole on every rank. Pass it as ``specs`` to
        ``tp_shard_params`` or ``init_sharded``."""
        return tree_map(lambda ax: ax if ax == -3 else None, self.tp_param_specs(moe_ep=True))

    def init_sharded(self, seed: int, rank: int, m: int, device="cuda", *,
                     moe_ep: bool = False, specs=None) -> dict:
        """Rank ``rank``'s shard of ``init(seed)`` without the whole tree:
        leaf by leaf from one generator in ``init``'s order, each split leaf
        drawn as the whole leaf is drawn and only the rank's part kept
        (``ParamInfo.initialize``), so the result equals
        ``tp_shard_params(init(seed), rank, m, moe_ep=, specs=)``."""
        if specs is None:
            specs = self.tp_param_specs(moe_ep=moe_ep)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return tree_map2(lambda info, ax: info.initialize(
            gen, device, None if ax is None else (ax, rank, m)), self.schema(), specs)

    @staticmethod
    def tp_cache_specs(cache, *, data_shard: bool = False):
        """For each cache leaf, the axes it splits: every leaf the TP path
        takes is an attention k/v (contiguous ``(L?, B, S, KH, hd)`` or paged
        ``(L?, P, bs, KH, hd)``) with the kv-head axis at ``ndim-2``, split
        over the model group, so a rank holds ``1/tp`` of the KV bytes; with
        ``data_shard`` (contiguous only) the batch axis ``ndim-4`` splits
        over the data group too."""
        return tree_map(lambda x: (x.dim() - 2,) + ((x.dim() - 4,) if data_shard else ()),
                        cache)

    def tp_shard_cache(self, cache, rank: int, m: int, *, data_rank: int = 0,
                       dp: int = 1):
        """The shard of a whole cache that rank (``data_rank``, ``rank``)
        holds (``tp_cache_specs``): its kv-head block, and with ``dp > 1``
        its rows (copies)."""
        def leaf(x, axes):
            for ax, i, n in zip(axes, (rank, data_rank), (m, dp)):
                x = x.narrow(ax, i * (x.shape[ax] // n), x.shape[ax] // n)
            return x.contiguous()

        return tree_map2(leaf, cache, self.tp_cache_specs(cache, data_shard=dp > 1))

    def _rank_rows(self, B: int, mesh):
        """The rows of a B-row batch this rank decodes: all of them, or its
        data shard's."""
        n = B // mesh.dp
        return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)

    def prefill_sharded(self, params, tokens, *, mesh, cache_len=None, active_sites=None,
                        moe_impl="dense"):
        """``prefill`` on the rank's shard of params (``tp_shard_params`` or
        ``init_sharded``): attention on the rank's heads (kernel #4 at the
        per-rank head count with ``prefill_attn='kernel'``), the combines
        as in ``decode_sharded``. Returns (the rank's cache shard, outs
        alike on every rank). Rows do not shard: a data rank takes its rows
        of the cache (``tp_shard_cache``)."""
        self._tp_check_once(mesh.tp, dp=1, paged=False)
        return self.prefill(params, tokens, cache_len=cache_len, active_sites=active_sites,
                            tp=mesh.tp_ctx, moe_impl=moe_impl)

    def decode_sharded(self, params, cache, tokens, pos, *, mesh, active_sites=None,
                       moe_impl="dense", block_tables=None, exit_thresholds=None):
        """One decode step of this rank (the reference's ``decode_sharded``,
        one ``shard_map`` body a rank): tensor-parallel attention and MLP on
        the rank's shard of params (``tp_param_specs``) with its shard of
        the cache (the contiguous rows or the paged pool, split by kv head:
        ``tp_shard_cache``). ``tokens``, ``pos`` and ``block_tables`` are
        the whole batch's, alike on every rank; with ``mesh.dp > 1``
        (contiguous rows only) the rank decodes its data shard's rows and
        the records are gathered over the data group. The ramp heads, the
        final head and the exit decision run on whole params, so every rank
        returns the same records and exit masks never leave the device.
        ``moe_impl='ep'`` runs MoE slots expert-parallel (params from
        ``moe_ep=True``). Returns (the rank's cache shard, outs)."""
        B = tokens.shape[0]
        self._tp_check_once(mesh.tp, dp=mesh.dp, paged=block_tables is not None, batch=B)
        rows = self._rank_rows(B, mesh)
        cache, outs = self.decode(params, cache, tokens[rows], pos.reshape(-1)[rows],
                                  active_sites=active_sites, exit_thresholds=exit_thresholds,
                                  block_tables=block_tables, tp=mesh.tp_ctx,
                                  moe_impl=moe_impl)
        if mesh.dp > 1:
            from repro_torch.distributed import all_gather_tiled

            g = mesh.groups["data"]
            outs = {part: {k: all_gather_tiled(v, g, v.dim() - 1) for k, v in st.items()}
                    for part, st in outs.items()}
        return cache, outs

    def decode_sharded_multi(self, params, cache, tokens, pos, n_steps: int, *, mesh,
                             n_max: int, active_sites=None, thresholds=None, row_valid=None,
                             moe_impl="dense", block_tables=None):
        """``decode_multi`` on this rank's shard (the reference's
        ``decode_sharded_multi``): the whole window runs in the rank, the
        exit masks on whole ramp heads alike on every rank, so the one host
        read per window stays at its end. With ``mesh.dp > 1`` the
        all-exited test sums over the data group each step and the records
        are gathered over it. Returns (the rank's cache shard, (rl, rm, fl,
        ex, n_done)) as ``decode_multi``."""
        B = tokens.shape[0]
        self._tp_check_once(mesh.tp, dp=mesh.dp, paged=block_tables is not None, batch=B)
        rows = self._rank_rows(B, mesh)
        if row_valid is None:
            row_valid = torch.ones(B, dtype=torch.bool, device=tokens.device)
        cache, (rl, rm, fl, ex, nd) = self.decode_multi(
            params, cache, tokens[rows], pos.reshape(-1)[rows], n_steps, n_max=n_max,
            active_sites=active_sites, thresholds=thresholds, row_valid=row_valid[rows],
            block_tables=block_tables, tp=mesh.tp_ctx, moe_impl=moe_impl)
        if mesh.dp > 1:
            from repro_torch.distributed import all_gather_tiled

            g = mesh.groups["data"]
            rl, rm, fl, ex = (all_gather_tiled(t, g, t.dim() - 1) for t in (rl, rm, fl, ex))
        return cache, (rl, rm, fl, ex, nd)

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
        with trace.span("model/heads"):
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
    """Sequence length of a contiguous cache: the LONGEST attention leaf, k
    ``(.., B, S, KH, hd)`` or MLA's c ``(.., B, S, r)``, stacked, prefix or
    suffix, so a W-row ring leaf never sets the global mask (the
    reference's max over leaves); a cross slot's nested ``xkv`` rows (M
    image tokens, attended unmasked) are not looked at, as the reference
    skips them. None when the plan has no attention: a
    mamba-only cache holds one recurrent state a row and no sequence (the
    reference skips the mask)."""
    found = []
    for part in ("prefix", "blocks", "suffix"):
        for blk in cache.get(part, []):
            if "k" in blk:
                found.append(blk["k"].shape[-3])
            if "c" in blk:
                found.append(blk["c"].shape[-2])
    return max(found) if found else None


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


def _nll_sum(cfg, logits, labels, ms=None):
    """(the summed NLL over the valid labels, their count): the reference's
    formula, max-shifted log-sum-exp with -1 padding labels and the padded
    vocabulary masked.

    With ``ms`` (a ``layers.ModelSplit``) ``logits`` are the rank's columns
    ``[i n, (i + 1) n)`` of the vocabulary, the model group's vocabulary
    parallel cross-entropy: the shift is the group's max (forward only:
    the log-sum-exp does not depend on it), the exponentials' sum and the
    label's logit (nonzero on the one rank that holds it) are summed over
    the group, and the padded columns are masked on the rank that holds
    them. The value is alike on every rank, the gradient the rank's
    columns'."""
    logits = logits.float()
    valid = labels >= 0
    lab = torch.clamp(labels, min=0).long()
    if ms is None:
        if logits.shape[-1] > cfg.vocab_size:
            logits = _mask_pad_vocab(cfg, logits)
        m = torch.max(logits, dim=-1).values
        lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
        ll = torch.gather(logits, -1, lab[..., None])[..., 0]
        return torch.sum((lse - ll) * valid), torch.sum(valid)
    n = logits.shape[-1]
    lo = ms.index * n
    if lo + n > cfg.vocab_size:
        col = lo + torch.arange(n, device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    m = ms.max(torch.max(logits, dim=-1).values)
    lse = m + torch.log(ms.sum(torch.sum(torch.exp(logits - m[..., None]), dim=-1)))
    loc = lab - lo
    mine = (loc >= 0) & (loc < n)
    ll = torch.gather(logits, -1, torch.where(mine, loc, 0)[..., None])[..., 0]
    ll = ms.sum(torch.where(mine, ll, 0.0))
    return torch.sum((lse - ll) * valid), torch.sum(valid)


def _mean_over(total, count, group=None):
    """``total / count`` (at least 1). With ``group`` (a data group whose
    ranks each hold a shard of the rows) the count is every shard's: the
    value the global mean, the gradient this shard's share
    (``global_value``)."""
    if group is None:
        return total / torch.clamp(count, min=1)
    from repro_torch.distributed import sum_over

    n = sum_over(count.float(), group)
    return MOE.global_value(total / torch.clamp(n, min=1), group)


def _masked_ce(cfg, logits, labels, group=None, ms=None):
    """Cross-entropy with -1 padding labels and padded-vocab masking (the
    reference's formula: max-shifted log-sum-exp, mean over valid labels;
    with ``group`` over every shard's valid labels, ``_mean_over``; with
    ``ms`` over the rank's vocabulary columns, ``_nll_sum``)."""
    return _mean_over(*_nll_sum(cfg, logits, labels, ms), group)
