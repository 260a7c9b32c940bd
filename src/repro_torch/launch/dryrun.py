"""One-card dry run: every runnable (arch × shape) cell of the ``SHAPES``
grid traced once at full width and depth on the ``meta`` device, and the
roofline terms of one H100 read off the trace.

The port's counterpart of the reference's multi-pod dry run, which lowers
and compiles each cell for 512 TPU chips and reads XLA's cost analysis.
Here a cell runs eagerly on meta tensors (nothing is allocated or
computed), on the plain path (kernels off: ``sdpa``, the plain SSD scan,
dense ramp heads; MoE on the dense dispatch the port serves, and in a
train step on the capacity-dropping one the loss takes, as the
reference's), so a step's work is counted the same way whatever later
implements it:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``;
* ``bytes``: ``ByteCounter``, every non-view aten op's operands and
  results (each distinct tensor once an op), the counterpart of XLA's
  "bytes accessed";
* ``floor_bytes``: the least a step must move (``step_floor``): the
  params it reads, the cache rows it reads once, what it writes;
* ``model_flops_ref``, ``params_total``, ``params_active``: the
  reference's ``model_flops`` formula (6·N·D train, 2·N·D serve, N
  without ramp heads, MoE counting the active experts);
* ``t_compute_s`` / ``t_memory_s`` (``flops`` over ``PEAK_FLOPS``,
  ``bytes`` over ``HBM_BW``: ``core/profiles.py``'s published H100
  peaks), ``bottleneck``, ``useful_flops_ratio``;
* ``fits``: the resident bytes (``resident``: params; train adds grads
  and AdamW's f32 moments; serving adds the cache) against the card's
  80 GB.

Eager tracing counts every layer, so no two-depth extrapolation is
needed. ``--mesh single`` reckons one H100. ``--mesh multi`` traces rank 0
of the reference's multi-pod layout, ``(pod 2, data 16, model 16)``, 512
cards: one rank of a job of 512 joined through PyTorch's fake process
group (no card, no peer; a collective returns its shapes and moves
nothing) on meta tensors. A train cell runs the mesh step
(``make_train_step(mesh=)``: rows over ``(pod, data)``, experts over
``model``) in the reference's FSDP layout, ``mesh_axes(mesh, fsdp=True)``:
the rank holds its part of every leaf of the params, gradients and AdamW
moments, split by the leaf's spec sanitized on the mesh, and the record
adds ``rank_state_bytes`` against ``whole_state_bytes``. Its loss splits
the compute over ``model`` as the reference's does (``fsdp_use``): a leaf
split over ``model`` is gathered over the data axes only, and the model
group sums its activations (``collectives_by_group``: each kind's calls
and bytes over the ``model`` group, the data group and any other). A
prefill or decode cell runs ``prefill_sharded`` / ``decode_sharded`` at tp
16 over ``model`` with rows over ``(pod, data)`` where ``tp_check`` allows
it, and where it refuses, the record's ``status`` is the check's text. A multi record adds
the rank's collectives by kind as the port's collectives count them
(``count_collectives``: calls and bytes), their bytes by link
(``collective_bytes_by_link``: NVLink for a group inside one 8-card host,
the network for a group across hosts), ``t_collective_s`` (each link's
bytes over its published rate, ``LINK_BW``, reckoned) and a per-rank
``resident``/``fits`` for this layout. Records go to
``build/dryrun/<arch>__<shape>__<single|multi>.json`` at the repo root.
The card is named from its published peaks; measured card numbers come
only from ``chip_smoke.py``.

Usage (runs on the CPU, no CUDA):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b --shape train_4k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table   # the records, as markdown
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, all_cells, get_config
from repro_torch.core.profiles import HBM_BW, ICI_BW, PEAK_FLOPS
from repro_torch.models import build_model
from repro_torch.models.common import (
    axis_specs,
    param_bytes,
    param_count,
    tree_leaves,
    tree_map2,
)

ART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "build",
                       "dryrun")
CARD = "NVIDIA H100 80GB HBM3, 700 W (published peaks)"
CARD_BYTES = 80e9  # the H100's HBM
MULTI_LAYOUT = {"pod": 2, "data": 16, "model": 16}  # make_production_mesh(multi_pod=True)
# the link a collective's group runs on: NVLink 4 inside one host of 8
# cards, the network between hosts (rank r on host r // HOST_CARDS); each
# byte is reckoned at its group's link rate each way a card
HOST_CARDS = 8  # an 8-card HGX/DGX H100 host (NVIDIA DGX H100 datasheet)
LINK_BW = {"nvlink": ICI_BW, "network": 400e9 / 8}
LINK = {"nvlink": "NVLink 4, 450 GB/s each way a card (NVIDIA H100 SXM datasheet, 900 GB/s "
                  "bidirectional)",
        "network": "one 400 Gb/s NDR InfiniBand port a card, 50 GB/s each way (ConnectX-7, "
                   "NVIDIA DGX H100 datasheet)"}


def link_of(ranks) -> str:
    """'nvlink' for a group whose ranks share one host, else 'network'."""
    return "nvlink" if len({r // HOST_CARDS for r in ranks}) == 1 else "network"


_aten = torch.ops.aten
# ops that move no bytes: results that alias their input without a view
# schema, and allocations that write nothing
_NO_BYTES = {_aten._unsafe_view.default, _aten.detach.default, _aten.lift_fresh.default,
             _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
             _aten.new_empty.default, _aten.new_empty_strided.default}


_COPIES = (_aten._to_copy.default, _aten.copy_.default)


def _moves_bytes(func, tensors) -> bool:
    """False for views, allocations and copies between devices (a host
    index sent to the card crosses the bus, not the card's memory)."""
    if func.is_view or func in _NO_BYTES:
        return False
    return func not in _COPIES or len({t.device for t in tensors}) == 1


class ByteCounter(TorchDispatchMode):
    """Sums, over every aten op that moves the device's bytes
    (``_moves_bytes``), the bytes of each distinct tensor among its
    operands and results (an in-place op's result is its operand, counted
    once)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {id(t): t for t in tree_flatten((args, kwargs, out))[0]
                if isinstance(t, torch.Tensor)}
        if _moves_bytes(func, seen.values()):
            self.bytes += sum(t.numel() * t.element_size() for t in seen.values())
            self.ops += 1
        return out


def count(fn):
    """Run ``fn()`` under both counters. Returns (its result, flops, bytes,
    aten ops counted)."""
    flops, nbytes = FlopCounterMode(display=False), ByteCounter()
    with flops, nbytes:
        out = fn()
    return out, flops.get_total_flops(), nbytes.bytes, nbytes.ops


def model_flops(cfg, shape_info):
    """Reference useful FLOPs: 6·N_active·D (train) / 2·N_active·D (serve);
    N excludes ramp heads (the technique's overhead is reported separately)."""
    schema = build_model(cfg).schema()
    n_total = param_count(schema)
    n_ramps = param_count(schema.get("ramps", {})) if isinstance(schema, dict) else 0
    n_backbone = n_total - n_ramps
    n_active = n_backbone
    if cfg.moe:
        e_tot, e_act = cfg.n_experts, cfg.top_k
        expert_params = 3 * cfg.d_model * cfg.moe_d_ff
        n_moe_layers = sum(
            1 for i in range(cfg.n_layers)
            if (not cfg.hybrid_period or i % cfg.moe_every == 1) and i >= cfg.first_k_dense
        )
        n_active = n_backbone - n_moe_layers * (e_tot - e_act) * expert_params
    D = shape_info["global_batch"] * (shape_info["seq_len"] if shape_info["kind"] != "decode"
                                      else 1)
    mult = 6.0 if shape_info["kind"] == "train" else 2.0
    return mult * n_active * D, n_total, n_active


# -- what a step must move, and what it keeps ---------------------------------


def _itemsize(cfg):
    return torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()


def _active(model, shape_info):
    return min(shape_info.get("active", model.cfg.ramp_budget_slots), len(model.sites))


def step_params_bytes(model, B, n_active, *, decode, touched_experts=None):
    """Bytes of the params one step reads: all of them but the ramp heads
    not active, an untied embedding's unread rows (B·S of them are read),
    and, in a decode step, the encoder and the image/frame projections
    (they run in the prefill). ``touched_experts`` counts only that many
    (layer, expert) slots of the MoE experts, the floor of a routed
    dispatch."""
    cfg = model.cfg
    sch = model.schema()
    total = param_bytes(sch)
    ramps = sch.get("ramps", {})
    if ramps and cfg.ramp_style != "tied":  # every ramp leaf has a leading site axis
        S = len(model.sites)
        total -= param_bytes(ramps) * (S - n_active) // S
    tok = sch.get("tok", {})
    if "lm_head" in tok and "embed" in tok:  # untied: the lookup reads B rows
        total -= param_bytes(tok["embed"]) - B * cfg.d_model * tok["embed"].dtype.itemsize
    if decode:
        for key in ("enc", "enc_norm", "frontend_proj", "frontend"):
            total -= param_bytes(sch.get(key, {}))
    if touched_experts is not None:
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff * _itemsize(cfg)
        n_moe = sum(1 for s in model.plan.layer_specs() if s.ffn == "moe")
        total -= (n_moe * cfg.n_experts - touched_experts) * per_expert
    return total


def decode_cache_bytes(model, B, pos, memory):
    """(read, written) bytes of the cache in one decode step of B rows at
    ``pos``: each global attention layer's k and v up to pos, a local
    layer's last min(W, pos + 1) rows, MLA's latent and rope key up to pos,
    a mamba layer's state (read and written), a cross layer's (or the
    enc-dec decoder's) ``xkv`` memory of ``memory`` rows; the new row of
    each attention and MLA layer written."""
    cfg = model.cfg
    it = _itemsize(cfg)
    # a k and a v row (an attention-free config has no head width)
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * it if cfg.n_heads else 0
    rows, M = pos + 1, memory
    if cfg.family == "encdec":
        L = cfg.n_dec_layers
        return B * L * (kv_row * rows + kv_row * M), B * L * kv_row
    read = written = 0
    for s in model.plan.layer_specs():
        if s.mixer == "mamba":
            di, N, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim
            conv_dim = di + 2 * cfg.ssm_ngroups * N
            state = (cfg.d_conv - 1) * conv_dim * it + (di // hp) * hp * N * 4
            read, written = read + B * state, written + B * state
        elif s.mixer == "mla":
            lat = (cfg.kv_lora_rank + cfg.qk_rope_dim) * it
            read, written = read + B * lat * rows, written + B * lat
        else:
            live = min(cfg.window, rows) if (s.is_local and cfg.window) else rows
            read, written = read + B * kv_row * live, written + B * kv_row
        if s.cross:
            read += B * kv_row * M
    return read, written


ENCDEC_SELF_ROWS = 4096  # an enc-dec decode cell's self-attention slots (the reference's)
ENCDEC_PROMPT = 64  # an enc-dec prefill cell's decoder tokens (the reference's)


def decode_geometry(cfg, info):
    """(cache slots a row, pos, memory rows) of a decode cell: a ``SHAPES``
    cell decodes at the cache's last slot (an enc-dec one over 4096 self
    slots and ``seq_len`` memory rows, the reference's cell); a served
    shape at its ``pos`` (its ``memory``, default the config's
    ``n_image_tokens``)."""
    S = info["seq_len"]
    if "pos" in info:
        return S, info["pos"], info.get("memory", cfg.n_image_tokens)
    if cfg.family == "encdec":
        return ENCDEC_SELF_ROWS, ENCDEC_SELF_ROWS - 1, S
    return S, S - 1, cfg.n_image_tokens


def cache_bytes(model, B, S, memory):
    """Bytes of the contiguous cache of B rows of S slots (with ``memory``
    rows of xkv for the enc-dec decoder)."""
    if model.cfg.family == "encdec":
        return param_bytes(model.cache_schema(B, S, memory))
    return param_bytes(model.cache_schema(B, S))


def step_floor(model, shape_info, *, touched_experts=None):
    """The least one step of the cell must move, in bytes, by part (each
    input read once, each output written once):
    * decode: the params it reads (``step_params_bytes``), the cache rows
      it reads and writes (``decode_cache_bytes``; ``pos`` defaults to the
      cache's last slot);
    * prefill: the params it reads, its image or frame inputs, the cache
      it writes;
    * train: the params read and written, AdamW's f32 moments read and
      written, the batch.
    """
    cfg = model.cfg
    kind, GB, S = shape_info["kind"], shape_info["global_batch"], shape_info["seq_len"]
    K = _active(model, shape_info)
    if kind == "train":
        p = param_bytes(model.schema())
        n = param_count(model.schema())
        parts = {"params": 2 * p, "moments": 2 * 2 * 4 * n, "batch": 2 * GB * S * 4}
    elif kind == "prefill":
        encdec = cfg.family == "encdec"
        parts = {"params": step_params_bytes(model, GB * S, K, decode=False,
                                             touched_experts=touched_experts),
                 "cache_written": cache_bytes(model, GB, ENCDEC_PROMPT if encdec else S, S)}
        if cfg.cross_attn_every or encdec:
            M = S if encdec else cfg.n_image_tokens
            parts["memory_inputs"] = GB * M * cfg.d_frontend * _itemsize(cfg)
    else:
        _, pos, memory = decode_geometry(cfg, shape_info)
        read, written = decode_cache_bytes(model, GB, pos, memory)
        parts = {"params": step_params_bytes(model, GB, K, decode=True,
                                             touched_experts=touched_experts),
                 "cache_read": read, "cache_written": written}
    parts["total"] = sum(parts.values())
    return parts


def resident(model, shape_info):
    """Bytes the cell keeps on the card: the params; train adds their
    gradients (the params' dtype) and AdamW's f32 mu and nu; serving adds
    the contiguous cache. Activations are not counted."""
    sch = model.schema()
    out = {"params": param_bytes(sch)}
    GB, S = shape_info["global_batch"], shape_info["seq_len"]
    if shape_info["kind"] == "train":
        out["grads"] = param_bytes(sch)
        out["adamw_moments"] = 2 * 4 * param_count(sch)
    elif shape_info["kind"] == "decode":
        rows, _, memory = decode_geometry(model.cfg, shape_info)
        out["cache"] = cache_bytes(model, GB, rows, memory)
    else:
        encdec = model.cfg.family == "encdec"
        out["cache"] = cache_bytes(model, GB, ENCDEC_PROMPT if encdec else S, S)
    out["total"] = sum(out.values())
    return out


# -- the cells ---------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def build_cell(arch: str, shape, *, moe_impl="ep", overrides=None):
    """(model, shape_info, fn): ``fn()`` runs one step of the cell on meta
    tensors, on the plain path. ``shape`` is a ``SHAPES`` name or a dict
    with kind, seq_len and global_batch (and for a served decode: ``pos``,
    the rows' position, and ``active``, the ramp count; an enc-dec cell's
    ``memory``, its frames)."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    info = SHAPES[shape] if isinstance(shape, str) else dict(shape)
    model = build_model(cfg, **({"ssd_impl": "ref"} if cfg.family == "lm" else {}))
    kind, GB, S = info["kind"], info["global_batch"], info["seq_len"]
    act = list(range(_active(model, info)))
    params = model.abstract()
    dt = getattr(torch, cfg.dtype)

    if kind == "train":
        from repro_torch.training.train_loop import TrainConfig, make_train_step
        from repro_torch.training.optim import AdamWConfig, adamw_init

        step_fn, opt_cfg = make_train_step(
            model, TrainConfig(moe_impl=moe_impl, remat=cfg.train_remat), AdamWConfig())
        n_tok = S if cfg.family != "encdec" else S // 8
        batch = {"tokens": _meta((GB, n_tok), torch.int32),
                 "labels": _meta((GB, n_tok), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = _meta((GB, S, cfg.d_frontend), dt)
        if cfg.cross_attn_every:
            batch["image_embeds"] = _meta((GB, cfg.n_image_tokens, cfg.d_frontend), dt)
        state = {"params": params, "opt": adamw_init(params, opt_cfg),
                 "step": _meta((), torch.int32)}
        return model, info, lambda: step_fn(state, batch)

    if kind == "prefill":
        if cfg.family == "encdec":
            frames = _meta((GB, S, cfg.d_frontend), dt)
            toks = _meta((GB, ENCDEC_PROMPT), torch.int32)
            return model, info, lambda: model.prefill(params, frames, toks, active_sites=act)
        kw = {}
        if cfg.cross_attn_every:
            kw["image_embeds"] = _meta((GB, cfg.n_image_tokens, cfg.d_frontend), dt)
        toks = _meta((GB, S), torch.int32)
        return model, info, lambda: model.prefill(params, toks, active_sites=act, **kw)

    # decode: one token a row against the cache of ``decode_geometry``
    rows, _, memory = decode_geometry(cfg, info)
    cache = (model.cache_abstract(GB, rows, memory) if cfg.family == "encdec"
             else model.cache_abstract(GB, rows))
    toks, pos = _meta((GB, 1), torch.int32), _meta((GB,), torch.int32)
    return model, info, lambda: model.decode(params, cache, toks, pos, active_sites=act)


def run_cell(arch: str, shape, mesh_kind: str = "single", *, tag="", write=True,
             touched_experts=None, overrides=None):
    """Trace one cell on meta and write its record. ``shape`` is a
    ``SHAPES`` name or a dict (``build_cell``); a dict cell is named by
    ``tag``."""
    if mesh_kind == "multi":
        return run_cell_multi(arch, shape, write=write, overrides=overrides)
    if mesh_kind != "single":
        raise ValueError(f"mesh {mesh_kind!r}: 'single' | 'multi'")
    name = shape if isinstance(shape, str) else (tag or "served")
    rec = {"arch": arch, "shape": name, "mesh": mesh_kind, "chips": 1, "card": CARD,
           "tag": tag, "ok": False}
    t0 = time.perf_counter()
    try:
        model, info, fn = build_cell(arch, shape, overrides=overrides)
        rec.update({k: info[k] for k in ("kind", "seq_len", "global_batch")},
                   **{k: info[k] for k in ("pos", "active", "memory") if k in info})
        with torch.no_grad() if info["kind"] != "train" else torch.enable_grad():
            _, flops, nbytes, ops = count(fn)
        mf, n_tot, n_act = model_flops(model.cfg, info)
        floor = step_floor(model, info, touched_experts=touched_experts)
        res = resident(model, info)
        rec.update({
            "flops": float(flops), "bytes": float(nbytes), "aten_ops": ops,
            "floor_bytes": float(floor["total"]), "floor": floor,
            "model_flops_ref": mf, "params_total": n_tot, "params_active": n_act,
            "t_compute_s": flops / PEAK_FLOPS, "t_memory_s": nbytes / HBM_BW,
            "t_floor_s": floor["total"] / HBM_BW,
            "useful_flops_ratio": mf / max(float(flops), 1.0),
            "resident": res, "fits": res["total"] <= CARD_BYTES,
        })
        rec["bottleneck"] = "compute" if rec["t_compute_s"] > rec["t_memory_s"] else "memory"
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — the record carries the failure
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = time.perf_counter() - t0
    if write:
        _write(rec)
    return rec


def _write(rec):
    os.makedirs(ART_DIR, exist_ok=True)
    name, mesh_kind = rec["shape"], rec["mesh"]
    with open(os.path.join(ART_DIR, f"{rec['arch']}__{name}__{mesh_kind}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '')[:120]})"
    if rec.get("refused"):
        status = f"refused ({rec['status'][:120]})"
    print(f"[{rec['arch']} × {name} × {mesh_kind}] {status}  {rec['total_s']:.1f}s  "
          f"bottleneck={rec.get('bottleneck', '-')}", flush=True)


# -- the multi-pod layout: rank 0 of 512 ----------------------------------------


@contextlib.contextmanager
def fake_job(world: int):
    """This process as rank 0 of a ``world``-rank job in PyTorch's fake
    process group: collectives return their shapes and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_job: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_bytes(schema, specs, mesh) -> int:
    """Bytes of the leaves a rank holds: each leaf's part by its partition
    spec on ``mesh`` (a ``RankMesh`` or a dict of axis sizes)."""
    from repro_torch.models.common import part_shape

    parts = []
    tree_map2(lambda info, sp: parts.append(
        math.prod(part_shape(info.shape, sp, mesh)) * info.dtype.itemsize), schema, specs)
    return sum(parts)


def build_cell_multi(arch: str, shape, mesh, *, overrides=None):
    """(model, shape_info, fn, rank's resident bytes by part): ``fn()`` runs
    this rank's step of the cell on meta tensors, or raises the
    ``tp_check`` refusal (``NotImplementedError``)."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    info = SHAPES[shape] if isinstance(shape, str) else dict(shape)
    model = build_model(cfg, **({"ssd_impl": "ref"} if cfg.family == "lm" else {}))
    kind, GB, S = info["kind"], info["global_batch"], info["seq_len"]
    m, D = mesh.model_size, mesh.data_size
    act = list(range(_active(model, info)))
    dt = getattr(torch, cfg.dtype)
    sch = model.schema()
    if kind == "train":
        from repro_torch.launch.mesh import mesh_axes
        from repro_torch.training.optim import AdamWConfig, adamw_init
        from repro_torch.training.train_loop import TrainConfig, layout_specs, make_train_step

        axes = mesh_axes(mesh, fsdp=True)
        specs = layout_specs(model, mesh, axes)
        params = _shard_meta(model.abstract(), specs, mesh)
        step_fn, opt_cfg = make_train_step(
            model, TrainConfig(moe_impl="ep", remat=cfg.train_remat), AdamWConfig(), mesh=mesh,
            axes=axes)
        n_tok = S if cfg.family != "encdec" else S // 8
        batch = {"tokens": _meta((GB, n_tok), torch.int32),
                 "labels": _meta((GB, n_tok), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = _meta((GB, S, cfg.d_frontend), dt)
        if cfg.cross_attn_every:
            batch["image_embeds"] = _meta((GB, cfg.n_image_tokens, cfg.d_frontend), dt)
        state = {"params": params, "opt": adamw_init(params, opt_cfg),
                 "step": _meta((), torch.int32)}
        p = _rank_bytes(sch, specs, mesh)
        res = {"params": p, "grads": p,
               "adamw_moments": 8 * sum(x.numel() for x in tree_leaves(params))}
        return model, info, lambda: step_fn(state, batch), res
    if not hasattr(model, "tp_check"):
        raise NotImplementedError(f"{type(model).__name__} has no tensor-parallel path: it "
                                  "serves on one rank")
    rows = GB // D
    model.tp_check(m, dp=D if kind == "decode" else 1, paged=False,
                   batch=GB if kind == "decode" else None)
    if kind == "prefill" and GB % D:
        raise NotImplementedError(f"prefill batch {GB} not divisible by {D} data ranks")
    specs = axis_specs(sch, model.tp_param_specs(moe_ep=True))
    params = _shard_meta(model.abstract(), specs, mesh)
    serving = mesh.serving()
    kw = {"moe_impl": "ep"} if cfg.moe else {}
    res = {"params": _rank_bytes(sch, specs, mesh)}
    if kind == "prefill":
        toks = _meta((rows, S), torch.int32)
        res["cache"] = cache_bytes(model, rows, S, S) // m
        return model, info, lambda: model.prefill_sharded(
            params, toks, mesh=serving, active_sites=act, **kw), res
    slots, _, memory = decode_geometry(cfg, info)
    cache = model.tp_shard_cache(model.cache_abstract(GB, slots), mesh.model_rank, m,
                                 data_rank=serving.data_rank, dp=D)
    res["cache"] = sum(x.numel() * x.element_size() for x in tree_leaves(cache))
    toks, pos = _meta((GB, 1), torch.int32), _meta((GB,), torch.int32)
    return model, info, lambda: model.decode_sharded(
        params, cache, toks, pos, mesh=serving, active_sites=act, **kw), res


def _shard_meta(params, specs, mesh):
    """The rank's part of each meta leaf by its partition spec
    (``take_part``)."""
    from repro_torch.models.common import take_part

    return tree_map2(lambda x, sp: take_part(x, sp, mesh), params, specs)


def run_cell_multi(arch: str, shape, *, write=True, overrides=None):
    """Trace rank 0 of the multi-pod layout (``make_production_mesh``) for
    one cell on meta (module docstring) and write its record."""
    from repro_torch.distributed import count_collectives
    from repro_torch.launch.mesh import make_production_mesh

    world = math.prod(MULTI_LAYOUT.values())
    name = shape if isinstance(shape, str) else "served"
    rec = {"arch": arch, "shape": name, "mesh": "multi", "chips": world,
           "layout": dict(MULTI_LAYOUT), "rank": 0, "card": CARD, "link": LINK, "ok": False}
    t0 = time.perf_counter()
    try:
        with fake_job(world):
            mesh = make_production_mesh(multi_pod=True, device="meta")
            try:
                model, info, fn, res = build_cell_multi(arch, shape, mesh, overrides=overrides)
            except NotImplementedError as e:  # the layout's check refused the cell
                rec.update(ok=True, refused=True, status=str(e))
            else:
                rec.update({k: info[k] for k in ("kind", "seq_len", "global_batch")})
                with count_collectives() as cc:
                    with torch.no_grad() if info["kind"] != "train" else torch.enable_grad():
                        _, flops, nbytes, ops = count(fn)
                rec["collectives_by_group"] = _by_group(cc, mesh)
        if not rec.get("refused"):
            coll = {k: {"calls": c, "bytes": b} for k, (c, b) in cc.items()}
            cbytes = sum(v["bytes"] for v in coll.values())
            by_link = dict.fromkeys(LINK_BW, 0.0)
            for ranks, b in cc.by_group.items():
                by_link[link_of(ranks)] += b
            res["total"] = sum(res.values())
            if info["kind"] == "train":
                rec["rank_state_bytes"] = res["params"] + res["grads"] + res["adamw_moments"]
                rec["whole_state_bytes"] = sum(
                    x.numel() * (2 * x.element_size() + 8) for x in tree_leaves(model.abstract()))
            rec.update({
                "status": "ok", "flops": float(flops), "bytes": float(nbytes), "aten_ops": ops,
                "collectives": coll, "collective_bytes": cbytes,
                "collective_bytes_by_link": by_link,
                "t_compute_s": flops / PEAK_FLOPS, "t_memory_s": nbytes / HBM_BW,
                "t_collective_s": sum(b / LINK_BW[k] for k, b in by_link.items()), "resident": res,
                "fits": res["total"] <= CARD_BYTES, "ok": True,
            })
            terms = {"compute": rec["t_compute_s"], "memory": rec["t_memory_s"],
                     "collective": rec["t_collective_s"]}
            rec["bottleneck"] = max(terms, key=terms.get)
    except Exception as e:  # noqa: BLE001 — the record carries the failure
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = time.perf_counter() - t0
    if write:
        _write(rec)
    return rec


def _by_group(cc, mesh):
    """``{"<kind> over <group>": {"calls", "bytes"}}`` of a
    ``count_collectives`` result: the group named ``model`` or ``data``
    where it is the mesh's, else by its ranks."""
    import torch.distributed as dist

    names = {tuple(dist.get_process_group_ranks(mesh.model_group)): "model",
             tuple(dist.get_process_group_ranks(mesh.data_group)): "data"}
    return {f"{kind} over {names.get(ranks, ranks)}": {"calls": c, "bytes": b}
            for (kind, ranks), (c, b) in sorted(cc.by_kind_group.items())}


def cells():
    return [(a, s) for a, s, runnable in all_cells() if runnable]


def table(records) -> str:
    """A markdown table of cell records, an arch a row and a shape a column:
    FLOPs, bytes, the byte floor (the reckoned terms), the bottleneck and
    whether it fits one card."""
    by = {(r["arch"], r["shape"]): r for r in records}
    shapes = [s for s in SHAPES if any((a, s) in by for a in ARCH_IDS)]
    lines = ["| arch | " + " | ".join(shapes) + " |", "|---" * (len(shapes) + 1) + "|"]
    for a in ARCH_IDS:
        row = []
        for s in shapes:
            r = by.get((a, s))
            if r is None or not r.get("ok"):
                row.append("—" if r is None else "FAIL")
                continue
            row.append(f"{r['flops']:.3g} F, {r['bytes']:.3g} B, floor {r['floor_bytes']:.3g}, "
                       f"{r['bottleneck'][:3]}, {'fits' if r['fits'] else 'no fit'}")
        if any(c != "—" for c in row):
            lines.append(f"| {a} | " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="every runnable cell of SHAPES")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the written records as a markdown table and exit")
    args = ap.parse_args(argv)
    if args.table:
        recs = []
        for a, s in cells():
            path = os.path.join(ART_DIR, f"{a}__{s}__single.json")
            if os.path.exists(path):
                with open(path) as f:
                    recs.append(json.load(f))
        print(table(recs))
        return 0
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = cells()
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    n_ok = 0
    for a, s in todo:
        for mk in meshes:
            path = os.path.join(ART_DIR, f"{a}__{s}__{mk}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        n_ok += 1
                        continue
            n_ok += bool(run_cell(a, s, mk)["ok"])
    print(f"dryrun: {n_ok}/{len(todo) * len(meshes)} cells OK", flush=True)
    return 0 if n_ok == len(todo) * len(meshes) else 1


if __name__ == "__main__":
    raise SystemExit(main())
