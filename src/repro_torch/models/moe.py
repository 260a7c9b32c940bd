"""Top-k mixture of experts (the port's counterpart of the JAX package's
``models/moe.py``), on one device and over a mesh of ranks.

``moe_apply_dense`` is the reference's oracle: every expert processes every
token, and each token sums its top-k experts' outputs weighted by their
normalised f32 gates, in top-k order. Every serving path of the port runs
it, as the reference's serving runner asks for (``moe_impl='dense'``).
``moe_apply_ep`` is the reference's capacity-dropping dispatch on one
device (``moe_apply_ep`` with ``mesh=None``), which the reference's
``LM.loss`` defaults to: assignments sorted by expert id into (E, C)
slot buffers, overflows past the capacity C dropped. ``moe_apply`` picks
one by ``impl``. ``moe_apply_ep_device`` is the expert-parallel dispatch
inside tensor-parallel decode: each rank of the model group owns E/m
experts, dispatches its chunk of the tokens locally, and two tiled
all-to-alls carry the slot buffers to the experts' owners and back
(``torch.distributed``). Given a mesh (``launch.mesh.make_mesh``),
``moe_apply_ep`` is the reference's mesh-level dispatch of its loss and
prefill: tokens over the data axes, experts over ``model``, the same
dispatch body with collectives that carry gradients, and the router's
load-balance loss over every token of the mesh.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.common import ParamInfo, torch_dtype
from repro_torch.models.layers import act_fn, ffn_apply


def moe_schema(cfg, L=None) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = torch_dtype(cfg.dtype)
    pre = () if L is None else (L,)
    pfx = (None,) * len(pre)
    sc = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    # the router is f32 and replicated; experts over `model`, FSDP on d
    sch = {
        "router": ParamInfo(pre + (d, E), torch.float32, "normal:0.006", (*pfx, None, None)),
        "w_gate": ParamInfo(pre + (E, d, ff), dt, "normal:0.02", (*pfx, "model", "data", None)),
        "w_up": ParamInfo(pre + (E, d, ff), dt, "normal:0.02", (*pfx, "model", "data", None)),
        "w_down": ParamInfo(pre + (E, ff, d), dt, f"normal:{sc}", (*pfx, "model", None, "data")),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * cfg.moe_d_ff
        sch["shared"] = {
            "w_gate": ParamInfo(pre + (d, sff), dt, "normal:0.02", (*pfx, "data", "model")),
            "w_up": ParamInfo(pre + (d, sff), dt, "normal:0.02", (*pfx, "data", "model")),
            "w_down": ParamInfo(pre + (sff, d), dt, f"normal:{sc}", (*pfx, "model", "data")),
        }
    return sch


def _router(cfg, p, x2d):
    """x2d: (T, d) -> (gates (T,k) f32 normalized, idx (T,k) int64, probs).
    The top k come from a stable descending sort, so equal probabilities
    keep the lower expert id first, as ``jax.lax.top_k`` does
    (``torch.topk`` orders exact ties otherwise)."""
    logits = (x2d.float() @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _aux_loss(cfg, probs, idx, group=None):
    """Switch-style load-balance loss. With ``group`` (the data group of a
    mesh whose ranks each hold a shard of the tokens) its per-expert means
    are over every shard's tokens, as the reference's router (outside its
    ``shard_map``) takes them; its value is then the global one and its
    gradient this shard's share, so the data group's summed gradients are
    the global loss's."""
    from repro_torch.distributed import sum_over

    E = cfg.n_experts
    # one-hot by comparison: F.one_hot checks its range with a host read on
    # the CPU and builds its result by device-specific ops
    hot = (idx[..., None] == torch.arange(E, device=idx.device)).float()
    if group is None:
        me = torch.mean(probs, dim=0)  # mean router prob per expert
        ce = torch.mean(torch.sum(hot, dim=1), dim=0) / cfg.top_k
        return E * torch.sum(me * ce)
    T = probs.shape[0] * dist.get_world_size(group)
    counts = sum_over(torch.sum(hot, dim=(0, 1)), group)  # assignments an expert
    mine = E * torch.sum(torch.sum(probs, dim=0) / T * (counts / T / cfg.top_k))
    return global_value(mine, group)


def global_value(mine: torch.Tensor, group) -> torch.Tensor:
    """A loss term whose value is the sum of every rank's ``mine`` over
    ``group`` and whose gradient is this rank's own (summing the ranks'
    gradients then gives the sum's)."""
    from repro_torch.distributed import sum_over

    d = mine.detach()
    return mine + (sum_over(d, group) - d)


def _expert_ffn(cfg, p, xs):
    """xs: (E, C, d) -> (E, C, d); per-expert SwiGLU (batched products)."""
    a = act_fn(cfg.act)
    h = a(torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _shared_ffn(cfg, p, x, ms=None):
    """The shared experts: a gated FFN, on the rank's hidden units with
    ``ms`` (``layers.ffn_apply``)."""
    return ffn_apply(cfg, p, x, ms)


def moe_apply_dense(cfg, p, x):
    """Oracle: dense dispatch, no drops. x: (B,S,d). Returns (y, aux)."""
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    gates, idx, probs = _router(cfg, p, x2)
    E = cfg.n_experts
    outs = _expert_ffn(cfg, p, x2[None].expand((E,) + x2.shape))
    # combine: for each token, sum gate_j * outs[idx_j, token]
    tok = torch.arange(x2.shape[0], device=x.device)
    y = torch.zeros(x2.shape, dtype=torch.float32, device=x.device)
    for j in range(cfg.top_k):
        y = y + gates[:, j:j + 1] * outs[idx[:, j], tok].float()
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        y = y + _shared_ffn(cfg, p["shared"], x2)
    return y.reshape(B, S, d), _aux_loss(cfg, probs, idx)



_DROPS = None


@contextlib.contextmanager
def count_drops():
    """Yields ``{"assignments": n, "dropped": n}``, summed over every
    capacity-dropping dispatch this rank runs inside the block (each reads
    its keep mask back to the host)."""
    global _DROPS
    prev, _DROPS = _DROPS, {"assignments": 0, "dropped": 0}
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def _dispatch_local(cfg, x2, gates, idx, capacity):
    """Sort-based dispatch of local tokens into (E, C, d) slot buffers.

    Returns (buf (E,C,d), slot (T*k,), keep (T*k,), tok (T*k,), gate (T*k,));
    a dropped assignment's slot is the sentinel E*C."""
    T, d = x2.shape
    k, E, C = cfg.top_k, cfg.n_experts, capacity
    dev = x2.device
    flat_e = idx.reshape(-1)
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    M = se.shape[0]
    ar = torch.arange(M, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), se[1:] != se[:-1]])
    seg_start = torch.cummax(torch.where(is_start, ar, 0), dim=0).values
    pos = ar - seg_start
    keep = pos < C
    if _DROPS is not None:
        _DROPS["assignments"] += keep.numel()
        _DROPS["dropped"] += int(keep.numel() - keep.sum())
    slot = torch.where(keep, se * C + pos, E * C)
    # row E*C takes every dropped assignment and is cut off: the reference's
    # scatter drops them
    buf = torch.zeros((E * C + 1, d), dtype=x2.dtype, device=dev).index_copy(
        0, slot, x2[st] * keep[:, None].to(x2.dtype))
    return buf[:E * C].reshape(E, C, d), slot, keep, st, sg


def moe_apply_ep(cfg, p, x, mesh=None, *, data_sharded: bool = True, ms=None):
    """Capacity-dropping dispatch (the reference's ``moe_apply_ep``).
    x: (B,S,d). Returns (y, aux).

    Without a mesh, on one device: capacity C = capacity_factor * T * k / E
    slots an expert, overflows dropped (their share of the output is
    zero).

    With a mesh (``make_mesh``; data axes ``("pod", "data")``, experts
    over ``"model"`` of m ranks): ``p`` holds this rank's (E/m, ...) slice
    of w_gate/w_up/w_down (whole when m is 1), the router and the shared
    experts whole. ``x`` is this rank's data shard of the tokens when
    ``data_sharded`` (the loss: its router means then span every shard,
    ``_aux_loss``), or the whole batch alike on every rank (the prefill),
    which, as the reference does, splits over the data axes when its token
    count divides by their size and otherwise stays whole on every data
    rank. The tokens then run ``_ep_device_body`` in the model group (each
    rank a chunk of ``ceil(T / m)``, capacity ``cf * chunk * k / E``), so
    every number, drops included, is the reference's mesh dispatch's.
    ``ms`` (a ``layers.ModelSplit``; the loss over FSDP parts) runs the
    shared experts on the rank's hidden units, as the dense FFN."""
    if mesh is not None:
        return _moe_apply_ep_mesh(cfg, p, x, mesh, data_sharded, ms)
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    gates, idx, probs = _router(cfg, p, x2)
    aux = _aux_loss(cfg, probs, idx)
    y = _dispatch_whole(cfg, p, x2, gates, idx)
    if cfg.n_shared_experts:
        y = y + _shared_ffn(cfg, p["shared"], x2)
    return y.reshape(B, S, d), aux


def _moe_apply_ep_mesh(cfg, p, x, mesh, data_sharded, ms=None):
    from repro_torch.distributed import all_gather_ad, take_chunk_ad

    B, S, d = x.shape
    E, m = cfg.n_experts, mesh.model_size
    if E % m or p["w_gate"].shape[-3] != E // m:
        raise ValueError(f"moe_apply_ep: {E} experts over {m} model ranks need a rank's slice "
                         f"of {E // m}, got {p['w_gate'].shape[-3]}")
    x2 = x.reshape(-1, d)
    gates, idx, probs = _router(cfg, p, x2)
    D = mesh.data_size
    aux = _aux_loss(cfg, probs, idx, mesh.data_group if data_sharded and D > 1 else None)
    T = x2.shape[0]
    split = not data_sharded and D > 1 and T % D == 0
    xs, gs, ii = x2, gates, idx
    if split:  # this data rank's block of the tokens, gathered back after
        n = T // D
        xs, gs = (take_chunk_ad(t, mesh.data_group, 0, n) for t in (x2, gates))
        ii = idx[mesh.data_rank * n:(mesh.data_rank + 1) * n]
    if m == 1:
        y = _dispatch_whole(cfg, p, xs, gs, ii)
    else:
        y = _ep_device_body(cfg, m, mesh.model_rank, mesh.model_group, xs, gs, ii,
                            p["w_gate"], p["w_up"], p["w_down"])
    if split:
        y = all_gather_ad(y, mesh.data_group, 0)
    if cfg.n_shared_experts:
        y = y + _shared_ffn(cfg, p["shared"], x2, ms)
    return y.reshape(B, S, d), aux


def _dispatch_whole(cfg, p, x2, gates, idx):
    """The one-device capacity-dropping dispatch of ``x2`` (T, d) over every
    expert: (T, d) in ``x2``'s dtype."""
    T, d = x2.shape
    E = cfg.n_experts
    C = max(1, int(cfg.capacity_factor * T * cfg.top_k / E))
    buf, slot, keep, st, sg = _dispatch_local(cfg, x2, gates, idx, C)
    out = _expert_ffn(cfg, p, buf).reshape(E * C, d)
    out = F.pad(out, (0, 0, 0, 1))  # row E*C: the drop sentinel
    taken = out[slot] * (sg * keep)[:, None].to(out.dtype)
    y = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device).index_add(
        0, st, taken.float())
    return y.to(x2.dtype)


def _ep_device_body(cfg, m: int, mi: int, group, x_blk, gates_blk, idx_blk, wg, wu, wd):
    """One rank's expert-parallel dispatch (the reference's
    ``_ep_device_body``). ``x_blk``/``gates_blk``/``idx_blk`` are the
    tokens every rank of the model group holds alike; ``wg/wu/wd`` the
    rank's (E/m, ...) expert slice; ``mi`` its index in ``group``. The rank
    takes its chunk of ``Tl = ceil(T / m)`` tokens, dispatches them into
    (E, C) slots with capacity ``C = max(1, int(cf * Tl * k / E))`` (an
    assignment past it is dropped), ships each expert's slots to its owner,
    runs its experts on the (E/m, C*m) slots it received, ships the outputs
    back, scatter-adds the kept ones in f32 and gathers the chunks of every
    rank. Returns (T, d) in ``x_blk``'s dtype. The collectives carry
    gradients (``all_to_all_ad``, ``take_chunk_ad``, ``all_gather_ad``), so
    the loss differentiates through it: a replicated input's gradient is
    then whole and alike on every rank of the group, and each rank's
    experts get the gradient of every token routed to them."""
    from repro_torch.distributed import all_gather_ad, all_to_all_ad, take_chunk_ad

    E = cfg.n_experts
    T, d = x_blk.shape
    Tl = max(1, -(-T // m))  # ceil: decode batches can be < m
    pad = Tl * m - T
    if pad:
        x_blk = F.pad(x_blk, (0, 0, 0, pad))
        gates_blk = F.pad(gates_blk, (0, 0, 0, pad))
        idx_blk = F.pad(idx_blk, (0, 0, 0, pad))
    xs, gs = (take_chunk_ad(t, group, 0, Tl) for t in (x_blk, gates_blk))
    ii = idx_blk[mi * Tl:(mi + 1) * Tl]
    C = max(1, int(cfg.capacity_factor * Tl * cfg.top_k / E))
    buf, slot, keep, st, sg = _dispatch_local(cfg, xs, gs, ii, C)
    # (E, C, d) -> each expert's slots to its owner: (E/m, C*m, d)
    buf = all_to_all_ad(buf, group, split_axis=0, concat_axis=1)
    out = _expert_ffn(cfg, {"w_gate": wg, "w_up": wu, "w_down": wd}, buf)
    out = all_to_all_ad(out, group, split_axis=1, concat_axis=0)  # (E, C, d)
    out = F.pad(out.reshape(E * C, d), (0, 0, 0, 1))  # row E*C: the drop sentinel
    taken = out[slot] * (sg * keep)[:, None].to(out.dtype)
    y = torch.zeros((Tl, d), dtype=torch.float32, device=x_blk.device).index_add(
        0, st, taken.float()).to(x_blk.dtype)
    y = all_gather_ad(y, group, 0)
    return y[:T] if pad else y


def moe_apply_ep_device(cfg, p_local, x, m: int, mi: int, group):
    """Expert-parallel MoE inside tensor-parallel decode (the reference's
    ``moe_apply_ep_device``): ``p_local`` holds this rank's (E/m, ...)
    slice of w_gate/w_up/w_down, the router and the shared experts whole;
    ``x`` (B,S,d) is alike on every rank of the model group (``group``,
    where this rank is ``mi`` of ``m``). The shared experts run on every
    rank, as in the reference. Returns (y, aux)."""
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    gates, idx, probs = _router(cfg, p_local, x2)
    aux = _aux_loss(cfg, probs, idx)
    y = _ep_device_body(cfg, m, mi, group, x2, gates, idx,
                        p_local["w_gate"], p_local["w_up"], p_local["w_down"])
    if cfg.n_shared_experts:
        y = y + _shared_ffn(cfg, p_local["shared"], x2)
    return y.reshape(B, S, d), aux


def moe_apply(cfg, p, x, impl: str = "ep", mesh=None, *, data_sharded: bool = True, ms=None):
    """``impl``: 'dense' (every expert on every token) | 'ep' (the
    capacity-dropping dispatch; with a mesh, expert-parallel over its
    ``model`` axis: ``moe_apply_ep``, whose shared experts take ``ms``).
    Returns (y, aux)."""
    if impl == "dense":
        if mesh is not None:
            raise ValueError("moe_impl='dense' on a mesh: the mesh's ranks hold a slice of the "
                             "experts; the mesh path is 'ep'")
        return moe_apply_dense(cfg, p, x)
    if impl == "ep":
        return moe_apply_ep(cfg, p, x, mesh, data_sharded=data_sharded, ms=ms)
    raise ValueError(f"moe_impl={impl!r}: the port takes 'dense' | 'ep'")
