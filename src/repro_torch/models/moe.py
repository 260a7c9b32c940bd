"""Top-k mixture of experts (the port's counterpart of the JAX package's
``models/moe.py``) on one device.

``moe_apply_dense`` is the reference's oracle: every expert processes every
token, and each token sums its top-k experts' outputs weighted by their
normalised f32 gates, in top-k order. Every serving path of the port runs
it, as the reference's serving runner asks for (``moe_impl='dense'``).
``moe_apply_ep`` is the reference's capacity-dropping dispatch on one
device (``moe_apply_ep`` with ``mesh=None``), which the reference's
``LM.loss`` defaults to: assignments sorted by expert id into (E, C)
slot buffers, overflows past the capacity C dropped. ``moe_apply`` picks
one by ``impl``. The expert-parallel all-to-all path is multi-device and
not ported (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamInfo, torch_dtype
from repro_torch.models.layers import act_fn


def moe_schema(cfg, L=None) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = torch_dtype(cfg.dtype)
    pre = () if L is None else (L,)
    sc = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    sch = {
        "router": ParamInfo(pre + (d, E), torch.float32, "normal:0.006"),
        "w_gate": ParamInfo(pre + (E, d, ff), dt, "normal:0.02"),
        "w_up": ParamInfo(pre + (E, d, ff), dt, "normal:0.02"),
        "w_down": ParamInfo(pre + (E, ff, d), dt, f"normal:{sc}"),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * cfg.moe_d_ff
        sch["shared"] = {
            "w_gate": ParamInfo(pre + (d, sff), dt, "normal:0.02"),
            "w_up": ParamInfo(pre + (d, sff), dt, "normal:0.02"),
            "w_down": ParamInfo(pre + (sff, d), dt, f"normal:{sc}"),
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


def _aux_loss(cfg, probs, idx):
    """Switch-style load-balance loss."""
    E = cfg.n_experts
    me = torch.mean(probs, dim=0)  # mean router prob per expert
    ce = torch.mean(torch.sum(F.one_hot(idx, E).float(), dim=1), dim=0) / cfg.top_k
    return E * torch.sum(me * ce)


def _expert_ffn(cfg, p, xs):
    """xs: (E, C, d) -> (E, C, d); per-expert SwiGLU (batched products)."""
    a = act_fn(cfg.act)
    h = a(torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _shared_ffn(cfg, p, x):
    a = act_fn(cfg.act)
    h = a(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


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
    slot = torch.where(keep, se * C + pos, E * C)
    # row E*C takes every dropped assignment and is cut off: the reference's
    # scatter drops them
    buf = torch.zeros((E * C + 1, d), dtype=x2.dtype, device=dev).index_copy(
        0, slot, x2[st] * keep[:, None].to(x2.dtype))
    return buf[:E * C].reshape(E, C, d), slot, keep, st, sg


def moe_apply_ep(cfg, p, x):
    """Capacity-dropping dispatch on one device (the reference's
    ``moe_apply_ep`` single-device path): capacity C = capacity_factor * T
    * k / E slots an expert, overflows dropped (their share of the output
    is zero). x: (B,S,d). Returns (y, aux)."""
    B, S, d = x.shape
    E = cfg.n_experts
    x2 = x.reshape(-1, d)
    gates, idx, probs = _router(cfg, p, x2)
    aux = _aux_loss(cfg, probs, idx)
    T = x2.shape[0]
    C = max(1, int(cfg.capacity_factor * T * cfg.top_k / E))
    buf, slot, keep, st, sg = _dispatch_local(cfg, x2, gates, idx, C)
    out = _expert_ffn(cfg, p, buf).reshape(E * C, d)
    out = F.pad(out, (0, 0, 0, 1))  # row E*C: the drop sentinel
    taken = out[slot] * (sg * keep)[:, None].to(out.dtype)
    y = torch.zeros(x2.shape, dtype=torch.float32, device=x.device).index_add(
        0, st, taken.float())
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        y = y + _shared_ffn(cfg, p["shared"], x2)
    return y.reshape(B, S, d), aux


def moe_apply(cfg, p, x, impl: str = "ep"):
    """``impl``: 'dense' (every expert on every token) | 'ep' (the
    capacity-dropping dispatch). Returns (y, aux)."""
    if impl == "dense":
        return moe_apply_dense(cfg, p, x)
    if impl == "ep":
        return moe_apply_ep(cfg, p, x)
    raise ValueError(f"moe_impl={impl!r}: the port takes 'dense' | 'ep'")
