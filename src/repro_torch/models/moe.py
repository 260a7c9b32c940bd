"""Top-k mixture of experts (the port's counterpart of the JAX package's
``models/moe.py``), dense dispatch only.

``moe_apply_dense`` is the reference's oracle: every expert processes every
token, and each token sums its top-k experts' outputs weighted by their
normalised f32 gates, in top-k order. Every MoE layer of the port runs this
way, as the reference's serving runner asks for (``moe_impl='dense'``).
The reference's capacity-dropping dispatch (``moe_apply_ep``: its
single-device path, which its ``LM.prefill``/``decode`` default to and
training uses, and the expert-parallel all-to-all path) is not ported:
see ROADMAP.md, Queue 1.
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

