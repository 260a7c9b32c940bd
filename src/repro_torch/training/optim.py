"""Hand-built optimizers (the port's counterpart of the JAX package's
``training/optim.py``): AdamW and Adafactor-lite, global-norm clipping,
the cosine schedule, and parameter masking (frozen-backbone ramp
training).

Plain functions over the port's dict/list trees. The state trees have the
reference's shape (``{"step", "mu", "nu"}``, ``{"step", "v"}``), so
checkpoints interchange; moments and the update math are f32, as in the
reference. Two choices of the port, neither of which changes a number:
- the updates write params and moments IN PLACE and return the same trees
  (at full width the f32 moments of qwen2-1.5b's twelve ramp heads are
  22.6 GB, and no second copy fits beside them); large leaves are walked
  in slices, so an f32 temporary never spans a whole leaf;
- a mask leaf may be a Python bool (the whole leaf trainable or frozen) as
  well as a bool tensor, and a gradient leaf may be None (the step never
  differentiated it: a zero gradient). A frozen leaf is not touched at
  all, which is what the reference's ``where(m, new, old)`` leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.common import tree_leaves, tree_map

SLICE = 1 << 24  # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32


def _step0(device):
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw_init(params, cfg: AdamWConfig):
    def z(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"step": _step0(dev), "mu": tree_map(z, params), "nu": tree_map(z, params)}


def _slices(*ts):
    """Flat views of equal-sized tensors, SLICE elements at a time."""
    flat = [t.reshape(-1) for t in ts]
    n = flat[0].numel()
    for lo in range(0, n, SLICE):
        yield [f[lo:lo + SLICE] for f in flat]


def _sq_sum(g):
    out = torch.zeros((), dtype=torch.float32, device=g.device)
    for (s,) in _slices(g):
        out = out + torch.sum(torch.square(s.float()))
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32; None leaves count
    as zeros."""
    leaves = [g for g in tree_leaves(tree) if g is not None]
    total = _sq_sum(leaves[0])
    for g in leaves[1:]:
        total = total + _sq_sum(g)
    return torch.sqrt(total)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0, mask=None):
    """mask: tree of bools or bool tensors (True = trainable); frozen params
    keep their value and their ``mu``/``nu``. Returns (params, state, grad
    norm); params and moments are updated in place."""
    step = state["step"] + 1
    dev = step.device
    gn = global_norm(grads)
    one = _f32(1.0, dev)
    scale = torch.minimum(one, cfg.clip_norm / (gn + 1e-9)) if cfg.clip_norm else one
    sf = step.float()
    bc1 = 1 - _f32(cfg.b1, dev) ** sf
    bc2 = 1 - _f32(cfg.b2, dev) ** sf
    lr = cfg.lr * _f32(lr_scale, dev)
    ps, gs, mus, nus = (tree_leaves(t) for t in (params, grads, state["mu"], state["nu"]))
    ms = tree_leaves(mask) if mask is not None else [True] * len(ps)

    for p, g, mu, nu, m in zip(ps, gs, mus, nus, ms):
        if m is False:
            continue
        gz = torch.zeros_like(p) if g is None else g
        mt = m if torch.is_tensor(m) else None
        parts = _slices(p, gz, mu, nu) if mt is None else _slices(p, gz, mu, nu, mt)
        for part in parts:
            pp, gg, mm, vv = part[:4]
            g32 = gg.float() * scale
            mu2 = cfg.b1 * mm + (1 - cfg.b1) * g32
            nu2 = cfg.b2 * vv + (1 - cfg.b2) * g32 * g32
            mhat = mu2 / bc1
            nhat = nu2 / bc2
            p32 = pp.float()
            delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p32
            newp = p32 - lr * delta
            if mt is not None:
                keep = part[4]
                newp = torch.where(keep, newp, p32)
                mu2 = torch.where(keep, mu2, mm)
                nu2 = torch.where(keep, nu2, vv)
            pp.copy_(newp)
            mm.copy_(mu2)
            vv.copy_(nu2)
    return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}, gn


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Returns f(step) -> the lr SCALE in [0, 1] (f32; step an int or a
    device tensor)."""
    def f(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return base_lr * warm * 0.5 * (1 + torch.cos(math.pi * prog)) / base_lr

    return f


# --- Adafactor-lite: factored second moments for huge embeddings -----------


def adafactor_init(params):
    def z(p):
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    dev = tree_leaves(params)[0].device
    return {"step": _step0(dev), "v": tree_map(z, params)}


def _is_factor_leaf(x):
    return isinstance(x, dict) and ("vr" in x or "v" in x)


def _factor_leaves(tree):
    if _is_factor_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _factor_leaves(tree[k])]
    return [x for v in tree for x in _factor_leaves(v)]


@torch.no_grad()
def adafactor_update(params, grads, state, lr=1e-2, decay=0.8, eps=1e-30, clip=1.0):
    """Returns (params, state); params and second moments are updated in
    place."""
    step = state["step"] + 1
    beta = 1.0 - (step.float() + 1) ** (-decay)
    for p, g, v in zip(tree_leaves(params), tree_leaves(grads), _factor_leaves(state["v"])):
        g = g.float()
        g2 = g * g + eps
        if p.dim() >= 2:
            vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, -1, keepdim=True), min=eps)
            u = g / torch.sqrt(vr[..., None] * vc[..., None, :] / denom[..., None] + eps)
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            nv = beta * v["v"] + (1 - beta) * g2
            u = g / torch.sqrt(nv + eps)
            v["v"].copy_(nv)
        rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp(rms / clip, min=1.0)
        p.copy_(p.float() - lr * u)
    return params, {"step": step, "v": state["v"]}
