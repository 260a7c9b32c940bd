"""Training loop (the port's counterpart of the JAX package's
``training/train_loop.py``): remat, grad accumulation, checkpoint/restart.

The train state is a plain tree, ``{"params", "opt": {"step", "mu", "nu"},
"step"}``, the reference's, so checkpoints interchange. A step is one
eager forward and backward through the model's ``loss`` (which reaches no
kernel) and one AdamW update, in place.

In ``ramps_only`` mode the step differentiates only the leaves whose
gradient the LM loss can make non-zero: the ramps, and with 'tied' ramps
the final head. Every other leaf's gradient in the reference is exactly
zero (stop-grad ramp features, ``0.0 * lm``) and the mask freezes it, so
the grad norm, the update and the frozen leaves are the reference's; the
backbone's backward (and its gradients' memory) is skipped. The
classifiers' losses have no stop-grad, so they differentiate every leaf.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    lr: float = 3e-4
    warmup: int = 20
    weight_decay: float = 0.01
    grad_accum: int = 1
    remat: bool = False
    moe_impl: str = "dense"
    train_mode: str = "full"  # 'full' | 'ramps_only'
    log_every: int = 20
    checkpoint_every: int = 0  # 0 = off
    seed: int = 0


def _walk(tree, under_ramp, path, fn):
    if isinstance(tree, dict):
        return {k: _walk(tree[k], under_ramp or k == "ramps", path + (k,), fn)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, under_ramp, path, fn) for v in tree]
    return fn(path, under_ramp)


def ramp_mask(params):
    """True only for ramp parameters (frozen-backbone ramp training): one
    bool a leaf, where the reference holds a bool array of the leaf's shape
    (at full width that would be 4.4 GB of bools)."""
    return _walk(params, False, (), lambda path, ramp: ramp)


def _differentiated(model, params, train_mode):
    """Bool tree: the leaves a step differentiates (module docstring)."""
    cfg = model.cfg
    if train_mode != "ramps_only" or cfg.family != "lm":
        return tree_map(lambda _: True, params)
    head = ("tok", "embed") if cfg.tie_embeddings else ("tok", "lm_head")

    def keep(path, ramp):
        return ramp or (cfg.ramp_style == "tied" and path == head)

    return _walk(params, False, (), keep)


def _to_device(batch, device):
    return {k: torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v), device=device)
            for k, v in batch.items()}


def make_train_step(model, tcfg: TrainConfig, opt_cfg: Optional[AdamWConfig] = None):
    """Returns (step_fn(state, batch) -> (state, metrics), opt_cfg). The
    batch's arrays may be numpy or tensors; they go to the params' device.
    The state is updated in place."""
    opt_cfg = opt_cfg or AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay)
    sched = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps)

    def loss_fn(params, batch):
        if model.cfg.family == "lm":
            return model.loss(params, batch, moe_impl=tcfg.moe_impl, remat=tcfg.remat,
                              train_mode=tcfg.train_mode)
        return model.loss(params, batch)

    def grads_of(params, leaves, batch):
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, batch)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs

    def step_fn(state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        dev = step.device
        batch = _to_device(batch, dev)
        wrt = tree_leaves(_differentiated(model, params, tcfg.train_mode))
        ps = tree_leaves(params)
        leaves = [p for p, w in zip(ps, wrt) if w]
        if tcfg.grad_accum > 1:
            n = tcfg.grad_accum
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n):
                mb = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                      for k, v in batch.items()}
                l, _, gs = grads_of(params, leaves, mb)
                for a, g in zip(acc, gs):
                    if g is not None:
                        a += g
                loss = loss + l
            gs = [a / n for a in acc]
            loss = loss / n
            metrics = {}
        else:
            loss, metrics, gs = grads_of(params, leaves, batch)
        it = iter(gs)
        grads = [next(it) if w else None for w in wrt]
        grads = _unflatten_like(params, grads)
        mask = ramp_mask(params) if tcfg.train_mode == "ramps_only" else None
        newp, newopt, gn = adamw_update(params, grads, opt, opt_cfg, lr_scale=sched(step),
                                        mask=mask)
        out = {"loss": loss, "grad_norm": gn, **metrics}
        return {"params": newp, "opt": newopt, "step": step + 1}, out

    return step_fn, opt_cfg


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def init_state(model, seed, opt_cfg: AdamWConfig, device="cuda"):
    """Params drawn from ``seed`` (``model.init``), zero moments, step 0."""
    params = model.init(seed, device=device)
    return {"params": params, "opt": adamw_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def train(
    model,
    batches: Callable[[int], Dict[str, np.ndarray]],
    tcfg: TrainConfig,
    *,
    state=None,
    checkpoint_mgr=None,
    start_step: int = 0,
    verbose: bool = True,
    device="cuda",
):
    """The simple loop used by examples/tests (``launch/train.py`` is the
    launcher): steps ``start_step`` .. ``tcfg.steps - 1`` on
    ``batches(step)``; logs (floats) every ``log_every`` steps and at the
    last; a checkpoint every ``checkpoint_every`` steps, written on the
    manager's worker thread (``save_async``: the same files as the
    reference's synchronous ``save``), waited for at the end. Returns
    (state, logs)."""
    step_fn, opt_cfg = make_train_step(model, tcfg)
    if state is None:
        state = init_state(model, tcfg.seed, opt_cfg, device=device)
    logs = []
    t0 = time.perf_counter()
    for s in range(start_step, tcfg.steps):
        state, out = step_fn(state, batches(s))
        if s % tcfg.log_every == 0 or s == tcfg.steps - 1:
            logs.append({k: float(v) for k, v in out.items()})
            if verbose:
                print(f"  step {s:5d} loss {logs[-1]['loss']:.4f} "
                      f"gnorm {logs[-1]['grad_norm']:.3f}")
        if checkpoint_mgr and tcfg.checkpoint_every and (s + 1) % tcfg.checkpoint_every == 0:
            checkpoint_mgr.save_async(state, step=s + 1)
    if checkpoint_mgr is not None:
        checkpoint_mgr.wait()
    if verbose:
        dt = time.perf_counter() - t0
        print(f"  trained {tcfg.steps - start_step} steps in {dt:.1f}s")
    return state, logs
