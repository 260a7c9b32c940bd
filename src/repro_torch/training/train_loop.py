"""Training loop (the port's counterpart of the JAX package's
``training/train_loop.py``): remat, grad accumulation, checkpoint/restart.

The train state is a plain tree, ``{"params", "opt": {"step", "mu", "nu"},
"step"}``, the reference's, so checkpoints interchange. A step is one
eager forward and backward through the model's ``loss`` (which reaches no
kernel) and one AdamW update, in place.

Given a mesh (``launch.mesh.make_mesh``) the step is data-parallel over
the combined data axes ``("pod", "data")`` and expert-parallel over
``model``, as the reference's step on a mesh computes it: every rank
takes the global batch and keeps its rows of each microbatch, the loss
(``loss(mesh=)``) is the global batch's, and AdamW updates each rank's own
leaves in place. Its layout is a partition spec a leaf of the params,
the gradients and AdamW's moments, sanitized on the mesh
(``layout_specs``), by the axes (``MeshAxes``; by default
``mesh_axes(mesh, fsdp=True)``, as the reference's train cells take it):
with ``fsdp=True`` the reference's FSDP specs, each leaf split over
``data`` and ``model``; with ``fsdp=False`` the experts split over
``model`` (``ep_param_specs``) and every other leaf whole. Either way the
loss gathers each split leaf where it uses it (``loss(fsdp=)``), whose
backward reduce-scatters its gradient over the data group, so only the
leaves unsplit over data are all-reduced (one bucketed
``all_reduce_flat``); the clipping norm sums each part's squares over the
ranks that hold different parts and counts a whole leaf once
(``_reduce_over_mesh``). The ``model`` axis splits the compute as well as
the storage, as the reference's GSPMD splits it (``transformer.fsdp_use``):
a leaf split over ``model`` is gathered over the data axes only, and each
rank of a model group computes its heads, hidden units and vocabulary
columns (column- then row-parallel products, a vocabulary-parallel
lookup and cross-entropy); the experts stay expert-parallel. A leaf whole
over ``model`` (the norms, the router, MLA's ``w_dkv``) gets the whole
gradient on every rank of the group, summed over it inside the loss.

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

from repro_torch.models.common import (
    axis_specs,
    entry_axes,
    init_parts,
    sanitize_specs,
    spec_parts,
    tree_leaves,
    tree_map,
    tree_map2,
)
from repro_torch.training.optim import (
    AdamWConfig,
    _sq_sum,
    adamw_init,
    adamw_update,
    cosine_schedule,
)


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


def expert_leaves(model, params) -> list:
    """One bool a leaf of ``params`` (``tree_leaves`` order): True where a
    mesh's model axis splits the leaf (``ep_param_specs``)."""
    if not hasattr(model, "ep_param_specs"):
        return [False] * len(tree_leaves(params))
    return [ax is not None for ax in tree_leaves(model.ep_param_specs())]


def layout_specs(model, mesh, axes):
    """Each param leaf's spec in a mesh step's layout for ``axes``,
    sanitized on ``mesh``: with ``axes.fsdp`` the reference's FSDP specs
    (``model.pspecs``), else the experts split over ``model``
    (``ep_param_specs``) and every other leaf whole."""
    sch = model.schema()
    if axes.fsdp:
        specs = model.pspecs(axes)
    elif hasattr(model, "ep_param_specs"):
        specs = axis_specs(sch, model.ep_param_specs())
    else:
        specs = tree_map(lambda _: (), sch)
    return sanitize_specs(specs, sch, mesh)


def _spec_list(model, specs) -> list:
    """``specs`` as a list in ``tree_leaves`` order of the params."""
    out: list = []
    tree_map2(lambda _, sp: out.append(sp), model.schema(), specs)
    return out


def _split_over(spec, mesh):
    """(split over the data axes, split over ``model``) of a sanitized spec
    on ``mesh``."""
    axes = [a for d, _, _ in spec_parts(spec, mesh) for a in entry_axes(spec[d])]
    return any(a != "model" for a in axes), "model" in axes


def _axes_of(mesh, axes):
    """``axes``, or a mesh step's default: ``mesh_axes(mesh, fsdp=True)``."""
    if axes is not None:
        return axes
    from repro_torch.launch.mesh import mesh_axes

    return mesh_axes(mesh, fsdp=True)


def state_sharding(model, mesh, axes=None):
    """The ``CheckpointManager`` sharding tree of a mesh step's state, in
    ``make_train_step``'s layout for ``axes`` (the same default): each leaf
    of the params and of AdamW's moments that its spec splits is a
    ``Shard`` over each dim it splits (the rank's part; ``replica`` its
    place among the ranks that hold the same part), every other leaf None
    (whole)."""
    from repro_torch.checkpoint.manager import Shard

    def shard(_, sp):
        cuts = spec_parts(sp, mesh)
        if not cuts:
            return None
        named = {a for d, _, _ in cuts for a in entry_axes(sp[d])}
        rep = 0
        for a in mesh.axis_names:
            if a not in named:
                rep = rep * mesh.shape[a] + mesh.coords[a]
        return Shard(*(tuple(c[k] for c in cuts) for k in range(3)), replica=rep)

    specs = tree_map2(shard, model.schema(), layout_specs(model, mesh, _axes_of(mesh, axes)))
    return {"params": specs, "opt": {"step": None, "mu": specs, "nu": specs}, "step": None}


def shard_state(state, model, mesh, axes=None):
    """The rank's parts of a whole state (``state_sharding``): copies, so
    the whole state can be freed."""
    return tree_map2(lambda x, sh: x if sh is None else x[sh.index_of(x.shape)].clone(),
                     state, state_sharding(model, mesh, axes))


def _rows(batch, i: int, n: int, mesh):
    """Microbatch ``i`` of ``n`` of the global batch, and on a mesh this data
    rank's contiguous share of it."""
    rows = next(iter(batch.values())).shape[0] // n
    lo = i * rows
    if mesh is not None:
        D = mesh.data_size
        if rows % D:
            raise ValueError(f"a microbatch of {rows} rows does not split over {D} data ranks")
        rows //= D
        lo += mesh.data_rank * rows
    return {k: v[lo:lo + rows] for k, v in batch.items()}


def make_train_step(model, tcfg: TrainConfig, opt_cfg: Optional[AdamWConfig] = None, *,
                    mesh=None, axes=None, mark: Optional[Callable[[str], None]] = None):
    """Returns (step_fn(state, batch) -> (state, metrics), opt_cfg). The
    batch's arrays may be numpy or tensors; they go to the params' device.
    The state is updated in place. With ``mesh`` (module docstring) the
    batch is the global one on every rank and the state is the rank's
    (``init_state(mesh=)``, ``shard_state``): its part of every leaf by
    ``layout_specs``. ``mark``, where given, is called with
    ``"forward"``, ``"backward"``, ``"reduce"`` and ``"update"`` as each
    part of a step ends (a timer's hook)."""
    opt_cfg = opt_cfg or AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay)
    sched = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps)
    mkw = {} if mesh is None else {"mesh": mesh}
    if mesh is not None:
        specs = layout_specs(model, mesh, _axes_of(mesh, axes))
        spec_list = _spec_list(model, specs)
        if any(spec_parts(sp, mesh) for sp in spec_list):
            mkw["fsdp"] = specs

    def loss_fn(params, batch):
        if model.cfg.family == "lm":
            return model.loss(params, batch, moe_impl=tcfg.moe_impl, remat=tcfg.remat,
                              train_mode=tcfg.train_mode, **mkw)
        return model.loss(params, batch, **mkw)

    def tick(name):
        if mark is not None:
            mark(name)

    def grads_of(params, leaves, batch):
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, batch)
            tick("forward")
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            tick("backward")
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
                l, _, gs = grads_of(params, leaves, _rows(batch, i, n, mesh))
                for a, g in zip(acc, gs):
                    if g is not None:
                        a += g
                loss = loss + l
            gs = [a / n for a in acc]
            loss = loss / n
            metrics = {}
        else:
            loss, metrics, gs = grads_of(params, leaves, _rows(batch, 0, 1, mesh))
        gn = None
        if mesh is not None:
            split = [_split_over(sp, mesh) for sp, w in zip(spec_list, wrt) if w]
            gs, gn = _reduce_over_mesh(mesh, leaves, gs, split)
            tick("reduce")
        it = iter(gs)
        grads = [next(it) if w else None for w in wrt]
        grads = _unflatten_like(params, grads)
        mask = ramp_mask(params) if tcfg.train_mode == "ramps_only" else None
        newp, newopt, gn = adamw_update(params, grads, opt, opt_cfg, lr_scale=sched(step),
                                        mask=mask, grad_norm=gn)
        tick("update")
        out = {"loss": loss, "grad_norm": gn, **metrics}
        return {"params": newp, "opt": newopt, "step": step + 1}, out

    return step_fn, opt_cfg


def _reduce_over_mesh(mesh, leaves, gs, split):
    """A mesh step's gradients summed over the data group, and the global
    norm, each element counted once. ``split`` is each differentiated
    leaf's (split over data, split over model): a leaf split over data has
    its sum already (its gather's reduce-scatter) and the others are
    summed in place in one bucketed all-reduce (a leaf never reached
    counts as zeros); a part's squares are summed over the ranks that hold
    other parts of its leaf (the whole mesh, the data group or the model
    group), each model-split part's once over the model group, and a leaf
    whole over ``model`` counted once: its gradient is alike over the model
    group, whose partial gradients the loss has summed (``fsdp_use``).
    Returns (gradients, norm)."""
    from repro_torch.distributed import all_reduce_flat, sum_over

    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
    if mesh.data_size > 1:
        all_reduce_flat([g for g, (d, _) in zip(gs, split) if not d], mesh.data_group)
    dev = gs[0].device
    sq = {k: torch.zeros((), dtype=torch.float32, device=dev)
          for k in ((False, False), (True, False), (False, True), (True, True))}
    for g, k in zip(gs, split):
        sq[k] = sq[k] + _sq_sum(g)
    model = mesh.model_group if mesh.model_size > 1 else None
    data = mesh.data_group if mesh.data_size > 1 else None

    def over(x, group):
        return x if group is None else sum_over(x, group)

    both = over(sq[True, False] + over(sq[True, True], model), data)
    return gs, torch.sqrt(sq[False, False] + both + over(sq[False, True], model))


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def init_state(model, seed, opt_cfg: AdamWConfig, device="cuda", *, mesh=None, axes=None):
    """Params drawn from ``seed`` (``model.init``), zero moments, step 0.
    With ``mesh`` the rank's state of ``make_train_step(mesh=, axes=)``,
    drawn without the whole tree: its part of every leaf by
    ``layout_specs`` (``init_parts``), each part the same slice of
    ``model.init(seed)``."""
    if mesh is None:
        params = model.init(seed, device=device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = init_parts(model.schema(), layout_specs(model, mesh, _axes_of(mesh, axes)), gen,
                            device, mesh)
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
