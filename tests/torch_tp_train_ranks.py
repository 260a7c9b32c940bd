"""Rank bodies of ``test_torch_tp_train.py``: what each spawned gloo rank
runs on the CPU. Kept apart from the test module so a rank imports torch
and the port only, never JAX: the parent passes numpy in and reads numpy
and Python values back, one dict a rank."""
import types

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402  # repro: allow[tier1-deps] — torch, skipped above without it

from repro_torch.configs import get_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.distributed import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    SumModel,
    count_collectives,
    from_model_region,
    to_model_region,
)
from repro_torch.launch.mesh import make_test_mesh, mesh_axes  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import transformer as T  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import take_part, tree_leaves, tree_map2  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.layers import ModelSplit, embed_apply  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.training.optim import AdamWConfig, adamw_init  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.training.train_loop import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    TrainConfig,
    _reduce_over_mesh,
    _split_over,
    layout_specs,
    make_train_step,
    shard_state,
)

# the compared steps: two AdamW steps, clipping active, remat on
LR, CLIP, STEPS = 1e-2, 0.05, 2
# the unit cases: a vocabulary of V over Vp padded columns (the last rank
# holds the padding at 2 and 4 ranks), labels in every rank's range
V, VP, D = 27, 32, 6
LABELS = [[0, 9, 17, 26, -1, 5], [-1, 12, 25, 3, 20, -1]]


def model_of(case):
    return build_model(get_tiny(case["arch"]).replace(**case["over"]))


def tcfg(remat=True):
    return TrainConfig(steps=STEPS, lr=LR, warmup=1, moe_impl="ep", remat=remat)


def opt_cfg():
    return AdamWConfig(lr=LR, weight_decay=tcfg().weight_decay, clip_norm=CLIP)


def _whole_state(case):
    params = from_numpy_params(case["params"], "cpu")
    return {"params": params, "opt": adamw_init(params, opt_cfg()),
            "step": torch.zeros((), dtype=torch.int32)}


def _rows(batch, mesh):
    """The rank's data shard of a global batch's rows, as tensors."""
    n = batch["tokens"].shape[0] // mesh.data_size
    lo = mesh.data_rank * n
    return {k: torch.as_tensor(v[lo:lo + n]) for k, v in batch.items()}


def _counts(cc):
    return {"kinds": {k: list(v) for k, v in cc.items()},
            "by_kind_group": {k: list(v) for k, v in cc.by_kind_group.items()}}


def _train(mesh, case):
    """Two FSDP steps (the model split) from the whole bridged params:
    per-step loss, grad norm and collectives, and the rank's part of every
    param leaf after the last step."""
    model = model_of(case)
    state = shard_state(_whole_state(case), model, mesh)
    step_fn, _ = make_train_step(model, tcfg(), opt_cfg(), mesh=mesh)
    logs, counts = [], []
    for b in case["batches"]:
        with count_collectives() as cc:
            state, out = step_fn(state, b)
        logs.append({k: float(v) for k, v in out.items()})
        counts.append(_counts(cc))
    return {"logs": logs, "counts": counts,
            "params": [x.numpy() for x in tree_leaves(state["params"])]}


def _loss_grads(mesh, case):
    """``loss(mesh=, fsdp=)`` on the rank's rows and parts, and the rank's
    part of every gradient summed over the data group, with the global
    norm (``_reduce_over_mesh``, as the step takes them)."""
    model = model_of(case)
    specs = layout_specs(model, mesh, mesh_axes(mesh))
    params = tree_map2(lambda x, sp: take_part(x, sp, mesh).clone(),
                       from_numpy_params(case["params"], "cpu"), specs)
    leaves = tree_leaves(params)
    spec_list = []
    tree_map2(lambda _, sp: spec_list.append(sp), model.schema(), specs)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = model.loss(params, _rows(case["batch"], mesh), mesh=mesh, fsdp=specs)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    for x in leaves:
        x.requires_grad_(False)
    gs, gn = _reduce_over_mesh(mesh, leaves, gs, [_split_over(sp, mesh) for sp in spec_list])
    return {"loss": float(loss.detach()), "grad_norm": float(gn),
            "grads": [g.numpy() for g in gs]}


def _units(mesh):
    """On the model group: the conjugate pair's forward and backward, the
    vocabulary-parallel ``_nll_sum`` (value and the rank's columns'
    gradient) and lookup, on inputs drawn per rank or alike."""
    g, m, i = mesh.model_group, mesh.model_size, mesh.model_rank
    ms = ModelSplit(m, i, g)
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(10 + i))
    up = torch.randn(3, 5, generator=torch.Generator().manual_seed(20 + i))
    out = {"x": x.numpy(), "up": up.numpy()}
    for name, fn in (("to", to_model_region), ("from", from_model_region)):
        a = x.clone().requires_grad_(True)
        y = fn(a, g)
        (y * up).sum().backward()
        out[f"{name}_y"], out[f"{name}_grad"] = y.detach().numpy(), a.grad.numpy()
    logits = torch.randn(2, 6, VP, generator=torch.Generator().manual_seed(5))
    logits[..., V:] += 8.0  # the padding would hold the max were it not masked
    n = VP // m
    loc = logits[..., i * n:(i + 1) * n].clone().requires_grad_(True)
    tot, cnt = T._nll_sum(types.SimpleNamespace(vocab_size=V), loc, torch.tensor(LABELS), ms)
    tot.backward()
    out.update(nll=float(tot.detach()), count=int(cnt), nll_grad=loc.grad.numpy())
    embed = torch.randn(VP, D, generator=torch.Generator().manual_seed(6))
    toks = torch.tensor([[0, 31, 8, 15], [16, 24, 7, 30]])
    h = embed_apply(types.SimpleNamespace(pos_type="rope"),
                    {"embed": embed[i * n:(i + 1) * n]}, toks, ms=ms)
    out["lookup"], out["lookup_want"] = h.numpy(), embed[toks].numpy()
    return out


def _flops(mesh, case):
    """Product FLOPs (``FlopCounterMode``) of one FSDP step on the rank's
    rows, and on rank 0 of the single rank's step on the same rows."""
    model = model_of(case)
    b = case["batches"][0]
    out = {}
    for name, m in (("rank", mesh), ("single", None)):
        if name == "single" and mesh.rank:
            break
        whole = _whole_state(case)
        state = whole if m is None else shard_state(whole, model, m)
        step_fn, _ = make_train_step(model, tcfg(), opt_cfg(), mesh=m)
        with FlopCounterMode(display=False) as fc:
            step_fn(state, b)  # data 1: the rank's rows are the batch
        out[name] = fc.get_total_flops()
    return out


def _model_sums(mesh, case):
    """One FSDP step without remat: its collectives (the model group's
    activation sums, counted once each)."""
    model = model_of(case)
    state = shard_state(_whole_state(case), model, mesh)
    step_fn, _ = make_train_step(model, tcfg(remat=False), opt_cfg(), mesh=mesh)
    with count_collectives() as cc:
        step_fn(state, case["batches"][0])
    return _counts(cc)


def _qnorm_grads(mesh, case):
    """qk-norm's gradients (a whole leaf acting on the rank's heads) of the
    split loss at data 1, with their model sum and, planted, without it
    (the use specs' ``SumModel`` on ``qnorm``/``knorm`` dropped); and the
    single rank's on the same rows."""
    model = model_of(case)
    specs = layout_specs(model, mesh, mesh_axes(mesh))
    whole = from_numpy_params(case["params"], "cpu")
    batch = {k: torch.as_tensor(v) for k, v in case["batches"][0].items()}
    paths = [("blocks", s, "mixer", k) for s in range(len(model.plan.period))
             for k in ("qnorm", "knorm")]

    def grads(params, **kw):
        leaves = [_get(params, p) for p in paths]
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = model.loss(params, batch, **kw)
        gs = torch.autograd.grad(loss, leaves)
        for x in leaves:
            x.requires_grad_(False)
        return [g.numpy() for g in gs]

    parts = tree_map2(lambda x, sp: take_part(x, sp, mesh).clone(), whole, specs)
    out = {"single": grads(whole), "split": grads(parts, mesh=mesh, fsdp=specs)}
    sound = T.fsdp_use

    def no_sum(cfg, sp, m):
        return _unmark(sound(cfg, sp, m))

    T.fsdp_use = no_sum
    try:
        out["planted"] = grads(parts, mesh=mesh, fsdp=specs)
    finally:
        T.fsdp_use = sound
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _unmark(tree):
    """A use-spec tree with every ``SumModel`` leaf a plain spec."""
    if isinstance(tree, dict):
        return {k: _unmark(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unmark(v) for v in tree]
    return tuple(tree) if isinstance(tree, SumModel) else tree


def job_four(rank, world, cases):
    """(data 2, model 2): each train case's two steps and the enc-dec's
    loss and gradients; then (data 1, model 4): the units on four ranks
    and the ``(1, 4)`` train cases."""
    torch.set_num_threads(1)
    out = {}
    mesh = make_test_mesh(2, 2, device="cpu")
    out["coords22"] = (mesh.data_rank, mesh.model_rank)
    for name, case in cases["train22"].items():
        out[name] = _train(mesh, case)
    for name, case in cases["grads22"].items():
        out[name] = _loss_grads(mesh, case)
    mesh = make_test_mesh(1, 4, device="cpu")
    out["coords14"] = (mesh.data_rank, mesh.model_rank)
    out["units"] = _units(mesh)
    for name, case in cases["train14"].items():
        out[name] = _train(mesh, case)
    return out


def job_two(rank, world, cases):
    """(data 1, model 2): the units on two ranks, a step's product FLOPs
    against the single rank's, a step's model-group sums without remat,
    and qk-norm's gradients with and without their model sum."""
    torch.set_num_threads(1)
    mesh = make_test_mesh(1, 2, device="cpu")
    return {"coords": (mesh.data_rank, mesh.model_rank), "units": _units(mesh),
            "flops": _flops(mesh, cases["flops"]), "sums": _model_sums(mesh, cases["flops"]),
            "qnorm": _qnorm_grads(mesh, cases["qnorm"])}
