"""Rank bodies of ``test_torch_fsdp.py``: what each spawned gloo rank runs
on the CPU. Kept apart from the test module so a rank imports torch and
the port only, never JAX: the parent passes numpy in and reads numpy and
Python values back, one dict a rank."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.configs import get_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.distributed import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    all_gather_ad,
    count_collectives,
    fsdp_gather_ad,
    reduce_scatter_tiled,
)
from repro_torch.launch.mesh import make_test_mesh, mesh_axes  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import take_part, tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.training.optim import AdamWConfig, adamw_init  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.training.train_loop import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    TrainConfig,
    make_train_step,
    shard_state,
    state_sharding,
)

# the compared steps: two AdamW steps, clipping active, remat on
LR, CLIP, STEPS = 1e-2, 0.05, 2
SPEC = ("data", "model")  # the unit cases' leaf: (4, 6) split on both dims


def model_of(case):
    return build_model(get_tiny(case["arch"]).replace(**case["over"]))


def tcfg():
    return TrainConfig(steps=STEPS, lr=LR, warmup=1, moe_impl="ep", remat=True)


def opt_cfg():
    return AdamWConfig(lr=LR, weight_decay=tcfg().weight_decay, clip_norm=CLIP)


def _units(mesh):
    """``reduce_scatter_tiled`` over the data group; ``fsdp_gather_ad`` and
    ``all_gather_ad`` (over data, then model) on one leaf whose
    upstream gradient differs by data rank and is alike in a model
    group."""
    x = torch.randn(3, 8, 5, generator=torch.Generator().manual_seed(mesh.rank))
    whole = torch.randn(4, 6, generator=torch.Generator().manual_seed(7))
    up = torch.randn(4, 6, generator=torch.Generator().manual_seed(100 + mesh.data_rank))
    part = take_part(whole, SPEC, mesh)
    grads = {}
    for name in ("fsdp", "all_gather_ad"):
        p = part.clone().requires_grad_(True)
        if name == "fsdp":
            y = fsdp_gather_ad(p, SPEC, mesh)
        else:
            y = all_gather_ad(all_gather_ad(p, mesh.data_group, 0), mesh.model_group, 1)
        (y * up).sum().backward()
        grads[name] = p.grad.numpy()
    return {"rs_in": x.numpy(), "rs_out": reduce_scatter_tiled(x, mesh.data_group, 1).numpy(),
            "gathered": fsdp_gather_ad(part, SPEC, mesh).numpy(), "up": up.numpy(), **grads}


def _train(mesh, axes, case):
    """Two FSDP steps from the whole bridged params, sharded by
    ``shard_state``: (per-step loss, grad norm and collectives, the rank's
    part shapes and its state after the last step as numpy; the model; the
    state)."""
    model = model_of(case)
    params = from_numpy_params(case["params"], "cpu")
    whole = {"params": params, "opt": adamw_init(params, opt_cfg()),
             "step": torch.zeros((), dtype=torch.int32)}
    state = shard_state(whole, model, mesh, axes)
    del whole, params
    step_fn, _ = make_train_step(model, tcfg(), opt_cfg(), mesh=mesh, axes=axes)
    logs, counts = [], []
    shapes = [tuple(x.shape) for x in tree_leaves(state["params"])]
    for b in case["batches"]:
        with count_collectives() as cc:
            state, out = step_fn(state, b)
        logs.append({k: float(v) for k, v in out.items()})
        counts.append({k: list(v) for k, v in cc.items()})
    return ({"logs": logs, "shapes": shapes, "state": to_numpy(state), "counts": counts},
            model, state)


def job(rank, world, cases, ckpt_dir):
    """(data 2, model 2): the unit cases, then each case's two FSDP steps;
    the first case's final state saved from the four ranks."""
    torch.set_num_threads(1)
    mesh = make_test_mesh(2, 2, device="cpu")
    axes = mesh_axes(mesh, fsdp=True)
    out = {"coords": (mesh.data_rank, mesh.model_rank), "units": _units(mesh)}
    for i, (name, case) in enumerate(cases.items()):
        out[name], model, state = _train(mesh, axes, case)
        if i == 0:
            CheckpointManager(ckpt_dir).save(state, STEPS, mesh=mesh,
                                             sharding_tree=state_sharding(model, mesh, axes))
    return out
