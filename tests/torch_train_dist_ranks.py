"""Rank bodies of ``test_torch_train_dist.py``: what each spawned gloo rank
runs on the CPU. Kept apart from the test module so a rank imports torch
and the port only, never JAX: the parent passes numpy in and reads numpy
and Python values back, one dict a rank."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.configs import get_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.distributed import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    all_reduce_flat,
    compressed_psum,
    make_compressed_grad_allreduce,
    pipeline_apply,
)
from repro_torch.launch.mesh import make_mesh, make_test_mesh, mesh_axes  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.moe import count_drops  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.training.optim import AdamWConfig, adamw_init  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.training.train_loop import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    TrainConfig,
    make_train_step,
    state_sharding,
)

MOE = "qwen3-moe-30b-a3b"
# the leaves whose gradients the EP-loss cases compare: (path, split over model)
GRAD_LEAVES = ((("blocks", 0, "ffn", "router"), False), (("blocks", 0, "ffn", "w_gate"), True),
               (("blocks", 0, "mixer", "wq"), False), (("ramps", "head"), False))


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _t(a):
    return torch.from_numpy(np.array(a))


def ep_shard(model, params, mesh):
    """The rank's expert slice of a whole tree (views)."""
    return model.tp_shard_params(params, mesh.model_rank, mesh.model_size,
                                 specs=model.ep_param_specs())


def moe_model(cf):
    return build_model(get_tiny(MOE).replace(capacity_factor=cf))


def _loss_grads(mesh, case, cf):
    """``LM.loss(mesh=)`` on the rank's rows and its gradients, summed over
    the data group: (loss, metrics, {leaf: gradient}); an expert leaf's
    gradient is the rank's slice."""
    model = moe_model(cf)
    params = tree_map(lambda x: x.clone(),
                      ep_shard(model, from_numpy_params(case["params"], "cpu"), mesh))
    n = case["tokens"].shape[0] // mesh.data_size
    rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
    batch = {"tokens": _t(case["tokens"][rows]).long(), "labels": _t(case["labels"][rows]).long()}
    leaves = [get(params, p) for p, _ in GRAD_LEAVES]
    for x in leaves:
        x.requires_grad_(True)
    with count_drops() as drops:
        loss, metrics = model.loss(params, batch, mesh=mesh, moe_impl="ep")
    gs = torch.autograd.grad(loss, leaves)
    gs = all_reduce_flat(list(gs), mesh.data_group)
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            {"/".join(map(str, p)): g.numpy() for (p, _), g in zip(GRAD_LEAVES, gs)}, drops)


def _train(mesh, name, case, n_steps):
    """``make_train_step(mesh=)`` in the ``fsdp=False`` layout (dense leaves
    whole, experts over ``model``) over the case's global batches: per-step
    loss and grad norm, and the rank's params after the last step."""
    cfg = get_tiny(case["arch"]).replace(**case.get("over", {}))
    model = build_model(cfg)
    params = from_numpy_params(case["params"], "cpu")
    if hasattr(model, "ep_param_specs"):
        params = ep_shard(model, params, mesh)
    params = tree_map(lambda x: x.clone(), params)
    tcfg = TrainConfig(**case["tcfg"])
    opt_cfg = AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay, clip_norm=case["clip"])
    step_fn, _ = make_train_step(model, tcfg, opt_cfg, mesh=mesh,
                                 axes=mesh_axes(mesh, fsdp=False))
    state = {"params": params, "opt": adamw_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32)}
    logs = []
    for s in range(n_steps):
        state, out = step_fn(state, case["batches"][s])
        logs.append({k: float(v) for k, v in out.items()})
    return {"logs": logs, "params": to_numpy(state["params"])}


def job_four(rank, world, cases):
    """(pod 2, data 2): the compressed all-reduce; (data 2, stage 2) and
    (stage 4): pipeline_apply; (data 2, model 2): the EP loss at each
    capacity, the small-batch prefill, the train step of the MoE model and
    of BERT."""
    torch.set_num_threads(1)
    out = {}
    pd = make_mesh((2, 2), ("pod", "data"), device="cpu")
    c = cases["compressed"]
    g = {"b": _t(c["cb"]), "w": _t(c["cw"])}
    f = make_compressed_grad_allreduce(pd, "pod")
    o1, r1 = f(g, tree_map(torch.zeros_like, g))
    o2, r2 = f(g, r1)
    gp = _t(c["gp"][pd.coords["pod"]])
    po1, pr1 = compressed_psum(gp, pd.groups["pod"], torch.zeros_like(gp))
    po2, pr2 = compressed_psum(gp, pd.groups["pod"], pr1)
    out["compressed"] = {"o1": to_numpy(o1), "r1": to_numpy(r1), "o2": to_numpy(o2),
                         "r2": to_numpy(r2), "po1": po1.numpy(), "pr1": pr1.numpy(),
                         "po2": po2.numpy(), "pr2": pr2.numpy()}

    p = cases["pipe"]
    out["pipe"] = {}
    for S, mesh in ((2, make_mesh((2, 2), ("data", "stage"), device="cpu")),
                    (4, make_mesh((4,), ("stage",), device="cpu"))):
        W = _t(p["W"][mesh.coords["stage"]])
        y = pipeline_apply(mesh, "stage", lambda w, h: torch.tanh(h @ w), W, _t(p["x"]))
        out["pipe"][S] = y.numpy()

    mesh = make_test_mesh(2, 2, device="cpu")
    out["coords"] = (mesh.data_rank, mesh.model_rank)
    e = cases["ep"]
    out["ep"] = {cf: _loss_grads(mesh, e, cf) for cf in e["cfs"]}

    s = cases["small"]
    model = moe_model(8.0)
    params = ep_shard(model, from_numpy_params(s["params"], "cpu"), mesh)
    out["small"] = {}
    for key, toks in s["tokens"].items():
        with torch.no_grad():
            _, outs = model.prefill(params, _t(toks).long(), active_sites=[0],
                                    with_cache=False, moe_impl="ep", mesh=mesh)
        out["small"][key] = {k: {q: v.numpy() for q, v in st.items()} for k, st in outs.items()}
    out["train"] = {name: _train(mesh, name, cases["train"][name], 3)
                    for name in cases["train"]}
    return out


def job_ckpt(rank, world, case):
    """One train step at (data 1, model 2), its state saved from both ranks
    in the reference's format; then the checkpoint restored at (data 2,
    model 1), whole on each rank. Returns the rank's saved state, the
    restored one and the bytes its restore read."""
    torch.set_num_threads(1)
    mesh = make_test_mesh(1, 2, device="cpu")
    out = _train_state(mesh, case)
    mgr = CheckpointManager(case["dir"])
    mgr.save(out.pop("state"), 1, mesh=mesh, sharding_tree=state_sharding(
        out.pop("model"), mesh, mesh_axes(mesh, fsdp=False)))
    mesh21 = make_test_mesh(2, 1, device="cpu")
    model = moe_model(8.0)
    back = mgr.restore(1, "cpu", sharding_tree=state_sharding(model, mesh21,
                                                              mesh_axes(mesh21, fsdp=False)))
    out.update(restored=to_numpy(back), bytes_read=mgr.bytes_read)
    return out


def _train_state(mesh, case):
    model = moe_model(8.0)
    params = tree_map(lambda x: x.clone(),
                      ep_shard(model, from_numpy_params(case["params"], "cpu"), mesh))
    opt_cfg = AdamWConfig(lr=1e-2)
    step_fn, _ = make_train_step(model, TrainConfig(lr=1e-2, warmup=0, moe_impl="ep"), opt_cfg,
                                 mesh=mesh, axes=mesh_axes(mesh, fsdp=False))
    state = {"params": params, "opt": adamw_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32)}
    state, _ = step_fn(state, case["batch"])
    return {"state": state, "model": model, "saved": to_numpy(state),
            "leaves": len(tree_leaves(state))}


def job_card_collectives(rank, world):
    """On one card, ``world`` gloo ranks of a (model,) mesh: the autograd
    all-to-all, chunk and all-gather forward and backward, and one
    compressed all-reduce, each on CUDA tensors (staged through the host)
    and on the same values on the CPU. Returns both sides as numpy."""
    from repro_torch.distributed import all_gather_ad, all_to_all_ad, take_chunk_ad  # repro: allow[tier1-deps] — the port under test

    mesh = make_mesh((world,), ("model",), device="cuda")
    g = mesh.groups["model"]
    gen = torch.Generator().manual_seed(7 + rank)
    x0 = torch.randn(4 * world, 6, 3, generator=gen)
    shared = torch.randn(2 * world, 5, generator=torch.Generator().manual_seed(3))
    grads = torch.randn(40, 9, generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        x = x0.to(dev).requires_grad_(True)
        s = shared.to(dev).requires_grad_(True)
        y = all_to_all_ad(x * 2, g, 0, 1)
        z = all_gather_ad(take_chunk_ad(s, g, 0, 2) * 3, g, 0)
        w = torch.arange(y.numel(), device=dev, dtype=y.dtype).reshape(y.shape)
        (gx, gs) = torch.autograd.grad((y * w).sum() + (z * z).sum(), (x, s))
        o, r = compressed_psum(grads.to(dev), g, torch.zeros_like(grads.to(dev)))
        out[dev] = {k: v.detach().cpu().numpy() for k, v in
                    dict(y=y, z=z, gx=gx, gs=gs, o=o, r=r).items()}
    return out


def job_card_raise(rank, world):
    """Rank 1 raises after the job has started: the spawn must fail."""
    make_mesh((world,), ("model",), device="cuda")
    if rank == 1:
        raise RuntimeError("planted failure in rank 1")
    return rank
