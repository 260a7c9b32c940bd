"""Rank bodies of ``test_torch_distributed.py``: what each spawned gloo rank
runs on the CPU, and the runner schedule both packages run. Kept apart
from the test module so a rank imports torch and the port only, never
JAX: the reference runs in the parent and reaches the ranks as numpy.
Each job returns plain numpy and Python values, one dict a rank."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.distributed.pipeline import pipeline_decode_window, stage_shard  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.serving import PoolExhausted, ShardedDecodeRunner  # noqa: E402  # repro: allow[tier1-deps] — the port under test

BS = 4  # pool block size
# (config, overrides): the cases' tiny models
MODELS = {"qwen2": ("qwen2-1.5b", {}), "qwen2_kh4": ("qwen2-1.5b", {"n_kv_heads": 4}),
          "moe": ("qwen3-moe-30b-a3b", {"capacity_factor": 8.0}),
          "pipe": ("qwen2-1.5b", {"n_layers": 4})}


def port_model(name, **kw):
    arch, over = MODELS[name]
    return build_model(get_tiny(arch).replace(**over, **kw), prefill_attn="kernel")


def _t(a):
    return torch.from_numpy(np.array(a))


def _outs(outs):
    return {p: {k: v.numpy() for k, v in st.items()} for p, st in outs.items()}


def _decode(name, case, mesh, *, moe_ep=False, **kw):
    """One ``decode_sharded`` step of ``case`` (the parent's numpy inputs:
    whole weights, cache, tokens, pos, active sites, thresholds, tables)."""
    model = port_model(name, decode_attn="paged-kernel" if "tables" in case else "kernel",
                       pallas_head="kernel")
    params = model.tp_shard_params(from_numpy_params(case["params"], "cpu"), mesh.model_rank,
                                   mesh.tp, moe_ep=moe_ep)
    paged = "tables" in case
    cache = model.tp_shard_cache(from_numpy_params(case["cache"], "cpu"), mesh.model_rank,
                                 mesh.tp, data_rank=mesh.data_rank,
                                 dp=1 if paged else mesh.dp)
    cache, outs = model.decode_sharded(
        params, cache, _t(case["tok"]).long(), _t(case["pos"]).long(), mesh=mesh,
        active_sites=case["act"], exit_thresholds=_t(case["thr"]),
        block_tables=_t(case["tables"]) if paged else None, **kw)
    return {"outs": _outs(outs), "cache": to_numpy(cache)}


def _window(name, case, mesh):
    """``decode_sharded_multi`` windows of ``case`` at each of its
    (thresholds, row_valid) variants."""
    model = port_model(name, decode_attn="kernel", pallas_head="kernel")
    params = model.tp_shard_params(from_numpy_params(case["params"], "cpu"), mesh.model_rank,
                                   mesh.tp)
    out = []
    for thr, valid in case["variants"]:
        cache = model.tp_shard_cache(from_numpy_params(case["cache"], "cpu"), mesh.model_rank,
                                     mesh.tp, data_rank=mesh.data_rank, dp=mesh.dp)
        cache, recs = model.decode_sharded_multi(
            params, cache, _t(case["tok"]).long(), _t(case["pos"]).long(), case["n"], mesh=mesh,
            n_max=case["n_max"], active_sites=case["act"], thresholds=_t(thr),
            row_valid=_t(valid))
        out.append({"recs": [r.numpy() for r in recs], "cache": to_numpy(cache)})
    return out


def _init_sharded(mesh):
    """``init_sharded`` against the slice of ``init``, for a dense and an
    expert-split tree: the leaves that differ (none expected)."""
    bad = []
    for name, moe_ep in (("qwen2", False), ("moe", True)):
        model = port_model(name)
        whole = model.tp_shard_params(model.init(3, device="cpu"), mesh.model_rank, mesh.tp,
                                      moe_ep=moe_ep)
        part = model.init_sharded(3, mesh.model_rank, mesh.tp, device="cpu", moe_ep=moe_ep)
        for i, (a, b) in enumerate(zip(tree_leaves(whole), tree_leaves(part))):
            if a.shape != b.shape or not torch.equal(a, b):
                bad.append((name, i))
    return bad


def _pipeline(case, mesh):
    """``pipeline_decode_window`` with thresholds off, then with the
    near-1.0 boundary thresholds of ``case`` (when it has boundary sites)."""
    model = port_model("pipe", decode_attn="kernel")
    S, s = mesh.pp, mesh.stage
    params = stage_shard(from_numpy_params(case["params"], "cpu"), s, S)
    out = {}
    for kind, kw in (("off", {}), ("on", case["exit"].get(S))):
        if kw is None:
            continue
        cache = stage_shard(from_numpy_params(case["cache"], "cpu"), s, S)
        cache, tok_rec, exit_rec, alive, steps = pipeline_decode_window(
            model, params, cache, _t(case["tok"]).long(), _t(case["pos"]).long(), case["n"],
            mesh=mesh, **kw)
        out[kind] = {"tok": tok_rec.numpy(), "exit": exit_rec.numpy(), "alive": alive.numpy(),
                     "steps": steps.numpy(), "cache": to_numpy(cache)}
    return out


def _solo_stage_mesh(rank, world):
    """A one-stage mesh of this rank alone (each rank runs S = 1 on its own)."""
    groups = [torch.distributed.new_group([r]) for r in range(world)]
    return ServingMesh(1, 1, 1, rank, {"stage": 0}, {"stage": groups[rank]},
                       torch.device("cpu"), "gloo")


# -- the runner schedule ---------------------------------------------------------------

_ACT, _THR = [0, 1], np.array([0.5, 0.9], np.float32)
# the paired schedules. On the pool: admits (a whole-prompt hit, a partial
# hit), steps, windows (one that ends after its first step), a swap round
# trip, an admission that finds the pool dry, frees and chunked prefill. On
# contiguous rows: admits, steps, windows, a free and a readmission.
CALLS = {
    "pages": [("start", 0, 0), ("start", 1, 1), ("start", 2, 2), ("step", [0, 1, 2], _ACT),
              ("step_multi", [0, 1, 2], _ACT, 3, _THR),
              ("step_multi", [0, 2], _ACT, 2, np.ones(2, np.float32)),
              ("swap_out", 1), ("start", 3, 3), ("free", 2), ("swap_in", 2),
              ("step_multi", [0, 2], _ACT, 4, _THR), ("free", 0), ("prefill_begin", 0, 4, 6),
              ("prefill_resume", 0, 3), ("prefill_resume", 0, 8), ("step", [0, 2], []),
              ("step_multi", [0, 2], _ACT, 3, _THR)],
    "rows": [("start", 0, 0), ("start", 1, 1), ("start", 2, 2), ("step", [0, 1, 2], _ACT),
             ("step_multi", [0, 1, 2], _ACT, 3, _THR),
             ("step_multi", [0, 2], _ACT, 2, np.ones(2, np.float32)), ("free", 1),
             ("start", 1, 3), ("step_multi", [0, 1, 2], _ACT, 4, _THR), ("step", [1], [])],
}


def schedule(runner, exc, layout="pages"):
    """Run one of ``CALLS`` on ``runner``. Returns one (status, result,
    state) a call; swap handles stay inside."""
    out, handle = [], None
    for name, *args in CALLS[layout]:
        if name == "swap_in":
            args = args + [handle]
        try:
            res = getattr(runner, name)(*args)
            status = "ok"
        except exc:
            res, status = None, "exhausted"
        if name == "swap_out":
            handle, res = res, None
        if isinstance(res, tuple):
            res = tuple(np.asarray(r) for r in res)
        out.append((status, res, runner_state(runner)))
    return out


def runner_state(r):
    kv = {k: v for k, v in r.kv_stats().items()
          if k not in ("tp", "dp", "per_device_cache_bytes")}
    out = {"pos": r._pos.tolist(), "tok": r._tok.tolist(), "live": sorted(r._live),
           "pf": dict(r._pf_progress), "kv": kv}
    if r._alloc is not None:
        al = r._alloc
        out["alloc"] = (al.table.tolist(), al.owned.tolist(), al.refcount.tolist(),
                        al.n_free, al.peak_blocks, al.pins)
    return out


def _runner(name, case, mesh, layout="pages"):
    model = port_model(name, decode_attn="paged-kernel" if layout == "pages" else "kernel",
                       pallas_head="kernel")
    shard = model.tp_shard_params(from_numpy_params(case["params"], "cpu"), mesh.model_rank,
                                  mesh.tp)
    runner = ShardedDecodeRunner(model, shard, case["prompts"], mesh=mesh, **case["kw"])
    calls = schedule(runner, PoolExhausted, layout)
    return {"calls": calls, "kv": runner.kv_stats(), "pool": to_numpy(runner._cache)}


# -- the jobs --------------------------------------------------------------------------

def job_two(rank, world, data):
    """Two ranks: tp 2 decode on rows and on the pool, windows, EP, the
    sharded runner, ``init_sharded``, and the pipeline at S = 1 and 2."""
    torch.set_num_threads(1)
    mesh = make_serving_mesh(tp=2, device="cpu")
    pipe = make_serving_mesh(pp=2, device="cpu")
    return {"rows": _decode("qwen2", data["rows"], mesh),
            "paged": _decode("qwen2", data["paged"], mesh),
            "window": _window("qwen2", data["window"], mesh),
            "ep": _decode("moe", data["ep"], mesh, moe_ep=True, moe_impl="ep"),
            "init": _init_sharded(mesh),
            "runner": _runner("qwen2", data["runner"], mesh),
            "pipe1": _pipeline(data["pipe"], _solo_stage_mesh(rank, world)),
            "pipe2": _pipeline(data["pipe"], pipe)}


def job_four(rank, world, data):
    """Four ranks: tp 4 and dp 2 x tp 2 decode and windows, the sharded
    runner on contiguous rows at dp 2 x tp 2, and the pipeline at S = 4."""
    torch.set_num_threads(1)
    tp4 = make_serving_mesh(tp=4, device="cpu")
    dp2 = make_serving_mesh(tp=2, dp=2, device="cpu")
    pipe = make_serving_mesh(pp=4, device="cpu")
    return {"tp4": _decode("qwen2_kh4", data["rows"], tp4),
            "dp2": _decode("qwen2_kh4", data["rows"], dp2),
            "window_dp2": _window("qwen2_kh4", data["window"], dp2),
            "pipe4": _pipeline(data["pipe"], pipe),
            "runner_dp2": _runner("qwen2_kh4", data["runner"], dp2, "rows"),
            "coords": (dp2.data_rank, dp2.model_rank)}


def job_raise(rank, world):
    """Rank 1 raises; rank 0 waits in a collective it never leaves."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()


def job_card_tp(rank, world):
    """On one card, ``world`` gloo ranks: one tensor-parallel decode step of
    tiny qwen2 (hd 64, 4 heads on 2, so a rank decodes 2 heads on 1) on
    contiguous rows (#1) and on the pool (#5) with the ramp heads on #2/#3,
    against the single-rank step on the same card; and whether
    ``graphs=True`` is refused under gloo."""
    from repro_torch.kernels import counted_wrappers  # repro: allow[tier1-deps] — the port under test

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_serving_mesh(tp=world)
    cfg = get_tiny("qwen2-1.5b").replace(head_dim=64, pallas_head="kernel")
    model = build_model(cfg.replace(decode_attn="kernel"), prefill_attn="kernel")
    paged = build_model(cfg.replace(decode_attn="paged-kernel"), prefill_attn="kernel")
    params = model.init(0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    B, P, bs = 4, 24, 8
    toks = torch.randint(1, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    cache, outs = model.prefill(params, toks, cache_len=P + bs)
    tok = outs["final"]["label"].reshape(B, 1).long()
    pos = torch.full((B,), P, device="cuda")
    act, thr = [0, 1], torch.full((2,), 0.5, device="cuda")
    nb = (P + bs) // bs
    table = (torch.randperm(B * nb, generator=gen, device="cuda") + 1).reshape(B, nb)
    pool = paged.init_paged_cache(1 + B * nb, bs, device="cuda")
    for pl, cl in zip(tree_leaves(pool), tree_leaves(cache)):
        pl.index_copy_(1, table.reshape(-1), cl.reshape(cl.shape[0], B * nb, bs,
                                                        *cl.shape[-2:]))
    table = table.to(torch.int32)
    shard = model.tp_shard_params(params, mesh.model_rank, world)
    fns = counted_wrappers()
    out = {}
    for name, mdl, c, kw in (("rows", model, cache, {}),
                             ("pages", paged, pool, {"block_tables": table})):
        _, single = mdl.decode(params, tree_map(torch.clone, c), tok, pos, active_sites=act,
                               exit_thresholds=thr, **kw)
        cs = model.tp_shard_cache(c, mesh.model_rank, world)
        for f in fns.values():
            f.launches = 0
        _, sharded = mdl.decode_sharded(shard, cs, tok, pos, mesh=mesh, active_sites=act,
                                        exit_thresholds=thr, **kw)
        torch.cuda.synchronize()
        out[name] = {"single": {p: {k: v.cpu().numpy() for k, v in st.items()}
                                for p, st in single.items()},
                     "sharded": {p: {k: v.cpu().numpy() for k, v in st.items()}
                                 for p, st in sharded.items()},
                     "launches": {k: f.launches for k, f in fns.items()}}
    try:
        ShardedDecodeRunner(model, shard, toks.cpu().numpy(), mesh=mesh, graphs=True)
        out["graphs_refused"] = False
    except ValueError:
        out["graphs_refused"] = True
    return out
