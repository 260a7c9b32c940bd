"""The port's one-card dry run (``launch/dryrun.py``): its FLOP and byte
counters give the same counts on meta tensors as on CPU tensors, its FLOP
count is the analytic one on a tiny dense config, its parameter counts are
the reference's, its byte floors reproduce the served-shape floors that
``chip_smoke.py`` reckons by hand, and its ``fits`` agrees with the
full-width bytes ``test_torch_configs.py`` reckons."""
import math
import os
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import SHAPES, get_config, get_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.launch import dryrun as DR  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import param_count  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.training.optim import AdamWConfig, adamw_init  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.training.train_loop import TrainConfig, make_train_step  # noqa: E402  # repro: allow[tier1-deps] — the port under test

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_configs import FULL_WIDTH_GB  # noqa: E402  # repro: allow[tier1-deps] — the rows test_torch_configs.py reckons, one source

B, S, CACHE = 2, 8, 16


def _steps(arch, dev):
    """(prefill, decode, train step) of the tiny config on ``dev``, the plain
    path, as zero-argument functions."""
    cfg = get_tiny(arch)
    model = build_model(cfg, **({"ssd_impl": "ref"} if cfg.family == "lm" else {}))
    params = model.init(0, device="cpu") if dev == "cpu" else model.abstract()

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family == "encdec":
        frames = z(B, 8, cfg.d_frontend, dtype=torch.float32)
        cache = (model.init_cache(B, CACHE, 8, device=dev) if dev == "cpu"
                 else model.cache_abstract(B, CACHE, 8))
        batch = {"tokens": z(B, S), "labels": z(B, S),
                 "frames": z(B, 16, cfg.d_frontend, dtype=torch.float32)}

        def prefill():
            return model.prefill(params, frames, z(B, S), cache_len=CACHE, active_sites=[0])
    else:
        kw = ({"image_embeds": z(B, cfg.n_image_tokens, cfg.d_frontend, dtype=torch.float32)}
              if cfg.cross_attn_every else {})
        cache = (model.init_cache(B, CACHE, device=dev) if dev == "cpu"
                 else model.cache_abstract(B, CACHE))
        batch = {"tokens": z(B, S), "labels": z(B, S), **kw}

        def prefill():
            return model.prefill(params, z(B, S), cache_len=CACHE, active_sites=[0], **kw)

    step, opt_cfg = make_train_step(model, TrainConfig(moe_impl="ep", remat=True),
                                    AdamWConfig())
    state = {"params": params, "opt": adamw_init(params, opt_cfg),
             "step": z(dtype=torch.int32)}
    return (prefill, lambda: model.decode(params, cache, z(B, 1), z(B), active_sites=[0]),
            lambda: step(state, batch))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-lite-16b", "mamba2-2.7b",
                                  "gemma3-4b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b", "seamless-m4t-large-v2"])
def test_meta_counts_equal_cpu_counts(arch):
    """The FLOP count, the byte count and the ops counted of a tiny prefill,
    decode step and train step (loss, backward, AdamW) are the same on meta
    tensors as on CPU tensors."""
    counts = {}
    for dev in ("cpu", "meta"):
        prefill, decode, train = _steps(arch, dev)
        with torch.no_grad():
            got = [DR.count(prefill)[1:], DR.count(decode)[1:]]
        got.append(DR.count(train)[1:])
        counts[dev] = got
    assert counts["meta"] == counts["cpu"]
    assert all(f > 0 and b > 0 for f, b, _ in counts["cpu"])


def test_flops_are_the_analytic_count():
    """A tiny dense prefill (qwen2, no ramps) counts 2·tokens·(its matmul
    params) for the projections and FFN, 2·B·d·V for the head on the last
    position, and 4·B·H·S·Sk·hd a layer for the attention's two products
    over the cache's Sk slots."""
    cfg = get_tiny("qwen2-1.5b")
    model = build_model(cfg)
    params = model.abstract()
    d, H, KH, hd, L = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    with torch.no_grad():
        _, flops, _, _ = DR.count(lambda: model.prefill(
            params, torch.zeros((B, S), dtype=torch.int32, device="meta"), cache_len=CACHE))
    per_layer = d * (H + 2 * KH) * hd + H * hd * d + 3 * d * cfg.d_ff
    want = (2 * B * S * L * per_layer + 2 * B * d * cfg.padded_vocab
            + L * 4 * B * H * S * CACHE * hd)
    assert flops == want


def test_param_count_equals_reference():
    from repro.configs import get_config as ref_config
    from repro.models import build_model as ref_build
    from repro.models.common import param_count as ref_param_count

    for arch in ("qwen2-1.5b", "deepseek-v2-lite-16b", "qwen3-moe-30b-a3b", "gemma3-4b",
                 "mamba2-2.7b", "jamba-1.5-large-398b", "llama-3.2-vision-90b",
                 "qwen1.5-32b", "deepseek-67b", "seamless-m4t-large-v2", "gpt2-medium",
                 "bert-base", "resnet50", "resnet18"):
        sch = build_model(get_config(arch)).schema()
        assert param_count(sch) == ref_param_count(ref_build(ref_config(arch)).schema()), arch
    assert DR.model_flops(get_config("qwen2-1.5b"), SHAPES["train_4k"])[1] == param_count(
        build_model(get_config("qwen2-1.5b")).schema())


# served decode steps at B 8, 4 ramps: (arch, cache slots, pos, overrides,
# touched expert slots, the floor in GB). The floors are chip_smoke.py's
# hand floors: Gemma3-4B's step_bytes (9a), Qwen3-MoE's moe_step_floor with
# every expert and with the 2503 of 6144 expert slots one step's routing
# touched (10a), one period of Llama-3.2-Vision (11b), SeamlessM4T's
# encdec_step_floor over 1600 frames (12b), qwen2-1.5b's step_bytes (13a).
SERVED_FLOORS = [
    ("gemma3-4b", 1140, 1120, None, None, 14.29),
    ("qwen3-moe-30b-a3b", 160, 140, None, None, 63.10),
    ("qwen3-moe-30b-a3b", 160, 140, None, 2503, 28.74),
    ("llama-3.2-vision-90b", 130, 128, {"n_layers": 5}, None, 19.50),
    ("seamless-m4t-large-v2", 104, 80, None, None, 5.58),
    ("qwen2-1.5b", 160, 140, None, None, 5.01),
]


@pytest.mark.parametrize("arch,slots,pos,ovr,touched,gb", SERVED_FLOORS)
def test_served_floor_reproduces_the_hand_floors(arch, slots, pos, ovr, touched, gb):
    shape = dict(kind="decode", seq_len=slots, global_batch=8, pos=pos, active=4)
    if arch.startswith("seamless"):
        shape["memory"] = 1600
    rec = DR.run_cell(arch, shape, tag="served", write=False, overrides=ovr,
                      touched_experts=touched)
    assert rec["ok"], rec.get("error")
    assert abs(rec["floor_bytes"] / 1e9 - gb) <= 0.01 * gb
    assert rec["floor"]["total"] == rec["floor_bytes"]
    assert rec["bytes"] > rec["floor_bytes"] and rec["flops"] > 0


@pytest.mark.parametrize("arch,L,n_sites,gb", FULL_WIDTH_GB)
def test_fits_agrees_with_full_width_bytes(arch, L, n_sites, gb):
    """A B 8 decode cell at 160 slots, the configs cut as
    test_torch_configs.py cuts them: the resident params are its GB, and
    only the cells under the card's 80 GB fit."""
    shape = dict(kind="decode", seq_len=160, global_batch=8, pos=140, active=4)
    model = build_model(get_config(arch).replace(n_layers=L))
    res = DR.resident(model, shape)
    assert round(res["params"] / 1e9, 2) == gb[3]
    assert res["total"] == res["params"] + res["cache"]
    assert (res["total"] <= DR.CARD_BYTES) == (gb[3] < 80)


def test_cells_and_records(tmp_path, monkeypatch):
    """The grid has the reference's 33 runnable cells; a cell's record
    carries the roofline terms; ``multi`` records tp_check's refusal of
    qwen2's 12 heads over tp 16; a train cell counts
    the loss, its backward and AdamW at full width."""
    assert len(DR.cells()) == 33
    monkeypatch.setattr(DR, "ART_DIR", str(tmp_path))
    rec = DR.run_cell("qwen2-1.5b", "decode_32k")
    assert rec["ok"] and rec["card"] == DR.CARD and rec["chips"] == 1
    assert (tmp_path / "qwen2-1.5b__decode_32k__single.json").is_file()
    for k in ("flops", "bytes", "floor_bytes", "model_flops_ref", "params_total",
              "params_active", "t_compute_s", "t_memory_s", "bottleneck", "useful_flops_ratio",
              "fits", "resident"):
        assert k in rec
    assert rec["t_memory_s"] == rec["bytes"] / DR.HBM_BW
    assert rec["bottleneck"] == "memory" and not rec["fits"]  # 120 GB of cache
    assert math.isclose(rec["model_flops_ref"], 2 * rec["params_active"] * 128)
    tr = DR.run_cell("gpt2-medium", dict(kind="train", seq_len=64, global_batch=2),
                     tag="t", write=False)
    assert tr["ok"] and tr["resident"]["adamw_moments"] == 8 * tr["params_total"]
    assert tr["flops"] > 3 * 2 * tr["params_active"] * 128
    multi = DR.run_cell("qwen2-1.5b", "decode_32k", "multi")  # tp_check refuses tp 16
    assert multi["ok"] and multi["refused"] and "not divisible by tp=16" in multi["status"]
    assert DR.main(["--arch", "gemma3-4b", "--shape", "long_500k"]) == 0


@pytest.mark.parametrize("arch,layout,more", [("qwen2-1.5b", {"data": 2, "model": 2}, {}),
                                              ("qwen3-moe-30b-a3b", None, {"n_experts": 16})])
def test_multi_train_cell_holds_the_fsdp_state(arch, layout, more):
    """A ``--mesh multi`` train cell's rank holds the FSDP state: its
    params, gradients and f32 moments are the bytes reckoned from each
    leaf's spec sanitized on the layout (tiny width): at (data 2, model 2)
    (rank 0 of a 4-rank fake job, ``build_cell_multi``) a quarter of the
    whole state apart from the f32 norms (and qwen2's biases, split over
    ``model`` alone); on the multi-pod layout (pod 2, data 16, model 16;
    ``run_cell_multi``'s record) each leaf over as many ranks as its dims
    allow. The step gathers and reduce-scatters its leaves, and
    all-reduces only the leaves left unsplit over data."""
    from repro_torch.distributed import count_collectives  # repro: allow[tier1-deps] — the port under test
    from repro_torch.launch.mesh import make_mesh, mesh_axes  # repro: allow[tier1-deps] — the port under test
    from repro_torch.models.common import part_shape, tree_map2  # repro: allow[tier1-deps] — the port under test
    from repro_torch.training.train_loop import layout_specs  # repro: allow[tier1-deps] — the port under test

    tiny = get_tiny(arch)
    over = {k: getattr(tiny, k) for k in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                                          "head_dim", "d_ff", "vocab_size", "dtype",
                                          "n_experts", "moe_d_ff")}
    over.update(more)  # the experts split over the 16 model ranks
    shape = dict(kind="train", seq_len=64, global_batch=64)
    if layout is None:
        lay = DR.MULTI_LAYOUT
        rec = DR.run_cell_multi(arch, shape, write=False, overrides=over)
        assert rec["ok"] and rec["status"] == "ok", rec.get("traceback")
        assert rec["chips"] == math.prod(lay.values())
        res, c = rec["resident"], rec["collectives"]
    else:
        lay = layout
        with DR.fake_job(math.prod(lay.values())):
            mesh = make_mesh(tuple(lay.values()), tuple(lay), device="meta")
            _, _, fn, res = DR.build_cell_multi(arch, shape, mesh, overrides=over)
            with count_collectives() as cc, torch.enable_grad():
                fn()
        c = {k: {"calls": n, "bytes": b} for k, (n, b) in cc.items()}
    model = build_model(get_config(arch).replace(**over))
    parts, whole, norms = [], [], []

    def leaf(info, sp):
        n = math.prod(info.shape)
        m = math.prod(part_shape(info.shape, sp, lay))
        parts.append(m * (2 * info.dtype.itemsize + 8))
        whole.append(n * (2 * info.dtype.itemsize + 8))
        if m == n:
            norms.append(n * (2 * info.dtype.itemsize + 8))
            assert info.dtype == torch.float32
    tree_map2(leaf, model.schema(), layout_specs(model, lay, mesh_axes(lay)))
    assert res["params"] + res["grads"] + res["adamw_moments"] == sum(parts)
    if layout is None:
        assert rec["rank_state_bytes"] == sum(parts)
        assert rec["whole_state_bytes"] == sum(whole)
    else:
        quarter = sum(norms) + (sum(whole) - sum(norms)) / 4
        assert abs(sum(parts) - quarter) < 0.005 * sum(whole)
    assert c["all-gather"]["calls"] > 0 and c["reduce-scatter"]["calls"] > 0
