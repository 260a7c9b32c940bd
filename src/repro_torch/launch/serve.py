"""Serving launcher of the port, on the CUDA card unless ``--device cpu``.
``--mode generative`` (the default): Apparate's per-token early
exits on a decoder LM, driven by the continuous-batching engine.
``--mode classification``: the paper's classification workloads (ResNet,
BERT, or an LM's next token) on the cluster engine, each worker with its
own Apparate controller, vanilla against Apparate.

  PYTHONPATH=src python -m repro_torch.launch.serve --config qwen2-1.5b \\
      --n 8 --decode-tokens 32 --steps-per-sync 4
  # the paged KV pool, with prefix sharing, swap preemption, chunked prefill
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-block-size 16 \\
      --kv-blocks 40 --prefix-cache --preempt swap --prefill-chunk 64
  # DeepSeek-V2-Lite (MLA + MoE) on paged latent pools (no prefix cache:
  # latent pages are not shared)
  PYTHONPATH=src python -m repro_torch.launch.serve --config deepseek-v2-lite-16b \\
      --kv-block-size 16
  # Mamba2-2.7B (SSD): contiguous state rows, or one state page a slot on the
  # pool (no prefix cache: state pages are not shared)
  PYTHONPATH=src python -m repro_torch.launch.serve --config mamba2-2.7b \\
      --kv-block-size 16
  # Qwen3-MoE-30B-A3B (128 experts, the prefix cache allowed), or
  # Llama-3.2-Vision (its cross layers on pinned xkv pages; the runner takes
  # no image, so they attend zero memory) and Jamba (attention and state
  # pages in one pool), both refusing a prefix cache; --tiny on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --config qwen3-moe-30b-a3b \\
      --kv-block-size 16 --prefix-cache
  # classification: ResNet-50 at 224 px (f32), BERT-base (its attention on
  # the flash-attention kernel) or qwen2-1.5b's next token
  PYTHONPATH=src python -m repro_torch.launch.serve --mode classification \\
      --config resnet50 --n 600 --workers 2 --dispatch jsq --admission
  # train on the bootstrap split first (the reference launcher's recipe)
  PYTHONPATH=src python -m repro_torch.launch.serve --mode classification \\
      --config bert-base --n 600 --train
  # the controller's budget and constraint, the offered load, and an
  # allocator preset applied before CUDA starts (launch/tuning.py)
  PYTHONPATH=src python -m repro_torch.launch.serve --budget 0.4 --acc 0.98 \\
      --load 0.7 --runtime-preset serve
  # tensor-parallel decode on 2 ranks (one card a rank under nccl; ranks that
  # share a card, or the CPU, under gloo), plus the exit-gated pipeline
  # window over 2 stage ranks
  PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 --pp 2 --dist-backend nccl
  PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 --pp 2 --tiny --device cpu \\
      --dist-backend gloo

Prefills run the port's prefill kernels: flash attention for the attention
models' whole prompts, the SSD chunk scan for Mamba2's.

The engine's latencies (TTFT, TPT, response latencies, the
vanilla-vs-Apparate wins) are SIMULATED from the analytic H100 latency
profile, as in the JAX package; the ``measured`` block holds host wall
times of the runner's calls on the device, each of which ends in a host
read of its result, read from the run's spans (``repro_torch.trace``,
on for the served run). Weights: the config's drawn from ``--seed`` (or a
caller's ``params``), which exit little or nothing; or, with ``--train``,
trained first as the JAX launcher trains its models (classification: the
whole model on the bootstrap split, the first ``max(n // 10, 256)``
items, then the rest served; generative: 300 steps on the decode
stream), so the ramps exit on a learned confidence. The port trains the
config's own model on the card where the reference trains a CPU-size
bench stand-in.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs import get_config, get_tiny
from repro_torch.launch.tuning import PRESETS, apply_preset
from repro_torch.core import ApparateController, ControllerConfig, build_profile
from repro_torch.data import make_decode_stream, make_image_stream, make_token_stream
from repro_torch.models import build_model
from repro_torch.serving import (
    AdmissionConfig,
    AdmissionPolicy,
    ClassifierRunner,
    ClusterConfig,
    ClusterSimulator,
    DecodeRunner,
    GenerativeConfig,
    GenerativeEngine,
    LMTokenRunner,
    PlatformConfig,
    ShardedDecodeRunner,
    make_gen_requests,
    make_requests,
    maf_trace,
    offered_decode_qps,
    savings_vs,
    summarize_cluster,
    summarize_generative,
    video_trace,
)
from repro_torch.models.common import tree_map


def _runner_times(spans):
    """The ``measured`` block's runner times from the run's spans
    (``repro_torch.trace``): each one-shot prefill (``runner/prefill``),
    each prefill chunk (``runner/chunk``) and each sync window
    (``runner/window``) with its kind, "capture", "replay" or "eager".
    Each call ends in a host read of a device result (a chunk that only
    shares cached blocks does no device work), so its time covers the
    device work. A call that raised (``PoolExhausted``, retried after a
    preemption) is not one. Returns (the block's entries, the windows'
    tokens, the calls' seconds, the windows' seconds)."""
    spans = [s for s in spans if "raised" not in s.attrs]

    def secs(name, kind=None):
        return [1e-9 * (s.t1 - s.t0) for s in spans
                if s.name == name and kind in (None, s.attrs.get("kind"))]

    def ms(t):
        return 1e3 * float(np.mean(t)) if t else 0.0

    pf, ch, win = secs("runner/prefill"), secs("runner/chunk"), secs("runner/window")
    out = {"prefill_ms_mean": ms(pf), "prefill_chunk_calls": len(ch),
           "prefill_chunk_ms_mean": ms(ch), "window_ms_mean": ms(win), "windows": len(win)}
    for kind in ("capture", "replay", "eager"):
        t = secs("runner/window", kind)
        out[f"{kind}_windows"], out[f"{kind}_window_ms_mean"] = len(t), ms(t)
    tokens = sum(s.attrs["nd"] * s.attrs["B"] for s in spans if s.name == "runner/window")
    return out, tokens, sum(pf + ch + win), sum(win)


def _cuda_or_cpu(device, what):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device (pass device='cpu' to run the plain "
                           "versions on the CPU)")
    # fp32 matmuls and convolutions stay full fp32 on the card (never TF32),
    # so fp32 runs compare with the reference at fp32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def _admission(on, slack):
    return AdmissionPolicy(AdmissionConfig(slack=slack)) if on else None


BATCH = 8  # decode slots
SLOTS = 4  # the controller's ramp gather slots
# ramp-overhead budget, a fraction of a vanilla step: at full width each
# untied ramp head of qwen2-1.5b streams 472 MB, ~15% of a batch-1 step in
# the H100 profile, so 0.6 admits four ramps (the JAX launcher's 0.02
# assumed ramps tied to the LM head)
BUDGET = 0.6
ACC = 0.99  # agreement constraint
LOAD = 0.5  # offered load, a fraction of one replica's decode capacity


def serve_generative(config="qwen2-1.5b", n=8, *, decode_tokens=32, prompt_len=128,
                     steps_per_sync=4, seed=0, tiny=False, device="cuda", verbose=True,
                     kv_block_size=0, kv_blocks=None, prefix_cache=False, preempt="none",
                     prefill_chunk=0, prompts=None, params=None, graphs=None,
                     admission=False, admission_slack=1.0, train=False, budget=BUDGET,
                     acc=ACC, load=LOAD, tp=1, dp=1, pp=1, dist_backend=None, mesh=None,
                     n_layers=None):
    """Vanilla (no-EE, simulated only) vs Apparate per-token exits served on
    the real model at the same accuracy constraint. ``tiny`` serves the
    config's TINY variant (CPU tests); ``n_layers`` cuts the config to that
    depth at its full width. Returns (summary, responses).

    ``kv_block_size > 0`` pages the decode KV cache into a block pool
    (``decode_attn='paged-kernel'``): KV memory scales with live tokens;
    ``kv_blocks`` caps the pool (default: full slot capacity).
    ``prefix_cache`` (paged only) shares cached prompt-prefix blocks
    between slots; ``preempt`` is the reaction to an exhausted pool ('swap'
    a victim's blocks to the host and readmit it later, 'shed' it, or
    'none': raise). ``prefill_chunk > 0`` prefills prompts in chunks
    interleaved with decode steps. ``prompts`` (n, prompt_len) replaces the
    seeded random prompts; ``params`` reuses weights already drawn with
    ``seed`` (the same tree for every decode_attn). ``graphs`` goes to the
    runner: each sync window one CUDA graph replay on a card (None, True)
    or eager (False). ``admission`` sheds hopeless requests at admission
    and doomed slots mid-stream (the SLO-aware ``AdmissionPolicy``, its
    deadlines stretched by ``admission_slack``). ``train`` first trains
    the model (from the TrainConfig's seed 0, as the reference launcher
    does) for 300 steps at lr 3e-3 on 32 rows a step of a decode stream
    whose rows carry the prompts, then serves those prompts with the
    trained weights; ``report["train"]`` holds the losses. ``budget`` (the
    controller's ramp-overhead budget, a fraction of a vanilla step),
    ``acc`` (its agreement constraint) and ``load`` (the offered load, a
    fraction of one replica's decode capacity) default to the port's
    ``BUDGET``, ``ACC`` and ``LOAD``.

    ``tp * dp > 1`` serves through ``ShardedDecodeRunner`` on a ``(data,
    model)`` mesh: ``tp * dp`` ranks (``launch.mesh.spawn``, backend
    ``dist_backend``: 'nccl' one card a rank, 'gloo' for ranks that share a
    card or the CPU) each draw their shard of the weights from ``seed``
    (``LM.init_sharded``) and run the same engine, controller and runner
    schedule on it; rank 0's report is returned, with ``mesh: {tp, dp}``. ``pp > 1`` adds
    ``pipeline_escape_demo`` over ``pp`` stage ranks. Under gloo the
    windows run eager. ``mesh`` is the rank's own mesh, inside a rank, where ``params`` is the
    rank's shard."""
    if tp * dp > 1 and mesh is None:
        if dist_backend is None:
            raise ValueError("tp * dp > 1 needs dist_backend ('nccl' one card a rank, 'gloo')")
        if params is not None or train:
            raise ValueError("a multi-rank run draws its weights from seed in every rank")
        kw = dict(config=config, n=n, decode_tokens=decode_tokens, prompt_len=prompt_len,
                  steps_per_sync=steps_per_sync, seed=seed, tiny=tiny, device=str(device),
                  verbose=False, kv_block_size=kv_block_size, kv_blocks=kv_blocks,
                  prefix_cache=prefix_cache, preempt=preempt, prefill_chunk=prefill_chunk,
                  prompts=prompts, graphs=graphs, admission=admission,
                  admission_slack=admission_slack, budget=budget, acc=acc, load=load,
                  n_layers=n_layers)
        from repro_torch.launch.mesh import spawn

        out, resp = spawn(_serve_rank, tp * dp, dist_backend, args=(tp, dp, kw),
                          device=device)[0]
        if pp > 1:
            out["pipeline"] = pipeline_escape_demo(
                config, pp, dist_backend, tiny=tiny, seed=seed, prompts=prompts,
                n=n, prompt_len=prompt_len, n_steps=decode_tokens, device=device)
        if verbose:
            print(json.dumps(out, indent=1, default=float))
        return out, resp
    if prefix_cache and not kv_block_size:
        raise ValueError("--prefix-cache requires --kv-block-size > 0 (paged KV)")
    if preempt != "none" and not kv_block_size:
        raise ValueError("--preempt requires --kv-block-size > 0 (paged KV)")
    device = _cuda_or_cpu(device, "serve_generative")
    cfg = (get_tiny if tiny else get_config)(config).replace(
        decode_attn="paged-kernel" if kv_block_size else "kernel", pallas_head="kernel")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if cfg.mla:
        # the paged MLA kernel takes the absorbed (latent-space) decode; both
        # layouts run it, so they compute the same math
        cfg = cfg.replace(mla_absorbed=True)
    model = build_model(cfg, prefill_attn="kernel", ssd_impl="kernel")
    trained = None
    if train:
        if params is not None or prompts is not None:
            raise ValueError("train=True draws its own weights and prompts")
        params, prompts, trained = _train_generative(model, n, prompt_len, seed, device)
    if params is None:
        # a rank draws only its shard: no rank ever holds the whole model
        params = (model.init_sharded(seed, mesh.model_rank, mesh.tp, device=device)
                  if mesh is not None else model.init(seed, device=device))
    if prompts is None:
        prompts = np.random.default_rng(seed).integers(1, cfg.vocab_size, (n, prompt_len))
    n, prompt_len = np.shape(prompts)
    prof = build_profile(cfg, mode="decode", chips=1, sites=model.sites, charge_kv=True)
    qps = offered_decode_qps(prof, max_batch_size=BATCH, tokens_per_request=decode_tokens,
                             load=load)
    reqs = make_gen_requests(maf_trace(n, mean_qps=qps, seed=seed), n_tokens=decode_tokens,
                             prompt_len=prompt_len, slo_ms=3 * prof.vanilla_time(1))
    gcfg = GenerativeConfig(max_batch_size=BATCH, steps_per_sync=steps_per_sync,
                            prefill_chunk=prefill_chunk, preempt=preempt)
    base_eng = GenerativeEngine(prof, gcfg, admission=_admission(admission, admission_slack))
    mb = summarize_generative(base_eng.run(reqs), horizon_ms=base_eng.makespan_ms)
    ctl = ApparateController(len(model.sites), prof, ControllerConfig(
        max_slots=SLOTS, ramp_budget_frac=budget, acc_constraint=acc))
    rkw = {}
    if kv_block_size:
        rkw = dict(kv_block_size=kv_block_size, kv_blocks=kv_blocks, prefix_cache=prefix_cache)
    if mesh is not None:
        rkw["mesh"] = mesh
    runner = (ShardedDecodeRunner if mesh is not None else DecodeRunner)(
        model, params, prompts, max_new_tokens=decode_tokens + 2, max_slots=SLOTS,
        n_slots=BATCH, graphs=graphs, **rkw)
    eng = GenerativeEngine(prof, gcfg, runner, ctl,
                           admission=_admission(admission, admission_slack))
    t0 = time.perf_counter()
    with trace.recording() as spans:
        resp = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0
    timed, window_tokens, runner_s, window_s = _runner_times(spans)
    g = runner.graphs
    graph_stats = ({"eager": g.eagers, "captures": g.captures, "replays": g.replays,
                    "keys": len(g.windows)} if g is not None else None)
    mo = summarize_generative(resp, horizon_ms=eng.makespan_ms)
    out = {
        "mode": "generative", "config": cfg.name, "n": n, "decode_tokens": decode_tokens,
        "prompt_len": prompt_len, "steps_per_sync": steps_per_sync,
        "decode_attn": cfg.decode_attn, "kv_block_size": kv_block_size,
        "kv_blocks": kv_blocks, "prefix_cache": prefix_cache, "preempt": preempt,
        "prefill_chunk": prefill_chunk, "budget": budget, "acc": acc, "load": load,
        "simulated": {
            "note": "engine latencies from the analytic H100 latency profile, not timed",
            "vanilla": mb, "apparate": mo,
            "tpt_p50_win_pct": (
                100.0 * (mb["tpt_p50_ms"] - mo["tpt_p50_ms"]) / mb["tpt_p50_ms"]
                if mb["tpt_p50_ms"] > 0 else 0.0
            ),
            "engine": eng.stats(),
        },
        "measured": {
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            **{k: timed[k] for k in ("prefill_ms_mean", "prefill_chunk_calls",
                                     "prefill_chunk_ms_mean", "window_ms_mean", "windows")},
            "graphs": graph_stats,
            **{f"{kind}_windows": timed[f"{kind}_windows"]
               for kind in ("capture", "replay", "eager")},
            **{f"{kind}_window_ms_mean": timed[f"{kind}_window_ms_mean"]
               for kind in ("capture", "replay", "eager")},
            "decode_steps": runner.decode_steps,
            "decode_tokens": window_tokens,
            "decode_tokens_per_s": window_tokens / max(window_s, 1e-12),
            "runner_s": runner_s,
            "engine_wall_s": wall_s,
        },
        "controller": dict(ctl.stats),
        "active_ramps": list(map(int, ctl.active)),
        "kv_cache": runner.kv_stats(),
    }
    if admission:
        out["admission"] = {"vanilla": base_eng.admission.stats(),
                            "apparate": eng.admission.stats()}
    if trained is not None:
        out["train"] = trained
    if mesh is not None:
        out["mesh"] = {"tp": mesh.tp, "dp": mesh.dp}
    if pp > 1:
        if dist_backend is None:
            raise ValueError("pp > 1 needs dist_backend ('nccl' one card a rank, 'gloo')")
        out["pipeline"] = pipeline_escape_demo(
            config, pp, dist_backend, tiny=tiny, seed=seed, prompts=prompts, n=n,
            prompt_len=prompt_len, n_steps=decode_tokens, device=device)
    if verbose:
        print(json.dumps(out, indent=1, default=float))
    return out, resp


def _serve_rank(rank, world, tp, dp, kw):
    """One rank of a multi-rank ``serve_generative``: its mesh, then the
    same run as every other rank on its shard. Returns (report,
    responses)."""
    from repro_torch.launch.mesh import make_serving_mesh

    if kw["device"] == "cpu":
        torch.set_num_threads(1)
    return serve_generative(**kw, mesh=make_serving_mesh(tp=tp, dp=dp, device=kw["device"]))


def pipeline_escape_demo(config, pp, dist_backend, *, tiny=False, seed=0, prompts=None, n=8,
                         prompt_len=128, n_steps=16, thr=0.6, device="cuda"):
    """The exit-gated pipeline decode window over ``pp`` stage ranks (the
    reference launcher's ``pipeline_escape_demo``): the same window with
    thresholds OFF (every row rides every stage) and ON at ``thr`` (rows
    under a boundary ramp's uncertainty skip the later stages). Each rank
    draws the weights from ``seed``, prefills the batch whole and keeps its
    stage's periods and cache; a TINY config's depth rounds up to whole
    stages. Returns each stage's work for both, from rank 0."""
    from repro_torch.launch.mesh import spawn

    return spawn(_pipeline_rank, pp, dist_backend, device=device,
                 args=(config, tiny, seed, prompts, n, prompt_len, n_steps, thr, str(device)))[0]


def _pipeline_rank(rank, world, config, tiny, seed, prompts, n, prompt_len, n_steps, thr,
                   device):
    from repro_torch.distributed.pipeline import pipeline_decode_window, stage_shard
    from repro_torch.launch.mesh import make_serving_mesh

    mesh = make_serving_mesh(pp=world, device=device)
    device = mesh.device
    if device.type == "cpu":
        torch.set_num_threads(1)
    # the pipeline reads the contiguous slot cache through the dense heads
    cfg = (get_tiny if tiny else get_config)(config).replace(decode_attn="kernel",
                                                             pallas_head="off")
    if tiny:  # a TINY stack (3 layers) rounded up to whole stages
        cfg = cfg.replace(n_layers=-(-cfg.n_layers // world) * world)
    model = build_model(cfg, prefill_attn="kernel")
    params = model.init(seed, device=device)
    if prompts is None:
        prompts = np.random.default_rng(seed).integers(1, cfg.vocab_size, (n, prompt_len))
    pp = mesh.pp
    B = max(pp, (min(8, len(prompts)) // pp) * pp)
    toks = torch.as_tensor(np.asarray(prompts)[:B], dtype=torch.int64, device=device)
    S = toks.shape[1]
    cache, outs = model.prefill(params, toks, cache_len=S + n_steps + 1)
    # keep the stage's periods only: the rest of the weights and cache go
    params = stage_shard(params, mesh.stage, pp)
    params["blocks"] = tree_map(torch.clone, params["blocks"])
    cache = tree_map(torch.clone, stage_shard(cache, mesh.stage, pp))
    last = outs["final"]["label"].reshape(B, 1).to(torch.int64)
    pos = torch.full((B,), S, dtype=torch.int64, device=device)
    sites, nsl = list(model.sites), len(model.plan.period)
    bounds = [(s + 1) * (model.plan.n_periods // pp) * nsl - 1 for s in range(pp - 1)]
    act = [sites.index(b) for b in bounds if b in sites]
    _, _, _, _, st_off = pipeline_decode_window(model, params, tree_map(torch.clone, cache),
                                                last, pos, n_steps, mesh=mesh)
    kw = dict(active_sites=act, thresholds=[thr] * len(act)) if act else {}
    _, _, exit_rec, alive, st_on = pipeline_decode_window(model, params, cache, last, pos,
                                                          n_steps, mesh=mesh, **kw)
    st_off, st_on = st_off.cpu(), st_on.cpu()
    return {
        "stages": pp, "n_layers": cfg.n_layers, "batch": B, "n_steps": n_steps, "threshold": thr,
        "boundary_sites": act,
        "stage_steps_no_exit": [int(x) for x in st_off],
        "stage_steps_exit": [int(x) for x in st_on],
        "rows_exited": int(B - int(alive.sum())),
        "exits_recorded": int((exit_rec >= 0).sum()),
        "later_stage_work_saved_pct": (
            100.0 * (1.0 - float(st_on[1:].sum()) / float(st_off[1:].sum()))
            if pp > 1 and float(st_off[1:].sum()) else 0.0),
    }


def _train_report(logs, wall_s, steps, lr):
    return {"steps": steps, "lr": lr, "losses": [r["loss"] for r in logs],
            "ramp_losses": [r["ramp_loss"] for r in logs if "ramp_loss" in r],
            "wall_s": wall_s}


def _train_generative(model, n, prompt_len, seed, device):
    """The reference launcher's generative recipe: 300 steps at lr 3e-3, 32
    rows a step drawn by ``default_rng(step)`` from a decode stream of
    ``max(2n, 256)`` rows of ``prompt_len + 1`` tokens (tokens and their
    next tokens); the served prompts are the stream's first ``n`` rows.
    Returns (params, prompts, report)."""
    from repro_torch.training import TrainConfig, train

    stream = make_decode_stream(max(2 * n, 256), seq_len=prompt_len + 1,
                                vocab=model.cfg.vocab_size, predict=0.96, seed=seed)

    def batches(s):
        rng = np.random.default_rng(s)
        toks = stream.data[rng.integers(0, len(stream.data), 32)].astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    tcfg = TrainConfig(steps=300, lr=3e-3, log_every=1)
    t0 = time.perf_counter()
    state, logs = train(model, batches, tcfg, verbose=False, device=device)
    report = _train_report(logs, time.perf_counter() - t0, tcfg.steps, tcfg.lr)
    return state["params"], stream.data[:n, :prompt_len], report


IMG_SIZE = 224  # ResNet images: the reference launcher's CV profile size
NLP_SEQ = 32  # BERT: the reference launcher's NLP stream
LM_CONTEXT = 128  # next-token serving: a context's tokens


# the reference launcher's training recipe by family: (lr, steps); 64 items
# a step drawn by default_rng(step) from the bootstrap split
TRAIN_RECIPE = {"resnet": (3e-3, 150), "encoder_cls": (1e-3, 200)}
TRAIN_CLASSES = 10
CKPT_EVERY = 50  # training steps between checkpoints (with ckpt_dir)


def serve(config="resnet50", n=600, *, policy="tfserve", budget=0.02, acc=0.99, load=0.5,
          seed=2, slots=6, workers=1, dispatch="jsq", admission=False, admission_slack=1.0,
          tiny=False, device="cuda", params=None, verbose=True, train=False, ckpt_dir=None):
    """Classification serving on the real model, the reference launcher's
    ``serve()``: a drifting synthetic stream (a video trace of images for a
    ResNet, MAF arrivals of token sequences for BERT or an LM's next token)
    served by the cluster engine with ``workers`` replicas behind
    ``dispatch``, batched by ``policy`` (``max_batch_size`` 8, timeout one
    vanilla batch-1 time), SLO twice that; vanilla (no ramps, simulated
    only) against Apparate (one controller a worker, the runner on the
    device), and the agreement of the released labels with the model's own
    (``vanilla_labels``). ``admission`` sheds hopeless requests
    (``AdmissionPolicy``, deadlines stretched by ``admission_slack``).

    A ResNet serves 224 px images in f32, BERT a 32-token stream, an LM the
    next token of 128-token contexts; BERT's attention and an LM's prefill
    run the flash-attention kernel, an LM's heads the ramp-head kernel.
    ``tiny`` serves the config's TINY variant at its own sizes (CPU tests).
    ``params`` reuses weights already drawn with ``seed``; without
    ``train`` all ``n`` items are served.

    ``train`` first trains the whole model (from the TrainConfig's seed 0,
    as the reference launcher does) with the reference launcher's recipe
    (``TRAIN_RECIPE``, 10 classes) on the bootstrap split, the first
    ``max(n // 10, 256)`` items, then serves the rest and reports the
    agreement over them; ``ckpt_dir`` writes a checkpoint every
    ``CKPT_EVERY`` steps there meanwhile; ``report["train"]`` holds every
    step's losses. Returns (summary, responses)."""
    device = _cuda_or_cpu(device, "serve")
    cfg = (get_tiny if tiny else get_config)(config)
    if train:
        if cfg.family not in TRAIN_RECIPE:
            raise ValueError(f"{cfg.name}: serve(train=True) takes a resnet or an "
                             "encoder_cls config (the reference's recipes)")
        if params is not None:
            raise ValueError("train=True draws its own weights")
        cfg = cfg.replace(n_classes=TRAIN_CLASSES)
    if cfg.family == "resnet":
        cfg = cfg if tiny else cfg.replace(img_size=IMG_SIZE)
        model = build_model(cfg)
        stream = make_image_stream(n, img_size=cfg.img_size, n_classes=cfg.n_classes,
                                   mode="cv", seed=seed)
        runner_cls = ClassifierRunner
    elif cfg.family in ("encoder_cls", "lm"):
        if cfg.family == "lm":
            cfg = cfg.replace(pallas_head="kernel")
        model = build_model(cfg, prefill_attn="kernel")
        seq = NLP_SEQ if cfg.family == "encoder_cls" else LM_CONTEXT
        stream = make_token_stream(n, seq_len=seq, vocab=cfg.vocab_size,
                                   n_classes=max(cfg.n_classes, 2), mode="nlp", seed=seed)
        runner_cls = ClassifierRunner if cfg.family == "encoder_cls" else LMTokenRunner
    else:
        raise ValueError(f"{cfg.name}: classification serving takes a resnet, an "
                         "encoder_cls or an lm config")
    boot, trained = 0, None
    if train:
        boot = max(n // 10, 256)
        params, trained = _train_classifier(model, stream, boot, device, ckpt_dir)
    if params is None:
        params = model.init(seed, device=device)
    runner = runner_cls(model, params, stream.data, max_slots=slots)
    prof = build_profile(cfg, mode="decode", chips=1, sites=model.sites)
    exec1 = prof.vanilla_time(1)
    n_serve = n - boot
    # the offered load scales with the cluster: each replica sees ~`load`
    if cfg.family == "resnet":
        arrivals = video_trace(n_serve, fps=workers * load * 1000.0 / exec1)
    else:
        arrivals = maf_trace(n_serve, mean_qps=workers * load * 1000.0 / exec1, seed=seed)
    reqs = make_requests(arrivals, slo_ms=2 * exec1,
                         items=np.arange(boot, n) if boot else None)
    pf = PlatformConfig(policy=policy, max_batch_size=8, batch_timeout_ms=exec1)

    def cluster():
        return ClusterConfig(n_workers=workers, dispatch=dispatch, platform=pf,
                             admission=_admission(admission, admission_slack))

    base_sim = ClusterSimulator(prof, cluster())
    base = base_sim.run(reqs)
    ccfg = ControllerConfig(max_slots=slots, ramp_budget_frac=budget, acc_constraint=acc)
    ctls = [ApparateController(len(model.sites), prof, ccfg) for _ in range(workers)]
    sim = ClusterSimulator(prof, cluster(), runner=runner, controllers=ctls)
    t0 = time.perf_counter()
    with trace.recording() as spans:
        resp = sim.run(reqs)
    wall_s = time.perf_counter() - t0
    served = {}  # bucket -> [seconds] of each ``infer``, which ends in a host read
    for sp in spans:
        if sp.name == "runner/infer":
            served.setdefault(sp.attrs["bucket"], []).append(1e-9 * (sp.t1 - sp.t0))
    served = dict(sorted(served.items()))
    van = runner.vanilla_labels(n)
    live = [r for r in resp if not r.dropped]
    agree = float(np.mean([r.label == van[boot + r.rid] for r in live])) if live else 0.0
    rep_b = summarize_cluster(base, horizon_ms=base_sim.makespan_ms, n_workers=workers)
    rep_o = summarize_cluster(resp, horizon_ms=sim.makespan_ms, n_workers=workers)
    mb, mo = rep_b["aggregate"], rep_o["aggregate"]
    out = {
        "mode": "classification", "config": cfg.name, "n": n, "served": n_serve,
        "policy": policy,
        "workers": workers, "dispatch": dispatch,
        "simulated": {
            "note": "latencies from the analytic H100 latency profile, not timed",
            "vanilla": mb, "apparate": mo, "wins": savings_vs(mb, mo),
        },
        "accuracy": agree,
        "measured": {
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "infer_ms_by_bucket": {b: 1e3 * float(np.mean(ts)) for b, ts in served.items()},
            "infer_calls_by_bucket": {b: len(ts) for b, ts in served.items()},
            "ramp_set_variants": runner.compiles,
            "noramp_variants": runner.noramp_compiles,
            "runner_s": float(sum(map(sum, served.values()))),
            "engine_wall_s": wall_s,
        },
        "controllers": [dict(c.stats) for c in ctls],
        "active_ramps": [list(map(int, c.active)) for c in ctls],
    }
    if admission:
        out["admission"] = {"vanilla": base_sim.cfg.admission.stats(),
                            "apparate": sim.cfg.admission.stats()}
    if workers > 1:
        out["per_worker"] = rep_o["workers"]
        out["worker_stats"] = sim.worker_stats()
    if trained is not None:
        out["train"] = trained
    if verbose:
        print(json.dumps(out, indent=1, default=float))
    return out, resp


def bootstrap_batches(stream, boot, key):
    """The reference launcher's training batches: 64 items a step drawn by
    ``default_rng(step)`` from the first ``boot`` items of ``stream``."""
    def batches(s):
        rng = np.random.default_rng(s)
        idx = rng.integers(0, boot, 64)
        return {key: stream.data[idx], "labels": stream.labels[idx]}

    return batches


def _train_classifier(model, stream, boot, device, ckpt_dir):
    """Train the whole model (TrainConfig 'full', as the reference launcher
    does) with its family's recipe on the bootstrap split. Returns
    (params, report)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.training import TrainConfig, train

    lr, steps = TRAIN_RECIPE[model.cfg.family]
    key = "images" if model.cfg.family == "resnet" else "tokens"
    tcfg = TrainConfig(steps=steps, lr=lr, log_every=1,
                       checkpoint_every=CKPT_EVERY if ckpt_dir else 0)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    t0 = time.perf_counter()
    state, logs = train(model, bootstrap_batches(stream, boot, key), tcfg,
                        checkpoint_mgr=mgr, verbose=False, device=device)
    report = _train_report(logs, time.perf_counter() - t0, steps, lr)
    report["bootstrap"] = boot
    return state["params"], report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="generative", choices=["generative", "classification"])
    ap.add_argument("--config", default=None,
                    choices=["qwen2-1.5b", "gpt2-medium", "deepseek-v2-lite-16b",
                             "mamba2-2.7b", "gemma3-4b", "qwen3-moe-30b-a3b",
                             "llama-3.2-vision-90b", "jamba-1.5-large-398b", "qwen1.5-32b",
                             "deepseek-67b", "resnet18", "resnet50", "bert-base"],
                    help="default: qwen2-1.5b (generative), resnet50 (classification); "
                         "classification also serves an LM's next token")
    ap.add_argument("--tiny", action="store_true", help="the config's TINY variant")
    ap.add_argument("--n", type=int, default=None,
                    help="requests (default: 8 generative, 600 classification)")
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps-per-sync", type=int, default=4,
                    help="decode steps per controller sync (one host read per window)")
    ap.add_argument("--seed", type=int, default=None,
                    help="weights, data and arrivals (default: 0 generative, 2 "
                         "classification, the reference launcher's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kv-block-size", type=int, default=0,
                    help=">0 pages the decode KV cache into blocks of this many tokens "
                         "(0 = contiguous rows)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="total paged KV pool blocks (default: full slot capacity)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged: share cached prompt-prefix blocks across slots "
                         "(refcount + copy-on-write); a repeated prompt skips its prefill")
    ap.add_argument("--preempt", default="none", choices=["none", "swap", "shed"],
                    help="paged: pool-exhaustion reaction: swap a victim's KV to the host "
                         "and readmit it later, shed it, or raise")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help=">0 prefills each prompt in chunks of this many tokens, "
                         "interleaved with decode steps (0 = one-shot prefill)")
    ap.add_argument("--admission", action="store_true",
                    help="SLO-aware admission: drop hopeless requests at admission; "
                         "generative mode also sheds doomed slots mid-stream")
    ap.add_argument("--admission-slack", type=float, default=1.0,
                    help="deadline slack multiplier for --admission")
    ap.add_argument("--policy", default="tfserve", choices=["tfserve", "clockwork"],
                    help="classification: batch formation")
    ap.add_argument("--workers", type=int, default=1, help="classification: replicas")
    ap.add_argument("--dispatch", default="jsq", choices=["round_robin", "jsq", "slo_aware"],
                    help="classification: how requests are routed to replicas")
    ap.add_argument("--train", action="store_true",
                    help="train first (the reference launcher's recipe; classification "
                         "serves the items past the bootstrap split)")
    ap.add_argument("--budget", type=float, default=None,
                    help="the controller's ramp-overhead budget, a fraction of a vanilla "
                         f"step (default: {BUDGET} generative, 0.02 classification)")
    ap.add_argument("--acc", type=float, default=ACC, help="agreement constraint")
    ap.add_argument("--load", type=float, default=LOAD,
                    help="offered load, a fraction of one replica's capacity")
    ap.add_argument("--runtime-preset", default="none", choices=["none"] + sorted(PRESETS),
                    help="apply an allocator/device env preset before CUDA starts (see "
                         "repro_torch.launch.tuning; variables already exported win)")
    ap.add_argument("--tp", type=int, default=1,
                    help="generative: tensor-parallel degree: decode through "
                         "ShardedDecodeRunner on a (data, model) mesh of tp*dp ranks, each "
                         "holding 1/tp of the KV cache")
    ap.add_argument("--dp", type=int, default=1,
                    help="generative: data-parallel degree of the decode mesh (contiguous "
                         "KV only)")
    ap.add_argument("--pp", type=int, default=1,
                    help="generative: >1 adds an exit-gated pipeline decode window demo over "
                         "this many stage ranks (reports per-stage work saved)")
    ap.add_argument("--mesh-shape", default=None, metavar="DPxTP",
                    help="generative: '<dp>x<tp>' shorthand that overrides --dp/--tp "
                         "(e.g. '1x4', '2x2')")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend of a multi-rank run: 'nccl' one card a "
                         "rank, 'gloo' for ranks that share a card or run on the CPU "
                         "(required with --tp, --dp or --pp > 1)")
    a = ap.parse_args(argv)
    if a.mesh_shape:
        try:
            a.dp, a.tp = (int(x) for x in a.mesh_shape.lower().split("x"))
        except ValueError:
            ap.error("--mesh-shape must look like '<dp>x<tp>', e.g. 1x4")
    if max(a.tp, a.dp, a.pp) > 1 and a.dist_backend is None:
        ap.error("--tp/--dp/--pp > 1 need --dist-backend nccl|gloo")
    # env presets must land before anything in the run touches CUDA
    wrote = apply_preset(a.runtime_preset)
    if a.runtime_preset != "none":
        print(f"runtime preset {a.runtime_preset}: wrote {json.dumps(wrote)}", flush=True)
    if a.mode == "classification":
        serve(a.config or "resnet50", 600 if a.n is None else a.n, policy=a.policy,
              budget=0.02 if a.budget is None else a.budget, acc=a.acc, load=a.load,
              seed=2 if a.seed is None else a.seed, workers=a.workers, dispatch=a.dispatch,
              admission=a.admission, admission_slack=a.admission_slack, tiny=a.tiny,
              device=a.device, train=a.train)
        return
    serve_generative(a.config or "qwen2-1.5b", 8 if a.n is None else a.n,
                     decode_tokens=a.decode_tokens, prompt_len=a.prompt_len,
                     steps_per_sync=a.steps_per_sync, seed=0 if a.seed is None else a.seed,
                     tiny=a.tiny, device=a.device, kv_block_size=a.kv_block_size,
                     kv_blocks=a.kv_blocks, prefix_cache=a.prefix_cache, preempt=a.preempt,
                     prefill_chunk=a.prefill_chunk, admission=a.admission,
                     admission_slack=a.admission_slack, train=a.train,
                     budget=BUDGET if a.budget is None else a.budget, acc=a.acc, load=a.load,
                     tp=a.tp, dp=a.dp, pp=a.pp, dist_backend=a.dist_backend)


if __name__ == "__main__":
    main()
