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
  # classification: ResNet-50 at 224 px (f32), BERT-base (its attention on
  # the flash-attention kernel) or qwen2-1.5b's next token
  PYTHONPATH=src python -m repro_torch.launch.serve --mode classification \\
      --config resnet50 --n 600 --workers 2 --dispatch jsq --admission
  # train on the bootstrap split first (the reference launcher's recipe)
  PYTHONPATH=src python -m repro_torch.launch.serve --mode classification \\
      --config bert-base --n 600 --train

Prefills run the port's prefill kernels: flash attention for the attention
models' whole prompts, the SSD chunk scan for Mamba2's.

The engine's latencies (TTFT, TPT, response latencies, the
vanilla-vs-Apparate wins) are SIMULATED from the analytic H100 latency
profile, as in the JAX package; the ``measured`` block holds host wall
times of the runner's calls on the device, each of which ends in a host
read of its result. Weights: the config's drawn from ``--seed`` (or a
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

from repro_torch.configs import get_config, get_tiny
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
    make_gen_requests,
    make_requests,
    maf_trace,
    offered_decode_qps,
    savings_vs,
    summarize_cluster,
    summarize_generative,
    video_trace,
)
from repro_torch.serving.runner import _bucket


class _TimedRunner(DecodeRunner):
    """``DecodeRunner`` that records the host wall time of each one-shot
    prefill, each prefill chunk and each sync window, and whether a window
    captured its CUDA graph, replayed it or ran eager. Each call ends in a
    host read of a device result (a chunk that only shares cached blocks
    does no device work), so the time covers the device work."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.prefill_s, self.chunk_s, self.window_s, self.window_tokens = [], [], [], 0
        self.window_kind = []  # "capture" | "replay" | "eager", one a window

    def start(self, slot, item):
        t0 = time.perf_counter()
        tok = super().start(slot, item)
        self.prefill_s.append(time.perf_counter() - t0)
        return tok

    def prefill_begin(self, slot, item, n_tokens):
        t0 = time.perf_counter()
        tok = super().prefill_begin(slot, item, n_tokens)
        self.chunk_s.append(time.perf_counter() - t0)
        return tok

    def prefill_resume(self, slot, n_tokens):
        t0 = time.perf_counter()
        tok = super().prefill_resume(slot, n_tokens)
        self.chunk_s.append(time.perf_counter() - t0)
        return tok

    def step_multi(self, slots, active, n_steps, thresholds):
        t0 = time.perf_counter()
        out = super().step_multi(slots, active, n_steps, thresholds)
        self.window_s.append(time.perf_counter() - t0)
        self.window_tokens += out[2].size
        self.window_kind.append("eager" if self.graphs is None else self.graphs.last)
        return out

    def window_ms(self, kind):
        """Mean host ms of the windows of one kind (0.0 without any)."""
        ts = [t for t, k in zip(self.window_s, self.window_kind) if k == kind]
        return 1e3 * float(np.mean(ts)) if ts else 0.0


class _TimedInfer:
    """A classification runner that records the host wall time of each
    ``infer`` by bucket. Each call ends in a host read of its records, so
    the time covers the device work."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.infer_s = {}  # bucket -> [seconds]

    def infer(self, items, active):
        t0 = time.perf_counter()
        out = super().infer(items, active)
        self.infer_s.setdefault(_bucket(len(items)), []).append(time.perf_counter() - t0)
        return out


class _TimedClassifier(_TimedInfer, ClassifierRunner):
    pass


class _TimedLMToken(_TimedInfer, LMTokenRunner):
    pass


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
                     admission=False, admission_slack=1.0, train=False):
    """Vanilla (no-EE, simulated only) vs Apparate per-token exits served on
    the real model at the same accuracy constraint. ``tiny`` serves the
    config's TINY variant (CPU tests). Returns (summary, responses).

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
    trained weights; ``report["train"]`` holds the losses."""
    if prefix_cache and not kv_block_size:
        raise ValueError("--prefix-cache requires --kv-block-size > 0 (paged KV)")
    if preempt != "none" and not kv_block_size:
        raise ValueError("--preempt requires --kv-block-size > 0 (paged KV)")
    device = _cuda_or_cpu(device, "serve_generative")
    cfg = (get_tiny if tiny else get_config)(config).replace(
        decode_attn="paged-kernel" if kv_block_size else "kernel", pallas_head="kernel")
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
        params = model.init(seed, device=device)
    if prompts is None:
        prompts = np.random.default_rng(seed).integers(1, cfg.vocab_size, (n, prompt_len))
    n, prompt_len = np.shape(prompts)
    prof = build_profile(cfg, mode="decode", chips=1, sites=model.sites, charge_kv=True)
    qps = offered_decode_qps(prof, max_batch_size=BATCH, tokens_per_request=decode_tokens,
                             load=LOAD)
    reqs = make_gen_requests(maf_trace(n, mean_qps=qps, seed=seed), n_tokens=decode_tokens,
                             prompt_len=prompt_len, slo_ms=3 * prof.vanilla_time(1))
    gcfg = GenerativeConfig(max_batch_size=BATCH, steps_per_sync=steps_per_sync,
                            prefill_chunk=prefill_chunk, preempt=preempt)
    base_eng = GenerativeEngine(prof, gcfg, admission=_admission(admission, admission_slack))
    mb = summarize_generative(base_eng.run(reqs), horizon_ms=base_eng.makespan_ms)
    ctl = ApparateController(len(model.sites), prof, ControllerConfig(
        max_slots=SLOTS, ramp_budget_frac=BUDGET, acc_constraint=ACC))
    rkw = {}
    if kv_block_size:
        rkw = dict(kv_block_size=kv_block_size, kv_blocks=kv_blocks, prefix_cache=prefix_cache)
    runner = _TimedRunner(model, params, prompts, max_new_tokens=decode_tokens + 2,
                          max_slots=SLOTS, n_slots=BATCH, graphs=graphs, **rkw)
    eng = GenerativeEngine(prof, gcfg, runner, ctl,
                           admission=_admission(admission, admission_slack))
    t0 = time.perf_counter()
    resp = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0
    g = runner.graphs
    graph_stats = ({"eager": g.eagers, "captures": g.captures, "replays": g.replays,
                    "keys": len(g.windows)} if g is not None else None)
    mo = summarize_generative(resp, horizon_ms=eng.makespan_ms)
    dev_s = sum(runner.prefill_s) + sum(runner.chunk_s) + sum(runner.window_s)
    out = {
        "mode": "generative", "config": cfg.name, "n": n, "decode_tokens": decode_tokens,
        "prompt_len": prompt_len, "steps_per_sync": steps_per_sync,
        "decode_attn": cfg.decode_attn, "kv_block_size": kv_block_size,
        "kv_blocks": kv_blocks, "prefix_cache": prefix_cache, "preempt": preempt,
        "prefill_chunk": prefill_chunk,
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
            "prefill_ms_mean": 1e3 * float(np.mean(runner.prefill_s)) if runner.prefill_s else 0.0,
            "prefill_chunk_calls": len(runner.chunk_s),
            "prefill_chunk_ms_mean": 1e3 * float(np.mean(runner.chunk_s)) if runner.chunk_s else 0.0,
            "window_ms_mean": 1e3 * float(np.mean(runner.window_s)) if runner.window_s else 0.0,
            "windows": len(runner.window_s),
            "graphs": graph_stats,
            **{f"{kind}_windows": runner.window_kind.count(kind)
               for kind in ("capture", "replay", "eager")},
            **{f"{kind}_window_ms_mean": runner.window_ms(kind)
               for kind in ("capture", "replay", "eager")},
            "decode_steps": runner.decode_steps,
            "decode_tokens": runner.window_tokens,
            "decode_tokens_per_s": runner.window_tokens / max(sum(runner.window_s), 1e-12),
            "runner_s": dev_s,
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
    if verbose:
        print(json.dumps(out, indent=1, default=float))
    return out, resp


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
        runner_cls = _TimedClassifier
    elif cfg.family in ("encoder_cls", "lm"):
        if cfg.family == "lm":
            cfg = cfg.replace(pallas_head="kernel")
        model = build_model(cfg, prefill_attn="kernel")
        seq = NLP_SEQ if cfg.family == "encoder_cls" else LM_CONTEXT
        stream = make_token_stream(n, seq_len=seq, vocab=cfg.vocab_size,
                                   n_classes=max(cfg.n_classes, 2), mode="nlp", seed=seed)
        runner_cls = _TimedClassifier if cfg.family == "encoder_cls" else _TimedLMToken
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
    resp = sim.run(reqs)
    wall_s = time.perf_counter() - t0
    served = {b: list(ts) for b, ts in sorted(runner.infer_s.items())}
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
                             "mamba2-2.7b", "resnet18", "resnet50", "bert-base"],
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
    a = ap.parse_args(argv)
    if a.mode == "classification":
        serve(a.config or "resnet50", 600 if a.n is None else a.n, policy=a.policy,
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
                     admission_slack=a.admission_slack, train=a.train)


if __name__ == "__main__":
    main()
