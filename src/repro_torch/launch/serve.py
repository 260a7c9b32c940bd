"""Generative serving launcher of the port: Apparate's per-token early exits
on a decoder LM with seeded random weights, driven by the continuous-
batching engine, on the CUDA card.

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

Prefills run the port's prefill kernels: flash attention for the attention
models' whole prompts, the SSD chunk scan for Mamba2's.

The engine's latencies (TTFT, TPT, the vanilla-vs-Apparate wins) are
SIMULATED from the analytic H100 latency profile, as in the JAX package;
the ``measured`` block holds host wall times of the runner's calls on the
device, each of which ends in a host read of its result.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_tiny
from repro_torch.core import ApparateController, ControllerConfig, build_profile
from repro_torch.models import build_model
from repro_torch.serving import (
    DecodeRunner,
    GenerativeConfig,
    GenerativeEngine,
    make_gen_requests,
    maf_trace,
    offered_decode_qps,
    summarize_generative,
)


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
                     prefill_chunk=0, prompts=None, params=None, graphs=None):
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
    or eager (False)."""
    if prefix_cache and not kv_block_size:
        raise ValueError("--prefix-cache requires --kv-block-size > 0 (paged KV)")
    if preempt != "none" and not kv_block_size:
        raise ValueError("--preempt requires --kv-block-size > 0 (paged KV)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve_generative: no CUDA device (pass device='cpu' to "
                           "run the plain versions on the CPU)")
    # fp32 matmuls stay full fp32 on the card (never TF32), so fp32 runs
    # compare with the reference at fp32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = (get_tiny if tiny else get_config)(config).replace(
        decode_attn="paged-kernel" if kv_block_size else "kernel", pallas_head="kernel")
    if cfg.mla:
        # the paged MLA kernel takes the absorbed (latent-space) decode; both
        # layouts run it, so they compute the same math
        cfg = cfg.replace(mla_absorbed=True)
    model = build_model(cfg, prefill_attn="kernel", ssd_impl="kernel")
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
    base_eng = GenerativeEngine(prof, gcfg)
    mb = summarize_generative(base_eng.run(reqs), horizon_ms=base_eng.makespan_ms)
    ctl = ApparateController(len(model.sites), prof, ControllerConfig(
        max_slots=SLOTS, ramp_budget_frac=BUDGET, acc_constraint=ACC))
    rkw = {}
    if kv_block_size:
        rkw = dict(kv_block_size=kv_block_size, kv_blocks=kv_blocks, prefix_cache=prefix_cache)
    runner = _TimedRunner(model, params, prompts, max_new_tokens=decode_tokens + 2,
                          max_slots=SLOTS, n_slots=BATCH, graphs=graphs, **rkw)
    eng = GenerativeEngine(prof, gcfg, runner, ctl)
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
    if verbose:
        print(json.dumps(out, indent=1, default=float))
    return out, resp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="qwen2-1.5b",
                    choices=["qwen2-1.5b", "gpt2-medium", "deepseek-v2-lite-16b",
                             "mamba2-2.7b"])
    ap.add_argument("--tiny", action="store_true", help="the config's TINY variant")
    ap.add_argument("--n", type=int, default=8, help="requests")
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps-per-sync", type=int, default=4,
                    help="decode steps per controller sync (one host read per window)")
    ap.add_argument("--seed", type=int, default=0, help="weights, prompts and arrivals")
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
    a = ap.parse_args(argv)
    serve_generative(a.config, a.n, decode_tokens=a.decode_tokens, prompt_len=a.prompt_len,
                     steps_per_sync=a.steps_per_sync, seed=a.seed, tiny=a.tiny,
                     device=a.device, kv_block_size=a.kv_block_size, kv_blocks=a.kv_blocks,
                     prefix_cache=a.prefix_cache, preempt=a.preempt,
                     prefill_chunk=a.prefill_chunk)


if __name__ == "__main__":
    main()
