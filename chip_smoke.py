#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py            # from the repository root

Phases, in order; any failure exits non-zero and prints no result line:
  1. a CUDA card is required; print its name and power limit;
  2. build every CUDA kernel of the main path with nvcc (ptxas report);
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, and time kernel, plain version and one PyTorch
     library call (CUDA events, L2 flushed between launches); the decode
     rows also read the device alone, the wrapper's host time, the key-axis
     split and an occupancy probe (CTAs, CTAs an SM, DRAM rate) that stands
     in for Nsight Compute;
     3b. the paged decode kernel against its plain version, and bit for bit
     against the contiguous kernel on the same keys;
  4. full-width qwen2-1.5b with seeded random weights: prefill + 8 decode
     steps with the kernels off and on, the prefill through sdpa and through
     the flash-attention kernel (labels equal except near-ties),
     then serve 8 requests through the port's GenerativeEngine +
     ApparateController + DecodeRunner on the contiguous cache;
     4b. the same engine on the contiguous cache and on the paged pool, on
     one schedule: greedy tokens equal except differences that begin at a
     near-tie (by the dense path's logits);
     4c. prefix sharing and swap preemption on a pool that runs dry;
     4d. chunked prefill on the paged pool, first tokens held against
     one-shot prefill;
     4e. one sync window as one CUDA graph replay, on both layouts: the
     same windows through a graphed and an eager runner (the graphed one's
     first eager, its second captured, its third replayed) give records,
     n_done and cache leaves equal bit for bit, the graph's kernel nodes
     equal the eager window's launches (the paged MLA combine keeps its
     programmatic edge), host ms per replayed vs eager window, device-busy
     ms per window, aten ops per replayed window, the graph pool's bytes;
     then one schedule served graphed and eager, tokens equal except
     near-ties;
  3c. (run beside 3 and 3b) the paged MLA kernel against its plain version
     at DeepSeek-V2-Lite's served shape and on 4096-token rows;
  3d. the flash-attention (prefill) kernel against its plain version at
     qwen2-1.5b's served prefill and on a 4096-token causal prompt;
  3e. the SSD chunk-scan kernel against its plain version at Mamba2-2.7B's
     served prefill (two chunks), a ragged 120-step prompt and 4096 steps;
  3f. the flash-attention kernel with no mask against its plain version at
     BERT-base's served shape (8 x 32 tokens, 12 heads of 64) and on one
     512-token row;
  4f. (after 4e, on qwen2-1.5b's weights) next-token serving through
     LMTokenRunner: 8 contexts of 128 tokens with 4 active ramps and none,
     kernels on vs off (labels equal except near-ties), then 64 requests
     through the launcher's classification serve() on the cluster engine;
  5. full-width DeepSeek-V2-Lite (MLA + MoE, absorbed MLA) with seeded
     random weights, once qwen2-1.5b's are freed: the ramp-head kernels at
     its d 2048 and V 102400; 5a. prefill + 8 decode steps on the paged
     pool with the kernels off and on; 5b-5d on its first 7 of 27 layers
     (``SERVE_DEPTH``): 5b. contiguous rows vs the paged pool on one
     schedule (the paged MLA kernel in every layer of every decode step),
     the paged run on the contiguous run's MoE routing, then both
     layouts' aten ops a window counted (eager) and their times taken
     without hooks; 5c. swap preemption on a pool that runs dry; 5d. as 4e;
  6. full-width Mamba2-2.7B with seeded random weights, once DeepSeek's are
     freed: the ramp-head kernels at its d 2560 and V 51200, one layer's
     plain recurrent state update timed; 6a. prefill (the SSD kernel) + 8
     decode steps with the kernels off and on; 6b-6d on its first 7 of 64
     layers: 6b. contiguous state rows vs state pages on one schedule; 6c. swap of state
     pages on a pool that runs dry; 6d. as 4e.
  7. the paper's classifiers, once Mamba2-2.7B's weights are freed, with
     seeded random weights: 7a. ResNet-50 at 224 px in f32 (TF32 off): the
     card's forward against the CPU forward of the same weights on 2
     images, ClassifierRunner at buckets 1-8 with 0 and 4 ramps (host ms,
     device-busy ms, the FLOP count), then 600 requests served with and
     without admission; 7b. BERT-base in bf16: the runner through sdpa vs
     the flash kernel, then 600 requests served through the kernel (12
     launches a forward). Their engine latencies are SIMULATED.
  3 (beside the ramp-head rows) the 'mlp' and 'tied' ramp styles' records
     through kernels #2/#3 against the dense path at qwen2-1.5b's shape;
  8. training on the card, once the classifiers' weights are freed: 8a.
     full-width qwen2-1.5b ramps_only training through the launcher
     (8 steps, batch 4 x 128; ms a step, losses, peak memory against the
     memory reckoned from shapes; the backbone bit-identical to the seed's
     draw; the ramp loss on step 0's batch falls), then 4 decode steps of
     8 TokenPipeline rows with the trained ramps, kernels on vs off; 8b.
     full-width BERT-base trained with the reference launcher's recipe on
     its bootstrap split (checkpoints every 50 steps, async), steps
     100-199 rerun from step 100's checkpoint against the uninterrupted
     run, then the rest of the stream served through kernel #4 (exit
     share and agreement beside 7b's random weights). The loss paths reach
     no kernel: the kernel dispatchers raise under autograd.
  9. full-width Gemma3-4B (34 layers: 29 local with a 1024-token window, 5
     global; d 2560, 8 heads on 4 of 256, qk-norm, a tied 262144-token
     vocab) with seeded random bf16 weights, once the trained models are
     freed, on prompts of 1100 tokens (every ring wraps in the prefill):
     9a. #1 and #5 at hd 256, #4 with the window and causal, #2/#3 on the
     tied embed^T and a ramp head, each against its plain version; the
     local decode window's plain gather timed; the step's byte floor;
     9b. the prefill through sdpa vs the flash kernel, then 40 decode
     steps with the kernels off vs on (labels equal except near-ties), one
     eager step profiled; 9c-9d on its first 7 of 34 layers
     (``SERVE_DEPTH``): 9c. 8 requests x 38 tokens on the full cache, on
     windowed_cache rings and on the paged pool (ring pages), then one on
     the pool with a 1060-token first chunk and 40 resumed tokens: greedy
     tokens equal except from a near-tie; a prefix cache refused; 9d. as
     4e.
  10. full-width Qwen3-MoE-30B-A3B, whole (48 layers of attention + MoE: d
     2048, 32 heads on 4 of 128, qk-norm, 128 experts top-8; 68.65 GB of
     bf16 weights) with seeded random weights, once Gemma3's are freed:
     10a. #1 and #5 at GQA group 8, #4 causal at 8 x 128, #2/#3 at d 2048 x
     V 153600, each against its plain version; the step's byte floor with
     the dense dispatch and with only the experts its routing touched;
     10b. a prefill through sdpa vs the flash kernel, then 8 decode steps
     with the kernels off vs on (MoE routing replayed), one eager step
     profiled; 10c-10d on its first 7 layers: 10c. 8 requests on
     contiguous rows and on the pool (its run on the contiguous run's
     routing), then prefix sharing, copy-on-write and swap on a 24-block
     pool; 10d. as 4e.
  11. full-width Llama-3.2-Vision-90B at one period's depth (5 layers, the
     last with a gated cross-attention over 1600 image tokens; d 8192, 64
     heads on 8 of 128; 21.56 GB), its cross gate set to 1.0: 11a. #1/#5
     at group 8 (#5 over tables with 100 trailing xkv columns), #4, #2/#3
     at d 8192 x V 129024; 11b. a prefill with image memory through sdpa vs
     the flash kernel, then 8 decode steps kernels off vs on; a step and
     its cross layer timed; 11c. 8 requests on contiguous rows and on the
     pool with pinned xkv pages (zero memory: the runner takes no image),
     swap on a pool that runs dry, a prefix cache refused; 11d. as 4e.
  12. full-width SeamlessM4T-large-v2 whole (24 + 24 layers, 16.23 GB)
     with seeded random weights, once Llama-3.2-Vision's are freed: 12a.
     its kernels' shapes against their plain versions; 12b. kernels off vs
     on over 32 decode steps; 12c. the pool vs contiguous rows (the
     counted main path); 12d. windows vs single steps bit for bit; 12e.
     the loss's backward.
  13. the port's analysis layer against the card, once SeamlessM4T's
     weights are freed: 13a. full-width qwen2-1.5b's params drawn against
     ``param_bytes`` of its schema (the memory_allocated rise), one B 8
     decode step (kernels off) counted by the dry run's FLOP and byte
     counters on meta tensors and on the card's (equal), the dry run's
     served-shape byte floor beside ``step_bytes``; 13b. each of the seven
     kernels' ``*_meta`` contract against its launch at a served shape
     (output shapes, dtypes, strides), the ramp head's shared-memory fit
     against the library's launch plan; 13c. the serve launcher with
     ``--runtime-preset serve`` and ``bench`` in subprocesses (8 requests,
     window graphs captured and replayed).
  14. multi-rank serving on one card, once phase 13 is done: the kernels
     at the ranks' shapes against their plain versions (#1/#5 on qwen2's
     6:1 heads a tp-2 rank, #1 on Qwen3-MoE's 16:2 and qwen1.5-32b's
     20:20, #4 on 20 heads, #2/#3 at qwen1.5-32b's d 5120 x V 152064),
     then 2 ranks as processes on cuda:0 over gloo (the collectives stage
     through host memory; eager windows): 14a. full-width qwen2-1.5b at tp
     2: a replicated prefill (#4), 8 decode_sharded steps (#1, #2/#3, 4
     ramps) against the single rank's decode fed the same tokens (labels
     equal except near-ties, records alike on both ranks), a window of 4
     bit for bit against single sharded steps, a rank's cache half the
     single rank's, the pool (#5) the same way; 14b. ShardedDecodeRunner
     through the engine and controller, 8 requests (prompt 120, 38 tokens)
     on rows and on the pool against a single-rank DecodeRunner (tokens
     equal except from a near-tie; both ranks' allocator digests equal);
     14c. Qwen3-MoE at full width, 8 of 48 layers, capacity 16:
     expert-parallel decode_sharded against the single rank's dense
     dispatch; 14d. qwen1.5-32b at full width, 8 of 64 layers: its first
     full-width shapes on the card, a TP prefill and 8 steps against the
     single rank; 14e. pipeline_decode_window, qwen2-1.5b at 16 layers over
     2 stages: thresholds off against the greedy loop, 0.9999 at the
     boundary ramp (rows exit, the later stage works less); 14f. one NCCL
     rank runs 14a's step through decode_sharded at tp 1, bit for bit with
     decode, then ShardedDecodeRunner at tp 1 under NCCL with window graphs
     on: its eager, captured and replayed windows bit for bit with an eager
     runner's. Times are labelled as 2 ranks sharing one card: no
     tensor-parallel speed-up.
  15. multi-rank training on one card, once phase 14 is done: Qwen3-MoE-
     30B-A3B at full width cut to 2 of 48 layers (one ramp site), bf16, a
     global batch of 8 x 128 TokenPipeline tokens with -1 labels planted
     unevenly. The single rank's runs first, in this process (its weights
     freed before any rank starts), then gloo ranks on cuda:0: 15a. (data
     2, model 2), 4 ranks: ``LM.loss(mesh=)`` and its backward at capacity
     16 (nothing drops) against the single rank's loss, grad norm and the
     gradients of the router, layer 0's experts, wq and the ramp head;
     replicated gradients bit for bit across each model group; again at the
     config's capacity 1.25 (the share of assignments dropped); 15b. the
     int8 error-feedback all-reduce of 15a's router and attention gradients
     over the data group against the plain sum (relative error, bytes sent;
     two calls with feedback closer than without); 15c. (data 1, model 2):
     three AdamW steps of ``make_train_step(mesh=)``, clipping active,
     against the single rank's; 15d. 15c's step-2 state, saved from both
     ranks in the reference's format, restored whole onto one rank (its
     step 3 against 15c's) and as rank 1 of (data 1, model 4) (a quarter of
     each expert leaf read); 15e. ``pipeline_apply`` of qwen2-1.5b's 28
     blocks over 2 stages, 4 microbatches of 2 x 128, against the single
     rank's forward. Times and bytes are labelled as ranks sharing one
     card. The loss reaches no kernel.
  16. the reference's FSDP train state on one card, once phase 15 is done:
     qwen2-1.5b whole (28 layers, 12 ramp heads, full width, bf16), 2 AdamW
     steps (phase 15's lr and clip, 'full' mode, remat) on 8 x 128
     TokenPipeline tokens with -1 labels planted unevenly. 16a: one rank
     takes them on the whole model (52.5 GB of state) in this process and
     keeps four sampled leaves and counts a step's product FLOPs, then
     again on each batch's rows reversed (the comparison's floor in bf16),
     then as the split control: each half of the rows' gradient under the
     whole batch's label counts, rounded to bf16 and the two summed in
     bf16, as the data split rounds them, each half's loss computed as
     the two model ranks would (``_model_split_played``: each sublayer's
     column and row slices in turn, the row partials summed in f32, the
     heads' vocabulary blocks); 16b: four gloo ranks of (data 2, model 2)
     on cuda:0, each drawing and holding only its part of every leaf of
     the params, gradients and AdamW moments (split by the leaf's spec
     sanitized on the mesh), gathering a model-split leaf over data only
     and computing its heads, hidden units and vocabulary columns:
     losses and grad norms against the split control's (16a's beside),
     the sampled leaves (gathered from the parts) against the split
     control's and 16a's; a rank's product FLOPs against 16a's on its
     rows; each rank's peak against its reckoned state; step 2 again with
     two faults planted, the backward's sum over data left out (read by
     the leaves) and each layer's forward gather held to the step's end
     (read by the peak), and once more with the model region's backward
     sum left out (read by the leaves), each of which must read beyond
     its limit; the all-gathered, reduce-scattered and model-summed bytes
     against those reckoned from the specs and the layers, the parts of
     a step's time; 16c: DeepSeek-V2-Lite at full width, its dense layer
     and one MoE layer (MLA, the shared experts and an untied LM head on
     a rank's slices, the routed experts expert-parallel, capacity 16 so
     nothing drops), two steps on four gloo ranks of (2, 2) against one
     rank's on the same rows, and step 2 again with the model region's
     backward sum left out. The loss reaches no kernel. ``python3
     chip_smoke.py --phase 16 [--seed N]`` runs this phase alone.
Every serving phase serves its sync windows as CUDA graph replays (the
runner's default on a card; a key's first window runs eager, its second
is captured), except runs that carry Python hooks, which run eager
(``graphs=False``). Each zeroes the launch counters just before it and
reads them just after (a replay adds what its capture recorded, and each
capture raises unless the graph's kernel nodes, read by name, are those
launches), and counts the model's prefills, the classifiers' forwards and its
runners' decode steps. The last
two lines are the kernels JSON and the result JSON.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

HBM_BW = 3.35e12  # B/s, H100 SXM
EPS_CAP = 0.25  # compare_paths: the two paths' logits, a model of <= 28 layers
PEAK_BF16 = 989e12  # dense bf16 FLOP/s, H100 SXM
PEAK_F32 = 67e12  # f32 FLOP/s outside the tensor cores, H100 SXM
CONFIG = "qwen2-1.5b"
DS_CONFIG = "deepseek-v2-lite-16b"
MB_CONFIG = "mamba2-2.7b"
# DeepSeek-V2-Lite, Mamba2-2.7B and Qwen3-MoE serve (5b-5d, 6b-6d, 10c-10d)
# on their first 7 layers at full width (6 ramp sites, SERVE_ACT of them
# active in the window graphs; Gemma3's 9c-9d hold a global layer between
# local ones), to keep the script well inside its time limit on a slow
# host; 5a, 6a and 10a-10b run the whole model
SERVE_DEPTH = 7
SERVE_ACT = (1, 2, 4, 5)
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def tick(name, t0):
    """Print a sub-phase's seconds since ``t0``, the card drained; returns
    the time now (the next sub-phase's start)."""
    torch.cuda.synchronize()
    now = time.perf_counter()
    print(f"{name} took {now - t0:.1f} s", flush=True)
    return now


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def demangle(names: list) -> list:
    """Kernel names through c++filt where it is installed, else as given."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    got = out.stdout.splitlines()
    return got if out.returncode == 0 and len(got) == len(names) else names


# ---------------------------------------------------------------------------
# timing


_FLUSH = None


def flush_l2():
    """Overwrite a 256 MB buffer: evicts the 50 MB L2 between launches."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    _FLUSH.zero_()


def _events_ms(fn, iters) -> float:
    ev = []
    for _ in range(iters):
        flush_l2()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean time of fn() in ms over `iters` launches: CUDA events around each
    launch, the L2 flushed before it (a decode step reaches each layer's
    cache and each head after GBs of other traffic). One sync at the end:
    the host enqueues the next launch while the device runs the flush. Where
    fn's host time before its launch outlasts the flush, the events also
    read that host time, as a host-bound caller meets it (device_ms reads
    the device alone)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, iters)


_CYCLES_PER_MS = None


def _head_start(ms: float) -> None:
    """Enqueue a spin of about `ms` on the device (torch.cuda._sleep)."""
    global _CYCLES_PER_MS
    if _CYCLES_PER_MS is None:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(1_000_000)
        b.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS = 1_000_000 / max(a.elapsed_time(b), 1e-3)
    torch.cuda._sleep(int(_CYCLES_PER_MS * ms))


def device_ms(fn, iters=20, warmup=3) -> float:
    """time_ms with the host's time taken out: a device spin of 1.5x the
    loop's host time goes first, so every launch is enqueued before the
    device reaches it and the events read the device alone."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(warmup):
        flush_l2()
        fn()
    host_ms = 1e3 * (time.perf_counter() - t) / warmup  # enqueue, or more if fn syncs
    torch.cuda.synchronize()
    _head_start(1.5 * host_ms * iters + 1.0)
    return _events_ms(fn, iters)


def host_us(fn, iters=20) -> float:
    """Mean host time of one call of fn in us, enqueue only (fn must not
    sync; the device queue is far from full at 20 calls)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * t / iters


def bound_ms(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BW, flops / PEAK_BF16
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def _decode_probe(name, label, info, nbytes, dev_ms):
    """Stands in for Nsight Compute, which does not run on the card's
    machine: the launch's CTAs, the CTAs an SM the occupancy API allows, the
    warps an SM that gives (of 64), and the DRAM rate of the bytes the call
    needs over its device time."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    resident = min(info["ctas"], n_sm * info["ctas_per_sm"])
    probe = {**info, "sms": n_sm, "warps_per_sm_allowed": 4 * info["ctas_per_sm"],
             "theoretical_occupancy": 4 * info["ctas_per_sm"] / 64,
             "resident_warps_per_sm_at_launch": 4 * resident / n_sm,
             "dram_tb_per_s": nbytes / dev_ms / 1e9}
    print(f"{name} occupancy probe {label}: {json.dumps(probe)}", flush=True)
    return probe


def check_decode_attention(B, S, label, gen, pos_lo=0, H=12, KH=2, hd=128):
    """Per-row pos drawn from [pos_lo, S), int64 as the model holds it;
    qwen2-1.5b's heads by default."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.decode_attention.kernel import decode_launch_info

    dt = torch.bfloat16
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    # the cache in its (B, S, KH, hd) storage, viewed (B, KH, S, hd) as the
    # model hands it over
    kc = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(dt)
    vc = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(dt)
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    pos = torch.randint(pos_lo, S, (B,), generator=gen, device="cuda")
    out = decode_attention(q, k, v, pos)
    ref = decode_attention_ref(q, k, v, pos)
    torch.cuda.synchronize()
    # bf16 output: the kernel rounds once from f32; the plain version sums
    # in another order; 1e-2 covers bf16's 8-bit mantissa
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2):
        fail(f"decode_attention {label}: max abs err {err}")
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None].long())

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask[:, None, None], enable_gqa=True)

    nk = (torch.clamp(pos.long(), max=S - 1) + 1).sum().item()
    nbytes = q.numel() * 2 + nk * KH * hd * 2 * 2 + B * 8 + B * H * hd * 2  # int64 pos
    flops = nk * H * hd * 4  # q.k and p.v per (key, query head)
    bm, by = bound_ms(nbytes, flops)
    n0 = decode_attention.launches
    row = {
        "shape": label, "max_abs_err": err,
        "ms": time_ms(lambda: decode_attention(q, k, v, pos)),
        "plain_ms": time_ms(lambda: decode_attention_ref(q, k, v, pos)),
        "library_ms": time_ms(library), "library": "SDPA (boolean mask, enable_gqa)",
        "bound_ms": bm, "bound_by": by, "bytes": nbytes,
    }
    row["device_ms"] = device_ms(lambda: decode_attention(q, k, v, pos))
    row["library_device_ms"] = device_ms(library)
    row["host_us"] = host_us(lambda: decode_attention(q, k, v, pos))
    info = decode_launch_info(q.dtype, B, H, KH, S, hd)
    probe = _decode_probe("decode_attention", label, info, nbytes, row["device_ms"])
    row.update(splits=info["splits"], ctas_per_sm=info["ctas_per_sm"],
               tb_per_s=probe["dram_tb_per_s"])
    decode_attention.launches = n0  # comparison launches do not count
    print(f"decode_attention {label}: {json.dumps(row)}", flush=True)
    return row


def check_paged_decode_attention(B, nb, label, gen, pos_lo, pos_hi, bs=16, H=12, KH=2,
                                 hd=128, trailing=0):
    """The paged kernel over a shuffled block table (pool block 0 is the
    trash block no row owns), per-row pos drawn from [pos_lo, pos_hi):
    against its plain version, and bit for bit against the contiguous
    kernel on the same keys gathered into a contiguous cache. With
    ``trailing`` the table carries that many more columns (a cross plan's
    pinned xkv pages, other keys) and the kernel gets the token columns
    as the model hands them over: a view with the whole row's stride."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        paged_decode_attention,
        paged_decode_attention_ref,
    )
    from repro_torch.kernels.decode_attention.kernel import decode_launch_info

    dt = torch.bfloat16
    S, P = nb * bs, B * (nb + trailing) + 1
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    k_pool = torch.randn(P, bs, KH, hd, generator=gen, device="cuda").to(dt)
    v_pool = torch.randn(P, bs, KH, hd, generator=gen, device="cuda").to(dt)
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(B, nb + trailing).to(torch.int32)[:, :nb]
    pos = torch.randint(pos_lo, pos_hi, (B,), generator=gen, device="cuda")
    n0 = (paged_decode_attention.launches, decode_attention.launches)
    out = paged_decode_attention(q, k_pool, v_pool, table, pos)
    ref = paged_decode_attention_ref(q, k_pool, v_pool, table, pos)
    kc = k_pool[table.long()].reshape(B, S, KH, hd)  # the same keys, contiguous
    vc = v_pool[table.long()].reshape(B, S, KH, hd)
    cont = decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), pos)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2):
        fail(f"paged_decode_attention {label}: max abs err {err}")
    if not torch.equal(out, cont):
        fail(f"paged_decode_attention {label}: differs from the contiguous kernel on the "
             f"same keys by {(out.float() - cont.float()).abs().max().item()}")
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None].long())

    def library():  # two calls: the gather of each row's blocks, then SDPA
        kg = k_pool[table.long()].reshape(B, S, KH, hd).transpose(1, 2)
        vg = v_pool[table.long()].reshape(B, S, KH, hd).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kg, vg, attn_mask=mask[:, None, None], enable_gqa=True)

    nk = torch.clamp(pos.long(), max=S - 1) + 1
    nblk = ((nk + bs - 1) // bs).sum().item()  # table entries the walk reads
    nk = nk.sum().item()
    nbytes = q.numel() * 2 + nk * KH * hd * 2 * 2 + nblk * 4 + B * 8 + B * H * hd * 2
    bm, by = bound_ms(nbytes, nk * H * hd * 4)
    row = {
        "shape": label, "max_abs_err": err, "bit_identical_to_contiguous": True,
        "ms": time_ms(lambda: paged_decode_attention(q, k_pool, v_pool, table, pos)),
        "contiguous_ms": time_ms(lambda: decode_attention(q, kc.transpose(1, 2),
                                                          vc.transpose(1, 2), pos)),
        "plain_ms": time_ms(lambda: paged_decode_attention_ref(q, k_pool, v_pool, table, pos)),
        "library_ms": time_ms(library), "library": "k_pool[table] gather + SDPA (two calls)",
        "bound_ms": bm, "bound_by": by, "bytes": nbytes,
    }
    row["device_ms"] = device_ms(lambda: paged_decode_attention(q, k_pool, v_pool, table, pos))
    row["library_device_ms"] = device_ms(library)
    row["host_us"] = host_us(lambda: paged_decode_attention(q, k_pool, v_pool, table, pos))
    info = decode_launch_info(q.dtype, B, H, KH, S, hd, paged=True, bs=bs)
    probe = _decode_probe("paged_decode_attention", label, info, nbytes, row["device_ms"])
    row.update(splits=info["splits"], ctas_per_sm=info["ctas_per_sm"],
               tb_per_s=probe["dram_tb_per_s"])
    paged_decode_attention.launches, decode_attention.launches = n0  # comparison launches
    print(f"paged_decode_attention {label}: {json.dumps(row)}", flush=True)
    return row


def check_paged_mla(B, nb, label, gen, pos_lo, pos_hi, bs=16, H=16, r=512, dr=64):
    """Phase 3c: the paged MLA kernel over a shuffled block table (pool
    block 0 is the trash block no row owns), per-row pos drawn from
    [pos_lo, pos_hi), against its plain version; timed beside one library
    route."""
    from repro_torch.kernels.decode_attention import (
        paged_mla_decode_attention,
        paged_mla_decode_attention_ref,
    )
    from repro_torch.kernels.decode_attention.kernel import mla_launch_info

    dt = torch.bfloat16
    S, P = nb * bs, B * nb + 1
    q_lat = torch.randn(B, H, r, generator=gen, device="cuda").to(dt)
    q_pe = torch.randn(B, H, dr, generator=gen, device="cuda").to(dt)
    c_pool = torch.randn(P, bs, r, generator=gen, device="cuda").to(dt)
    kpe_pool = torch.randn(P, bs, dr, generator=gen, device="cuda").to(dt)
    table = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).reshape(B, nb)
    table = table.to(torch.int32)
    pos = torch.randint(pos_lo, pos_hi, (B,), generator=gen, device="cuda")  # int64, as the model
    scale = 1.0 / (128 + dr) ** 0.5  # 1/sqrt(dn + dr) of DeepSeek-V2-Lite
    args = (q_lat, q_pe, c_pool, kpe_pool, table, pos)
    n0 = paged_mla_decode_attention.launches
    out = paged_mla_decode_attention(*args, scale=scale)
    ref = paged_mla_decode_attention_ref(*args, scale=scale)
    torch.cuda.synchronize()
    # bf16 output: the kernel rounds once from f32; the plain version sums
    # in another order; 1e-2 covers bf16's 8-bit mantissa
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2):
        fail(f"paged_mla_decode_attention {label}: max abs err {err}")
    tab = table.long()
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None].long())

    def library():
        c = c_pool[tab].reshape(B, S, r)
        kp = kpe_pool[tab].reshape(B, S, dr)
        s = (torch.matmul(q_lat, c.transpose(1, 2))
             + torch.matmul(q_pe, kp.transpose(1, 2))).float() * scale
        p = torch.softmax(s.masked_fill(~mask[:, None], -1e30), dim=-1)
        return torch.matmul(p.to(dt), c)

    nk = torch.clamp(pos.long(), max=S - 1) + 1
    nblk = ((nk + bs - 1) // bs).sum().item()  # table entries the walk reads
    nk = nk.sum().item()
    nbytes = (q_lat.numel() + q_pe.numel()) * 2 + nk * (r + dr) * 2 + nblk * 4 + B * 8 \
        + B * H * r * 2
    flops = nk * H * (2 * (r + dr) + 2 * r)  # scores against c and k_pe, then p.c
    bm, by = bound_ms(nbytes, flops)
    row = {
        "shape": label, "max_abs_err": err,
        "ms": time_ms(lambda: paged_mla_decode_attention(*args, scale=scale)),
        "plain_ms": time_ms(lambda: paged_mla_decode_attention_ref(*args, scale=scale)),
        "library_ms": time_ms(library),
        "library": "c_pool[table] and kpe_pool[table] gathers, torch.matmul scores, "
                   "torch.softmax, torch.matmul context",
        "bound_ms": bm, "bound_by": by, "bytes": nbytes, "flops": flops,
    }
    call = lambda: paged_mla_decode_attention(*args, scale=scale)  # noqa: E731
    row["device_ms"] = device_ms(call)
    row["library_device_ms"] = device_ms(library)
    row["host_us"] = host_us(call)
    row["tb_per_s"] = nbytes / row["device_ms"] / 1e9  # DRAM rate of the counted bytes
    # the launch's key ranges and the CTAs an SM the occupancy API allows
    # (Nsight Compute does not run on the card's machine)
    row.update(mla_launch_info(dt, B, H, r, dr, bs, nb))
    paged_mla_decode_attention.launches = n0  # comparison launches do not count
    print(f"paged_mla_decode_attention {label}: {json.dumps(row)}", flush=True)
    return row


def check_flash_attention(B, H, KH, Sq, Sk, hd, label, gen, causal=True, window=None):
    """Phases 3d, 3f and 9a: the flash-attention kernel, causal from query 0
    (3d), with no mask (3f, BERT's encoder) or causal within a sliding
    window (9a, Gemma3's local layers), against its plain version, q/k/v
    handed over as the model does (views of (B, S, heads, hd) storage);
    timed beside SDPA (top-left causal, no mask, or the window's boolean
    mask)."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    dt = torch.bfloat16
    q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dt).transpose(1, 2)
    k = torch.randn(B, Sk, KH, hd, generator=gen, device="cuda").to(dt).transpose(1, 2)
    v = torch.randn(B, Sk, KH, hd, generator=gen, device="cuda").to(dt).transpose(1, 2)
    kw = dict(causal=causal, window=window)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    ref = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    # bf16 output: the kernel rounds once from f32; the plain version sums
    # in another order; 1e-2 covers bf16's 8-bit mantissa
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2):
        fail(f"flash_attention {label}: max abs err {err}")
    mask = None
    if window is not None:
        qi = torch.arange(Sq, device="cuda")[:, None]
        kj = torch.arange(Sk, device="cuda")[None, :]
        mask = (kj > qi - window) & ((kj <= qi) if causal else True)

    def library():
        if mask is not None:
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                    enable_gqa=True)
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                enable_gqa=True)

    # what causal-from-0 needs: keys 0..Sq-1 of each head, (q_i, k_j) pairs
    # j <= i (and j > i - window); with no mask every key and every pair
    nk = min(Sk, Sq) if causal else Sk
    if causal:
        pairs = sum(min(i + 1, Sk, window or Sk) for i in range(Sq))
    else:
        pairs = Sq * Sk if window is None else \
            sum(sum(1 for j in range(Sk) if j > i - window) for i in range(Sq))
    nbytes = 2 * (2 * q.numel() + 2 * B * KH * nk * hd)
    flops = 4 * B * H * pairs * hd  # q.k and p.v
    bm, by = bound_ms(nbytes, flops)
    row = {
        "shape": label, "max_abs_err": err,
        "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, **kw)),
        "library_ms": time_ms(library),
        "library": ("SDPA (boolean sliding-window mask)" if window is not None
                    else "SDPA (is_causal, top-left)" if causal else "SDPA (no mask)"),
        "bound_ms": bm, "bound_by": by, "bytes": nbytes, "flops": flops,
        "cuda_core_ms": 1e3 * flops / PEAK_F32,
    }
    row["tflop_per_s"] = flops / row["ms"] / 1e9  # of the counted flop
    row["device_ms"] = device_ms(lambda: flash_attention(q, k, v, **kw))
    row["library_device_ms"] = device_ms(library)
    row["host_us"] = host_us(lambda: flash_attention(q, k, v, **kw))
    flash_attention.launches = n0  # comparison launches do not count
    print(f"flash_attention {label}: {json.dumps(row)}", flush=True)
    return row


def check_ssd(B, H, S, hp, N, label, gen):
    """Phase 3e: the SSD chunk-scan kernel against its plain version at the
    reference's chunking (64 where it divides S, else one chunk of S), the
    inputs as the model hands them over (x and dt views of (B, S, H, .)
    storage, bf16 x/B/C, f32 dt). No single PyTorch call computes SSD."""
    from repro_torch.kernels.ssd import ssd, ssd_chunked
    from repro_torch.kernels.ssd.kernel import ssd_launch_info

    dt = torch.bfloat16
    x = torch.randn(B, S, H, hp, generator=gen, device="cuda").to(dt).transpose(1, 2)
    dts = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device="cuda") - 2).transpose(1, 2)
    A = -torch.exp(torch.rand(H, generator=gen, device="cuda") * 2.7726)  # -[1, 16)
    Bm = torch.randn(B, S, N, generator=gen, device="cuda").to(dt)
    Cm = torch.randn(B, S, N, generator=gen, device="cuda").to(dt)
    n0 = ssd_chunked.launches
    y, st = ssd_chunked(x, dts, A, Bm, Cm)
    y_ref, st_ref = ssd(x, dts, A, Bm, Cm, use_kernel=False)
    torch.cuda.synchronize()
    # f32 internals in both; the sums in another order and grouping: 1e-4
    # relative to the largest magnitude
    err = 0.0
    for name, a, r in (("y", y, y_ref), ("state", st, st_ref)):
        scale = float(r.abs().max())
        e = (a - r).abs().max().item()
        err = max(err, e)
        if not torch.allclose(a, r, rtol=1e-4, atol=1e-4 * scale):
            fail(f"ssd_chunked {label} {name}: max abs err {e} (max |ref| {scale})")
    # what the scan needs: each input read once, y and the state written once;
    # per (batch, head) and chunk of L real steps the masked scores
    # L(L+1)/2 x 2N, y's diagonal L(L+1)/2 x 2hp and off-diagonal 2 L N hp,
    # the state update 2 L N hp
    nbytes = 2 * (x.numel() + Bm.numel() + Cm.numel()) + 4 * (dts.numel() + H) \
        + 4 * (y.numel() + st.numel())
    flops = 0
    for c0 in range(0, S, 64):
        L = min(64, S - c0)
        flops += L * (L + 1) // 2 * 2 * (N + hp) + 4 * L * N * hp
    flops *= B * H
    bm, by = bound_ms(nbytes, flops)
    row = {
        "shape": label, "max_abs_err": err,
        "ms": time_ms(lambda: ssd_chunked(x, dts, A, Bm, Cm)),
        "plain_ms": time_ms(lambda: ssd(x, dts, A, Bm, Cm, use_kernel=False)),
        "library_ms": None, "library": "none: no single PyTorch call computes SSD",
        "bound_ms": bm, "bound_by": by, "bytes": nbytes, "flops": flops,
    }
    row["device_ms"] = device_ms(lambda: ssd_chunked(x, dts, A, Bm, Cm))
    row["host_us"] = host_us(lambda: ssd_chunked(x, dts, A, Bm, Cm))
    row["tb_per_s"] = nbytes / row["device_ms"] / 1e9  # DRAM rate of the counted bytes
    row.update(ssd_launch_info(dt, B, H, hp, N))  # head-dim slices, CTAs, CTAs an SM
    ssd_chunked.launches = n0  # comparison launches do not count
    print(f"ssd_chunked {label}: {json.dumps(row)}", flush=True)
    return row


def _near_tie_labels(lab, lab_ref, logits_ref, tol, what):
    """Labels must match exactly, except where the reference's logit at the
    kernel's label is within `tol` of the reference max (a near-tie)."""
    bad = (lab != lab_ref).nonzero().flatten().tolist()
    ties = 0
    for b in bad:
        gap = (logits_ref[b].max() - logits_ref[b, int(lab[b])]).item()
        if gap >= tol:
            fail(f"{what}: row {b} label {lab[b].item()} vs {lab_ref[b].item()}, gap {gap}")
        ties += 1
    return ties


def _logits_ref(h, w, v_limit):
    lg = h.float() @ w.float()
    col = torch.arange(lg.shape[-1], device=lg.device)
    return torch.where(col < v_limit, lg, -1e30)


def head_weight(params, cfg):
    """The final head (d, V): the tied embed^T view, or the untied lm_head."""
    return params["tok"]["embed"].T if cfg.tie_embeddings else params["tok"]["lm_head"]


def check_ramp_head(params, cfg, gen):
    """Both ramp-head kernels against their plain versions on the model's
    final head and on ramp head 0, at B 8 and the model's d and V."""
    from repro_torch.kernels.ramp_head import (
        ramp_head_exit,
        ramp_head_exit_ref,
        ramp_head_stats,
        ramp_head_stats_ref,
    )

    B, d, V, vl = 8, cfg.d_model, cfg.padded_vocab, cfg.vocab_size
    h = torch.randn(B, d, generator=gen, device="cuda").to(head_weight(params, cfg).dtype)
    rows = {}

    def close(x, y):
        # f32 stats of a d-term contraction and a V-term softmax sum, in
        # another order: rtol 1e-4, atol scaled to the magnitude
        return torch.allclose(x, y, rtol=1e-4, atol=1e-4 * float(y.abs().max()))

    def lib_stats(hh, w):
        lg = torch.matmul(hh, w).float()
        lg = torch.where(torch.arange(V, device="cuda") < vl, lg, -1e30)
        m = lg.max(-1).values
        e = torch.exp(lg - m[:, None])
        return m, e.sum(-1), (lg * e).sum(-1), lg.argmax(-1)

    def counted_bytes(extra_out):
        # what the function needs: columns >= v_limit are fixed at -1e30 and
        # never move m, s, t, argmax or exit, so only d * v_limit weights count
        return d * vl * 2 + B * d * 2 + B * (16 + extra_out)

    def bounds(extra_out):
        return bound_ms(counted_bytes(extra_out), 2.0 * B * d * vl)

    # -- stats on the final head: the tied embed^T (a view contiguous along
    # d) or the untied lm_head (contiguous along V)
    w = head_weight(params, cfg)
    wname = "embed^T" if cfg.tie_embeddings else "lm_head"
    got = ramp_head_stats(h, w, v_limit=vl)
    ref = ramp_head_stats_ref(h, w, vl)
    torch.cuda.synchronize()
    for name, x, y in zip("mst", got[:3], ref[:3]):
        if not close(x, y):
            fail(f"ramp_head_stats {name}: max abs err {(x - y).abs().max().item()}")
    ties = _near_tie_labels(got[3], ref[3], _logits_ref(h, w, vl), 1e-3, "ramp_head_stats")
    err = max((x - y).abs().max().item() for x, y in zip(got[:3], ref[:3]))
    bm, by = bounds(0)
    n0 = ramp_head_stats.launches
    rows["ramp_head_stats"] = {
        "shape": f"B={B} {wname} ({d},{V}) v_limit={vl}", "max_abs_err": err,
        "near_ties": ties,
        "ms": time_ms(lambda: ramp_head_stats(h, w, v_limit=vl)),
        "plain_ms": time_ms(lambda: ramp_head_stats_ref(h, w, vl)),
        "library_ms": time_ms(lambda: lib_stats(h, w)),
        "bound_ms": bm, "bound_by": by,
    }
    rows["ramp_head_stats"]["tb_per_s"] = counted_bytes(0) / rows["ramp_head_stats"]["ms"] / 1e9
    rows["ramp_head_stats"]["device_ms"] = device_ms(lambda: ramp_head_stats(h, w, v_limit=vl))
    rows["ramp_head_stats"]["library_device_ms"] = device_ms(lambda: lib_stats(h, w))
    rows["ramp_head_stats"]["host_us"] = host_us(lambda: ramp_head_stats(h, w, v_limit=vl))
    ramp_head_stats.launches = n0

    # -- exit on a ramp head: head[site], (d, V) contiguous along V, with
    # thresholds just above (exit) and just below (stay) each row's unc
    w = params["ramps"]["head"][0]
    _, s_ref, _, _ = ramp_head_stats_ref(h, w, vl)
    unc = 1.0 - 1.0 / s_ref
    sign = torch.tensor([1.0, -1.0] * (B // 2), device="cuda")
    thr = unc + sign * 1e-5
    got = ramp_head_exit(h, w, thr, v_limit=vl)
    ref = ramp_head_exit_ref(h, w, thr, vl)
    torch.cuda.synchronize()
    for name, x, y in zip("mst", got[:3], ref[:3]):
        if not close(x, y):
            fail(f"ramp_head_exit {name}: max abs err {(x - y).abs().max().item()}")
    ties = _near_tie_labels(got[3], ref[3], _logits_ref(h, w, vl), 1e-3, "ramp_head_exit")
    # exit bits exact, except where |unc - thr| is under 1e-6 (the f32
    # unc of the two versions differs by ~1e-10 here)
    mism = (got[4] != ref[4]).nonzero().flatten().tolist()
    near = [b for b in mism if abs((unc[b] - thr[b]).item()) < 1e-6]
    if len(near) != len(mism):
        fail(f"ramp_head_exit: exit bits differ on rows {mism}")
    if not (got[4].sum().item() > 0 and (got[4] == 0).sum().item() > 0):
        fail("ramp_head_exit: thresholds on both sides should give both exit values")
    err = max((x - y).abs().max().item() for x, y in zip(got[:3], ref[:3]))
    bm, by = bounds(8)
    n0 = ramp_head_exit.launches
    rows["ramp_head_exit"] = {
        "shape": f"B={B} head[site] ({d},{V}) v_limit={vl}", "max_abs_err": err,
        "near_ties": ties + len(near),
        "ms": time_ms(lambda: ramp_head_exit(h, w, thr, v_limit=vl)),
        "plain_ms": time_ms(lambda: ramp_head_exit_ref(h, w, thr, vl)),
        "library_ms": time_ms(lambda: lib_stats(h, w)),
        "bound_ms": bm, "bound_by": by,
    }
    rows["ramp_head_exit"]["tb_per_s"] = counted_bytes(8) / rows["ramp_head_exit"]["ms"] / 1e9
    rows["ramp_head_exit"]["device_ms"] = device_ms(lambda: ramp_head_exit(h, w, thr, v_limit=vl))
    rows["ramp_head_exit"]["library_device_ms"] = device_ms(lambda: lib_stats(h, w))
    rows["ramp_head_exit"]["host_us"] = host_us(lambda: ramp_head_exit(h, w, thr, v_limit=vl))
    ramp_head_exit.launches = n0
    n_bound = check_exit_boundary(h, head_weight(params, cfg), vl, wname)
    n_bound += check_exit_boundary(h, w, vl, "head[site]")
    rows["ramp_head_exit"]["boundary_rows"] = n_bound
    for name, row in rows.items():
        print(f"{name} ({cfg.name}): {json.dumps(row)}", flush=True)
    return rows


def check_exit_boundary(h, w, vl, layout):
    """The exit compare is strict, on the card: with unc = 1 - 1/s formed
    in f32 from the kernel's own s, thr == unc must not exit and the next
    float up must. Also: an empty batch launches nothing and counts nothing.
    Returns the rows checked; the launch counters are left as found."""
    from repro_torch.kernels.ramp_head import ramp_head_exit, ramp_head_stats

    n0 = (ramp_head_stats.launches, ramp_head_exit.launches)
    _, s, _, _ = ramp_head_stats(h, w, v_limit=vl)
    s_host = s.cpu()
    unc = torch.ones_like(s_host) / s_host  # IEEE f32 divide and subtract on
    unc = torch.ones_like(s_host) - unc     # the host, as the kernel rounds them
    up = torch.nextafter(unc, torch.full_like(unc, float("inf")))
    at = ramp_head_exit(h, w, unc.cuda(), v_limit=vl)
    above = ramp_head_exit(h, w, up.cuda(), v_limit=vl)
    if not (torch.equal(at[1], s) and torch.equal(above[1], s)):
        fail(f"ramp_head {layout}: s differs between the stats and exit calls")
    if at[4].any().item():
        fail(f"ramp_head_exit {layout}: thr == unc exited on rows "
             f"{at[4].nonzero().flatten().tolist()} (the compare must be strict)")
    if not above[4].all().item():
        fail(f"ramp_head_exit {layout}: thr = nextafter(unc) did not exit on rows "
             f"{(above[4] == 0).nonzero().flatten().tolist()}")
    empty = h[:0]
    ramp_head_stats(empty, w, v_limit=vl)
    ramp_head_exit(empty, w, torch.empty(0, device="cuda"), v_limit=vl)
    if (ramp_head_stats.launches, ramp_head_exit.launches) != (n0[0] + 1, n0[1] + 2):
        fail(f"ramp_head {layout}: launch counters moved by "
             f"{ramp_head_stats.launches - n0[0]}, {ramp_head_exit.launches - n0[1]}; "
             "expected 1, 2 (an empty batch launches nothing)")
    ramp_head_stats.launches, ramp_head_exit.launches = n0
    return h.shape[0]


# ---------------------------------------------------------------------------
# phase 4a: kernels off vs on through the full-width model


class RouteReplay:
    """MoE routing held fixed between two runs of one model: ``record``
    keeps the expert ids of every router call of one run, ``replay`` hands
    them, call for call, to the other run (its gates are its own router
    probabilities at those experts, normalised as the router does).

    Why: with seeded random weights DeepSeek's router is nearly uniform
    over 64 experts, its 6th and 7th probabilities a median ~1e-4 apart,
    while two correct paths that round attention differently move them by
    ~1e-4 to 1e-3 (a CPU probe at full width, 4 layers). Left free, the
    router flips experts in most rows somewhere in 26 MoE layers and the
    paths' outputs part for reasons that have nothing to do with the
    kernels. ``flips`` counts, on the device, the routes the replaying run
    would have taken otherwise: the router near-ties (``flip_count()``
    reads it once, after the runs, so the replay adds no host sync)."""

    def __init__(self):
        self.ids, self.mode, self.i, self.flips, self.routes = [], None, 0, None, 0

    def flip_count(self) -> int:
        return 0 if self.flips is None else int(self.flips)

    def __call__(self, mode, fn):
        from repro_torch.models import moe as MOE

        router = MOE._router

        def hook(cfg_, p, x2d):
            gates, idx, probs = router(cfg_, p, x2d)
            if self.mode == "record":
                self.ids.append(idx)
                return gates, idx, probs
            if self.i >= len(self.ids) or self.ids[self.i].shape != idx.shape:
                fail(f"routing replay out of step at router call {self.i}")
            want = self.ids[self.i]
            self.i += 1
            self.routes += idx.shape[0]
            d = (want.sort(-1).values != idx.sort(-1).values).any(-1).sum()
            self.flips = d if self.flips is None else self.flips + d
            g = probs.gather(1, want)
            return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), want, probs

        self.mode = mode
        if mode == "record":
            self.ids, self.i = [], 0
        MOE._router = hook
        try:
            return fn()
        finally:
            MOE._router = router
            if mode == "replay" and self.i != len(self.ids):
                fail(f"routing replay used {self.i} of {len(self.ids)} recorded router calls")


def _to_pool(model, cache, bs, gen):
    """Lay a contiguous cache of B rows x nb*bs tokens out as a paged pool
    of 1 + B*nb blocks of bs under a shuffled block table (block 0 is the
    trash block no row owns). Returns (pool, table)."""
    from repro_torch.models.common import tree_leaves

    leaves = tree_leaves(cache)
    B, S = leaves[0].shape[-3], leaves[0].shape[-2]  # any leaf: (.., B, S, w)
    nb = S // bs
    table = (torch.randperm(B * nb, generator=gen, device="cuda") + 1).reshape(B, nb)
    pool = model.init_paged_cache(1 + B * nb, bs, device="cuda")
    for pl, cl in zip(tree_leaves(pool), leaves):
        ax = pl.dim() - 3  # the pool axis: 0 for prefix leaves, 1 for stacked ones
        blocks = cl.reshape(cl.shape[:ax] + (B * nb, bs) + cl.shape[-1:])
        pl.index_copy_(ax, table.reshape(-1), blocks)
    return pool, table.to(torch.int32)


def compare_paths(params, cfg, off_cfg, on_cfg, gen, paged_bs=0, off_kw=None, on_kw=None,
                  prefill_kernel=None, toks=None, T=8, thr=None, act=(2, 5, 8, 11),
                  prefill_kw=None, cache_len=None):
    """Prefill 128 tokens for 8 rows (each path twice, timed in the order
    off, on, on, off; ``toks`` (B, P) replaces the drawn prompts), then
    ``T`` greedy decode steps (exit thresholds ``thr``, 0.5 by default),
    through the model with
    the kernels off (``off_cfg``, built with ``off_kw``) and on
    (``on_cfg``, ``on_kw``); with ``paged_bs`` the decode steps run on a
    paged pool of that block size (both paths on the same pool contents).
    Both paths are fed the kernels-off greedy tokens, so a near-tie cannot
    derail the rest. ``prefill_kernel`` must launch once a layer in the on
    path's prefill and never in the off path's.

    Labels of the final head and the four ramps must be equal, except a
    near-tie: the two paths round differently in bf16 (the dense path
    rounds attention probabilities and logits to bf16, the kernels keep
    f32), so each row's logits differ by some eps, measured here from f32
    logits of each path's own hidden states; a label may flip only where
    the kernels-off logit at the kernels-on label is within 2 * eps of the
    top. eps itself must stay under 0.25 for a model of up to 28 layers:
    with bf16's 2^-9 rounding at ~10 points per layer over 28 layers, h
    drifts by ~3% and top logits (~3-4) by ~0.1. The drift adds up layer by
    layer, so a deeper model's cap grows with its depth: 0.25 * L / 28
    (Mamba2-2.7B's 64 layers: 0.571); and a drift of h moves the logits in
    proportion to their size, so where the mean top logit of the prefill's
    kernels-off final head passes 5 (the other models' 3.5-4.6; d 8192 of
    Llama-3.2-Vision: ~8) the cap is scaled by it over 5. ``act`` are the
    active ramp sites, ``prefill_kw`` more arguments of the prefill (a
    cross plan's ``image_embeds``, the enc-dec model's ``frames``; the
    prompt goes as ``tokens=``), ``cache_len`` the cache's rows (default
    P + T + 1)."""
    from repro_torch.models import build_model
    from repro_torch.models import layers as LY

    off, on = build_model(off_cfg, **(off_kw or {})), build_model(on_cfg, **(on_kw or {}))
    act = list(act)
    prefill_kw = prefill_kw or {}
    vl = cfg.vocab_size
    if thr is None:
        thr = torch.full((len(act),), 0.5, device="cuda")
    if toks is None:
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 1)
        toks = torch.randint(1, vl, (8, 128), generator=g, device="cuda")
    B, P = toks.shape

    def spy(model):
        seen = {}
        orig = model._head_stats

        def head_stats(params_, h_last, pooled, active_sites, exit_thresholds=None):
            seen["h"], seen["pooled"] = h_last, pooled
            return orig(params_, h_last, pooled, active_sites, exit_thresholds)

        model._head_stats = head_stats
        return seen

    seen_off, seen_on = spy(off), spy(on)

    def f32_logits(seen):
        """f32 logits of the final head and each ramp from a path's hidden."""
        h = LY.apply_norm(cfg, params["final_norm"], seen["h"])[:, 0]
        out = [_logits_ref(h, head_weight(params, cfg), vl)]
        hs = on._ramp_hidden(params, seen["pooled"], act)[:, :, 0]
        out += [_logits_ref(hs[j], params["ramps"]["head"][i], vl) for j, i in enumerate(act)]
        return out

    def labels(o):
        return [o["final"]["label"]] + [o["ramps"]["label"][j] for j in range(len(act))]

    stats = {"labels": 0, "near_ties": 0, "max_eps": 0.0, "eps_by_step": [],
             "ramp_exits": 0, "ramp_records": 0, "ramp_maxprob_over_half": 0}
    cap = EPS_CAP * max(1.0, cfg.n_layers / 28)
    routes = RouteReplay()  # MoE: the on path takes the off path's experts

    def check(o_on, o_off, t):
        nonlocal cap
        lg_on, lg_off = f32_logits(seen_on), f32_logits(seen_off)
        if t == 0:  # the prefill's top logits set the cap's scale
            stats["top_logit"] = lg_off[0].max(dim=-1).values.mean().item()
            cap *= max(1.0, stats["top_logit"] / 5.0)
        names = ["final"] + [f"ramp {i}" for i in act]
        step_eps = 0.0
        for name, a, b, la, lb in zip(names, lg_on, lg_off, labels(o_on), labels(o_off)):
            eps = (a - b).abs().max(dim=-1).values
            step_eps = max(step_eps, eps.max().item())
            stats["max_eps"] = max(stats["max_eps"], eps.max().item())
            if eps.max().item() > cap:
                fail(f"{name}, step {t}: the paths' logits differ by {eps.max().item()}")
            # the kernels against their own path's f32 logits: same inputs
            _near_tie_labels(la, a.argmax(-1), a, 1e-3, f"{name} kernel label, step {t}")
            for r in (la != lb).nonzero().flatten().tolist():
                gap = (b[r].max() - b[r, int(la[r])]).item()
                if gap > 2 * eps[r].item():
                    fail(f"{name}, step {t}, row {r}: label {la[r].item()} vs "
                         f"{lb[r].item()}, gap {gap} > 2 * eps {eps[r].item()}")
                stats["near_ties"] += 1
            stats["labels"] += B
        stats["eps_by_step"].append(round(step_eps, 4))
        if t:  # a decode step's exit bits at thr, and its confident ramp records
            stats["ramp_exits"] += int(o_on["ramps"]["exit"].sum())
            stats["ramp_records"] += o_on["ramps"]["exit"].numel()
            stats["ramp_maxprob_over_half"] += int((o_on["ramps"]["maxprob"] > 0.5).sum())

    cache_len = cache_len or P + T + 1
    if paged_bs:
        cache_len = -(-cache_len // paged_bs) * paged_bs
    times = {"prefill_off_ms": [], "prefill_on_ms": []}
    runs = {}
    # in the order off, on, on, off: the first prefill of fresh weights pays
    # one-time costs that are neither path's
    for name in ("off", "on", "on", "off"):
        model = off if name == "off" else on
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name], pl = counted(lambda m=model: m.prefill(params, tokens=toks,
                                                            cache_len=cache_len,
                                                            active_sites=act, **prefill_kw))
        times[f"prefill_{name}_ms"].append(1e3 * (time.perf_counter() - t0))
        for k in PREFILL:
            expect = cfg.n_layers if (k == prefill_kernel and name == "on") else 0
            if pl[k] != expect:
                fail(f"{cfg.name} {name} prefill launched {k} {pl[k]} times; expected {expect}")
    (c_off, o_off), (c_on, o_on) = runs["off"], runs["on"]
    tables = None
    if paged_bs:  # one pool for both paths, each path its own copy
        from repro_torch.models.common import tree_map

        c_off, tables = _to_pool(off, c_off, paged_bs, gen)
        c_on = tree_map(torch.clone, c_off)
    step_ms = {"off": 0.0, "on": 0.0}
    pos = torch.full((B,), P, device="cuda", dtype=torch.int64)
    for t in range(T + 1):
        if t:
            nxt = o_off["final"]["label"].reshape(B, 1).long()
            for name, model, cache in (("off", off, c_off), ("on", on, c_on)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, o = routes("record" if name == "off" else "replay", lambda: model.decode(
                    params, cache, nxt, pos, active_sites=act, exit_thresholds=thr,
                    block_tables=tables))
                torch.cuda.synchronize()
                step_ms[name] += 1e3 * (time.perf_counter() - t0)
                if name == "off":
                    o_off = o
                else:
                    o_on = o
            pos = pos + 1
        check(o_on, o_off, t)
    times["decode_step_off_ms"] = step_ms["off"] / T
    times["decode_step_on_ms"] = step_ms["on"] / T
    nxt = o_off["final"]["label"].reshape(B, 1).long()
    times["profile_on"] = profile_step(lambda: on.decode(
        params, c_on, nxt, pos, active_sites=act, exit_thresholds=thr, block_tables=tables))
    if prefill_kernel is not None:  # one prefill of the on path: its prefill kernel's share
        times["profile_prefill_on"] = profile_step(lambda: on.prefill(
            params, tokens=toks, cache_len=cache_len, active_sites=act, **prefill_kw))
    print(f"model {cfg.name} kernels off ({off_cfg.decode_attn}, {off_cfg.pallas_head}, "
          f"{off_kw or {}}) vs on ({on_cfg.decode_attn}, {on_cfg.pallas_head}, {on_kw or {}}): "
          f"{stats['labels']} labels, {stats['near_ties']} near-ties, max logit eps "
          f"{stats['max_eps']:.4f} (cap {cap:.3f}, mean top logit {stats['top_logit']:.3f}; "
          f"by step {stats['eps_by_step']}); "
          f"kernels-on ramp records: {stats['ramp_exits']} of {stats['ramp_records']} exit at "
          f"thresholds {[round(x, 4) for x in thr.tolist()]}, "
          f"{stats['ramp_maxprob_over_half']} with maxprob > 0.5; "
          + (f"MoE routing replayed from the off path: {routes.flip_count()} of "
             f"{routes.routes} token routes of the on path would have taken other experts "
             "(router near-ties); "
             if cfg.moe else "") + json.dumps(times), flush=True)
    return {**times, "eps_cap": cap,
            **{k: stats[k] for k in ("ramp_exits", "ramp_records", "ramp_maxprob_over_half",
                                     "near_ties", "max_eps", "top_logit")}}


def profile_step(fn, top=6):
    """One call of fn under torch.profiler: device busy ms (the sum of
    kernel times), wall ms, the kernels that took the most device time, and
    the device ms of each of the port's own kernels (by kernel name)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    kern.sort(key=lambda e: -e.self_device_time_total)
    ours = {}
    for e in kern:  # csrc/*.cu kernels live in anonymous namespaces outside at::
        if "(anonymous namespace)::" in e.key and "at::" not in e.key:
            name = e.key.split("(anonymous namespace)::")[1].split("<")[0].split("(")[0]
            ours[name] = ours.get(name, 0.0) + e.self_device_time_total / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy,
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in kern[:top]},
            "port_kernels_ms": ours}


# ---------------------------------------------------------------------------
# phases 4b-4d: the paged pool at full width


# two paths' greedy labels may differ only where the reference path's f32
# logits of the two labels lie within this gap: compare_paths measures the
# kernels-off and kernels-on bf16 logits of one step apart by up to ~0.17
NEAR_TIE = 0.25
PAGED_PROMPT, PAGED_TOKENS = 120, 38  # cache_len 120 + 38 + 2 = 160 = 10 blocks of 16
ATTENTION = ("decode_attention", "paged_decode_attention", "paged_mla_decode_attention")
PREFILL = ("flash_attention", "ssd_chunked")


def _tracked_runners():
    """Wrap ``DecodeRunner.__init__`` so that every runner built meanwhile
    lands in the returned list; call the returned ``undo`` to unwrap."""
    from repro_torch.serving.runner import DecodeRunner

    runners, init = [], DecodeRunner.__init__

    def tracking(self, *a, **kw):
        init(self, *a, **kw)
        runners.append(self)

    DecodeRunner.__init__ = tracking

    def undo():
        DecodeRunner.__init__ = init

    return runners, undo


def counted(fn):
    """Run fn() with every kernel's launch count set to 0 just before and
    read just after, and count the model's prefills (``LM.prefill`` and
    ``EncDecLM.prefill`` calls),
    the classifiers' forwards (``EncoderClassifier.forward`` and
    ``ResNet.forward`` calls) and the decode steps of every runner fn
    builds (``decode_steps``: a replayed window graph runs its steps without
    calling ``LM.decode``). Returns (fn's result, {kernel: launches,
    "prefills": n, "forwards": n, "decode_steps": n})."""
    from repro_torch.kernels import counted_wrappers
    from repro_torch.models.encdec import EncDecLM, EncoderClassifier
    from repro_torch.models.resnet import ResNet
    from repro_torch.models.transformer import LM

    fns = counted_wrappers()
    for f in fns.values():
        f.launches = 0
    calls = {"prefills": 0, "forwards": 0}
    hooked = [(LM, "prefill", "prefills"), (EncDecLM, "prefill", "prefills"),
              (EncoderClassifier, "forward", "forwards"), (ResNet, "forward", "forwards")]
    origs = [getattr(cls, name) for cls, name, _ in hooked]

    def counting(orig, key):
        def call(self, *a, **kw):
            calls[key] += 1
            return orig(self, *a, **kw)
        return call

    for (cls, name, key), orig in zip(hooked, origs):
        setattr(cls, name, counting(orig, key))
    runners, undo = _tracked_runners()
    try:
        out = fn()
    finally:
        for (cls, name, _), orig in zip(hooked, origs):
            setattr(cls, name, orig)
        undo()
    torch.cuda.synchronize()
    calls["decode_steps"] = sum(r.decode_steps for r in runners)
    return out, {**{name: f.launches for name, f in fns.items()}, **calls}


def check_prefill_launches(phase, cfg, launches, kernel):
    """``kernel`` (None: none) ran once a layer a prefill, no other
    prefill kernel ran, and the run prefilled."""
    n = launches["prefills"]
    for k in PREFILL:
        expect = cfg.n_layers * n if k == kernel else 0
        if launches[k] != expect or n <= 0:
            fail(f"{phase} launched {k} {launches[k]} times in {n} prefills; expected {expect}")


def _final_logits(params, cfg, toks, act=()):
    """f32 logits of the final head at the last position of each row of
    toks, through the dense path (no kernel, no launch counted; a cross
    plan's layers over zero memory, as served); with
    ``act`` (site indices), (ramp logits (K, B, V), final logits (B, V))."""
    from repro_torch.models import build_model
    from repro_torch.models import layers as LY

    model = build_model(cfg.replace(decode_attn="dense", pallas_head="off"), ssd_impl="ref")
    seen = {}
    orig = model._head_stats

    def head_stats(params_, h_last, pooled, *a, **kw):
        seen["h"], seen["pooled"] = h_last, pooled
        return orig(params_, h_last, pooled, *a, **kw)

    model._head_stats = head_stats
    kw = {}
    if cfg.cross_attn_every:  # the served cross layers attend zero memory
        kw["image_embeds"] = torch.zeros(toks.shape[0], cfg.n_image_tokens, cfg.d_frontend,
                                         device=toks.device)
    model.prefill(params, toks, active_sites=None, with_cache=False, **kw)
    h = LY.apply_norm(cfg, params["final_norm"], seen["h"])[:, 0]
    final = _logits_ref(h, head_weight(params, cfg), cfg.vocab_size)
    if not act:
        return final
    hs = model._ramp_hidden(params, seen["pooled"], act)[:, :, 0]
    ramps = torch.stack([_logits_ref(hs[j], params["ramps"]["head"][i], cfg.vocab_size)
                         for j, i in enumerate(act)])
    return ramps, final


class TokenHidden:
    """Records, for one serving run, the hidden state the final head read
    for every generated token of every request, in that run's own
    numerics: the prefill's last position for token 0 (``start``), then
    window step k of a slot at pos p for token p - prompt_len + 1 + k
    (``step_multi``). ``logits(rid, t)`` gives that token's f32 logits."""

    def __init__(self, params, cfg):
        self.params, self.cfg, self.h = params, cfg, {}

    def __call__(self, fn):
        from repro_torch.models.transformer import LM
        from repro_torch.serving.runner import DecodeRunner

        start, step_multi, head_stats = DecodeRunner.start, DecodeRunner.step_multi, LM._head_stats
        item_of, rows = {}, []  # slot -> request; the current call's (request, token) rows

        def rec_start(runner, slot, item):
            item_of[slot] = item
            rows[:] = [(item, 0)]
            return start(runner, slot, item)

        def rec_step_multi(runner, slots, active, n_steps, thresholds):
            S = runner.prompts.shape[1]
            rows[:] = [(item_of[sl], int(runner._pos[sl]) - S + 1) for sl in slots]
            return step_multi(runner, slots, active, n_steps, thresholds)

        def rec_head_stats(model, params_, h_last, *a, **kw):
            for i, (item, t) in enumerate(rows):
                self.h[(item, t)] = h_last[i, -1].clone()
            rows[:] = [(item, t + 1) for item, t in rows]  # the window's next step
            return head_stats(model, params_, h_last, *a, **kw)

        DecodeRunner.start, DecodeRunner.step_multi = rec_start, rec_step_multi
        LM._head_stats = rec_head_stats
        try:
            return fn()
        finally:
            DecodeRunner.start, DecodeRunner.step_multi = start, step_multi
            LM._head_stats = head_stats

    def logits(self, rid, t):
        from repro_torch.models import layers as LY

        h = LY.apply_norm(self.cfg, self.params["final_norm"], self.h[(rid, t)][None])
        return _logits_ref(h, head_weight(self.params, self.cfg), self.cfg.vocab_size)[0]


def _complete(resp, n, n_tokens, vocab, what):
    if len(resp) != n:
        fail(f"{what}: served {len(resp)} of {n} requests")
    for r in resp:
        if r.dropped or r.shed or len(r.tokens) != n_tokens or len(r.final_tokens) != n_tokens:
            fail(f"{what}: request {r.rid} did not complete its {n_tokens} tokens")
        if not all(0 <= x < vocab for x in r.final_tokens):
            fail(f"{what}: request {r.rid} has tokens outside the vocabulary")


def _window_kind(runner):
    """What the runner's last window did: "capture", "replay" or "eager"."""
    return "eager" if runner.graphs is None else runner.graphs.last


def graph_note(m) -> str:
    """A served run's windows by kind: captured, replayed, eager (a graphed
    run's first window of each key runs eager)."""
    return (f"windows {m['windows']}: {m['capture_windows']} captured "
            f"({m['capture_window_ms_mean']:.3f} ms each), {m['replay_windows']} replayed "
            f"({m['replay_window_ms_mean']:.3f} ms each), {m['eager_windows']} eager "
            f"({m['eager_window_ms_mean']:.3f} ms each)")


def window_ops(fn):
    """fn() with the aten ops that each ``DecodeRunner.step_multi`` call
    dispatches counted, by the kind of window (capture, replay, eager), and
    those inside ``LM.decode`` apart: the host work a window costs, whatever
    the host's speed. Steps are the runner's ``decode_steps``. The count
    slows the run, so its times are not used. Returns (fn's result,
    {"ops_per_window": {kind: ops}, "windows": {kind: n},
    "decode_ops_per_step": ops inside LM.decode a step of the eager
    windows})."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.transformer import LM
    from repro_torch.serving.runner import DecodeRunner

    c = {"ops": 0, "decode_ops": 0, "in_decode": False, "decode_steps": 0,
         "by_kind": {}, "windows": {}}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            c["ops"] += 1
            c["decode_ops"] += c["in_decode"]
            return func(*args, **(kwargs or {}))

    step_multi, decode = DecodeRunner.step_multi, LM.decode

    def counting_step_multi(runner, *a, **kw):
        ops0, dec0, steps0 = c["ops"], c["decode_ops"], runner.decode_steps
        with Count():
            out = step_multi(runner, *a, **kw)
        kind = _window_kind(runner)
        c["by_kind"][kind] = c["by_kind"].get(kind, 0) + c["ops"] - ops0
        c["windows"][kind] = c["windows"].get(kind, 0) + 1
        if kind == "eager":  # a capture runs its steps twice, a replay not at all
            c["decode_steps"] += runner.decode_steps - steps0
        else:
            c["decode_ops"] = dec0
        return out

    def counting_decode(model, *a, **kw):
        c["in_decode"] = True
        try:
            return decode(model, *a, **kw)
        finally:
            c["in_decode"] = False

    DecodeRunner.step_multi, LM.decode = counting_step_multi, counting_decode
    try:
        out = fn()
    finally:
        DecodeRunner.step_multi, LM.decode = step_multi, decode
    if not c["windows"]:
        fail("window_ops: no window ran")
    return out, {"ops_per_window": {k: c["by_kind"][k] / n for k, n in c["windows"].items()},
                 "windows": c["windows"],
                 "decode_ops_per_step": c["decode_ops"] / max(c["decode_steps"], 1)}


def _divergence_gap(params, cfg, prompt, toks_a, toks_b):
    """Where two greedy sequences of one prompt first differ, the gap of the
    dense path's f32 logits between the two labels there (0.0 if equal)."""
    t = next((i for i, (x, y) in enumerate(zip(toks_a, toks_b)) if x != y), None)
    if t is None:
        return None, 0.0
    ctx = torch.tensor([list(prompt) + list(toks_a[:t])], device="cuda")
    lg = _final_logits(params, cfg, ctx)[0]
    return t, abs(lg[toks_a[t]] - lg[toks_b[t]]).item()


def _moe_divergences(phase, runs, hidden):
    """The MoE model's layouts, the paged run on the contiguous run's
    experts: where a request's tokens first differ, both runs' own f32
    logits (``TokenHidden``) must give their served labels, lie within
    eps <= 0.25 of each other (phase 5a's cap), and each put the two labels
    within NEAR_TIE of each other. The dense path of ``_divergence_gap``
    would route the experts afresh, so no third path can judge the tie.
    Returns the requests that differ."""
    ties = []
    for rid, rc in runs["contiguous"][1].items():
        rp = runs["paged"][1][rid]
        t = next((i for i, (x, y) in enumerate(zip(rc.final_tokens, rp.final_tokens))
                  if x != y), None)
        if t is None:
            continue
        x, y = rc.final_tokens[t], rp.final_tokens[t]
        lc, lp = hidden["contiguous"].logits(rid, t), hidden["paged"].logits(rid, t)
        if lc[x] < lc.max() - 1e-3 or lp[y] < lp.max() - 1e-3:  # as check_ramp_head's ties
            fail(f"{phase} request {rid}: the recorded logits of token {t} do not give the "
                 f"served labels {x}, {y}")
        eps = (lc - lp).abs().max().item()
        gap_c, gap_p = (lc[x] - lc[y]).item(), (lp[y] - lp[x]).item()
        print(f"{phase} request {rid}: paged and contiguous tokens differ from token {t} "
              f"({x} vs {y}), contiguous logit gap {gap_c:.4f}, paged {gap_p:.4f}, "
              f"paths apart by eps {eps:.4f}", flush=True)
        if eps > 0.25 or gap_c >= NEAR_TIE or gap_p >= NEAR_TIE:
            fail(f"{phase} request {rid}: a difference that begins at no near-tie")
        ties.append(rid)
    return ties


def serve_paged_vs_contiguous(params, cfg, serve, phase, cont_kernel, paged_kernel,
                              prefill_kernel, rounds=2, ops=True):
    """Phases 4b, 5b, 6b, 10c and 11c: 8 requests, prompt 120, 38 tokens, windows of
    4, served on the contiguous runner and on the paged pool (bs 16,
    paged-kernel) on one schedule. Greedy tokens equal, except a difference
    that begins at a near-tie. Each run launches its attention kernel
    (``cont_kernel``, ``paged_kernel``; None: none) once per layer per
    decode step and no other attention kernel, its prefill kernel
    (``prefill_kernel``; None: none) once per layer per prefill, and both
    ramp-head kernels.

    Every run serves its windows as CUDA graph replays, except where a run
    carries Python hooks, which a replay would skip. For the MoE model the
    compared runs carry hooks (the paged run replays the contiguous run's
    routing, both record their final-head inputs) and run eager, so the
    times come from runs of each layout without any hook, in the order
    contiguous, paged, paged, contiguous, ``rounds`` times, and with
    ``ops`` one more eager run of each counts the aten ops of a window
    (``window_ops``; Qwen3-MoE, whose eager windows take ~0.7 s, counts
    none). Returns the compared contiguous and paged runs' launch
    counts."""
    import numpy as np

    prompts = np.random.default_rng(SEED + 2).integers(1, cfg.vocab_size, (8, PAGED_PROMPT))
    layouts = (("contiguous", 0), ("paged", 16))

    def serve_once(name, bs, wrap=lambda call: call(), graphs=None):
        (out, resp), launches = counted(lambda: wrap(lambda: serve(
            cfg.name, decode_tokens=PAGED_TOKENS, steps_per_sync=4, seed=SEED, device="cuda",
            verbose=False, kv_block_size=bs, prompts=prompts, params=params, graphs=graphs)))
        _complete(resp, 8, PAGED_TOKENS, cfg.vocab_size, f"{phase} {name}")
        want = cont_kernel if bs == 0 else paged_kernel
        steps = launches["decode_steps"]
        for k in ATTENTION:
            expect = cfg.n_layers * steps if k == want else 0
            if launches[k] != expect or steps <= 0:
                fail(f"{phase} {name} run launched {k} {launches[k]} times in {steps} decode "
                     f"steps; expected {expect}")
        for k in ("ramp_head_stats", "ramp_head_exit"):
            if launches[k] <= 0:
                fail(f"{phase} {name} run launched {k} {launches[k]} times")
        check_prefill_launches(f"{phase} {name} run", cfg, launches, prefill_kernel)
        return out, {r.rid: r for r in resp}, launches

    runs = {}
    if cfg.moe:
        routes, hidden = RouteReplay(), {}
        for name, bs in layouts:
            hidden[name] = TokenHidden(params, cfg)
            mode = "record" if bs == 0 else "replay"
            runs[name] = serve_once(name, bs, lambda call, h=hidden[name], m=mode: h(
                lambda: routes(m, call)), graphs=False)
        ties = _moe_divergences(phase, runs, hidden)
        timed = []
        order = (layouts + layouts[::-1]) * rounds
        for name, bs in order:
            gc.collect()  # earlier runs' engine objects sit in reference cycles
            timed.append((name, serve_once(name, bs)))
        hooked = " vs ".join(f"{runs[name][0]['measured']['window_ms_mean']:.3f}"
                             for name, _ in layouts)
        extra = (f"MoE routing replayed from the contiguous run: {routes.flip_count()} of "
                 f"{routes.routes} token routes of the paged run would have taken other "
                 f"experts; eager ms per window with the hooks {hooked}; ")
        if ops:
            n = [window_ops(lambda: serve_once(name, bs, graphs=False))[1]
                 for name, bs in layouts]
            extra += (f"eager aten ops per window {n[0]['ops_per_window']['eager']:.1f} vs "
                      f"{n[1]['ops_per_window']['eager']:.1f}, in LM.decode per step "
                      f"{n[0]['decode_ops_per_step']:.1f} vs "
                      f"{n[1]['decode_ops_per_step']:.1f}; ")
        extra += ("times below from graphed runs without hooks in the order "
                  + ", ".join(name[0] for name, _ in order) + " (median last); ")
    else:
        for name, bs in layouts:
            runs[name] = serve_once(name, bs)
        ties = []
        for rid, rc in runs["contiguous"][1].items():
            rp = runs["paged"][1][rid]
            t, gap = _divergence_gap(params, cfg, prompts[rid], rc.final_tokens,
                                     rp.final_tokens)
            if t is not None:
                print(f"{phase} request {rid}: paged and contiguous tokens differ from token "
                      f"{t} ({rc.final_tokens[t]} vs {rp.final_tokens[t]}), logit gap "
                      f"{gap:.4f}", flush=True)
                if gap >= NEAR_TIE:
                    fail(f"{phase} request {rid}: a difference that begins at no near-tie")
                ties.append(rid)
        timed = [(name, runs[name]) for name, _ in layouts]
        extra = ""
    m = {name: [run[0]["measured"] for n, run in timed if n == name] for name, _ in layouts}

    def each(key, fmt):
        def one(xs):
            vals = [x[key] for x in xs]
            med = f" (median {statistics.median(vals):{fmt}})" if len(vals) > 1 else ""
            return "/".join(format(v, fmt) for v in vals) + med
        return " vs ".join(one(m[name]) for name, _ in layouts)

    c_l, p_l = runs["contiguous"][2], runs["paged"][2]
    print(f"{phase} {cfg.name} paged vs contiguous serving on {card_line()}, 8 x "
          f"{PAGED_TOKENS} tokens: {8 - len(ties)} of 8 requests token-identical, near-tie "
          f"divergences {ties}; {extra}ms per window {each('window_ms_mean', '.3f')} "
          f"(contiguous vs paged), of it ms per replayed window "
          f"{each('replay_window_ms_mean', '.3f')} and per capture window "
          f"{each('capture_window_ms_mean', '.3f')} (windows captured/replayed/eager "
          f"{each('capture_windows', 'g')} / {each('replay_windows', 'g')} / "
          f"{each('eager_windows', 'g')}), prefill ms "
          f"{each('prefill_ms_mean', '.3f')}, decode "
          f"tokens/s {each('decode_tokens_per_s', '.2f')}; launches {json.dumps(c_l)} vs "
          f"{json.dumps(p_l)}; paged kv {json.dumps(runs['paged'][0]['kv_cache'])}",
          flush=True)
    return c_l, p_l


def serve_prefix_swap(params, cfg, serve, phase="4c"):
    """Phases 4c and 10c: 8 requests drawing on 4 prompts that share a
    64-token prefix, each prompt sent twice, with the prefix cache and swap
    preemption on a 24-block pool (full capacity is 80): it runs dry with
    up to four streams decoding together."""
    import numpy as np

    base = np.random.default_rng(SEED + 3).integers(1, cfg.vocab_size, (4, PAGED_PROMPT))
    base[:, :64] = base[0, :64]
    prompts = np.concatenate([base, base])
    (out, resp), launches = counted(lambda: serve(
        cfg.name, decode_tokens=PAGED_TOKENS, steps_per_sync=4, seed=SEED, device="cuda",
        verbose=False, kv_block_size=16, kv_blocks=24, prefix_cache=True, preempt="swap",
        prompts=prompts, params=params))
    _complete(resp, 8, PAGED_TOKENS, cfg.vocab_size, phase)
    kv = out["kv_cache"]
    for key in ("prefix_hits", "cow_copies", "swap_outs"):
        if kv[key] <= 0:
            fail(f"{phase}: {key} is {kv[key]}; the run must share, copy on write and swap")
    if kv["swap_ins"] != kv["swap_outs"]:
        fail(f"{phase}: {kv['swap_outs']} swaps out but {kv['swap_ins']} back in")
    if launches["paged_decode_attention"] <= 0:
        fail(f"{phase}: the paged kernel was not launched")
    check_prefill_launches(phase, cfg, launches, "flash_attention")
    print(f"{phase} {cfg.name} prefix sharing + swap preemption, 24-block pool: "
          f"{graph_note(out['measured'])}; kv {json.dumps(kv)}; engine "
          f"{json.dumps(out['simulated']['engine'], default=float)}; launches "
          f"{json.dumps(launches)}", flush=True)


def serve_chunked(params, cfg, serve):
    """Phase 4d: 4 requests with prefill_chunk 64 on the paged runner. Their
    first tokens equal one-shot prefill's, except a printed near-tie (the
    resumed prompt tokens go through the decode kernel, the one-shot prompt
    through dense attention)."""
    import numpy as np

    from repro_torch.models import build_model

    prompts = np.random.default_rng(SEED + 4).integers(1, cfg.vocab_size, (4, PAGED_PROMPT))
    (out, resp), launches = counted(lambda: serve(
        CONFIG, decode_tokens=PAGED_TOKENS, steps_per_sync=4, seed=SEED, device="cuda",
        verbose=False, kv_block_size=16, prefill_chunk=64, prompts=prompts, params=params))
    _complete(resp, 4, PAGED_TOKENS, cfg.vocab_size, "4d")
    if launches["paged_decode_attention"] <= 0:
        fail("4d: the paged kernel was not launched")
    check_prefill_launches("4d", cfg, launches, "flash_attention")
    one_shot = build_model(cfg.replace(pallas_head="kernel"))
    toks = torch.tensor(prompts, device="cuda")
    _, outs = one_shot.prefill(params, toks, active_sites=None, with_cache=False)
    first = outs["final"]["label"].reshape(-1).tolist()
    logits = _final_logits(params, cfg, toks)
    ties = []
    for r in resp:
        a, b = r.final_tokens[0], first[r.rid]
        if a != b:
            gap = abs(logits[r.rid, a] - logits[r.rid, b]).item()
            print(f"4d request {r.rid}: chunked first token {a} vs one-shot {b}, "
                  f"logit gap {gap:.4f}", flush=True)
            if gap >= NEAR_TIE:
                fail(f"4d request {r.rid}: the first tokens differ at no near-tie")
            ties.append(r.rid)
    m = out["measured"]
    print(f"4d chunked prefill (64-token chunks): 4 of 4 complete, first tokens equal to "
          f"one-shot prefill on {4 - len(ties)} of 4 (near-ties {ties}); "
          f"{m['prefill_chunk_calls']} chunk calls, {m['prefill_chunk_ms_mean']:.3f} ms each; "
          f"{graph_note(m)}; "
          f"launches {json.dumps(launches)}", flush=True)


# ---------------------------------------------------------------------------
# phases 5a-5c: DeepSeek-V2-Lite (MLA + MoE) at full width


def serve_swap(params, cfg, serve, phase, seed, decode_kernel, prefill_kernel, kv_blocks=24):
    """Phases 5c, 6c and 11c: 8 requests (prompt 120, 38 tokens) with swap
    preemption on a ``kv_blocks`` pool (by default 24; full capacity is 80,
    a stream needs up to 10 blocks and a cross plan's its pinned xkv pages
    too): the pool runs dry and streams are swapped out and back in, and
    every block (pins included) is free at the end. No prefix cache:
    latent, state and xkv pages are not shared. ``decode_kernel`` (None:
    none) runs once a layer a decode step, ``prefill_kernel`` once a layer
    a prefill."""
    import numpy as np

    prompts = np.random.default_rng(seed).integers(1, cfg.vocab_size, (8, PAGED_PROMPT))
    (out, resp), launches = counted(lambda: serve(
        cfg.name, decode_tokens=PAGED_TOKENS, steps_per_sync=4, seed=SEED, device="cuda",
        verbose=False, kv_block_size=16, kv_blocks=kv_blocks, preempt="swap", prompts=prompts,
        params=params))
    _complete(resp, 8, PAGED_TOKENS, cfg.vocab_size, phase)
    kv = out["kv_cache"]
    if not kv["swap_outs"] > 0 or kv["swap_ins"] != kv["swap_outs"] or kv["live_blocks"]:
        fail(f"{phase}: {kv['swap_outs']} swaps out and {kv['swap_ins']} back in, "
             f"{kv['live_blocks']} blocks live at the end; the run must swap, every stream "
             "swapped out must come back, and every block must be freed")
    steps = launches["decode_steps"]
    for k in ATTENTION:
        expect = cfg.n_layers * steps if k == decode_kernel else 0
        if launches[k] != expect or steps <= 0:
            fail(f"{phase}: {k} launched {launches[k]} times in {steps} decode steps")
    for k in ("ramp_head_stats", "ramp_head_exit"):
        if launches[k] <= 0:
            fail(f"{phase}: {k} launched {launches[k]} times")
    check_prefill_launches(phase, cfg, launches, prefill_kernel)
    print(f"{phase} {cfg.name} swap preemption, {kv_blocks}-block pool: "
          f"{graph_note(out['measured'])}; "
          f"kv {json.dumps(kv)}; engine "
          f"{json.dumps(out['simulated']['engine'], default=float)}; launches "
          f"{json.dumps(launches)}", flush=True)


def _cut_depth(params, cfg, serve):
    """The first ``SERVE_DEPTH`` layers of a whole model: its config, views
    of its params (each layer-stacked leaf's first layers, the first ramp
    sites' heads) and ``serve`` at that depth."""
    import functools

    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map2

    def first(x, want):
        y = x[:want.shape[0]]
        if y.shape != want.shape:
            fail(f"a leaf of {tuple(x.shape)} does not cut to {tuple(want.shape)}")
        return y

    cut = cfg.replace(n_layers=SERVE_DEPTH)
    part = tree_map2(first, params, build_model(cut).abstract())
    return part, cut, functools.partial(serve, n_layers=SERVE_DEPTH)


def deepseek_phases(gen, serve):
    """Phases 5a-5d on full-width DeepSeek-V2-Lite with seeded random
    weights. Returns (phase 5b's paged serving run's launches, the
    ramp-head rows at this model's shapes, phase 5d's summary)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    # absorbed MLA on both layouts, as the launcher serves it
    cfg = get_config(DS_CONFIG).replace(mla_absorbed=True)
    t0 = time.perf_counter()
    params = build_model(cfg).init(SEED, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"drew {DS_CONFIG} weights ({n / 1e9:.3f} B params with the ramp heads, {cfg.dtype}; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rh = check_ramp_head(params, cfg, gen)
    t = tick("5 draw and ramp heads", t0)
    # 5a: prefill + 8 decode steps on the paged pool, kernels off vs on
    compare_paths(params, cfg, cfg.replace(decode_attn="paged", pallas_head="off"),
                  cfg.replace(decode_attn="paged-kernel", pallas_head="kernel"), gen,
                  paged_bs=16)
    t = tick("5a", t)
    # 5b: contiguous rows (absorbed plain math, no attention kernel) vs the
    # pool (the paged MLA kernel in every layer), at SERVE_DEPTH
    params, cfg, serve = _cut_depth(params, cfg, serve)
    _, launches = serve_paged_vs_contiguous(params, cfg, serve, "5b", None,
                                         "paged_mla_decode_attention", None, rounds=1)
    t = tick("5b", t)
    serve_swap(params, cfg, serve, "5c", SEED + 5, "paged_mla_decode_attention", None)
    t = tick("5c", t)
    graphs = graph_vs_eager(params, cfg, serve, "5d", SEED + 8, act=SERVE_ACT)
    tick("5d", t)
    return launches, rh, graphs


# ---------------------------------------------------------------------------
# phases 6a-6c: Mamba2-2.7B (SSD) at full width


def time_state_update(cfg, gen, B=8):
    """One mamba layer's recurrent state update at the served batch, as a
    decode step runs it: the plain ``ssd_decode_step`` and the gated
    in-place write of the new state (``LM._mamba``). Device ms (CUDA events,
    L2 flushed) beside the bound of reading and writing the f32 state once."""
    from repro_torch.models import mamba as MB

    H, hp, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    state = torch.randn(B, H, hp, N, generator=gen, device="cuda")
    x = torch.randn(B, H, hp, generator=gen, device="cuda").to(torch.bfloat16)
    dts = torch.nn.functional.softplus(torch.randn(B, H, generator=gen, device="cuda") - 2)
    A = -torch.exp(torch.rand(H, generator=gen, device="cuda") * 2.7726)
    Bm = torch.randn(B, 1, N, generator=gen, device="cuda").to(torch.bfloat16)
    Cm = torch.randn(B, 1, N, generator=gen, device="cuda").to(torch.bfloat16)
    gate = torch.ones((), dtype=torch.bool, device="cuda")

    def step():
        _, new = MB.ssd_decode_step(state, x, dts, A, Bm, Cm)
        state.copy_(torch.where(gate, new, state))

    nbytes = 2 * 4 * state.numel()
    row = {"shape": f"B={B} H={H} hp={hp} N={N} f32 state", "ms": time_ms(step),
           "bound_ms": bound_ms(nbytes, 0)[0], "state_bytes_per_layer": nbytes // 2,
           "layers": cfg.n_layers}
    print(f"mamba state update, one layer (plain ssd_decode_step + gated write): "
          f"{json.dumps(row)}; x {cfg.n_layers} layers = {row['ms'] * cfg.n_layers:.3f} ms "
          "a decode step", flush=True)


def mamba_phases(gen, serve):
    """Phases 6a-6d on full-width Mamba2-2.7B with seeded random weights.
    Returns (phase 6b's paged serving run's launches, the ramp-head rows at
    this model's shapes, phase 6d's summary)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    cfg = get_config(MB_CONFIG)
    t0 = time.perf_counter()
    params = build_model(cfg).init(SEED, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"drew {MB_CONFIG} weights ({n / 1e9:.3f} B params with the ramp heads, {cfg.dtype}; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rh = check_ramp_head(params, cfg, gen)
    time_state_update(cfg, gen)
    t = tick("6 draw, ramp heads and state update", t0)
    # 6a: prefill (the SSD kernel vs the plain scan) + 8 decode steps, kernels
    # off vs on, on contiguous state rows
    compare_paths(params, cfg, cfg.replace(decode_attn="dense", pallas_head="off"),
                  cfg.replace(decode_attn="kernel", pallas_head="kernel"), gen,
                  off_kw={"ssd_impl": "ref"}, on_kw={"ssd_impl": "kernel"},
                  prefill_kernel="ssd_chunked")
    t = tick("6a", t)
    # 6b: contiguous state rows vs state pages (no decode attention kernel),
    # at SERVE_DEPTH
    params, cfg, serve = _cut_depth(params, cfg, serve)
    _, launches = serve_paged_vs_contiguous(params, cfg, serve, "6b", None, None,
                                            "ssd_chunked")
    t = tick("6b", t)
    serve_swap(params, cfg, serve, "6c", SEED + 6, None, "ssd_chunked")
    t = tick("6c", t)
    graphs = graph_vs_eager(params, cfg, serve, "6d", SEED + 9, act=SERVE_ACT)
    tick("6d", t)
    return launches, rh, graphs


# ---------------------------------------------------------------------------
# phases 4e, 5d and 6d: one sync window as one CUDA graph replay


def graph_vs_eager(params, cfg, serve, phase, seed, prompt_len=PAGED_PROMPT,
                   act=(2, 5, 8, 11)):
    """Phases 4e, 5d, 6d, 9d, 10d and 11d (active sites ``act``). On each
    layout, two runners over the same
    weights and prompts, one serving its windows as CUDA graphs and one
    eager: the same windows through both (the graphed runner's first runs
    eager, its second is captured, its third replays) must give records,
    n_done and every cache leaf equal bit for bit; the graph's kernel nodes
    must equal the eager window's launches; then host ms per replayed and per eager
    window (in turns), device-busy ms per window (``profile_step``), aten
    ops per replayed window and the graph pool's bytes. Last, one schedule
    served graphed and eager: greedy tokens equal except differences that
    begin at a near-tie. Its runners, and with them every graph, are gone
    before it returns."""
    import numpy as np
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import counted_wrappers
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import DecodeRunner
    from repro_torch.serving.graphs import kernel_nodes

    prompts = np.random.default_rng(seed).integers(1, cfg.vocab_size, (8, prompt_len))
    act = list(act)
    thr = np.full(len(act), 0.5, np.float32)
    slots = list(range(8))
    fns = counted_wrappers()
    summary = {}
    for layout, bs in (("contiguous", 0), ("paged", 16)):
        mcfg = cfg.replace(decode_attn="paged-kernel" if bs else "kernel", pallas_head="kernel")
        model = build_model(mcfg, prefill_attn="kernel", ssd_impl="kernel")
        kw = dict(max_new_tokens=PAGED_TOKENS + 2, max_slots=4, n_slots=8)
        if bs:
            kw["kv_block_size"] = bs
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved()
        e = DecodeRunner(model, params, prompts, graphs=False, **kw)
        g = DecodeRunner(model, params, prompts, **kw)
        if g.graphs is None:
            fail(f"{phase} {layout}: a runner on the card built no window graphs")
        for r in (e, g):
            for sl in slots:
                r.start(sl, sl)

        def window(r):
            n0 = {k: f.launches for k, f in fns.items()}
            out = r.step_multi(slots, act, 4, thr)
            return out, {k: f.launches - n0[k] for k, f in fns.items()}

        # a key's first window runs eager, its second is captured, then replays
        for what in ("eager", "capture", "replay"):
            torch.cuda.synchronize()
            reserved1 = torch.cuda.memory_reserved()
            ge, gl = window(g)
            torch.cuda.synchronize()
            if _window_kind(g) != what:
                fail(f"{phase} {layout}: the graphed runner's {what} window was a "
                     f"{_window_kind(g)}")
            if what == "capture":  # what the capture window added: the graph pool
                pool_bytes = torch.cuda.memory_reserved() - reserved1
            ee, el = window(e)
            for name, a, b in zip(("labels", "unc", "finals", "exits"), ge, ee):
                if not np.array_equal(a, b):
                    fail(f"{phase} {layout}: the {what} window's {name} differ from the eager "
                         f"window's (max abs {np.abs(a.astype(float) - b).max()})")
            if gl != el:
                fail(f"{phase} {layout}: the {what} window counted {gl}, the eager one {el}")
            for j, (a, b) in enumerate(zip(tree_leaves(g._cache), tree_leaves(e._cache))):
                if not torch.equal(a, b):
                    fail(f"{phase} {layout}: cache leaf {j} differs after the {what} window "
                         f"(max abs {(a.float() - b.float()).abs().max().item()})")
        gs = g.graphs
        if (gs.eagers, gs.captures, gs.replays) != (1, 1, 1):
            fail(f"{phase} {layout}: {gs.eagers} eager, {gs.captures} captured and "
                 f"{gs.replays} replayed windows; expected one of each")
        # the graph's kernel nodes (checked at capture against the launches it
        # counted) against the eager window's launches
        (w,) = gs.windows.values()
        nodes, edges, n_kernels = kernel_nodes(w.graph, with_edges=True)
        if nodes != w.nodes:
            fail(f"{phase} {layout}: the graph's nodes read now {nodes}, at capture {w.nodes}")
        want = {"decode_attention": el["decode_attention"],
                "paged_decode_attention": el["paged_decode_attention"],
                "paged_mla_decode_attention": el["paged_mla_decode_attention"],
                "ramp_head": el["ramp_head_stats"] + el["ramp_head_exit"],
                "ramp_merge": el["ramp_head_stats"] + el["ramp_head_exit"]}
        for k, v in want.items():
            if nodes[k] != v:
                fail(f"{phase} {layout}: the graph holds {nodes[k]} {k} kernel nodes, the "
                     f"eager window launched {v}")
        pdl = sum(1 for a, b, t in edges if (a, b) == ("paged_mla_decode_attention",
                                                      "mla_combine") and t == 1)
        if el["paged_mla_decode_attention"] and not (
                nodes["mla_combine"] == pdl == el["paged_mla_decode_attention"]):
            fail(f"{phase} {layout}: {nodes['mla_combine']} MLA combine nodes, {pdl} "
                 f"programmatic walk -> combine edges, {el['paged_mla_decode_attention']} "
                 "walks")
        # host ms a window, graphed (replays) and eager, in turns
        ms = {"replay": [], "eager": []}
        for r, kind in ((g, "replay"), (e, "eager"), (e, "eager"), (g, "replay")):
            t0 = time.perf_counter()
            r.step_multi(slots, act, 4, thr)  # ends in its host read of n_done
            ms[kind].append(1e3 * (time.perf_counter() - t0))
            if _window_kind(r) != kind:
                fail(f"{phase} {layout}: a timed window was not a {kind}")
        prof = {kind: profile_step(lambda r=r: r.step_multi(slots, act, 4, thr))
                for r, kind in ((g, "replay"), (e, "eager"))}
        c = {"ops": 0}

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                c["ops"] += 1
                return func(*args, **(kwargs or {}))

        with Count():
            g.step_multi(slots, act, 4, thr)
        if _window_kind(g) != "replay":
            fail(f"{phase} {layout}: the counted window was not a replay")
        steps = g.decode_steps
        if steps != e.decode_steps + 4:  # g ran one window more
            fail(f"{phase} {layout}: decode steps {steps} graphed vs {e.decode_steps} eager")
        row = {"windows_compared": 3, "kernel_nodes": n_kernels, "graph_nodes": nodes,
               "programmatic_mla_edges": pdl, "eager_window_launches": el,
               "host_ms_per_replayed_window": ms["replay"],
               "host_ms_per_eager_window": ms["eager"],
               "device_busy_ms_per_window": {k: v["device_busy_ms"] for k, v in prof.items()},
               "profiled_wall_ms": {k: v["wall_ms"] for k, v in prof.items()},
               "aten_ops_per_replayed_window": c["ops"],
               "graph_pool_bytes": pool_bytes,
               "reserved_bytes_before_runners": reserved0}
        print(f"{phase} {cfg.name} {layout}: graph vs eager window on {card_line()}: records, "
              f"n_done and every cache leaf equal bit for bit; {json.dumps(row)}", flush=True)
        summary[layout] = row
        del e, g, gs, model, w
        gc.collect()
        torch.cuda.empty_cache()
    # one schedule served both ways
    runs = {}
    for name, graphs in (("graphed", None), ("eager", False)):
        (out, resp), launches = counted(lambda graphs=graphs: serve(
            cfg.name, decode_tokens=PAGED_TOKENS, steps_per_sync=4, seed=SEED, device="cuda",
            verbose=False, kv_block_size=16, prompts=prompts, params=params, graphs=graphs))
        _complete(resp, 8, PAGED_TOKENS, cfg.vocab_size, f"{phase} {name}")
        runs[name] = (out["measured"], {r.rid: r for r in resp}, launches)
    ties = []
    for rid, rg in runs["graphed"][1].items():
        t, gap = _divergence_gap(params, cfg, prompts[rid], rg.final_tokens,
                                 runs["eager"][1][rid].final_tokens)
        if t is not None:
            print(f"{phase} request {rid}: graphed and eager tokens differ from token {t}, "
                  f"logit gap {gap:.4f}", flush=True)
            if gap >= NEAR_TIE:
                fail(f"{phase} request {rid}: graphed and eager differ at no near-tie")
            ties.append(rid)
    mg, me = runs["graphed"][0], runs["eager"][0]
    lg, le = runs["graphed"][2], runs["eager"][2]
    for k in ATTENTION:  # once a layer a step in both
        if lg[k] * le["decode_steps"] != le[k] * lg["decode_steps"]:
            fail(f"{phase}: {k} launched {lg[k]} times in {lg['decode_steps']} graphed steps, "
                 f"{le[k]} in {le['decode_steps']} eager ones")
    if not (lg["ramp_head_exit"] > 0 and mg["replay_windows"] > 0 and me["replay_windows"] == 0):
        fail(f"{phase}: the graphed run replayed {mg['replay_windows']} windows and launched "
             f"the exit heads {lg['ramp_head_exit']} times; the eager run replayed "
             f"{me['replay_windows']}")
    keys = ("windows", "capture_windows", "replay_windows", "eager_windows",
            "capture_window_ms_mean", "replay_window_ms_mean", "eager_window_ms_mean",
            "window_ms_mean", "decode_tokens_per_s")
    for m in (mg, me):  # the engine's and controller's host time outside the runner's calls
        m["engine_ms_per_window"] = 1e3 * (m["engine_wall_s"] - m["runner_s"]) / m["windows"]
    keys += ("engine_ms_per_window",)
    serve_row = {"graphed": {k: mg[k] for k in keys}, "eager": {k: me[k] for k in keys},
                 "graph_keys": mg["graphs"]["keys"],
                 "token_identical": 8 - len(ties), "near_tie_divergences": ties}
    print(f"{phase} {cfg.name} paged serving graphed vs eager, 8 x {PAGED_TOKENS} tokens: "
          f"{json.dumps(serve_row)}", flush=True)
    summary["serve"] = serve_row
    gc.collect()
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 9: Gemma3-4B (5 local : 1 global sliding-window attention) at full width


GM_CONFIG = "gemma3-4b"
# prompts longer than the 1024-token window, so every local layer's ring
# wraps during the prefill; 38 new tokens (+ 2) make a 1140-slot cache, 72
# blocks of 16 (1152 slots) paged
GM_PROMPT, GM_TOKENS = 1100, 38
# chunked prefill: a first chunk past the window (its scatter wraps every
# ring), then 40 resumed prompt tokens, one eager decode call each (tens of
# ms at full width, host-bound: 256-token chunks would resume 844 tokens,
# over a minute for one request)
GM_CHUNK, GM_CHUNKED_REQUESTS = 1060, 1


class _Config:
    """serve_generative builds its config from the name, as the launcher
    does; this hands it ``cfg`` (Gemma3's ``windowed_cache`` rings) for the
    name instead, the way the reference reaches its ring caches: through
    the config's own field."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __enter__(self):
        from repro_torch.launch import serve as LS

        self.orig = LS.get_config
        LS.get_config = lambda name: self.cfg if name == self.cfg.name else self.orig(name)

    def __exit__(self, *exc):
        from repro_torch.launch import serve as LS

        LS.get_config = self.orig


def gather_probe(gen, B=8, S=GM_PROMPT + GM_TOKENS + 2):
    """Phase 9a: what a local layer's decode step spends on its window
    outside any kernel: the chronological W-row gather of k and v out of a
    full contiguous cache (the reference's arithmetic: (B, W, KH, hd) each)
    and the masked sdpa over the gathered rows, at Gemma3's B 8, W 1024."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as LY

    cfg = get_config(GM_CONFIG)
    W, KH, hd, H = cfg.window, cfg.n_kv_heads, cfg.hd, cfg.n_heads
    kc = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(torch.bfloat16)
    vc = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn(B, 1, H, hd, generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.randint(S - GM_TOKENS - 2, S, (B,), generator=gen, device="cuda")
    rows = torch.arange(B, device="cuda")[:, None]

    def gather():
        tpos = pos[:, None] - (W - 1) + torch.arange(W, device="cuda")
        slot = torch.clamp(tpos, min=0)
        return kc[rows, slot], vc[rows, slot], (tpos >= 0)[:, None, None, :]

    k, v, mask = gather()
    row = {"shape": f"B={B} W={W} KH={KH} hd={hd} bf16, cache {S} rows",
           "gather_ms": device_ms(gather),
           "sdpa_ms": device_ms(lambda: LY.sdpa(q, k, v, mask)),
           "gathered_bytes_per_layer": 2 * k.numel() * k.element_size()}
    # read W rows of k and v, write them, read them again in sdpa
    row["gather_bound_ms"] = 1e3 * 3 * row["gathered_bytes_per_layer"] / HBM_BW
    row["per_step_ms_29_layers"] = 29 * (row["gather_ms"] + row["sdpa_ms"])
    print(f"9a local decode window (gather + sdpa, no kernel) on {card_line()}: "
          f"{json.dumps(row)}", flush=True)
    return row


def step_bytes(params, cfg, model, B, n_ramps, pos):
    """What one decode step of B rows at ``pos`` must read at least: every
    layer's weights, the tied final head, ``n_ramps`` ramp heads, the global
    layers' keys and values up to pos, and the local layers' W-row
    windows."""
    from repro_torch.models.common import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    layers = nbytes(params["blocks"]) + nbytes(params.get("suffix", []))
    head = nbytes(params["tok"]["embed"])
    ramp = params["ramps"]["head"][0].numel() * params["ramps"]["head"].element_size()
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * 2
    n_local = sum(1 for sl in model.plan.layer_specs() if sl.is_local)
    caches = B * kv_row * ((cfg.n_layers - n_local) * (pos + 1)
                           + (n_local * cfg.window if n_local else 0))
    return {"layers": layers, "final_head": head, "ramp_heads": n_ramps * ramp,
            "caches": caches, "total": layers + head + n_ramps * ramp + caches}


def serve_gemma_layouts(params, cfg, serve):
    """Phase 9c: the same 8 prompts of 1100 tokens, 38 tokens each, served on
    the full contiguous cache, on ``windowed_cache`` rings and on the paged
    pool (bs 16), then the pool once more with chunked prefill (one
    request, a 1060-token first chunk, then 40 resumed tokens). Greedy
    tokens equal across the layouts except a difference that begins at a
    near-tie (by the dense path's logits); the global layers launch their
    decode kernel once a layer a step, the flash kernel runs once a layer a
    prefill. The runs serve eager, so the layouts alone differ; 9d serves
    graphs. A prefix cache is refused."""
    import numpy as np

    from repro_torch.models import build_model

    prompts = np.random.default_rng(SEED + 9).integers(1, cfg.vocab_size, (8, GM_PROMPT))
    n_global = sum(1 for sl in build_model(cfg).plan.layer_specs() if not sl.is_local)
    runs = {}
    for name, bs, ccfg, kw in (
            ("full", 0, cfg, {}),
            ("ring", 0, cfg.replace(windowed_cache=True), {}),
            ("paged", 16, cfg, {}),
            ("paged chunked", 16, cfg, {"prefill_chunk": GM_CHUNK})):
        pr = prompts[:GM_CHUNKED_REQUESTS] if kw else prompts
        t0 = time.perf_counter()
        with _Config(ccfg):
            (out, resp), launches = counted(lambda: serve(
                cfg.name, decode_tokens=GM_TOKENS, steps_per_sync=4, seed=SEED, device="cuda",
                verbose=False, kv_block_size=bs, prompts=pr, params=params, graphs=False, **kw))
        wall = time.perf_counter() - t0
        _complete(resp, len(pr), GM_TOKENS, cfg.vocab_size, f"9c {name}")
        want = "paged_decode_attention" if bs else "decode_attention"
        steps = launches["decode_steps"]
        for k in ATTENTION:
            expect = n_global * steps if k == want else 0
            if launches[k] != expect or steps <= 0:
                fail(f"9c {name} launched {k} {launches[k]} times in {steps} decode steps; "
                     f"expected {expect}")
        for k in ("ramp_head_stats", "ramp_head_exit"):
            if launches[k] <= 0:
                fail(f"9c {name} launched {k} {launches[k]} times")
        check_prefill_launches(f"9c {name}", cfg, launches, "flash_attention")
        runs[name] = (out, {r.rid: r for r in resp}, launches)
        m = out["measured"]
        print(f"9c {cfg.name} {name} ({len(pr)} x {GM_PROMPT}-token prompts, {GM_TOKENS} tokens)"
              f": {wall:.1f} s, prefill {m['prefill_ms_mean']:.3f} ms, chunk calls "
              f"{m['prefill_chunk_calls']} at {m['prefill_chunk_ms_mean']:.3f} ms, "
              f"{m['window_ms_mean']:.3f} ms per eager window of up to 4 steps, "
              f"{m['decode_tokens_per_s']:.1f} decode tokens/s; kv {json.dumps(out['kv_cache'])}; "
              f"launches {json.dumps(launches)}", flush=True)
    ties, same = [], 0
    base = runs["full"][1]
    for name in ("ring", "paged", "paged chunked"):
        for rid, rr in runs[name][1].items():
            t, gap = _divergence_gap(params, cfg, prompts[rid], base[rid].final_tokens,
                                     rr.final_tokens)
            if t is None:
                same += 1
                continue
            print(f"9c request {rid}: {name} and full tokens differ from token {t}, logit gap "
                  f"{gap:.4f}", flush=True)
            if gap >= NEAR_TIE:
                fail(f"9c request {rid}: {name} and full differ at no near-tie")
            ties.append((name, rid))
    try:
        serve(cfg.name, 2, decode_tokens=2, prompt_len=16, seed=SEED, device="cuda",
              verbose=False, kv_block_size=16, prefix_cache=True, params=params)
        fail("9c: a prefix cache over ring pages was not refused")
    except ValueError as e:
        refused = str(e)
    print(f"9c layouts on {card_line()}: {same} of {8 + 8 + GM_CHUNKED_REQUESTS} "
          f"(ring, paged, chunked) requests token-identical to the full cache, near-tie "
          f"divergences {ties}; prefix cache refused: {refused}", flush=True)
    return runs["full"][2], runs["paged"][2]


def gemma_phases(gen, serve):
    """Phase 9: Gemma3-4B at full width (34 layers: 29 local with a
    1024-token window and RoPE base 1e4, 5 global; d 2560, 8 heads on 4 of
    256, qk-norm, a tied 262144-token vocab, 12 ramp heads), seeded random
    bf16 weights. 9a: the kernels alone at its shapes and the local decode
    window's plain gather; 9b: an 1100-token prefill through sdpa vs the
    flash kernel, then 40 decode steps with the kernels off vs on, one
    eager step profiled; on its first ``SERVE_DEPTH`` layers, 9c: three
    layouts; 9d: window graphs. Returns the kernel rows (with the cut
    model's local and all layers, ``prefill_layers``) and the runs'
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    cfg = get_config(GM_CONFIG)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"drew {GM_CONFIG} weights ({n / 1e9:.3f} B params, {cfg.dtype}, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rows = {}
    # -- 9a: the kernels alone at Gemma3's shapes
    rows["decode"] = check_decode_attention(
        8, 1200, "B=8 H=8 KH=4 hd=256 S=1200 pos 1100..1199 bf16", gen, pos_lo=1100,
        H=8, KH=4, hd=256)
    rows["paged"] = check_paged_decode_attention(
        8, 75, "B=8 H=8 KH=4 hd=256 bs=16 nb=75 pos 1100..1199 shuffled bf16", gen, 1100, 1200,
        H=8, KH=4, hd=256)
    rows["flash_window"] = check_flash_attention(
        1, 8, 4, GM_PROMPT, GM_PROMPT, 256,
        f"B=1 H=8 KH=4 hd=256 Sq=Sk={GM_PROMPT} causal window=1024 bf16", gen, window=1024)
    rows["flash_causal"] = check_flash_attention(
        1, 8, 4, GM_PROMPT, GM_PROMPT, 256, f"B=1 H=8 KH=4 hd=256 Sq=Sk={GM_PROMPT} causal bf16",
        gen)
    rows["ramp"] = check_ramp_head(params, cfg, gen)
    rows["gather"] = gather_probe(gen)
    t = tick("9 draw and 9a kernels", t0)
    floor = step_bytes(params, cfg, model, 8, 4, GM_PROMPT + 20)
    floor["ms"] = 1e3 * floor["total"] / HBM_BW
    rows["floor"] = floor
    print(f"9a {GM_CONFIG} decode step byte floor at B 8, 4 ramps, pos {GM_PROMPT + 20}: "
          f"{json.dumps(floor)} (bytes; ms at 3.35 TB/s)", flush=True)
    # -- 9b: the model, kernels off vs on
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    toks = torch.randint(1, cfg.vocab_size, (8, GM_PROMPT), generator=g, device="cuda")
    rows["paths"] = compare_paths(
        params, cfg, cfg.replace(decode_attn="dense", pallas_head="off"),
        cfg.replace(decode_attn="kernel", pallas_head="kernel"), gen, toks=toks, T=40,
        on_kw={"prefill_attn": "kernel"}, prefill_kernel="flash_attention")
    t = tick("9a floor and 9b", t)
    # -- 9c: three layouts; 9d: window graphs, at SERVE_DEPTH
    params, cfg, serve = _cut_depth(params, cfg, serve)
    local = [sl.is_local for sl in build_model(cfg).plan.layer_specs()]
    rows["prefill_layers"] = (sum(local), len(local))
    full_l, paged_l = serve_gemma_layouts(params, cfg, serve)
    t = tick("9c", t)
    rows["graphs"] = graph_vs_eager(params, cfg, serve, "9d", SEED + 11, prompt_len=GM_PROMPT,
                                    act=SERVE_ACT)
    tick("9d", t)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return rows, full_l, paged_l



# ---------------------------------------------------------------------------
# phase 4f and phases 7a-7b: the paper's classification workloads


CLS_ACT = 4  # active ramps in the runner checks


def _spread(n_sites: int, k: int) -> list:
    """k site indices spread from the first site to the last."""
    return sorted({round(i * (n_sites - 1) / (k - 1)) for i in range(k)})


def _records_agree(rec, rec_ref, logits, tol, unc_tol, what):
    """Runner records (labels (K, B), unc (K, B), final (B,)) against a
    reference path's: labels equal except near-ties (by the reference's f32
    ``logits``: (ramp (K, B, C), final (B, C))), unc within ``unc_tol``.
    Returns (near-ties, max |unc difference|)."""
    (lab, unc, fin), (lab_r, unc_r, fin_r) = rec, rec_ref
    ramp_logits, final_logits = logits
    ties = _near_tie_labels(torch.as_tensor(fin), torch.as_tensor(fin_r), final_logits.cpu(),
                            tol, f"{what} final")
    K, B = lab.shape
    ties += _near_tie_labels(torch.as_tensor(lab).reshape(-1), torch.as_tensor(lab_r).reshape(-1),
                             ramp_logits.cpu().reshape(K * B, -1), tol, f"{what} ramps")
    du = float(abs(unc - unc_r).max()) if unc.size else 0.0
    if du > unc_tol:
        fail(f"{what}: ramp uncertainties differ by {du}")
    return ties, du


def _bucket_times(runner, act, buckets=(1, 2, 4, 8), reps=3):
    """Host ms of one ``infer`` a bucket (each ends in its record read),
    with no ramp and with ``act``, after a warm-up call."""
    out = {}
    for bs in buckets:
        for a in ([], act):
            items = list(range(bs))
            runner.infer(items, a)
            t0 = time.perf_counter()
            for _ in range(reps):
                runner.infer(items, a)
            out[f"{bs}/{len(a)}"] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def _served_note(out) -> str:
    m = out["measured"]
    return (f"host ms per infer by bucket {json.dumps(m['infer_ms_by_bucket'])} "
            f"(calls {json.dumps(m['infer_calls_by_bucket'])}), ramp-set variants "
            f"{m['ramp_set_variants']}, no-ramp variants {m['noramp_variants']}, agreement with "
            f"the model's own labels {out['accuracy']:.4f}, active ramps {out['active_ramps']}, "
            f"controllers {json.dumps(out['controllers'])}")


def _simulated_note(out) -> str:
    sim = out["simulated"]
    keys = ("p50_ms", "p99_ms", "exit_rate", "slo_miss_rate", "throughput_rps")
    pick = {name: {k: sim[name][k] for k in keys if k in sim[name]}
            for name in ("vanilla", "apparate")}
    return ("SIMULATED from the analytic H100 profile, not timed: "
            + json.dumps({**pick, "wins": sim["wins"],
                          **({"admission": out["admission"]} if "admission" in out else {})},
                         default=float))


def lm_token_phase(params, cfg, gen, serve):
    """Phase 4f: next-token serving of qwen2-1.5b through ``LMTokenRunner``,
    on the drawn weights: 8 contexts of 128 tokens with 4 active ramps and
    with none, kernels on (the flash kernel in every prefill layer, the
    ramp-head kernel on every head) against kernels off; then 64 requests
    through the launcher's ``serve()`` on the cluster engine. Returns the
    served run's launches."""
    from repro_torch.models import build_model
    from repro_torch.serving import LMTokenRunner

    toks = torch.randint(1, cfg.vocab_size, (8, 128), generator=gen, device="cuda")
    data, items = toks.cpu().numpy(), list(range(8))
    on = build_model(cfg.replace(pallas_head="kernel"), prefill_attn="kernel")
    off = build_model(cfg.replace(pallas_head="off"), prefill_attn="sdpa")
    act = _spread(len(on.sites), CLS_ACT)
    recs = {}
    for name, model in (("off", off), ("on", on)):
        runner = LMTokenRunner(model, params, data, max_slots=CLS_ACT)
        recs[name] = counted(lambda: (runner.infer(items, act), runner.infer(items, [])))
    times = _bucket_times(runner, act)  # kernels on
    busy = profile_step(lambda: runner.infer(items, act))["device_busy_ms"]
    (ramped, plain), launches = recs["on"]
    (ramped_off, plain_off), off_launches = recs["off"]
    expect = {"flash_attention": 2 * cfg.n_layers, "ramp_head_stats": 2 + len(act),
              "ramp_head_exit": 0}
    for k, n in expect.items():
        if launches[k] != n or off_launches[k] != 0:
            fail(f"4f: the runner launched {k} {launches[k]} times kernels on, "
                 f"{off_launches[k]} off; expected {n} and 0")
    if (plain[2] != ramped[2]).any() or (plain_off[2] != ramped_off[2]).any():
        fail("4f: the no-ramp variant's final labels differ from the ramped one's")
    ties, du = _records_agree(ramped, ramped_off, _final_logits(params, cfg, toks, act),
                              NEAR_TIE, 1e-2, "4f kernels on vs off")
    print(f"4f {cfg.name} LMTokenRunner, 8 contexts of 128 tokens, sites {act}: kernels on vs "
          f"off, labels equal except {ties} near-ties, unc within {du:.2e}; launches "
          f"{json.dumps({k: launches[k] for k in expect})}; kernels on, host ms per infer "
          f"(bucket/active ramps) {json.dumps(times)}, device-busy ms at bucket 8 {busy:.3f}",
          flush=True)
    (out, resp), launches = counted(lambda: serve(
        CONFIG, 64, policy="tfserve", workers=1, seed=SEED, budget=0.6, device="cuda",
        params=params, verbose=False))
    if len(resp) != 64 or any(r.dropped or not 0 <= r.label < cfg.vocab_size for r in resp):
        fail("4f: the served run did not answer 64 requests with tokens of the vocabulary")
    n = launches["prefills"]
    if n <= 0 or launches["flash_attention"] != cfg.n_layers * n \
            or launches["ramp_head_stats"] <= n:
        fail(f"4f: {n} prefills launched flash_attention {launches['flash_attention']} and "
             f"ramp_head_stats {launches['ramp_head_stats']} times; expected "
             f"{cfg.n_layers} a prefill and ramps beside the final head")
    print(f"4f {cfg.name} next-token serving, 64 requests, 1 worker, tfserve: {n} prefills, "
          f"launches {json.dumps({k: launches[k] for k in expect})}; {_served_note(out)}",
          flush=True)
    print(f"4f engine summary ({_simulated_note(out)})", flush=True)
    return launches


def loop_runner_phase(params, cfg, T=8):
    """Phase 4g: the per-slot ``LoopDecodeRunner`` (one B = 1 prefill a
    start, one B = 1 decode a slot a step) and the batched ``DecodeRunner``
    (one B = 8 decode a step), kernels on, over the same 8 prompts of 128
    tokens for ``T`` steps with 4 active ramps: greedy tokens equal except
    a difference that begins at a near-tie (the two run other batch shapes,
    so other GEMM and key-range roundings), 8 dispatches a step against 1,
    the host ms a step of each (``step`` reads its records, so it ends
    synced). Returns the loop run's launches."""
    import numpy as np

    from repro_torch.models import build_model
    from repro_torch.serving import DecodeRunner, LoopDecodeRunner

    model = build_model(cfg.replace(decode_attn="kernel", pallas_head="kernel"),
                        prefill_attn="kernel")
    prompts = np.random.default_rng(SEED + 16).integers(1, cfg.vocab_size, (8, 128))
    act, slots = [2, 5, 8, 11], list(range(8))
    runs = {}
    for name, cls, kw in (("loop", LoopDecodeRunner, {}),
                          ("batched", DecodeRunner, {"n_slots": 8, "graphs": False})):
        def run(cls=cls, kw=kw):
            r = cls(model, params, prompts, max_new_tokens=T, max_slots=4, **kw)
            toks, ms = [[r.start(s, s) for s in slots]], []
            for _ in range(T):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, _, fin = r.step(slots, act)
                ms.append(1e3 * (time.perf_counter() - t0))
                toks.append(fin.tolist())
            return r, toks, ms

        (r, toks, ms), launches = counted(run)
        runs[name] = (r.dispatches, [list(x) for x in zip(*toks)], ms, launches)
    if (runs["loop"][0], runs["batched"][0]) != (8 * T, T):
        fail(f"4g: dispatches {runs['loop'][0]} (loop) and {runs['batched'][0]} (batched); "
             f"expected {8 * T} and {T}")
    lp = runs["loop"][3]
    for k, want in (("decode_attention", cfg.n_layers * 8 * T),
                    ("flash_attention", cfg.n_layers * 8)):
        if lp[k] != want:
            fail(f"4g: the loop runner launched {k} {lp[k]} times; expected {want}")
    if lp["ramp_head_stats"] <= 0:
        fail("4g: the loop runner launched no ramp-head kernel")
    ties = []
    for b in slots:
        t, gap = _divergence_gap(params, cfg, prompts[b], runs["loop"][1][b],
                                 runs["batched"][1][b])
        if t is not None:
            print(f"4g row {b}: loop and batched tokens differ from token {t}, logit gap "
                  f"{gap:.4f}", flush=True)
            if gap >= NEAR_TIE:
                fail(f"4g row {b}: a difference that begins at no near-tie")
            ties.append(b)
    ms = {name: runs[name][2] for name in runs}
    print(f"4g {cfg.name} LoopDecodeRunner vs DecodeRunner on {card_line()}, 8 rows x {T} "
          f"steps, 4 ramps, kernels on: {8 - len(ties)} of 8 rows token-identical (near-tie "
          f"divergences {ties}); dispatches a step {runs['loop'][0] / T:g} vs "
          f"{runs['batched'][0] / T:g}; host ms a step mean "
          f"{statistics.mean(ms['loop']):.3f} vs {statistics.mean(ms['batched']):.3f}, median "
          f"{statistics.median(ms['loop']):.3f} vs {statistics.median(ms['batched']):.3f} "
          f"(loop vs batched); loop launches {json.dumps(lp)}", flush=True)
    return lp


def resnet_flops(cfg) -> float:
    """2 x the multiply-adds of one image's forward at ``cfg.img_size``, from
    the convolutions' shapes (stem, each block's convolutions and
    projection, the final FC)."""
    hw, cin = cfg.img_size, cfg.resnet_widths[0]
    f = 2 * hw * hw * 9 * 3 * cin
    for stage, (n, w) in enumerate(zip(cfg.resnet_blocks, cfg.resnet_widths)):
        wout = w * (4 if cfg.resnet_bottleneck else 1)
        for b in range(n):
            ho = -(-hw // (2 if b == 0 and stage > 0 else 1))
            if cfg.resnet_bottleneck:
                f += 2 * (hw * hw * cin * w + ho * ho * 9 * w * w + ho * ho * w * wout)
            else:
                f += 2 * ho * ho * 9 * (cin * w + w * wout)
            if cin != wout or (b == 0 and stage > 0):
                f += 2 * ho * ho * cin * wout
            hw, cin = ho, wout
    return f + 2 * cin * cfg.n_classes


def resnet_phase(gen, serve):
    """Phase 7a: ResNet-50 at 224 px, f32 (TF32 off), weights from SEED:
    the card's forward against the port's CPU forward of the same weights
    on 2 images, ``ClassifierRunner.infer`` at buckets 1-8 with 0 and 4
    active ramps (host ms a batch, device-busy ms from one profiler
    window), then 600 requests served by ``serve()``, with and without
    admission."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serving import ClassifierRunner

    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("resnet50").replace(img_size=224)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    act = _spread(len(model.sites), CLS_ACT)
    data = torch.randn(8, 224, 224, 3, generator=gen, device="cuda").cpu().numpy()
    x = torch.from_numpy(data[:2])
    card = model.forward(params, x.cuda(), active_sites=act)
    host = model.forward(tree_map(lambda t: t.cpu(), params), x, active_sites=act)
    for part in ("final", "ramps"):
        for k in ("maxprob", "entropy"):
            a, b = card[part][k].cpu(), host[part][k]
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-7):
                fail(f"7a: the card's {part} {k} differs from the CPU forward's by "
                     f"{(a - b).abs().max().item()}")
    runner = ClassifierRunner(model, params, data, max_slots=CLS_ACT)
    rec = runner.infer([0, 1], act)
    rec_host = (host["ramps"]["label"].numpy(), (1.0 - host["ramps"]["maxprob"]).numpy(),
                host["final"]["label"].numpy())
    ties, du = _records_agree(rec, rec_host, (host["ramp_logits"], host["final_logits"]), 1e-3,
                              1e-4, "7a card vs CPU")
    times = _bucket_times(runner, act)
    busy = {bs: profile_step(lambda: runner.infer(list(range(bs)), act))["device_busy_ms"]
            for bs in (1, 8)}
    flops = resnet_flops(cfg)
    print(f"7a resnet50 at 224 px f32 on {card_line()}: {flops / 1e9:.2f} GFLOP an image; card "
          f"vs CPU forward within 1e-4 relative, labels equal except {ties} near-ties, unc "
          f"within {du:.2e}; host ms per infer (bucket/active ramps) {json.dumps(times)}; "
          f"device-busy ms per batch {json.dumps(busy)} "
          f"({8 * flops / busy[8] / 1e9:.1f} TFLOP/s at bucket 8); variants built: "
          f"{runner.compiles} ramp sets, {runner.noramp_compiles} no-ramp", flush=True)
    for adm in (False, True):
        (out, resp), launches = counted(lambda: serve(
            "resnet50", 600, policy="tfserve", workers=1, seed=SEED, admission=adm,
            device="cuda", params=params, verbose=False))
        if len(resp) != 600 or any(not r.dropped and not 0 <= r.label < cfg.n_classes
                                   for r in resp):
            fail("7a: the served run did not answer 600 requests with class labels")
        if launches["forwards"] <= 0:
            fail("7a: the served run ran no forward")
        print(f"7a resnet50 served 600 requests, 1 worker, tfserve, admission {adm}: "
              f"{launches['forwards']} forwards, {sum(r.dropped for r in resp)} dropped; "
              f"{_served_note(out)}", flush=True)
        print(f"7a engine summary ({_simulated_note(out)})", flush=True)


def bert_phase(gen, serve):
    """Phase 7b: BERT-base, bf16, weights from SEED: the runner with its
    attention through sdpa and through the flash kernel (no mask), then 600
    requests served by ``serve()`` through the kernel, 12 launches a
    forward. Returns (the served run's launches, its summary)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ClassifierRunner

    cfg = get_config("bert-base")
    kern = build_model(cfg, prefill_attn="kernel")
    params = kern.init(SEED, device="cuda")
    toks = torch.randint(1, cfg.vocab_size, (8, 32), generator=gen, device="cuda")
    data, items = toks.cpu().numpy(), list(range(8))
    act = _spread(len(kern.sites), CLS_ACT)
    recs = {}
    for name, model in (("sdpa", build_model(cfg, prefill_attn="sdpa")), ("kernel", kern)):
        runner = ClassifierRunner(model, params, data, max_slots=CLS_ACT)
        recs[name] = counted(lambda: runner.infer(items, act))
    times = _bucket_times(runner, act)  # through the kernel
    busy = profile_step(lambda: runner.infer(items, act))["device_busy_ms"]
    if recs["kernel"][1]["flash_attention"] != cfg.n_layers \
            or recs["sdpa"][1]["flash_attention"] != 0:
        fail(f"7b: the runner launched flash_attention {recs['kernel'][1]['flash_attention']} "
             f"times through the kernel, {recs['sdpa'][1]['flash_attention']} through sdpa")
    ref = build_model(cfg).forward(params, toks, active_sites=act)
    ties, du = _records_agree(recs["kernel"][0], recs["sdpa"][0],
                              (ref["ramp_logits"], ref["final_logits"]), NEAR_TIE, 1e-2,
                              "7b kernel vs sdpa")
    print(f"7b bert-base bf16, 8 x 32 tokens, sites {act}: flash kernel vs sdpa, labels equal "
          f"except {ties} near-ties, maxprob within {du:.2e}; through the kernel, host ms per "
          f"infer (bucket/active ramps) {json.dumps(times)}, device-busy ms at bucket 8 "
          f"{busy:.3f}", flush=True)
    (out, resp), launches = counted(lambda: serve(
        "bert-base", 600, policy="tfserve", workers=1, seed=SEED, device="cuda",
        params=params, verbose=False))
    n = launches["forwards"]
    if len(resp) != 600 or any(not r.dropped and not 0 <= r.label < cfg.n_classes
                               for r in resp):
        fail("7b: the served run did not answer 600 requests with class labels")
    if n <= 0 or launches["flash_attention"] != cfg.n_layers * n:
        fail(f"7b: {n} forwards launched flash_attention {launches['flash_attention']} times; "
             f"expected {cfg.n_layers} a forward")
    print(f"7b bert-base served 600 requests, 1 worker, tfserve: {n} forwards, flash_attention "
          f"{launches['flash_attention']} launches ({cfg.n_layers} a forward); "
          f"{_served_note(out)}", flush=True)
    print(f"7b engine summary ({_simulated_note(out)})", flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# phase 3, the ramp styles: 'mlp' and 'tied' records through kernels #2/#3


def check_ramp_styles(params, cfg, gen):
    """The 'mlp' and 'tied' ramp records of 8 rows at 4 active sites through
    the kernel head path (#2 on the final head, #3 on each ramp) against
    the dense path, at ``cfg``'s shape: the 'mlp' ramps on the drawn heads
    with GELU-residual weights drawn here, the 'tied' ramps on the final
    head. Stats within 1e-4 relative of the f32 logits of the features the
    dense path forms (the kernel sums in f32), labels equal to the dense
    path's except near-ties of its bf16 logits (gap under 0.05), exit bits
    equal except where |unc - thr| < 1e-6; thresholds at each ramp's median
    uncertainty, so rows exit and stay. Comparison launches are not
    counted."""
    from repro_torch.kernels import counted_wrappers
    from repro_torch.models import build_model
    from repro_torch.models.transformer import _stats

    B, L, d, vl = 8, cfg.n_layers, cfg.d_model, cfg.vocab_size
    act = [2, 5, 8, 11]
    wdt = params["ramps"]["head"].dtype
    h_last = torch.randn(B, 1, d, generator=gen, device="cuda").to(wdt)
    pooled = torch.randn(L, B, 1, d, generator=gen, device="cuda").to(wdt)
    S = len(params["ramps"]["norm_w"])
    n0 = {k: f.launches for k, f in counted_wrappers().items()}
    for style in ("mlp", "tied"):
        ramps = {"norm_w": params["ramps"]["norm_w"]}
        if style == "mlp":
            ramps["head"] = params["ramps"]["head"]
            for k, shp in (("w1", (S, d, cfg.ramp_hidden)), ("w2", (S, cfg.ramp_hidden, d))):
                ramps[k] = (0.02 * torch.randn(shp, generator=gen, device="cuda")).to(wdt)
        p = {**params, "ramps": ramps}
        scfg = cfg.replace(ramp_style=style)
        on = build_model(scfg.replace(pallas_head="kernel"))
        off = build_model(scfg.replace(pallas_head="off"))
        with torch.no_grad():
            hs = off._ramp_hidden(p, pooled, act)[:, :, 0]  # (K, B, d): what the heads read
            ref = [_logits_ref(hs[j], off.ramp_head(p, i), vl) for j, i in enumerate(act)]
            unc = 1.0 - torch.stack([_stats(lg)["maxprob"] for lg in ref])  # (K, B)
            thr = unc.median(dim=1).values
            o_on = on._head_stats(p, h_last, pooled, act, exit_thresholds=thr)
            o_off = off._head_stats(p, h_last, pooled, act, exit_thresholds=thr)
        torch.cuda.synchronize()
        err, ties, bits = 0.0, 0, 0
        for j in range(len(act)):
            want = _stats(ref[j])
            for k in ("maxprob", "entropy"):
                a, b = o_on["ramps"][k][j].float(), want[k]
                if not torch.allclose(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max())):
                    fail(f"3 ramp style {style} {k}, ramp {act[j]}: max abs err "
                         f"{(a - b).abs().max().item()}")
                err = max(err, (a - b).abs().max().item())
            ties += _near_tie_labels(o_on["ramps"]["label"][j], want["label"], ref[j], 1e-3,
                                     f"3 ramp style {style} kernel vs f32, ramp {act[j]}")
            ties += _near_tie_labels(o_on["ramps"]["label"][j], o_off["ramps"]["label"][j],
                                     ref[j], 0.05, f"3 ramp style {style} kernel vs dense")
            mism = (o_on["ramps"]["exit"][j] != o_off["ramps"]["exit"][j]).nonzero()
            for r in mism.flatten().tolist():
                if abs((unc[j, r] - thr[j]).item()) >= 1e-6:
                    fail(f"3 ramp style {style}: exit bit of ramp {act[j]}, row {r} differs")
                bits += 1
        n_exit = int(o_on["ramps"]["exit"].sum())
        if not 0 < n_exit < o_on["ramps"]["exit"].numel():
            fail(f"3 ramp style {style}: {n_exit} exits; thresholds at the median should "
                 "give both exit values")
        print(f"3 ramp style {style} ({cfg.name}, B={B}, sites {act}, d {d}, V {vl}): kernel "
              f"head path vs dense, stats max abs err {err:.3e} vs f32 logits, {ties} label "
              f"near-ties, {bits} exit bits at |unc - thr| < 1e-6, {n_exit} exits", flush=True)
    for k, f in counted_wrappers().items():
        f.launches = n0[k]


# ---------------------------------------------------------------------------
# phase 8: training on the card, then serving what was trained


TRAIN_ARGS = ["--arch", CONFIG, "--mode", "ramps_only", "--steps", "8", "--batch", "4",
              "--seq", "128"]


def _nbytes(tree) -> int:
    from repro_torch.models.common import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def train_qwen_phase(gen):
    """Phase 8a: full-width qwen2-1.5b ramps_only training through the
    launcher (``launch.train.main(TRAIN_ARGS)``): ms a step (CUDA events),
    each step's loss and ramp loss, the peak memory against the one
    reckoned from shapes; the backbone bit-identical to a fresh draw from
    the seed; the ramp loss on step 0's batch below step 0's; then 8 rows
    of TokenPipeline prompts prefilled and decoded 4 steps with the trained
    ramps, kernels on (#1-#4) vs off, at the controller's initial
    thresholds (0: nothing exits). Returns (the decode steps' launches,
    summary)."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    cfg = get_config(CONFIG)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    hist = []
    t0 = time.perf_counter()
    state = train_main(TRAIN_ARGS, history=hist)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    params = state["params"]
    n_params = sum(t.numel() for t in tree_leaves(params))
    p_bytes = _nbytes(params)
    ramp_bytes = _nbytes(params["ramps"])
    B, S, npos = 4, 128, 16
    logits = B * S * cfg.padded_vocab * 4
    ramp_logits = len(params["ramps"]["norm_w"]) * B * npos * cfg.padded_vocab * 4
    reckoned = p_bytes + 8 * n_params + ramp_bytes + logits + ramp_logits
    if peak - resident > 1.2 * reckoned:
        fail(f"8a: peak {peak / 1e9:.2f} GB above the {reckoned / 1e9:.2f} GB reckoned from "
             "shapes (params, f32 moments, ramp grads, logits)")
    first = hist[0]["ramp_loss"]
    model = build_model(cfg)
    batch0 = {k: torch.as_tensor(v, device="cuda")
              for k, v in TokenPipeline(cfg.vocab_size, S, B, seed=0).batch_at(0).items()}
    with torch.no_grad():
        _, met = model.loss(params, batch0, train_mode="ramps_only")
    after0 = float(met["ramp_loss"])
    if not after0 < first:
        fail(f"8a: the ramp loss on step 0's batch is {after0} after training, {first} before")
    # one more step (after a warm-up one) under the profiler: where a step's
    # device time goes
    from repro_torch.training import TrainConfig, make_train_step

    step_fn, _ = make_train_step(model, TrainConfig(steps=10, lr=3e-4,
                                                    train_mode="ramps_only"))
    pipe = TokenPipeline(cfg.vocab_size, S, B, seed=0)
    prof_step = profile_step(lambda: step_fn(state, pipe.batch_at(8)), top=8)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    fresh = model.init(0, device="cuda")  # the launcher's --seed 0
    same = moved = 0
    for key in sorted(params):
        for a, b in zip(tree_leaves(params[key]), tree_leaves(fresh[key])):
            if key == "ramps":
                moved += int(not torch.equal(a, b))
            elif not torch.equal(a, b):
                fail(f"8a: backbone leaf under {key!r} changed in ramps_only training")
            else:
                same += 1
    del fresh
    torch.cuda.empty_cache()
    if moved == 0:
        fail("8a: no ramp leaf moved")
    ms = [h["ms"] for h in hist]
    print(f"8a {CONFIG} ramps_only training on {card_line()}, {' '.join(TRAIN_ARGS)}: "
          f"{n_params / 1e9:.3f} B params; ms a step {json.dumps([round(m, 2) for m in ms])} "
          f"(median of steps 1-7 {statistics.median(ms[1:]):.2f}); loss by step "
          f"{json.dumps([round(h['loss'], 4) for h in hist])}; ramp loss by step "
          f"{json.dumps([round(h['ramp_loss'], 4) for h in hist])}; step 0's batch ramp loss "
          f"{first:.4f} before, {after0:.4f} after; peak memory "
          f"{(peak - resident) / 1e9:.2f} GB over {resident / 1e9:.2f} GB resident (reckoned "
          f"{reckoned / 1e9:.2f}: params {p_bytes / 1e9:.2f}, f32 mu + nu "
          f"{8 * n_params / 1e9:.2f}, ramp grads {ramp_bytes / 1e9:.2f}, logits "
          f"{logits / 1e9:.2f} + ramp logits {ramp_logits / 1e9:.2f}); backbone "
          f"{same} leaves bit-identical to the seed's draw, {moved} ramp leaves moved; "
          f"wall {wall:.1f} s", flush=True)
    print(f"8a one more ramps_only step under torch.profiler (after the checks): "
          f"{json.dumps(prof_step)}", flush=True)
    toks = torch.as_tensor(TokenPipeline(cfg.vocab_size, 128, 8, seed=1).batch_at(0)["tokens"],
                           device="cuda")
    thr0 = torch.zeros(4, device="cuda")  # ApparateController's initial thresholds
    res, launches = counted(lambda: compare_paths(
        params, cfg, cfg.replace(decode_attn="dense", pallas_head="off"),
        cfg.replace(decode_attn="kernel", pallas_head="kernel"), gen,
        on_kw={"prefill_attn": "kernel"}, prefill_kernel="flash_attention", toks=toks, T=4,
        thr=thr0))
    # compare_paths counts each prefill itself (the flash kernel once a layer
    # in the on path's); these are the decode steps' launches
    for k in ("decode_attention", "ramp_head_stats", "ramp_head_exit"):
        if launches[k] <= 0:
            fail(f"8a: the trained model's decode launched {k} no time")
    if res["ramp_exits"]:
        fail(f"8a: {res['ramp_exits']} exits at thresholds 0 (the compare is strict)")
    summary = {"ms_per_step": ms, "peak_gb": (peak - resident) / 1e9,
               "step_device_busy_ms": prof_step["device_busy_ms"],
               "reckoned_gb": reckoned / 1e9, "ramp_loss": [h["ramp_loss"] for h in hist],
               "records": res["ramp_records"], "maxprob_over_half": res["ramp_maxprob_over_half"]}
    print(f"8a trained ramps, 8 TokenPipeline rows x 4 decode steps, kernels on vs off: "
          f"decode launches {json.dumps({k: launches[k] for k in ATTENTION[:1] + ('ramp_head_stats', 'ramp_head_exit')})}; "
          f"{res['ramp_exits']} exits at the controller's initial thresholds (0), "
          f"{res['ramp_maxprob_over_half']} of {res['ramp_records']} ramp records with maxprob "
          f"> 0.5", flush=True)
    del params
    return launches, summary


BERT_TRAIN_STEPS = 200  # the reference launcher's NLP recipe
RESUME_RTOL = 2e-2  # steps 100-199 resumed vs uninterrupted, relative (see bert_train_phase)


def bert_train_phase(serve, random_run):
    """Phase 8b: full-width BERT-base (10 classes, bf16) trained with the
    reference launcher's recipe on the NLP stream's bootstrap split (the
    first 256 of 600 items, 200 steps of 64, lr 1e-3, the whole model),
    checkpointed every 50 steps (``save_async``) to a temporary directory,
    then the other 344 items served through kernel #4 (12 launches a served
    forward). Step 100's checkpoint is restored into a fresh state and
    steps 100-199 run again: their losses must equal the uninterrupted
    run's within ``RESUME_RTOL`` (no deterministic-algorithms switch; the
    line says whether they came out bit-identical). Prints ms a training
    step, the simulated exit share and the agreement with the model's own
    labels beside 7b's random-weight run, and the ramp-set variants built.
    Returns the served run's launches."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import make_token_stream
    from repro_torch.launch.serve import TRAIN_RECIPE, bootstrap_batches
    from repro_torch.models import build_model
    from repro_torch.training import TrainConfig, train

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        (out, resp), launches = counted(lambda: serve(
            "bert-base", 600, policy="tfserve", workers=1, seed=SEED, device="cuda",
            verbose=False, train=True, ckpt_dir=tmp))
        tr = out["train"]
        n_fwd = launches["forwards"] - BERT_TRAIN_STEPS  # the loss runs one forward a step
        if len(resp) != out["served"] or out["served"] != 600 - tr["bootstrap"] \
                or any(not r.dropped and not 0 <= r.label < 10 for r in resp):
            fail("8b: the served run did not answer the 344 items past the split with labels")
        if n_fwd <= 0 or launches["flash_attention"] != 12 * n_fwd:
            fail(f"8b: {n_fwd} served forwards launched flash_attention "
                 f"{launches['flash_attention']} times; expected 12 a forward (training: none)")
        losses = tr["losses"]
        if not losses[-1] < losses[0]:
            fail(f"8b: the training loss went from {losses[0]} to {losses[-1]}")
        mgr = CheckpointManager(tmp)
        if mgr.all_steps() != [100, 150, 200]:
            fail(f"8b: checkpoints {mgr.all_steps()}; expected [100, 150, 200] (keep 3)")
        cfg = get_config("bert-base").replace(n_classes=10)
        model = build_model(cfg, prefill_attn="kernel")
        stream = make_token_stream(600, seq_len=32, vocab=cfg.vocab_size, n_classes=10,
                                   mode="nlp", seed=SEED)
        lr, steps = TRAIN_RECIPE["encoder_cls"]
        state = mgr.restore(100, device="cuda")
        if int(state["step"]) != 100:
            fail(f"8b: step 100's checkpoint holds step {int(state['step'])}")
        _, logs = train(model, bootstrap_batches(stream, tr["bootstrap"], "tokens"),
                        TrainConfig(steps=steps, lr=lr, log_every=1), state=state,
                        start_step=100, verbose=False)
        again = [r["loss"] for r in logs]
        ref = losses[100:]
        dev = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(again, ref))
        if len(again) != len(ref) or dev > RESUME_RTOL:
            fail(f"8b: steps 100-199 resumed from the checkpoint differ from the "
                 f"uninterrupted run by {dev} relative (tolerance {RESUME_RTOL})")
        # the trained ramps on the served items (the final checkpoint): each
        # ramp's agreement with the final head and its mean maxprob
        from repro_torch.serving import ClassifierRunner

        final = mgr.restore(steps, device="cuda")["params"]
        runner = ClassifierRunner(model, final, stream.data, max_slots=len(model.sites))
        sites = list(range(len(model.sites)))
        lab, unc, fin = zip(*(runner.infer(list(range(lo, min(lo + 8, 600))), sites)
                              for lo in range(tr["bootstrap"], 600, 8)))
        lab, unc, fin = (np.concatenate(x, axis=-1) for x in (lab, unc, fin))
        agree_by_ramp = [round(float(np.mean(lab[k] == fin)), 4) for k in sites]
        maxprob_by_ramp = [round(float(np.mean(1.0 - unc[k])), 4) for k in sites]
        # where a step's device time goes (two more steps, one profiled)
        from repro_torch.training import make_train_step

        step_fn, _ = make_train_step(model, TrainConfig(steps=steps, lr=lr))
        batches = bootstrap_batches(stream, tr["bootstrap"], "tokens")
        prof_step = profile_step(lambda: step_fn(state, batches(0)), top=8)
        del state, final, runner
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sim, rsim = out["simulated"]["apparate"], random_run["simulated"]["apparate"]
    print(f"8b bert-base (10 classes, bf16) trained on {card_line()}: {steps} steps of 64 x 32 "
          f"tokens on the first {tr['bootstrap']} items, {1e3 * tr['wall_s'] / steps:.2f} ms a "
          f"training step (host clock, each step ending in its loss read, checkpoints every 50 "
          f"steps written async); loss {losses[0]:.4f} -> {losses[-1]:.4f}, ramp loss "
          f"{tr['ramp_losses'][0]:.4f} -> {tr['ramp_losses'][-1]:.4f}; steps 100-199 resumed "
          f"from step 100's checkpoint: max relative loss difference {dev:.3e} "
          f"({'bit-identical' if again == ref else 'not bit-identical'}; tolerance "
          f"{RESUME_RTOL})", flush=True)
    print(f"8b served {out['served']} items past the split, 1 worker, tfserve: {n_fwd} forwards "
          f"({launches['flash_attention']} flash_attention launches); trained vs random "
          f"weights (7b): simulated exit share {sim.get('exit_rate', 0.0):.4f} vs "
          f"{rsim.get('exit_rate', 0.0):.4f}, agreement with the model's own labels "
          f"{out['accuracy']:.4f} vs {random_run['accuracy']:.4f}; {_served_note(out)}",
          flush=True)
    print(f"8b trained ramps on the {out['served']} served items (step {steps}'s "
          f"checkpoint, every site active): agreement with the final head by ramp "
          f"{agree_by_ramp}, mean maxprob by ramp {maxprob_by_ramp}; one more training step "
          f"under torch.profiler: {json.dumps(prof_step)}", flush=True)
    print(f"8b engine summary ({_simulated_note(out)})", flush=True)
    return launches, {"train_ms_per_step": 1e3 * tr["wall_s"] / steps,
                      "exit_rate": sim.get("exit_rate", 0.0), "accuracy": out["accuracy"],
                      "random_exit_rate": rsim.get("exit_rate", 0.0),
                      "random_accuracy": random_run["accuracy"], "resume_max_rel": dev,
                      "ramp_set_variants": out["measured"]["ramp_set_variants"]}

# ---------------------------------------------------------------------------
# phases 10 and 11: Qwen3-MoE-30B-A3B whole, and one period of Llama-3.2-Vision,
# at full width


Q3_CONFIG = "qwen3-moe-30b-a3b"
LV_CONFIG = "llama-3.2-vision-90b"
LV_ACT = (0, 1, 2, 3)  # one period of 5 layers has 4 ramp sites


def _lap(name, t0):
    """Print a sub-phase's seconds since ``t0`` and the peak of device
    memory allocated meanwhile (the peak counter restarts here)."""
    torch.cuda.synchronize()
    print(f"{name}: {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated", flush=True)
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def _draw(cfg, what):
    """The model of ``cfg`` and its seeded weights on the card."""
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"drew {what} ({n / 1e9:.3f} B params with the ramp heads, {cfg.dtype}; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated) on {card_line()} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model, params


def moe_step_floor(params, cfg, model, gen, B=8, n_ramps=4, pos=PAGED_PROMPT + 20):
    """Phase 10a: what one decode step of B rows at ``pos`` must read at
    least, two ways: with the dense dispatch the port serves (every expert
    of every layer) and with only the experts the step's routing touches
    (the floor of a grouped dispatch). The touched experts are those of one
    decode step (the dense path, no kernel) after a prefill of B random
    prompts, its router calls recorded."""
    ffn = params["blocks"][0]["ffn"]
    per_expert = sum(ffn[k][0, 0].numel() * ffn[k].element_size()
                     for k in ("w_gate", "w_up", "w_down"))
    experts = cfg.n_layers * cfg.n_experts * per_expert
    toks = torch.randint(1, cfg.vocab_size, (B, pos), generator=gen, device="cuda")
    cache, outs = model.prefill(params, toks, cache_len=pos + 2, active_sites=None)
    routes = RouteReplay()
    routes("record", lambda: model.decode(
        params, cache, outs["final"]["label"].reshape(-1, 1).long(),
        torch.full((B,), pos, device="cuda")))
    touched = sum(int(torch.unique(ids).numel()) for ids in routes.ids)
    del cache
    row = {"layers": _nbytes(params["blocks"]), "experts_all": experts,
           "experts_touched": touched * per_expert, "touched_experts": touched,
           "expert_slots": cfg.n_layers * cfg.n_experts,
           "final_head": _nbytes(params["tok"]["lm_head"]),
           "ramp_heads": n_ramps * params["ramps"]["head"][0].numel() * 2,
           "caches": B * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.hd * 2 * (pos + 1)}
    row["dense_total"] = row["layers"] + row["final_head"] + row["ramp_heads"] + row["caches"]
    row["touched_total"] = row["dense_total"] - experts + row["experts_touched"]
    row["dense_ms"] = 1e3 * row["dense_total"] / HBM_BW
    row["touched_ms"] = 1e3 * row["touched_total"] / HBM_BW
    print(f"10a {cfg.name} decode step byte floor at B {B}, {n_ramps} ramps, pos {pos}: "
          f"{json.dumps(row)} (bytes; ms at 3.35 TB/s)", flush=True)
    return row


def qwen3_phases(gen, serve):
    """Phase 10: Qwen3-MoE-30B-A3B whole (48 layers of attention + MoE; d
    2048, 32 heads on 4 of 128, qk-norm, 128 experts of width 768 with
    top-8, an untied 151936-token vocab, 12 ramp heads: 68.65 GB of bf16
    weights), seeded random weights drawn once Gemma3's are freed. 10a: #1
    and #5 at group 8 (32:4), #4 causal at 8 x 128, #2/#3 at d 2048 x V
    153600, each against its plain version; the step's byte floor, dense
    and routed. 10b: a prefill of 8 x 128 through sdpa vs the flash kernel,
    then 8 decode steps with the kernels off vs on on the off path's
    routing, one eager step profiled. 10c-10d on the first 7 layers
    (``SERVE_DEPTH``). 10c: 8 requests (prompt 120, 38 tokens) on
    contiguous rows, then on the pool on the contiguous run's routing;
    prefix sharing, copy-on-write and swap on a 24-block pool.
    10d: window graphs on both layouts. Returns (its rows, 10c's contiguous
    and paged launches)."""
    from repro_torch.configs import get_config

    cfg = get_config(Q3_CONFIG)
    model, params = _draw(cfg, f"{Q3_CONFIG} weights, whole: 48 layers of d 2048, 32 heads on "
                               "4 of 128, qk-norm, 128 experts top-8 of width 768")
    t = _lap("10 draw", time.perf_counter())
    rows = {}
    # -- 10a: the kernels alone at Qwen3-MoE's shapes, and the step's floor
    rows["decode"] = check_decode_attention(
        8, 160, "B=8 H=32 KH=4 hd=128 S=160 pos 120..159 bf16", gen, pos_lo=120, H=32, KH=4)
    rows["paged"] = check_paged_decode_attention(
        8, 10, "B=8 H=32 KH=4 hd=128 bs=16 nb=10 pos 120..159 shuffled bf16", gen, 120, 160,
        H=32, KH=4)
    rows["flash"] = check_flash_attention(8, 32, 4, 128, 128, 128,
                                          "B=8 H=32 KH=4 hd=128 Sq=Sk=128 causal bf16", gen)
    rows["ramp"] = check_ramp_head(params, cfg, gen)
    rows["floor"] = moe_step_floor(params, cfg, model, gen)
    t = _lap("10a", t)
    # -- 10b: the model, kernels off vs on
    rows["paths"] = compare_paths(
        params, cfg, cfg.replace(decode_attn="dense", pallas_head="off"),
        cfg.replace(decode_attn="kernel", pallas_head="kernel"), gen,
        on_kw={"prefill_attn": "kernel"}, prefill_kernel="flash_attention")
    prof, floor = rows["paths"]["profile_on"], rows["floor"]
    print(f"10b {cfg.name} one eager decode step (B 8, 4 ramps, kernels on) on {card_line()}: "
          f"device-busy {prof['device_busy_ms']:.3f} ms, wall {prof['wall_ms']:.3f} ms; byte "
          f"floor {floor['dense_ms']:.3f} ms with the dense dispatch (every expert), "
          f"{floor['touched_ms']:.3f} ms with the {floor['touched_experts']} of "
          f"{floor['expert_slots']} experts its routing touched", flush=True)
    t = _lap("10b", t)
    # -- 10c: serving on both layouts, then prefix sharing and swap, at
    # SERVE_DEPTH
    params, cfg, serve = _cut_depth(params, cfg, serve)
    cont, paged = serve_paged_vs_contiguous(params, cfg, serve, "10c", "decode_attention",
                                            "paged_decode_attention", "flash_attention",
                                            rounds=1, ops=False)
    serve_prefix_swap(params, cfg, serve, "10c")
    t = _lap("10c", t)
    # -- 10d: window graphs
    rows["graphs"] = graph_vs_eager(params, cfg, serve, "10d", SEED + 12, act=SERVE_ACT)
    _lap("10d", t)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return rows, cont, paged


def cross_step_share(params, cfg, gen, img, B=8, P=128):
    """Phase 11b: a decode step of B rows (kernels on) after a prefill of P
    tokens with image memory, and the cross layer's branch alone at that
    step (norm, q projection, sdpa over the M image rows, output
    projection, gate), device ms each (CUDA events, the L2 flushed); the
    step's byte floor."""
    from repro_torch.kernels import counted_wrappers
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    on = build_model(cfg.replace(decode_attn="kernel", pallas_head="kernel"),
                     prefill_attn="kernel")
    fns = counted_wrappers()
    saved = {k: f.launches for k, f in fns.items()}
    toks = torch.randint(1, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    cache, outs = on.prefill(params, toks, cache_len=P + 2, active_sites=None,
                             image_embeds=img)
    tok, pos = outs["final"]["label"].reshape(-1, 1).long(), torch.full((B,), P, device="cuda")
    act = list(LV_ACT)
    thr = torch.full((len(act),), 0.5, device="cuda")
    lp = tree_map(lambda x: x[0], params["blocks"][-1])
    lc = tree_map(lambda x: x[0], cache["blocks"][-1])
    h = torch.randn(B, 1, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    row = {"step_ms": device_ms(lambda: on.decode(params, cache, tok, pos, active_sites=act,
                                                  exit_thresholds=thr)),
           "cross_ms": device_ms(lambda: on._cross(lp, h, lc, None, None)),
           "xkv_bytes_read": 2 * lc["xkv"]["k"].numel() * 2}
    for k, f in fns.items():  # launches made to time a call do not count
        f.launches = saved[k]
    row["cross_share"] = row["cross_ms"] / row["step_ms"]
    row["floor_bytes"] = (_nbytes(params["blocks"]) + _nbytes(params["tok"]["lm_head"])
                          + len(act) * params["ramps"]["head"][0].numel() * 2
                          + B * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.hd * 2 * (P + 1)
                          + row["xkv_bytes_read"])
    row["floor_ms"] = 1e3 * row["floor_bytes"] / HBM_BW
    print(f"11b {cfg.name} decode step (B {B}, 4 ramps, kernels on, pos {P}) and its cross "
          f"layer on {card_line()}: {json.dumps(row)} (device ms; floor at 3.35 TB/s)",
          flush=True)
    return row


def llama_phases(gen, serve):
    """Phase 11: Llama-3.2-Vision-90B at full width and one period's depth
    (5 layers: 4 self-attention, then one that adds a tanh-gated
    cross-attention over 1600 image tokens of width 1280; d 8192, 64 heads
    on 8 of 128, V 128256, 4 ramp heads: 21.56 GB of bf16 weights), seeded
    random weights, its cross gate set to 1.0 after the draw (zero at init,
    a branch that changes nothing). 11a: #1 at group 8 (64:8), #5 over a
    table that carries 100 trailing xkv columns, #4 causal at 8 x 128,
    #2/#3 at d 8192 x V 129024. 11b: a prefill of 8 x 128 with image memory
    through sdpa vs the flash kernel, then 8 decode steps on the contiguous
    cache with the kernels off vs on; a step and its cross layer timed.
    11c: 8 requests x 38 tokens on contiguous rows and on the pool with
    pinned xkv pages (the runner takes no image: its cross layers attend
    zero memory, as the reference's), then swap on a pool that runs dry;
    a prefix cache refused. 11d: window graphs on both layouts. Returns
    (its rows, 11c's contiguous and paged launches)."""
    from repro_torch.configs import get_config

    cfg = get_config(LV_CONFIG).replace(n_layers=5)
    model, params = _draw(cfg, f"{LV_CONFIG} weights, one period at full width: 5 layers "
                               "(4 self, 1 cross) of d 8192, 64 heads on 8 of 128")
    params["blocks"][-1]["xattn"]["gate"].fill_(1.0)
    print("11: the cross layer's gate set to 1.0 (tanh 0.762) after the draw, so that its "
          "branch changes the output", flush=True)
    del model
    t = _lap("11 draw", time.perf_counter())
    rows = {}
    nbx = -(-cfg.n_image_tokens // 16)
    # -- 11a: the kernels alone at Llama-3.2-Vision's shapes
    rows["decode"] = check_decode_attention(
        8, 160, "B=8 H=64 KH=8 hd=128 S=160 pos 120..159 bf16", gen, pos_lo=120, H=64, KH=8)
    rows["paged"] = check_paged_decode_attention(
        8, 10, f"B=8 H=64 KH=8 hd=128 bs=16 nb=10 (+{nbx} trailing xkv columns) pos 120..159 "
        "shuffled bf16", gen, 120, 160, H=64, KH=8, trailing=nbx)
    rows["flash"] = check_flash_attention(8, 64, 8, 128, 128, 128,
                                          "B=8 H=64 KH=8 hd=128 Sq=Sk=128 causal bf16", gen)
    rows["ramp"] = check_ramp_head(params, cfg, gen)
    t = _lap("11a", t)
    # -- 11b: the model with image memory, kernels off vs on
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 15)
    img = torch.randn(8, cfg.n_image_tokens, cfg.d_frontend, generator=g,
                      device="cuda").to(torch.bfloat16)
    rows["paths"] = compare_paths(
        params, cfg, cfg.replace(decode_attn="dense", pallas_head="off"),
        cfg.replace(decode_attn="kernel", pallas_head="kernel"), gen,
        on_kw={"prefill_attn": "kernel"}, prefill_kernel="flash_attention", act=LV_ACT,
        prefill_kw={"image_embeds": img})
    rows["step"] = cross_step_share(params, cfg, gen, img)
    t = _lap("11b", t)
    # -- 11c: serving on both layouts, then swap of token and xkv pages
    with _Config(cfg):
        cont, paged = serve_paged_vs_contiguous(params, cfg, serve, "11c", "decode_attention",
                                                "paged_decode_attention", "flash_attention")
        # three admissions (8 token blocks and the pinned xkv pages each) and
        # 4 blocks more: the streams' appends run the pool dry
        serve_swap(params, cfg, serve, "11c swap", SEED + 14, "paged_decode_attention",
                   "flash_attention", kv_blocks=3 * (8 + nbx) + 4)
        try:
            serve(cfg.name, 2, decode_tokens=2, prompt_len=16, seed=SEED, device="cuda",
                  verbose=False, kv_block_size=16, prefix_cache=True, params=params)
            fail("11c: a prefix cache over pinned xkv pages was not refused")
        except ValueError as e:
            print(f"11c: prefix cache refused: {e}", flush=True)
        t = _lap("11c", t)
        # -- 11d: window graphs
        rows["graphs"] = graph_vs_eager(params, cfg, serve, "11d", SEED + 13, act=LV_ACT)
    _lap("11d", t)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rows, cont, paged


# ---------------------------------------------------------------------------
# phase 12: SeamlessM4T-large-v2's encoder-decoder, whole, at full width


SM_CONFIG = "seamless-m4t-large-v2"
SM_ACT = (0, 7, 14, 21)  # 4 of the 23 decoder ramp sites
SM_PROMPT, SM_STEPS, SM_CACHE, SM_BS = 64, 32, 104, 16  # 104 rows = 7 blocks of 16


def encdec_pool(model, cache, bs):
    """Lay a prefill's contiguous enc-dec cache out on a pool as the serving
    runner's paged prefill scatter does (``DecodeRunner.start``): for each
    row in turn, its token blocks, then its pinned xkv pages, claimed from
    a ``BlockAllocator``; each table its token columns, then its trailing
    xkv columns; the self k/v scattered into the token pages, the memory's
    k/v into the pinned pages (a partly filled last page zero-padded).
    Returns (pool, tables (B, nb + nbx) int32 on the card)."""
    import numpy as np

    from repro_torch.serving.runner import BlockAllocator

    B, S = cache["k"].shape[1:3]
    nb, nbx = -(-S // bs), model.paged_xkv_blocks(bs)
    al = BlockAllocator(B * (nb + nbx), nb, B)
    xtab = []
    for b in range(B):
        al.alloc(b, nb)
        xtab.append(al.alloc_pinned(nbx))
    tables = torch.from_numpy(np.concatenate([al.table[:B, :nb], np.asarray(xtab)], 1)
                              .astype(np.int64)).cuda()
    pool = model.init_paged_cache(1 + al.n_blocks, bs, device="cuda")

    def scatter(dst, src, ids):
        rows = ids.shape[1] * bs
        src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, rows - src.shape[2]))
        dst.index_copy_(1, ids.reshape(-1), src.reshape((src.shape[0], -1, bs) + src.shape[3:]))

    for k in ("k", "v"):
        scatter(pool[k], cache[k], tables[:, :nb])
        scatter(pool["xkv"][k], cache["xkv"][k], tables[:, nb:])
    return pool, tables.to(torch.int32)


def encdec_step_floor(params, cfg, B=8, pos=SM_PROMPT + SM_STEPS // 2):
    """What one decode step of B rows must read at least: the decoder's
    weights, the untied final head, 4 ramp heads, every layer's memory k/v
    (M rows a row) and its self k/v up to ``pos``."""
    L, kv = cfg.n_dec_layers, cfg.n_kv_heads * cfg.hd * 2  # bf16 bytes a row of k (or v)
    row = {"decoder": _nbytes(params["dec"]), "final_head": _nbytes(params["tok"]["lm_head"]),
           "ramp_heads": len(SM_ACT) * params["ramps"]["head"][0].numel() * 2,
           "xkv": B * L * 2 * cfg.n_image_tokens * kv, "self_kv": B * L * 2 * (pos + 1) * kv}
    row["total"] = sum(row.values())
    row["ms"] = 1e3 * row["total"] / HBM_BW
    return row


def encdec_layouts(params, cfg, frames, toks, act):
    """Phases 12b (its timings) and 12c: one prefill through the flash
    kernel, then ``SM_STEPS`` decode steps with every kernel on, on
    contiguous rows (#1) and on the pool (#5 over the token columns; the
    cross layers gather their M rows from the pinned pages), counted as
    one run: the main path. Both layouts are fed the contiguous run's
    greedy tokens; their labels (final and ramps) must be equal except
    where the contiguous run's f32 logits put the two labels within
    NEAR_TIE. Then, outside the count: the device ms of the encoder and of
    one layer's cross branch (and, on the pool, of its gather alone), each
    timed alone (CUDA events, the L2 flushed), a step on each layout under
    the profiler (its device-busy ms: an eager step of ~2 k launches
    outruns the launch queue, so events around it read the host), and the
    share of that device-busy time the 24 cross layers take. Returns
    (launches, timings)."""
    from repro_torch.kernels import counted_wrappers
    from repro_torch.models import build_model
    from repro_torch.models import layers as LY
    from repro_torch.models.common import tree_map

    cont = build_model(cfg.replace(decode_attn="kernel", pallas_head="kernel"),
                       prefill_attn="kernel")
    paged = build_model(cfg.replace(decode_attn="paged-kernel", pallas_head="kernel"),
                        prefill_attn="kernel")
    B = toks.shape[0]
    seen = {}
    orig = cont._head_stats

    def head_stats(params_, h_last, pooled, active_sites, exit_thresholds=None):
        seen["h"], seen["pooled"] = h_last, pooled
        return orig(params_, h_last, pooled, active_sites, exit_thresholds)

    thr = torch.full((len(act),), 0.5, device="cuda")
    stats = {"labels": 0, "near_ties": 0}

    def run():
        c_cont, o = cont.prefill(params, frames, toks, cache_len=SM_CACHE, active_sites=act)
        pool, tables = encdec_pool(paged, c_cont, SM_BS)
        pos = torch.full((B,), SM_PROMPT, device="cuda")
        for t in range(SM_STEPS):
            nxt = o["final"]["label"].reshape(-1, 1).long()
            _, o = cont.decode(params, c_cont, nxt, pos, active_sites=act, exit_thresholds=thr)
            _, op = paged.decode(params, pool, nxt, pos, active_sites=act, exit_thresholds=thr,
                                 block_tables=tables)
            h = LY.apply_norm(cfg, params["final_norm"], seen["h"])[:, 0]
            hs = cont._ramp_hidden(params, seen["pooled"], act)[:, :, 0]
            logits = [_logits_ref(h, params["tok"]["lm_head"], cfg.vocab_size)]
            logits += [_logits_ref(hs[j], params["ramps"]["head"][i], cfg.vocab_size)
                       for j, i in enumerate(act)]
            la = [o["final"]["label"]] + list(o["ramps"]["label"])
            lb = [op["final"]["label"]] + list(op["ramps"]["label"])
            for lg, x, y in zip(logits, la, lb):
                for r in (x != y).nonzero().flatten().tolist():
                    gap = (lg[r, int(x[r])] - lg[r, int(y[r])]).abs().item()
                    if gap >= NEAR_TIE:
                        fail(f"12c step {t} row {r}: paged label {int(y[r])} vs contiguous "
                             f"{int(x[r])}, logit gap {gap}")
                    stats["near_ties"] += 1
                stats["labels"] += B
            pos = pos + 1
        return c_cont, pool, tables, o, pos

    cont._head_stats = head_stats  # what the contiguous decode steps' heads read
    try:
        (c_cont, pool, tables, o, pos), launches = counted(run)
    finally:
        cont._head_stats = orig
    want = {"decode_attention": cfg.n_dec_layers * SM_STEPS,
            "paged_decode_attention": cfg.n_dec_layers * SM_STEPS,
            "flash_attention": cfg.n_enc_layers + cfg.n_dec_layers}
    for k, n in want.items():
        if launches[k] != n:
            fail(f"12c launched {k} {launches[k]} times; expected {n}")
    for k in ("ramp_head_stats", "ramp_head_exit"):
        if launches[k] <= 0:
            fail(f"12c launched {k} {launches[k]} times")
    # -- timings, outside the count: a step at the last position again
    nxt = o["final"]["label"].reshape(-1, 1).long()
    pos = pos - 1
    nb = tables.shape[1] - paged.paged_xkv_blocks(SM_BS)
    lp = tree_map(lambda x: x[0], params["dec"])
    lc = tree_map(lambda x: x[0], c_cont)
    lpool = tree_map(lambda x: x[0], pool)
    xtab = tables[:, nb:]
    h = torch.randn(B, 1, cfg.d_model, device="cuda").to(params["frontend_proj"].dtype)
    M = cfg.n_image_tokens

    def gather():
        t = xtab.long()
        return [lpool["xkv"][k][t].flatten(1, 2)[:, :M] for k in ("k", "v")]

    fns = {
        "encoder_ms": lambda: cont.encode(params, frames),
        "cross_layer_contiguous_ms": lambda: cont._cross(lp, h, lc, None, None),
        "cross_layer_paged_ms": lambda: paged._cross(lp, h, lpool, None, xtab),
        "gather_layer_paged_ms": gather,
    }
    wrappers = counted_wrappers()
    saved = {k: f.launches for k, f in wrappers.items()}
    row = {k: device_ms(f, iters=10) for k, f in fns.items()}
    row["profile_contiguous"] = profile_step(lambda: cont.decode(
        params, c_cont, nxt, pos, active_sites=act, exit_thresholds=thr))
    row["profile_paged"] = profile_step(lambda: paged.decode(
        params, pool, nxt, pos, active_sites=act, exit_thresholds=thr, block_tables=tables))
    for k, f in wrappers.items():  # launches made to time a call do not count
        f.launches = saved[k]
    L = cfg.n_dec_layers
    busy = {lay: row[f"profile_{lay}"]["device_busy_ms"] for lay in ("contiguous", "paged")}
    row["cross_share_contiguous"] = L * row["cross_layer_contiguous_ms"] / busy["contiguous"]
    row["cross_share_paged"] = L * row["cross_layer_paged_ms"] / busy["paged"]
    row["gather_share_paged"] = L * row["gather_layer_paged_ms"] / busy["paged"]
    row["gather_bytes_layer"] = 2 * 2 * B * M * cfg.n_kv_heads * cfg.hd * 2  # read + write
    row.update(stats)
    del c_cont, pool
    return launches, row


def encdec_window(params, cfg, frames, toks, act):
    """Phase 12d: ``decode_multi`` windows of 4 against 4 single ``decode``
    calls (the window's exit decision taken on the host from their exit
    bits), from one prefill's cache: thresholds at each ramp's median
    uncertainty of the first step (some rows exit, some stay) and at 1.0
    (every row exits at once: ``n_done`` 1). Records, ``n_done`` and the
    caches after must be equal bit for bit."""
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map

    on = build_model(cfg.replace(decode_attn="kernel", pallas_head="kernel"),
                     prefill_attn="kernel")
    cache, o = on.prefill(params, frames, toks, cache_len=SM_CACHE, active_sites=None)
    B, K = toks.shape[0], len(act)
    tok = o["final"]["label"].reshape(-1, 1).long()
    pos = torch.full((B,), SM_PROMPT, device="cuda")
    _, probe = on.decode(params, tree_map(torch.clone, cache), tok, pos, active_sites=act)
    unc = 1.0 - probe["ramps"]["maxprob"].float()
    out = {}
    for name, thr in (("median", unc.median(dim=1).values), ("one", torch.ones(K, device="cuda"))):
        a, b = tree_map(torch.clone, cache), tree_map(torch.clone, cache)
        _, (rl, rm, fl, ex, nd) = on.decode_multi(params, a, tok, pos, 4, n_max=4,
                                                  active_sites=act, thresholds=thr)
        nd = int(nd)
        t, p, n, exits = tok, pos, 0, 0
        for i in range(4):
            _, s1 = on.decode(params, b, t, p, active_sites=act, exit_thresholds=thr)
            m = s1["ramps"]["exit"].bool()
            site = torch.where(m.any(0), torch.tensor(act, device="cuda")[m.int().argmax(0)], -1)
            if i < nd and not (torch.equal(rl[i], s1["ramps"]["label"].int())
                               and torch.equal(rm[i], s1["ramps"]["maxprob"].float())
                               and torch.equal(fl[i], s1["final"]["label"].reshape(-1).int())
                               and torch.equal(ex[i], site.int())):
                fail(f"12d {name}: window step {i} differs from a single decode call")
            n += 1
            exits += int(m.any(0).sum())
            if bool((site >= 0).all()):
                break
            t, p = s1["final"]["label"].reshape(-1, 1).long(), p + 1
        if n != nd:
            fail(f"12d {name}: n_done {nd}, single calls ran {n} steps")
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            if not torch.equal(x, y):
                fail(f"12d {name}: the window's cache differs from the single calls'")
        out[name] = {"n_done": nd, "row_exits": exits}
    if not (out["one"]["n_done"] == 1 and out["median"]["row_exits"] > 0):
        fail(f"12d: windows {out}; expected exits at the median and n_done 1 at 1.0")
    print(f"12d {cfg.name} decode_multi windows of 4 vs 4 single decode calls on "
          f"{card_line()}: records, n_done and caches bit for bit; {json.dumps(out)}",
          flush=True)
    return out


def encdec_loss(model, params, cfg, gen, B=2, S=SM_PROMPT):
    """Phase 12e: one ``loss`` and its backward at B 2, 64 tokens and 1600
    frames, every parameter's gradient (the plain paths: sdpa, dense ramp
    logits; no kernel): finite loss, finite gradients, the cross gates', the
    frontend's and the ramp heads' nonzero; ms and peak memory."""
    from repro_torch.models.common import tree_leaves

    fr = torch.randn(B, cfg.n_image_tokens, cfg.d_frontend, generator=gen,
                     device="cuda").to(torch.bfloat16)
    toks = torch.randint(1, cfg.vocab_size, (B, S + 1), generator=gen, device="cuda")
    batch = {"frames": fr, "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = tree_leaves(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for x in leaves:
        x.requires_grad_(True)
    try:
        loss, met = model.loss(params, batch)
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves, allow_unused=True)))
    finally:
        for x in leaves:
            x.requires_grad_(False)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    bad = [i for i, g in enumerate(grads.values()) if g is None or not torch.isfinite(g).all()]
    if not torch.isfinite(loss) or bad:
        fail(f"12e: loss {loss.item()}, leaves without a finite gradient {bad}")
    for what, leaf in (("cross gates", params["dec"]["xattn"]["gate"]),
                       ("frontend_proj", params["frontend_proj"]),
                       ("ramp heads", params["ramps"]["head"])):
        if not grads[id(leaf)].abs().max().item() > 0:
            fail(f"12e: the {what} have no gradient")
    row = {"loss": loss.item(), **{k: v.item() for k, v in met.items()}, "ms": ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del grads, loss
    print(f"12e {cfg.name} loss + backward at B {B}, {S} tokens, {cfg.n_image_tokens} frames on "
          f"{card_line()}: {json.dumps(row)}", flush=True)
    return row


def seamless_phases(gen):
    """Phase 12: SeamlessM4T-large-v2 whole (24 encoder + 24 decoder layers,
    d 1024, 16 heads of 64, d_ff 8192, an untied 256206-token vocab padded
    to 258048, 23 ramp heads: 8.12 B parameters, 16.23 GB of bf16), seeded
    random weights, its cross gates set to 1.0 after the draw (zero at
    init). B 8 rows of 1600 frames (d_frontend 1024) and 64 prompt tokens,
    4 active ramps. 12a: #4 at the encoder's shape (no mask, 1600 x 1600)
    and the decoder's (causal, 64 x 104), #1 and #5 at group 1, hd 64 (#5
    over tables with 100 trailing xkv columns), #2/#3 at d 1024 x V 258048,
    each against its plain version. 12b: prefills through sdpa vs the flash
    kernel, then 32 decode steps on contiguous rows with the kernels off vs
    on; the encoder's device ms, a step's device-busy ms against its byte
    floor, the cross layers' share. 12c: the same rows on the pool (bs 16,
    7 token blocks and 100 pinned xkv blocks a row) against the contiguous
    rows; the pinned pages' gather's share. 12d: sync windows against
    single steps. 12e: the loss and its backward. Returns (its rows, 12c's
    launches)."""
    from repro_torch.configs import get_config

    cfg = get_config(SM_CONFIG)
    model, params = _draw(cfg, f"{SM_CONFIG} weights, whole: 24 encoder + 24 decoder layers "
                               "of d 1024, 16 heads of 64, 23 ramp heads")
    params["dec"]["xattn"]["gate"].fill_(1.0)
    print("12: the cross gates set to 1.0 (tanh 0.762) after the draw, so that the memory "
          "changes the output", flush=True)
    t = _lap("12 draw", time.perf_counter())
    rows = {}
    nbx = -(-cfg.n_image_tokens // SM_BS)
    nb = -(-SM_CACHE // SM_BS)
    # -- 12a: the kernels alone at SeamlessM4T's shapes
    rows["flash_enc"] = check_flash_attention(
        8, 16, 16, cfg.n_image_tokens, cfg.n_image_tokens, 64,
        f"B=8 H=KH=16 hd=64 Sq=Sk={cfg.n_image_tokens} no mask bf16 (encoder)", gen,
        causal=False)
    rows["flash_dec"] = check_flash_attention(
        8, 16, 16, SM_PROMPT, SM_CACHE, 64, "B=8 H=KH=16 hd=64 Sq=64 Sk=104 causal bf16 (decoder)",
        gen)
    rows["decode"] = check_decode_attention(
        8, SM_CACHE, "B=8 H=KH=16 hd=64 S=104 pos 64..103 bf16", gen, pos_lo=SM_PROMPT, H=16,
        KH=16, hd=64)
    rows["paged"] = check_paged_decode_attention(
        8, nb, f"B=8 H=KH=16 hd=64 bs=16 nb={nb} (+{nbx} trailing xkv columns) pos 64..103 "
        "shuffled bf16", gen, SM_PROMPT, SM_CACHE, H=16, KH=16, hd=64, trailing=nbx)
    rows["ramp"] = check_ramp_head(params, cfg, gen)
    t = _lap("12a", t)
    # -- 12b: the model, kernels off vs on, on contiguous rows
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 17)
    frames = torch.randn(8, cfg.n_image_tokens, cfg.d_frontend, generator=g,
                         device="cuda").to(torch.bfloat16)
    toks = torch.randint(1, cfg.vocab_size, (8, SM_PROMPT), generator=g, device="cuda")
    act = list(SM_ACT)
    rows["paths"] = compare_paths(
        params, cfg, cfg.replace(decode_attn="dense", pallas_head="off"),
        cfg.replace(decode_attn="kernel", pallas_head="kernel"), gen,
        on_kw={"prefill_attn": "kernel"}, prefill_kernel="flash_attention", toks=toks,
        T=SM_STEPS, act=act, prefill_kw={"frames": frames}, cache_len=SM_CACHE)
    t = _lap("12b", t)
    # -- 12c: contiguous rows vs the pool, counted: the main path
    launches, step = encdec_layouts(params, cfg, frames, toks, act)
    rows["step"] = step
    floor = rows["floor"] = encdec_step_floor(params, cfg)
    prof = step["profile_contiguous"]
    print(f"12b {cfg.name} on {card_line()}: the encoder (8 x {cfg.n_image_tokens} frames, flash kernel) "
          f"{step['encoder_ms']:.3f} ms device; one eager decode step (B 8, 4 ramps, kernels "
          f"on, contiguous) device-busy {prof['device_busy_ms']:.3f} ms, wall "
          f"{prof['wall_ms']:.3f} ms, against a byte floor of {floor['ms']:.3f} ms "
          f"({json.dumps(floor)}); the 24 cross layers (each timed alone) "
          f"{100 * step['cross_share_contiguous']:.1f}% of the step's device-busy time",
          flush=True)
    print(f"12c {cfg.name} paged vs contiguous on {card_line()}: {step['labels']} labels, "
          f"{step['near_ties']} near-ties; a paged step device-busy "
          f"{step['profile_paged']['device_busy_ms']:.3f} ms, wall "
          f"{step['profile_paged']['wall_ms']:.3f} ms, the 24 cross layers "
          f"{100 * step['cross_share_paged']:.1f}% of it, their gather of the pinned pages "
          f"{100 * step['gather_share_paged']:.1f}% ({step['gather_layer_paged_ms']:.4f} ms a "
          f"layer); timings {json.dumps(step)}; launches of the counted run (a prefill, "
          f"{SM_STEPS} steps on each layout) {json.dumps(launches)}", flush=True)
    t = _lap("12c", t)
    # -- 12d: sync windows; 12e: the loss
    rows["window"] = encdec_window(params, cfg, frames, toks, act)
    t = _lap("12d", t)
    del frames, toks
    gc.collect()
    torch.cuda.empty_cache()
    rows["loss"] = encdec_loss(model, params, cfg, gen)
    _lap("12e", t)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------------------
# phase 13: the dry run's counts against the card, the kernels' meta
# contracts against their launches, the runtime presets


P13_B, P13_POS, P13_CACHE = 8, PAGED_PROMPT + 20, PAGED_PROMPT + PAGED_TOKENS + 2


def _op_names(fn):
    """Each aten op's count in ``fn()`` (for the report when counts differ)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Names(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func)] = self.n.get(str(func), 0) + 1
            return func(*args, **(kwargs or {}))

    mode = Names()
    with mode:
        fn()
    return mode.n


def dryrun_counts_phase(gen):
    """Phase 13a: qwen2-1.5b at full width. The bytes drawing its params asks
    of the caching allocator against ``param_bytes(schema)`` (equal), and
    the allocated rise beside them (512-byte blocks, a large block keeping
    up to 1 MiB of its segment's remainder); one B 8 decode step at pos
    140, kernels off, counted by the dry run's two counters on meta tensors
    and on the card's tensors, which must be equal; the dry run's
    served-shape ``floor_bytes`` beside ``step_bytes``' total."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import count, run_cell
    from repro_torch.models import build_model
    from repro_torch.models.common import param_bytes, tree_leaves

    cfg = get_config(CONFIG)
    model = build_model(cfg)  # the plain path: dense decode, dense heads
    sch = model.schema()
    want = param_bytes(sch)
    rounded = sum(-(-(math.prod(i.shape) * i.dtype.itemsize) // 512) * 512
                  for i in tree_leaves(sch))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    # bytes asked of the caching allocator (requested), and the blocks it
    # gave (allocated: a large block may keep its segment's remainder)
    stats = ("requested_bytes.all.current", "allocated_bytes.all.current")
    before = [torch.cuda.memory_stats()[k] for k in stats]
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    req, rise = (torch.cuda.memory_stats()[k] - b for k, b in zip(stats, before))
    row = {"param_bytes": want, "param_bytes_rounded_512": rounded, "requested_rise": req,
           "allocated_rise": rise}
    if req != want or not rounded <= rise <= rounded + len(tree_leaves(sch)) * (1 << 20):
        fail(f"13a: drawing {CONFIG}'s params asked the allocator for {req} B and raised "
             f"allocated memory by {rise} B; the schema reckons {want} B ({rounded} B in "
             "512-byte blocks, each block keeping at most 1 MiB of its segment)")
    B, pos, S = P13_B, P13_POS, P13_CACHE

    def step_on(dev):
        if dev == "meta":
            p, cache = model.abstract(), model.cache_abstract(B, S)
            toks = torch.empty((B, 1), dtype=torch.int64, device="meta")
            pp = torch.empty((B,), dtype=torch.int64, device="meta")
        else:
            p, cache = params, model.init_cache(B, S, device="cuda")
            toks = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen, device="cuda")
            pp = torch.full((B,), pos, dtype=torch.int64, device="cuda")
        act = list(range(4))
        return lambda: model.decode(p, cache, toks, pp, active_sites=act)

    with torch.no_grad():
        meta_fn, card_fn = step_on("meta"), step_on("cuda")
        _, mf, mb, mo = count(meta_fn)
        _, cf, cb, co = count(card_fn)
        torch.cuda.synchronize()
        row.update({"meta": {"flops": mf, "bytes": mb, "ops": mo},
                    "card": {"flops": cf, "bytes": cb, "ops": co}})
        if (mf, mb, mo) != (cf, cb, co):
            mn, cn = _op_names(meta_fn), _op_names(card_fn)
            diff = {k: (mn.get(k, 0), cn.get(k, 0)) for k in sorted(set(mn) | set(cn))
                    if mn.get(k, 0) != cn.get(k, 0)}
            fail(f"13a: the decode step counts {mf} FLOPs, {mb} B in {mo} ops on meta and "
                 f"{cf} FLOPs, {cb} B in {co} ops on the card; ops (meta, card): {diff}")
    served = dict(kind="decode", seq_len=S, global_batch=B, pos=pos, active=4)
    rec = run_cell(CONFIG, served, tag="served", write=False)
    if not rec["ok"]:
        fail(f"13a: the dry run's served cell failed: {rec.get('error')}")
    hand = step_bytes(params, cfg, model, B, 4, pos)
    row.update({"floor_bytes": rec["floor_bytes"], "floor": rec["floor"],
                "step_bytes_total": hand["total"], "floor_ms": 1e3 * rec["t_floor_s"],
                "dryrun_flops": rec["flops"], "dryrun_bytes": rec["bytes"]})
    if abs(rec["floor_bytes"] - hand["total"]) > 0.01 * hand["total"]:
        fail(f"13a: the dry run's floor {rec['floor_bytes']} B and step_bytes' "
             f"{hand['total']} B differ by more than 1%")
    print(f"13a {CONFIG} on {card_line()}: params {want} B reckoned, {req} B requested of "
          f"the allocator, allocated memory rose {rise} B; a B {B} decode step at pos {pos} "
          f"(kernels off) counts {cf} FLOPs and {cb} B in {co} aten ops on the card, equal "
          f"on meta; the dry run's floor {rec['floor_bytes']} B ({row['floor_ms']:.3f} ms at "
          f"3.35 TB/s) beside step_bytes' {hand['total']} B: {json.dumps(row)}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _meta_like(t):
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def meta_contracts_phase(gen):
    """Phase 13b: each of #1-#7 at one served shape (qwen2-1.5b's #1/#5/#4
    and heads, DeepSeek-V2-Lite's #6, Mamba2-2.7B's #7): the ``*_meta``
    twin's outputs on meta copies of the operands (the same strides) have
    the shapes, dtypes and strides of the kernel's outputs on the card.
    Then the ramp-head kernel's shared-memory fit as the meta contract
    reckons it (``smem_fits``) against the library's launch plan
    (``ramp_head_parts`` >= 1) over widths d, rows B and both layouts."""
    from repro_torch.kernels.decode_attention import kernel as DA
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.ramp_head import kernel as RH
    from repro_torch.kernels.ssd import kernel as SK

    bf, dev = torch.bfloat16, "cuda"

    def rnd(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, H, KH, hd, S = 8, 12, 2, 128, 160
    cache = rnd(B, S, KH, hd)
    pos = torch.randint(120, S, (B,), generator=gen, device=dev)
    table = torch.randperm(80, generator=gen, device=dev)[:B * 10].reshape(B, 10).to(torch.int32)
    pool = rnd(80, 16, KH, hd)
    c_pool, kpe = rnd(80, 16, 512), rnd(80, 16, 64)
    qf, kf = rnd(1, 128, 12, hd), rnd(1, S, KH, hd)
    xs = rnd(1, 128, 80, 64)
    dt = torch.rand(1, 128, 80, generator=gen, device=dev)
    A = -torch.rand(80, generator=gen, device=dev)
    bc = rnd(1, 128, 128)
    embed = rnd(151936, 1536)
    head = rnd(1536, 151936)
    h, thr = rnd(B, 1536), torch.full((B,), 0.5, device=dev)
    cases = {
        "decode_attention": (DA.decode_attention, DA.decode_attention_meta,
                             (rnd(B, H, hd), cache.transpose(1, 2), cache.transpose(1, 2), pos),
                             {}),
        "paged_decode_attention": (DA.paged_decode_attention, DA.paged_decode_attention_meta,
                                   (rnd(B, H, hd), pool, pool, table, pos), {}),
        "paged_mla_decode_attention": (
            DA.paged_mla_decode_attention, DA.paged_mla_decode_attention_meta,
            (rnd(B, 16, 512), rnd(B, 16, 64), c_pool, kpe, table, pos),
            {"scale": 1 / math.sqrt(192)}),
        "flash_attention": (FA.flash_attention, FA.flash_attention_meta,
                            (qf.transpose(1, 2), kf.transpose(1, 2), kf.transpose(1, 2)),
                            {"causal": True}),
        "ssd_chunked": (SK.ssd_chunked, SK.ssd_chunked_meta,
                        (xs.transpose(1, 2), dt.transpose(1, 2), A, bc, bc), {}),
        "ramp_head_stats": (RH.ramp_head_stats, RH.ramp_head_stats_meta,
                            (h, embed.T), {"v_limit": 151936}),
        "ramp_head_exit": (RH.ramp_head_exit, RH.ramp_head_exit_meta, (h, head, thr),
                           {"v_limit": 151936}),
    }
    rows = {}
    for name, (card_fn, meta_fn, args, kw) in cases.items():
        outs = card_fn(*args, **kw)
        metas = meta_fn(*[_meta_like(a) if torch.is_tensor(a) else a for a in args], **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        metas = metas if isinstance(metas, tuple) else (metas,)
        got = [(tuple(t.shape), str(t.dtype), t.stride()) for t in outs]
        want = [(tuple(t.shape), str(t.dtype), t.stride()) for t in metas]
        if got != want or any(t.device.type != "meta" for t in metas):
            fail(f"13b {name}: the card's outputs {got}, the meta contract's {want}")
        rows[name] = got
    torch.cuda.synchronize()
    lib = RH._lib()
    sweep = []
    for d in (512, 1024, 2048, 4096, 5120, 6144, 7168, 8192, 9216, 10240, 12288, 16384):
        for Bh in (1, 8, 32):
            for vmaj in (True, False):
                sk, sv = (151936, 1) if vmaj else (1, d)
                lib_fits = lib.ramp_head_parts(Bh, d, 151936, 151936, sk, sv, 1) >= 1
                if lib_fits != RH.smem_fits(Bh, d, vmaj, bf):
                    fail(f"13b ramp head: at d {d}, B {Bh}, {'V' if vmaj else 'd'}-major the "
                         f"library {'fits' if lib_fits else 'does not fit'} a launch shape; "
                         "smem_fits says otherwise")
                sweep.append(lib_fits)
    print(f"13b the seven kernels' meta contracts on {card_line()}: outputs (shape, dtype, "
          f"strides) equal the card's at each served shape {json.dumps(rows)}; the ramp "
          f"head's shared-memory fit agrees with the library at {len(sweep)} (d, B, layout) "
          f"points ({sum(sweep)} fit)", flush=True)
    return rows


PRESET_ARGS = ["--config", CONFIG, "--n", "8"]


def presets_phase():
    """Phase 13c: the launcher with ``--runtime-preset serve`` and then
    ``bench`` in subprocesses (qwen2-1.5b, 8 requests, window graphs on):
    each exits 0; print the variables the preset wrote, the windows
    captured and replayed, and decode tokens/s."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    rows = {}
    for preset in ("serve", "bench"):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                              "--runtime-preset", preset, *PRESET_ARGS], cwd=root, env=env,
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            fail(f"13c: the launcher with --runtime-preset {preset} exited "
                 f"{out.returncode}: {out.stderr[-2000:]}")
        lines = out.stdout.splitlines()
        wrote = [ln for ln in lines if ln.startswith(f"runtime preset {preset}: wrote ")]
        start = next((i for i, ln in enumerate(lines) if ln == "{"), None)
        if not wrote or start is None:
            fail(f"13c: the launcher with --runtime-preset {preset} printed no preset line "
                 f"or summary: {out.stdout[-2000:]}")
        m = json.loads("\n".join(lines[start:]))["measured"]
        if not m["graphs"] or not m["graphs"]["captures"] or not m["graphs"]["replays"]:
            fail(f"13c: --runtime-preset {preset} captured or replayed no window graph: "
                 f"{json.dumps(m['graphs'])}")
        rows[preset] = {"wrote": json.loads(wrote[0].split(" wrote ", 1)[1]),
                        "graphs": m["graphs"], "decode_tokens_per_s": m["decode_tokens_per_s"],
                        "window_ms_mean": m["window_ms_mean"],
                        "wall_s": time.perf_counter() - t0}
        print(f"13c launcher --runtime-preset {preset} on {card_line()}: wrote "
              f"{json.dumps(rows[preset]['wrote'])}; {m['decode_tokens_per_s']:.1f} decode "
              f"tokens/s, graphs {json.dumps(m['graphs'])}, "
              f"{rows[preset]['wall_s']:.1f} s", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 14: multi-rank serving, two ranks sharing one card over gloo

MR_RANKS = 2  # processes on cuda:0; their collectives stage through host memory (gloo)
MR_LABEL = "2 ranks sharing one card"
MR_PROMPT, MR_STEPS = 128, 8
MR_THR = 0.5  # exit thresholds of the compared steps (random weights: nothing exits)
# sharded records against the single rank's: |log maxprob| apart by at most
# this, about twice the largest sound reading (0.090, qwen1.5-32b at tp 2);
# 14a's planted fault (a rank reading the other rank's kv-head block) must
# exceed it
MR_LOGP_TOL = 0.2
Q3_DEPTH, Q32_DEPTH, PIPE_DEPTH = 8, 8, 16
Q32_CONFIG = "qwen1.5-32b"


def _mr_recs(outs):
    """One step's records on the host: final and ramp labels, maxprob, exit."""
    recs = {"final_label": outs["final"]["label"].reshape(-1).cpu(),
            "final_maxprob": outs["final"]["maxprob"].float().reshape(-1).cpu()}
    if "ramps" in outs:
        recs.update(ramp_label=outs["ramps"]["label"].cpu(),
                    ramp_maxprob=outs["ramps"]["maxprob"].float().cpu(),
                    exit=outs["ramps"]["exit"].cpu())
    return recs


class _HeadSpy:
    """Records the (h_last, pooled) of each ``_head_stats`` call of ``model``
    inside the block; ``logits(params, act)`` turns them into the f32 dense
    logits of the final head and the active ramps (the near-tie rule's
    judge), on the host."""

    def __init__(self, model):
        self.model, self.seen = model, []

    def __enter__(self):
        orig = type(self.model)._head_stats

        def spy(params_, h_last, pooled, *a, **kw):
            self.seen.append((h_last, pooled))
            return orig(self.model, params_, h_last, pooled, *a, **kw)

        self.model._head_stats = spy
        return self

    def __exit__(self, *exc):
        del self.model._head_stats

    def logits(self, params, act=()):
        from repro_torch.models import layers as LY

        model, cfg, out = self.model, self.model.cfg, []
        for h_last, pooled in self.seen:
            hn = LY.apply_norm(cfg, params["final_norm"], h_last)[:, -1]
            fin = _logits_ref(hn, head_weight(params, cfg), cfg.vocab_size).cpu()
            ramps = None
            if act:
                hs = model._ramp_hidden(params, pooled, list(act))[:, :, -1]
                ramps = torch.stack([_logits_ref(hs[j], model.ramp_head(params, i),
                                                 cfg.vocab_size) for j, i in enumerate(act)])
                ramps = ramps.cpu()
            out.append((fin, ramps))
        self.seen = []
        return out


def _mr_steps(step, tok, pos, n, feeds=None):
    """n decode steps through ``step(tok, pos) -> outs``, each fed ``feeds[i]``
    or the previous step's own greedy label. Returns (records, tokens fed,
    host ms of each step with the device synced around it)."""
    recs, fed, ms = [], [], []
    for i in range(n):
        tok = feeds[i].to(pos.device) if feeds is not None else tok
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = step(tok, pos)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        recs.append(_mr_recs(outs))
        fed.append(tok.cpu())
        tok, pos = outs["final"]["label"].reshape(-1, 1).long(), pos + 1
    return recs, fed, ms


def _mr_apart(a, b):
    """The largest |log maxprob| difference of two steps' records (the
    final head's and every ramp's)."""
    return max((a[k].log() - b[k].log()).abs().max().item()
               for k in ("final_maxprob", "ramp_maxprob"))


def _mr_compare(what, recs, ref, logits):
    """Sharded records against the single rank's on the same tokens: labels
    equal except near-ties of the single rank's f32 logits (NEAR_TIE), log
    maxprob within MR_LOGP_TOL, exit masks equal. Returns (near ties, the
    largest |log maxprob| difference)."""
    ties, dmax = 0, 0.0
    for i, (a, b) in enumerate(zip(recs, ref)):
        fin, ramps = logits[i]
        ties += _near_tie_labels(a["final_label"], b["final_label"], fin, NEAR_TIE,
                                 f"{what} step {i} final")
        for j in range(a["ramp_label"].shape[0]):
            ties += _near_tie_labels(a["ramp_label"][j], b["ramp_label"][j], ramps[j],
                                     NEAR_TIE, f"{what} step {i} ramp {j}")
        d = _mr_apart(a, b)
        dmax = max(dmax, d)
        if not d <= MR_LOGP_TOL:
            fail(f"{what} step {i}: log maxprob apart by {d}, limit {MR_LOGP_TOL}")
        if not torch.equal(a["exit"], b["exit"]):
            fail(f"{what} step {i}: exit masks differ")
    return ties, dmax


def _mr_bytes(tree):
    from repro_torch.models.common import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _mr_clone(tree, fn=torch.clone):
    from repro_torch.models.common import tree_map

    return tree_map(fn, tree)


def _mr_bcast(obj):
    """Rank 0's ``obj`` on every rank (a pickled host object, over gloo)."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _mr_pool(model, cache, bs, gen):
    """An attention cache of B rows x nb*bs tokens as a paged pool of 1 +
    B*nb blocks of bs under a shuffled block table (block 0 the trash
    block). Returns (pool, table)."""
    from repro_torch.models.common import tree_leaves

    leaves = tree_leaves(cache)
    B, S = leaves[0].shape[-4], leaves[0].shape[-3]  # any leaf: (.., B, S, KH, hd)
    nb = S // bs
    table = (torch.randperm(B * nb, generator=gen, device="cuda") + 1).reshape(B, nb)
    pool = model.init_paged_cache(1 + B * nb, bs, device="cuda")
    for pl, cl in zip(tree_leaves(pool), leaves):
        ax = pl.dim() - 4  # the pool axis: 0 for prefix leaves, 1 for stacked ones
        pl.index_copy_(ax, table.reshape(-1), cl.reshape(cl.shape[:ax] + (B * nb, bs)
                                                         + cl.shape[-2:]))
    return pool, table.to(torch.int32)


def _mr_reset():
    from repro_torch.kernels import counted_wrappers

    fns = counted_wrappers()
    for f in fns.values():
        f.launches = 0
    return lambda: {k: f.launches for k, f in fns.items()}


def _mr_qwen2(mesh, rank):
    """14a: qwen2-1.5b whole at tp 2: the replicated prefill (#4), 8 steps
    through ``decode_sharded`` (#1 on 6:1 heads a rank, #2/#3) against the
    single rank's ``decode`` fed the same tokens, windows of 4 bit for bit
    against single sharded steps, the cache bytes a rank holds, and the
    paged pool (#5) the same way. Returns (results, model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(CONFIG).replace(decode_attn="kernel", pallas_head="kernel")
    model = build_model(cfg, prefill_attn="kernel")
    paged = build_model(cfg.replace(decode_attn="paged-kernel"), prefill_attn="kernel")
    params = model.init(SEED, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 14)
    act = _spread(len(model.sites), 4)
    thr = torch.full((len(act),), MR_THR, device="cuda")
    B, P = 8, MR_PROMPT
    toks = torch.randint(1, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    read = _mr_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, outs = model.prefill(params, toks, cache_len=P + 16)
    torch.cuda.synchronize()
    res = {"prefill_ms": 1e3 * (time.perf_counter() - t0), "prefill_launches": read()}
    tok0, pos0 = outs["final"]["label"].reshape(B, 1).long(), torch.full((B,), P, device="cuda")
    mi, m = mesh.model_rank, mesh.tp
    shard = model.tp_shard_params(params, mi, m)
    pool, table = _mr_pool(paged, cache, 16, gen)
    layouts = (("rows", model, cache, {}), ("pages", paged, pool, {"block_tables": table}))
    single = {}
    if rank == 0:
        for name, mdl, c, kw in layouts:
            c = _mr_clone(c)
            with _HeadSpy(mdl) as spy:
                recs, fed, ms = _mr_steps(lambda t, p: mdl.decode(
                    params, c, t, p, active_sites=act, exit_thresholds=thr, **kw)[1],
                    tok0, pos0, MR_STEPS)
            single[name] = (recs, fed, ms, spy.logits(params, act), _mr_bytes(c))
    feeds = _mr_bcast({k: v[1] for k, v in single.items()})
    for name, mdl, c, kw in layouts:
        cs = model.tp_shard_cache(c, mi, m)
        read = _mr_reset()
        recs, _, ms = _mr_steps(lambda t, p: mdl.decode_sharded(
            shard, cs, t, p, mesh=mesh, active_sites=act, exit_thresholds=thr, **kw)[1],
            tok0, pos0, MR_STEPS, feeds[name])
        res[name] = {"recs": recs, "ms": ms, "launches": read(), "cache_bytes": _mr_bytes(cs)}
        if rank == 0:
            ties, dmax = _mr_compare(f"14a {name}", recs, single[name][0], single[name][3])
            res[name].update(single_ms=single[name][2], near_ties=ties, log_maxprob_apart=dmax,
                             single_cache_bytes=single[name][4])
            if m * res[name]["cache_bytes"] != single[name][4]:
                fail(f"14a {name}: a rank holds {res[name]['cache_bytes']} B of the single "
                     f"rank's {single[name][4]}")
    # the planted fault: each rank decodes on the other rank's kv-head block
    # of the same cache; the log maxprob limit must catch it
    cs = model.tp_shard_cache(cache, (mi + 1) % m, m)
    bad, _, _ = _mr_steps(lambda t, p: model.decode_sharded(
        shard, cs, t, p, mesh=mesh, active_sites=act, exit_thresholds=thr)[1],
        tok0, pos0, MR_STEPS, feeds["rows"])
    if rank == 0:
        res["fault_apart"] = max(_mr_apart(a, b) for a, b in zip(bad, single["rows"][0]))
        res["fault_labels"] = sum(int((a[k] != b[k]).sum()) for a, b in zip(bad, single["rows"][0])
                                  for k in ("final_label", "ramp_label"))
        if not res["fault_apart"] > MR_LOGP_TOL:
            fail(f"14a: a rank on the other rank's kv-head block moves log maxprob only "
                 f"{res['fault_apart']}, within the limit {MR_LOGP_TOL}")
    # a window of 4 against 4 single sharded steps, each fed its own label
    cs = model.tp_shard_cache(cache, mi, m)
    steps, _, _ = _mr_steps(lambda t, p: model.decode_sharded(
        shard, cs, t, p, mesh=mesh, active_sites=act, exit_thresholds=thr)[1], tok0, pos0, 4)
    cs = model.tp_shard_cache(cache, mi, m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs, (rl, rm, fl, ex, nd) = model.decode_sharded_multi(
        shard, cs, tok0, pos0, 4, mesh=mesh, n_max=4, active_sites=act, thresholds=thr)
    torch.cuda.synchronize()
    res["window_ms"] = 1e3 * (time.perf_counter() - t0)
    if int(nd) != 4:
        fail(f"14a: a window of 4 ran {int(nd)} steps at thresholds {MR_THR}")
    for i, s in enumerate(steps):
        if not (torch.equal(rl[i].cpu(), s["ramp_label"].to(torch.int32))
                and torch.equal(rm[i].cpu(), s["ramp_maxprob"])
                and torch.equal(fl[i].cpu(), s["final_label"].to(torch.int32))):
            fail(f"14a: window step {i} differs from the single sharded step")
    return res, model, params


def _mr_serve(mesh, rank, model, params):
    """14b: ``ShardedDecodeRunner`` through the port's engine and
    controller, 8 requests (prompt 120, 38 tokens) on contiguous rows and
    on the pool, eager windows, each rank on its shard of the weights (its
    prefill tensor-parallel, #4 on 6:1 heads), against a single-rank
    ``DecodeRunner`` on the same schedule: tokens equal except from a
    near-tie, and how many tokens each request matched before it parted."""
    import hashlib

    from repro_torch.launch.serve import serve_generative

    cfg = model.cfg
    prompts = np.random.default_rng(SEED + 7).integers(1, cfg.vocab_size, (8, PAGED_PROMPT))
    kw = dict(decode_tokens=PAGED_TOKENS, prompt_len=PAGED_PROMPT, steps_per_sync=4,
              seed=SEED, device="cuda", verbose=False, prompts=prompts, graphs=False)
    shard = model.tp_shard_params(params, mesh.model_rank, mesh.tp)
    res = {}
    for layout, lk in (("rows", {}), ("pages", {"kv_block_size": 16})):
        if rank == 0:
            ref_out, ref = serve_generative(CONFIG, 8, **kw, **lk, params=params)
            ref_toks = {r.rid: list(r.final_tokens) for r in ref}
        runners, undo = _tracked_runners()
        read = _mr_reset()
        try:
            out, resp = serve_generative(CONFIG, 8, **kw, **lk, params=shard, mesh=mesh)
        finally:
            undo()
        launches = read()
        _complete(resp, 8, PAGED_TOKENS, cfg.vocab_size, f"14b {layout}")
        r = runners[0]
        state = [r._pos, r._tok] + ([r._alloc.table, r._alloc.owned, r._alloc.refcount]
                                    if r._alloc is not None else [])
        toks = {x.rid: list(x.final_tokens) for x in resp}
        meas = out["measured"]
        res[layout] = {"digest": hashlib.sha256(b"".join(np.asarray(a).tobytes()
                                                         for a in state)).hexdigest(),
                       "tokens": toks, "launches": launches, "kv": out["kv_cache"],
                       "window_ms": meas["window_ms_mean"], "prefill_ms": meas["prefill_ms_mean"],
                       "tokens_per_s": meas["decode_tokens_per_s"]}
        if rank == 0:
            # a request is compared up to its first divergence: t tokens
            gaps, compared, total = [], 0, 0
            for rid, want in ref_toks.items():
                t, gap = _divergence_gap(params, cfg, prompts[rid], want, toks[rid])
                compared += len(want) if t is None else t
                total += len(want)
                if t is not None:
                    if gap >= NEAR_TIE:
                        fail(f"14b {layout} request {rid}: tokens differ from token {t}, "
                             f"logit gap {gap:.4f}")
                    gaps.append((rid, t, round(gap, 4)))
            res[layout].update(
                divergences=gaps, compared=(compared, total),
                single_window_ms=ref_out["measured"]["window_ms_mean"],
                single_tokens_per_s=ref_out["measured"]["decode_tokens_per_s"],
                single_cache_bytes=ref_out["kv_cache"]["cache_bytes"])
    return res


def _mr_wide(mesh, rank, what, cfg, moe_ep):
    """14c/14d: a wide config at reduced depth. Rank 0 draws it whole and
    runs its prefill and 8 decode steps (MoE on the dense dispatch); then
    every rank draws only its shard (``init_sharded``) and decodes 8 steps
    at tp 2 fed the same tokens: Qwen3-MoE from the single rank's prefill
    cache, expert-parallel (``moe_impl='ep'``, 64 experts a rank);
    qwen1.5-32b after its own tensor-parallel prefill (``prefill_sharded``,
    #4 on 20 heads a rank), whose labels are held against the single
    rank's."""
    from repro_torch.models import build_model

    model = build_model(cfg, prefill_attn="kernel")
    act = _spread(len(model.sites), 4)
    thr = torch.full((len(act),), MR_THR, device="cuda")
    B, P = 8, (32 if moe_ep else MR_PROMPT)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 15)
    toks = torch.randint(1, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    pos0 = torch.full((B,), P, device="cuda")
    ref = None
    if rank == 0:
        t0 = time.perf_counter()
        params = model.init(SEED, device="cuda")
        torch.cuda.synchronize()
        ref = {"draw_s": time.perf_counter() - t0, "bytes": _mr_bytes(params)}
        with _HeadSpy(model) as spy:
            cache, outs = model.prefill(params, toks, cache_len=P + 16)
            ref["pf_logits"] = spy.logits(params)[0][0]
        ref["tok0"] = outs["final"]["label"].reshape(B, 1).long().cpu()
        ref["cache"] = _mr_clone(cache, lambda t: t.cpu()) if moe_ep else None
        with _HeadSpy(model) as spy:
            ref["recs"], ref["fed"], ref["ms"] = _mr_steps(lambda t, p: model.decode(
                params, cache, t, p, active_sites=act, exit_thresholds=thr)[1],
                ref["tok0"].cuda(), pos0, MR_STEPS)
            ref["logits"] = spy.logits(params, act)
        del params, cache, outs, spy
        gc.collect()
        torch.cuda.empty_cache()
    got = _mr_bcast(None if ref is None else {k: ref[k] for k in ("fed", "tok0", "cache")})
    mi, m = mesh.model_rank, mesh.tp
    t0 = time.perf_counter()
    shard = model.init_sharded(SEED, mi, m, device="cuda", moe_ep=moe_ep)
    torch.cuda.synchronize()
    res = {"draw_s": time.perf_counter() - t0, "shard_bytes": _mr_bytes(shard)}
    read = _mr_reset()
    if moe_ep:
        cs = model.tp_shard_cache(_mr_clone(got["cache"], lambda t: t.cuda()), mi, m)
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs, outs = model.prefill_sharded(shard, toks, mesh=mesh, cache_len=P + 16)
        torch.cuda.synchronize()
        res["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        if rank == 0:
            res["prefill_near_ties"] = _near_tie_labels(
                outs["final"]["label"].reshape(-1).cpu(), ref["tok0"].reshape(-1),
                ref["pf_logits"], NEAR_TIE, f"{what} prefill")
    recs, _, ms = _mr_steps(lambda t, p: model.decode_sharded(
        shard, cs, t, p, mesh=mesh, active_sites=act, exit_thresholds=thr,
        moe_impl="ep" if moe_ep else "dense")[1], got["tok0"].cuda(), pos0, MR_STEPS,
        got["fed"])
    res.update(recs=recs, ms=ms, launches=read())
    if rank == 0:
        ties, dmax = _mr_compare(what, recs, ref["recs"], ref["logits"])
        res.update(single_ms=ref["ms"], single_draw_s=ref["draw_s"], near_ties=ties,
                   log_maxprob_apart=dmax, single_bytes=ref["bytes"])
    del shard, cs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _mr_pipeline(mesh, rank):
    """14e: ``pipeline_decode_window`` on qwen2-1.5b at full width over 2
    stages, at 16 layers so the stage boundary (layer 7) carries ramp site
    6 (at 28 layers it falls between sites): thresholds off against the
    single rank's greedy loop (tokens equal except from a near-tie), then
    0.9999 at the boundary ramp (rows exit, the later stage works less)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import pipeline_decode_window, stage_shard
    from repro_torch.models import build_model

    cfg = get_config(CONFIG).replace(n_layers=PIPE_DEPTH, decode_attn="kernel",
                                        pallas_head="off")
    model = build_model(cfg, prefill_attn="kernel")
    params = model.init(SEED, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 16)
    B, P, n = 8, MR_PROMPT, MR_STEPS
    toks = torch.randint(1, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    cache, outs = model.prefill(params, toks, cache_len=P + n + 1)
    tok0, pos0 = outs["final"]["label"].reshape(B, 1).long(), torch.full((B,), P, device="cuda")
    res = {}
    if rank == 0:
        c = _mr_clone(cache)
        with _HeadSpy(model) as spy:
            recs, _, res["loop_ms"] = _mr_steps(lambda t, p: model.decode(params, c, t, p)[1],
                                                tok0, pos0, n)
            logits = [lg for lg, _ in spy.logits(params)]
        loop = torch.stack([r["final_label"] for r in recs])
    S = mesh.pp
    p_st, c_st = stage_shard(params, mesh.stage, S), stage_shard(cache, mesh.stage, S)
    site = list(model.sites).index(PIPE_DEPTH // S - 1)
    for kind, kw in (("off", {}), ("on", {"active_sites": [site], "thresholds": [0.9999]})):
        c = _mr_clone(c_st)
        read = _mr_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, tok_rec, exit_rec, alive, steps = pipeline_decode_window(
            model, p_st, c, tok0, pos0, n, mesh=mesh, **kw)
        torch.cuda.synchronize()
        res[kind] = {"ms": 1e3 * (time.perf_counter() - t0), "tok": tok_rec.cpu(),
                     "exit": exit_rec.cpu(), "alive": alive.cpu(),
                     "steps": steps.cpu().tolist(), "launches": read()}
    if rank == 0:
        got, ties = res["off"]["tok"].to(torch.int64), 0
        for b in range(B):
            t = next((i for i in range(n) if got[i, b] != loop[i, b]), None)
            if t is not None:
                gap = (logits[t][b].max() - logits[t][b, int(got[t, b])]).item()
                if gap >= NEAR_TIE:
                    fail(f"14e row {b}: the window's token {t} differs from the loop's, "
                         f"logit gap {gap}")
                ties += 1
        on = res["on"]
        res["near_ties"], res["exits"] = ties, int((on["exit"] >= 0).sum())
        if not (on["steps"][1] < on["steps"][0] and res["exits"] > 0):
            fail(f"14e: at 0.9999 stage_steps {on['steps']}, {res['exits']} exits")
    del params, cache, outs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def multirank_rank(rank, world):
    """Phase 14 inside one rank (``launch.mesh.spawn``): 14a, 14b, 14c,
    14d and 14e in turn, each sub-phase's weights freed before the next is
    drawn. Returns the rank's results and the seconds of each sub-phase."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_serving_mesh(tp=world, device="cuda")
    pipe = make_serving_mesh(pp=world, device="cuda")
    out, secs = {}, {}
    t0 = time.perf_counter()
    out["14a"], model, params = _mr_qwen2(mesh, rank)
    secs["14a"] = time.perf_counter() - t0
    out["14b"] = _mr_serve(mesh, rank, model, params)
    secs["14b"] = time.perf_counter() - t0 - sum(secs.values())
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    out["14c"] = _mr_wide(mesh, rank, "14c qwen3-moe", get_config(Q3_CONFIG).replace(
        n_layers=Q3_DEPTH, capacity_factor=16.0, decode_attn="kernel", pallas_head="kernel"),
        True)
    secs["14c"] = time.perf_counter() - t0 - sum(secs.values())
    out["14d"] = _mr_wide(mesh, rank, "14d qwen1.5-32b", get_config(Q32_CONFIG).replace(
        n_layers=Q32_DEPTH, decode_attn="kernel", pallas_head="kernel"), False)
    secs["14d"] = time.perf_counter() - t0 - sum(secs.values())
    out["14e"] = _mr_pipeline(pipe, rank)
    secs["14e"] = time.perf_counter() - t0 - sum(secs.values())
    out["secs"] = secs
    return out


def _mr_same(results, path, what):
    """A record tree equal bit for bit on every rank."""
    def get(r):
        for k in path:
            r = r[k]
        return r

    a = get(results[0])
    for other in results[1:]:
        b = get(other)
        ok = (all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
              if isinstance(a, list) else a == b)
        if not ok:
            fail(f"{what}: the ranks' records differ")


def nccl_phase(card):
    """14f: one NCCL rank (world size 1) runs 14a's step through
    ``decode_sharded`` at tp 1: the TP branch with its all-gathers through
    NCCL, which at tp 1 concatenate one slice, so the step equals
    ``decode``'s bit for bit. Then ``ShardedDecodeRunner`` at tp 1 with
    window graphs on (``nccl_graphs``)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_dist, make_serving_mesh
    from repro_torch.models import build_model

    cfg = get_config(CONFIG).replace(decode_attn="kernel", pallas_head="kernel")
    with tempfile.TemporaryDirectory() as tmp:
        init_dist(0, 1, backend="nccl", init_method="file://" + os.path.join(tmp, "store"))
        try:
            mesh = make_serving_mesh(tp=1, device="cuda")
            model = build_model(cfg, prefill_attn="kernel")
            params = model.init(SEED, device="cuda")
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED + 14)
            toks = torch.randint(1, cfg.vocab_size, (8, MR_PROMPT), generator=gen, device="cuda")
            cache, outs = model.prefill(params, toks, cache_len=MR_PROMPT + 16)
            tok = outs["final"]["label"].reshape(-1, 1).long()
            pos = torch.full((8,), MR_PROMPT, device="cuda")
            act = _spread(len(model.sites), 4)
            thr = torch.full((len(act),), MR_THR, device="cuda")
            shard = model.tp_shard_params(params, 0, 1)
            gathers = []
            orig = dist.all_gather

            def counting(*a, **kw):
                gathers.append(1)
                return orig(*a, **kw)

            runs = {}
            for name, call in (("decode", lambda c: model.decode(
                    params, c, tok, pos, active_sites=act, exit_thresholds=thr)),
                               ("decode_sharded", lambda c: model.decode_sharded(
                    shard, c, tok, pos, mesh=mesh, active_sites=act, exit_thresholds=thr))):
                c = _mr_clone(cache)
                dist.all_gather = counting
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    c, o = call(c)
                    torch.cuda.synchronize()
                finally:
                    dist.all_gather = orig
                runs[name] = (c, o, 1e3 * (time.perf_counter() - t0))
            (c1, o1, ms1), (c2, o2, ms2) = runs["decode"], runs["decode_sharded"]
            from repro_torch.models.common import tree_leaves

            same = all(torch.equal(a, b) for a, b in zip(tree_leaves(o1), tree_leaves(o2)))
            same = same and all(torch.equal(a, b) for a, b in zip(tree_leaves(c1),
                                                                  tree_leaves(c2)))
            if not same:
                fail("14f: decode_sharded at tp 1 under NCCL differs from decode")
            if len(gathers) != 4 * cfg.n_layers:
                fail(f"14f: {len(gathers)} NCCL all-gathers in a step, expected "
                     f"{4 * cfg.n_layers}")
            print(f"14f (one NCCL rank, world size 1) on {card}: decode_sharded at tp 1 equals "
                  f"decode bit for bit (records and cache), {len(gathers)} NCCL all-gathers; "
                  f"first step {ms2:.3f} ms vs decode {ms1:.3f} ms (host, synced)", flush=True)
            del c1, c2, o1, o2, runs
            nccl_graphs(model, shard, mesh, cfg, card)
        finally:
            dist.destroy_process_group()
    del params, cache, model
    gc.collect()
    torch.cuda.empty_cache()


def nccl_graphs(model, shard, mesh, cfg, card):
    """14f's second part: ``ShardedDecodeRunner`` at tp 1 under NCCL with
    window graphs on, against one with them off, on the same 8 prompts:
    the graphed runner's first window runs eager, its second is captured,
    its third replays; each must give records and cache leaves equal bit
    for bit with the eager runner's same window."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import ShardedDecodeRunner

    prompts = np.random.default_rng(SEED + 141).integers(1, cfg.vocab_size, (8, PAGED_PROMPT))
    kw = dict(max_new_tokens=PAGED_TOKENS + 2, max_slots=4, n_slots=8)
    act, slots = [0, 1], list(range(8))
    thr = np.full(len(act), MR_THR, np.float32)
    e = ShardedDecodeRunner(model, shard, prompts, mesh=mesh, graphs=False, **kw)
    g = ShardedDecodeRunner(model, shard, prompts, mesh=mesh, graphs=True, **kw)
    if g.graphs is None:
        fail("14f: ShardedDecodeRunner under NCCL built no window graphs")
    for r in (e, g):
        for sl in slots:
            r.start(sl, sl)
    ms = {}
    for what in ("eager", "capture", "replay"):
        ge, t = _sync_ms(lambda: g.step_multi(slots, act, 4, thr))
        ms[what] = t
        if _window_kind(g) != what:
            fail(f"14f: the graphed runner's {what} window was a {_window_kind(g)}")
        ee, ms[what + " (eager runner)"] = _sync_ms(lambda: e.step_multi(slots, act, 4, thr))
        for name, a, b in zip(("labels", "unc", "finals", "exits"), ge, ee):
            if not np.array_equal(a, b):
                fail(f"14f: the {what} window's {name} differ from the eager runner's")
        for j, (a, b) in enumerate(zip(tree_leaves(g._cache), tree_leaves(e._cache))):
            if not torch.equal(a, b):
                fail(f"14f: cache leaf {j} differs after the {what} window")
    print(f"14f ShardedDecodeRunner at tp 1 under NCCL, window graphs on ({card}): its eager, "
          f"captured and replayed windows (4 steps, 8 rows, 2 ramps) equal an eager runner's "
          f"bit for bit (records and cache); host ms a window "
          f"{json.dumps({k: round(v, 2) for k, v in ms.items()})}", flush=True)
    del e, g
    gc.collect()


def multirank_phases(gen):
    """Phase 14: multi-rank serving on one card. The kernels at the ranks'
    shapes against their plain versions here, then 14a-14e in 2 spawned
    ranks over gloo (``multirank_rank``), then 14f here under NCCL.
    Returns (kernel rows, the launches counted in rank 0 by sub-phase)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn

    card = card_line()
    rows = {
        "da_q2": check_decode_attention(
            8, 144, "B=8 H=6 KH=1 hd=128 S=144 pos 128..143 bf16 (qwen2-1.5b, a tp-2 rank)",
            gen, pos_lo=128, H=6, KH=1),
        "pda_q2": check_paged_decode_attention(
            8, 9, "B=8 H=6 KH=1 hd=128 bs=16 nb=9 pos 128..143 shuffled bf16 (qwen2-1.5b, a "
            "tp-2 rank)", gen, 128, 144, H=6, KH=1),
        "fa_q2": check_flash_attention(8, 12, 2, 128, 144, 128, "B=8 H=12 KH=2 hd=128 Sq=128 "
                                       "Sk=144 causal bf16 (14a's replicated prefill)", gen),
        "da_pipe": check_decode_attention(
            4, 137, "B=4 H=12 KH=2 hd=128 S=137 pos 128..136 bf16 (a 14e microbatch)", gen,
            pos_lo=128),
        "da_q3": check_decode_attention(
            8, 48, "B=8 H=16 KH=2 hd=128 S=48 pos 32..47 bf16 (Qwen3-MoE, a tp-2 rank)", gen,
            pos_lo=32, H=16, KH=2),
        "da_q32": check_decode_attention(
            8, 144, "B=8 H=20 KH=20 hd=128 S=144 pos 128..143 bf16 (qwen1.5-32b, a tp-2 rank)",
            gen, pos_lo=128, H=20, KH=20),
        "fa_q2r": check_flash_attention(1, 6, 1, PAGED_PROMPT, PAGED_PROMPT + PAGED_TOKENS + 2,
                                        128, "B=1 H=6 KH=1 hd=128 Sq=120 Sk=160 causal bf16 "
                                        "(14b: a tp-2 rank's runner prefill)", gen),
        "fa_q32": check_flash_attention(8, 20, 20, 128, 144, 128, "B=8 H=KH=20 hd=128 Sq=128 "
                                        "Sk=144 causal bf16 (qwen1.5-32b, a tp-2 rank's "
                                        "prefill)", gen),
    }
    c32 = get_config(Q32_CONFIG)
    w = torch.empty(c32.d_model, c32.padded_vocab, dtype=torch.bfloat16, device="cuda")
    heads = {"tok": {"lm_head": w.normal_(0.0, 0.02, generator=gen)},
             "ramps": {"head": torch.empty(1, c32.d_model, c32.padded_vocab,
                                           dtype=torch.bfloat16, device="cuda")
                       .normal_(0.0, 0.02, generator=gen)}}
    rows["rh_q32"] = check_ramp_head(heads, c32, gen)
    del heads, w
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn(multirank_rank, MR_RANKS, "gloo", device="cuda")
    launches = _mr_report(res, card, time.perf_counter() - t0)
    nccl_phase(card)
    for k in ("decode_attention", "ramp_head_stats", "ramp_head_exit"):
        if min(launches["14a"][k], launches["14c"][k], launches["14d"][k]) <= 0:
            fail(f"phase 14: kernel {k} was not launched on a sharded path")
    if min(launches["14a pages"]["paged_decode_attention"],
           launches["14b pages"]["paged_decode_attention"],
           launches["14a prefill"]["flash_attention"], launches["14d"]["flash_attention"],
           launches["14b rows"]["flash_attention"], launches["14b pages"]["flash_attention"],
           launches["14e"]["decode_attention"]) <= 0:
        fail("phase 14: kernel #5 or #4 was not launched on a sharded path")
    return rows, launches


def _mr_report(res, card, spawn_s):
    """Phase 14's checks across the ranks and its lines; returns the
    launches rank 0 counted in each sub-phase."""
    r0 = res[0]
    for path, what in ((("14a", "rows", "recs"), "14a rows"), (("14a", "pages", "recs"),
                                                               "14a pages"),
                       (("14c", "recs"), "14c"), (("14d", "recs"), "14d")):
        _mr_same(res, path, what)
    for layout in ("rows", "pages"):
        if len({r["14b"][layout]["digest"] for r in res}) != 1 or \
                len({json.dumps(r["14b"][layout]["tokens"], sort_keys=True) for r in res}) != 1:
            fail(f"14b {layout}: the ranks' allocator digests or tokens differ")
    for kind in ("off", "on"):
        if not all(torch.equal(r["14e"][kind]["tok"], r0["14e"][kind]["tok"])
                   and r["14e"][kind]["steps"] == r0["14e"][kind]["steps"] for r in res):
            fail(f"14e {kind}: the ranks' tokens or stage work differ")

    def mean(x):
        return statistics.mean(x)

    a = r0["14a"]
    for name in ("rows", "pages"):
        x = a[name]
        print(f"14a qwen2-1.5b tp 2 {name} ({MR_LABEL}; {card}): {mean(x['ms']):.3f} ms a "
              f"decode_sharded step (host, synced) vs {mean(x['single_ms']):.3f} ms a single-rank "
              f"step; labels equal but {x['near_ties']} near-ties, log maxprob within "
              f"{x['log_maxprob_apart']:.3g}; records bit for bit across the ranks; a rank's "
              f"cache {x['cache_bytes']} B of the single rank's {x['single_cache_bytes']} B; "
              f"launches {json.dumps(x['launches'])}", flush=True)
    print(f"14a planted fault (each rank on the other rank's kv-head block): log maxprob "
          f"apart by {a['fault_apart']:.3g} (limit {MR_LOGP_TOL}), {a['fault_labels']} of "
          f"{MR_STEPS * 8 * 5} labels differ", flush=True)
    print(f"14a: a window of 4 through decode_sharded_multi {a['window_ms']:.3f} ms, bit for "
          f"bit with 4 single sharded steps; the replicated prefill (8 x 128) "
          f"{a['prefill_ms']:.3f} ms, launches {json.dumps(a['prefill_launches'])}", flush=True)
    for layout in ("rows", "pages"):
        x = r0["14b"][layout]
        print(f"14b ShardedDecodeRunner {layout} ({MR_LABEL}; {card}): 8 requests x "
              f"{PAGED_TOKENS} tokens, {x['window_ms']:.3f} ms a window of up to 4 steps "
              f"(eager) vs {x['single_window_ms']:.3f} single-rank, {x['tokens_per_s']:.1f} vs "
              f"{x['single_tokens_per_s']:.1f} decode tokens/s; tokens equal but "
              f"{len(x['divergences'])} requests from a near-tie (request, tokens equal before "
              f"it, logit gap) {x['divergences']}, {x['compared'][0]} of {x['compared'][1]} "
              f"tokens compared before a divergence; both ranks' "
              f"allocator digests and tokens equal; kv {json.dumps(x['kv'])}; launches "
              f"{json.dumps(x['launches'])}", flush=True)
    for key, name in (("14c", f"{Q3_CONFIG} {Q3_DEPTH} of 48 layers, EP 64 experts a rank"),
                      ("14d", f"{Q32_CONFIG} {Q32_DEPTH} of 64 layers, 20:20 heads a rank")):
        x = r0[key]
        pf = (f"; its TP prefill {x['prefill_ms']:.3f} ms, labels equal but "
              f"{x['prefill_near_ties']} near-ties" if "prefill_ms" in x else "")
        print(f"{key} {name} tp 2 ({MR_LABEL}; {card}): {mean(x['ms']):.3f} ms a "
              f"decode_sharded step vs {mean(x['single_ms']):.3f} ms single-rank; labels equal "
              f"but {x['near_ties']} near-ties, log maxprob within "
              f"{x['log_maxprob_apart']:.3g}; a rank's shard {x['shard_bytes'] / 1e9:.2f} GB "
              f"drawn in {x['draw_s']:.1f} s (the whole {x['single_bytes'] / 1e9:.2f} GB in "
              f"{x['single_draw_s']:.1f} s){pf}; launches {json.dumps(x['launches'])}",
              flush=True)
    e = r0["14e"]
    print(f"14e pipeline_decode_window qwen2-1.5b {PIPE_DEPTH} layers over 2 stages "
          f"({MR_LABEL}; {card}): a window of {MR_STEPS} steps {e['off']['ms']:.3f} ms "
          f"(thresholds off) vs {sum(e['loop_ms']):.3f} ms of the single rank's loop; tokens "
          f"equal but {e['near_ties']} rows from a near-tie; stage_steps off "
          f"{e['off']['steps']}, at 0.9999 {e['on']['steps']} ({e['exits']} exits, "
          f"{e['on']['ms']:.3f} ms)", flush=True)
    print(f"phase 14 ranks: {json.dumps({k: round(v, 1) for k, v in r0['secs'].items()})} s, "
          f"spawn to end {spawn_s:.1f} s", flush=True)
    return {"14a": a["rows"]["launches"], "14a pages": a["pages"]["launches"],
            "14a prefill": a["prefill_launches"], "14b rows": r0["14b"]["rows"]["launches"],
            "14b pages": r0["14b"]["pages"]["launches"], "14c": r0["14c"]["launches"],
            "14d": r0["14d"]["launches"], "14e": r0["14e"]["off"]["launches"]}


# ---------------------------------------------------------------------------
# phase 15: multi-rank training, ranks sharing one card over gloo

TR_DEPTH = 2  # of Qwen3-MoE's 48 layers (full width): one ramp site
TR_B, TR_S = 8, 128  # the global batch: TokenPipeline rows (seed 0)
TR_CF = 16.0  # the compared runs' capacity factor: C = the chunk, nothing drops
# phase 15's limits against the single rank, each between its largest sound
# reading on an H100 and the reading of a fault planted in the same run,
# which the phase requires to lie beyond it (PERF.md section 6)
TR_LOSS_TOL = 1e-4  # a loss, relative: sound 1.8e-6, planted 8.3e-4
TR_NORM_TOL = 7e-4  # a grad norm, relative: sound 1.6e-4, planted 3.0e-3
# 15a: a gradient leaf's largest difference over its largest magnitude:
# sound 0.0068, planted 0.42
TR_GRAD_TOL = 2e-2
TR_UPD_TOL = 5e-2  # 15c: a leaf's difference over its update's norm: sound 0.0070, planted 0.29
TR_PIPE_TOL = 1e-3  # 15e: as 15a's leaves, the hidden states: sound 0, planted 1.28
TR_LR, TR_CLIP = 1e-3, 0.05  # 15c's AdamW; the clipping norm under the grad norm
TR_LABEL = "ranks sharing one card"
PIPE_STAGES, PIPE_MICRO, PIPE_MB = 2, 4, 2  # 15e: qwen2-1.5b's 28 blocks over 2 stages
# the leaves whose gradients 15a holds against the single rank (layer 0's
# experts as the expert block)
TR_LEAVES = {"router": ("blocks", 0, "ffn", "router"), "w_gate": ("blocks", 0, "ffn", "w_gate"),
             "wq": ("blocks", 0, "mixer", "wq"), "ramp_head": ("ramps", "head")}


def _tr_cfg(cf=TR_CF):
    from repro_torch.configs import get_config

    return get_config(Q3_CONFIG).replace(n_layers=TR_DEPTH, capacity_factor=cf)


def _tr_batch(step):
    """Step ``step``'s global batch: 8 x 128 TokenPipeline tokens (seed 0)
    with -1 labels planted unevenly: data rank 0's rows (0-3 under data 2)
    keep 288 of 512 labels, data rank 1's 448."""
    from repro_torch.data import TokenPipeline

    b = TokenPipeline(_tr_cfg().vocab_size, TR_S, TR_B, seed=SEED).batch_at(step)
    lab = b["labels"]
    lab[0, 10:], lab[2, :100], lab[5, 64:] = -1, -1, -1
    return b


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _rel(a, b) -> float:
    """max |a - b| over max |b| (f32)."""
    b = b.float()
    return float((a.float() - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _digest(t, chunk=1 << 25) -> int:
    """A checksum of ``t``'s bits on its device: the sum, wrapping at 2^64,
    of each element's bits times an odd weight of its position, so any one
    element that differs changes it."""
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    flat = t.detach().contiguous().view(bits).reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for lo in range(0, flat.numel(), chunk):
        part = flat[lo:lo + chunk].to(torch.int64)
        w = torch.arange(lo, lo + part.numel(), device=t.device, dtype=torch.int64) * 2 + 1
        total = total + torch.sum(part * (w * 0x9E3779B1))
    return int(total)


def _upd_rel(got, want, start) -> float:
    """|got - want| over |want - start| (f32 norms): how far a leaf's update
    from ``start`` lies from the single rank's."""
    want = want.float()
    return float((got.float() - want).norm() / (want - start.float()).norm().clamp(min=1e-30))


def _off(got, want, tol) -> bool:
    """True when ``got`` is beyond ``tol`` of ``want``, relative."""
    return not abs(got - want) <= tol * abs(want)


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _tr_anchors(tmp):
    """The single rank's runs, in this process before any rank starts: 15a's
    loss and gradients on the whole batch, 15c's three AdamW steps, 15e's
    forward of qwen2-1.5b's 28 blocks on each microbatch (the GEMM shapes of
    the stages). Written to ``tmp`` for the ranks;
    every tensor freed before it returns. Returns the summary."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.optim import AdamWConfig, adamw_init, global_norm

    out = {}
    cfg = _tr_cfg()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, device="cuda")
    out["param_bytes"] = _nbytes(params)
    batch = {k: torch.as_tensor(v, device="cuda").long() for k, v in _tr_batch(0).items()}
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    (loss, met), ms = _sync_ms(lambda: model.loss(params, batch, moe_impl="ep"))
    grads, bms = _sync_ms(lambda: torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    gtree = _tree_like(params, grads)
    anchor = {k: _get(gtree, path).detach() for k, path in TR_LEAVES.items()}
    anchor["w_gate"] = anchor["w_gate"][0]  # layer 0's experts
    anchor.update(loss=float(loss.detach()), grad_norm=float(global_norm(gtree)),
                  metrics={k: float(v.detach()) for k, v in met.items()})
    # a planted fault for the loss check: the mean of the two data shards'
    # own means (rows 0-3 and 4-7), as a mesh loss that reduced nothing gives
    with torch.no_grad():
        half = TR_B // 2
        anchor["planted_loss"] = statistics.mean(float(model.loss(
            params, {k: v[i:i + half] for k, v in batch.items()}, moe_impl="ep")[0])
            for i in (0, half))
    torch.save(anchor, os.path.join(tmp, "anchor_a.pt"))
    out["a"] = {"loss": anchor["loss"], "grad_norm": anchor["grad_norm"], "fwd_ms": ms,
                "bwd_ms": bms, "peak": torch.cuda.max_memory_allocated()}
    del grads, gtree, anchor, loss, met
    gc.collect()

    # 15c's anchor: three AdamW steps of the whole model on one rank
    torch.cuda.reset_peak_memory_stats()
    opt_cfg = AdamWConfig(lr=TR_LR, clip_norm=TR_CLIP)
    tcfg = TrainConfig(steps=3, lr=TR_LR, warmup=1, moe_impl="ep")
    step_fn, _ = make_train_step(model, tcfg, opt_cfg)
    state = {"params": params, "opt": adamw_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    start = {k: _get(params, path).clone() for k, path in TR_LEAVES.items()}
    start["w_gate"] = start["w_gate"][0]
    logs, step_ms = [], []
    for s in range(3):
        (state, o), ms = _sync_ms(lambda: step_fn(state, _tr_batch(s)))
        logs.append({k: float(v) for k, v in o.items()})
        step_ms.append(ms)
    sample = {k: _get(state["params"], path).clone() for k, path in TR_LEAVES.items()}
    sample["w_gate"] = sample["w_gate"][0]
    torch.save({"logs": logs, "sample": sample, "start": start}, os.path.join(tmp, "anchor_c.pt"))
    out["c"] = {"logs": logs, "ms": step_ms, "peak": torch.cuda.max_memory_allocated()}
    del state, params, sample, start, step_fn, batch, leaves
    gc.collect()
    torch.cuda.empty_cache()

    # 15e's anchor: qwen2-1.5b's 28 blocks on one rank, on the microbatches'
    # embeddings
    qcfg = get_config(CONFIG)
    qm = build_model(qcfg)
    qp = qm.init(SEED, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 15)
    toks = torch.randint(1, qcfg.vocab_size, (PIPE_MICRO * PIPE_MB, TR_S), generator=gen,
                         device="cuda")
    from repro_torch.models import layers as LY

    pos = torch.arange(TR_S, device="cuda")[None, :]
    with torch.no_grad():
        x = LY.embed_apply(qcfg, qp["tok"], toks, pos).reshape(PIPE_MICRO, PIPE_MB, TR_S, -1)
        # microbatch by microbatch, at the shapes each stage runs
        h, ms = _sync_ms(lambda: torch.stack([_pipe_stage(qm, qp["blocks"], xm) for xm in x]))
    torch.save({"x": x, "y": h}, os.path.join(tmp, "anchor_e.pt"))
    out["e"] = {"ms": ms, "layers": qcfg.n_layers}
    del qp, x, h, toks
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pipe_stage(model, blocks, h):
    """The blocks of ``blocks`` (stacked on a leading layer axis) on ``h``
    (rows, S, d): the plain path (sdpa), no cache."""
    from repro_torch.models.layers import causal_mask
    from repro_torch.models.transformer import _layer

    S = h.shape[-2]
    lead = h.shape[:-2]
    h = h.reshape(-1, S, h.shape[-1])
    pos = torch.arange(S, device=h.device)[None, :]
    mask = causal_mask(S, S, 0, device=h.device)
    (slot,) = model.plan.period
    for l in range(next(iter(blocks[0]["ln1"].values())).shape[0]):
        h, _ = model._block(slot, _layer(blocks[0], l), h, positions=pos, mask=mask,
                            mask_local=mask, cache=None, cache_index=None, plain=True)
    return h.reshape(lead + h.shape[-2:])


def _rank_rows(batch, mesh):
    n = TR_B // mesh.data_size
    return {k: torch.as_tensor(v[mesh.data_rank * n:(mesh.data_rank + 1) * n],
                               device="cuda").long() for k, v in batch.items()}


def _mesh_norm(model, mesh, grads):
    """The global grad norm of a mesh's gradients (replicated leaves once,
    expert leaves summed over the model group), as the mesh step reckons
    it; and, as a planted fault, the norm over the rank's own experts only."""
    from repro_torch.distributed import sum_over
    from repro_torch.training.optim import _sq_sum
    from repro_torch.training.train_loop import expert_leaves

    sq = [torch.zeros((), device="cuda"), torch.zeros((), device="cuda")]
    for g, e in zip(grads, expert_leaves(model, model.abstract())):
        sq[e] = sq[e] + _sq_sum(g)
    return (float(torch.sqrt(sq[0] + sum_over(sq[1], mesh.model_group))),
            float(torch.sqrt(sq[0] + sq[1])))


def train_rank_ab(rank, world, tmp):
    """15a and 15b in one rank of (data 2, model 2): the mesh loss and its
    backward at capacity 16 held against the single rank's, then at the
    config's capacity (drops); the compressed all-reduce of 15a's gradients
    over the data group."""
    from repro_torch.distributed import (all_reduce_flat, count_collectives,
                                         make_compressed_grad_allreduce)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.moe import count_drops
    from repro_torch.training.train_loop import expert_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_test_mesh(2, 2, device="cuda")
    out = {"coords": (mesh.data_rank, mesh.model_rank)}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = build_model(_tr_cfg())
    params = model.init_sharded(SEED, mesh.model_rank, 2, "cuda", specs=model.ep_param_specs())
    leaves = tree_leaves(params)
    split = expert_leaves(model, params)
    out["param_bytes"] = _nbytes(params)
    batch = _rank_rows(_tr_batch(0), mesh)
    for cf in (TR_CF, _tr_cfg(1.25).capacity_factor):
        m = build_model(_tr_cfg(cf))
        for p in leaves:
            p.requires_grad_(True)
        with count_drops() as drops:
            (loss, met), fms = _sync_ms(lambda: m.loss(params, batch, mesh=mesh, moe_impl="ep"))
            grads, bms = _sync_ms(lambda: torch.autograd.grad(loss, leaves))
        for p in leaves:
            p.requires_grad_(False)
        r = {"loss": float(loss.detach()), "fwd_ms": fms, "bwd_ms": bms,
             "digests": [_digest(g) for g, e in zip(grads, split) if not e],
             "drops": dict(drops), "finite": bool(torch.isfinite(loss.detach()))}
        if cf == TR_CF:  # held against the single rank: the gradients summed over data
            keep = {k: v.clone() for k, v in _pick(params, grads, ("router", "wq", "wk", "wv",
                                                                   "wo")).items()}
            a = torch.load(os.path.join(tmp, "anchor_a.pt"), map_location="cuda")

            def leaf_errs(gs):
                errs, gtree = {}, _tree_like(params, gs)
                for k, path in TR_LEAVES.items():
                    g, want = _get(gtree, path), a[k]
                    if k == "w_gate":
                        n = g.shape[-3]
                        g, want = g[0], want[mesh.model_rank * n:(mesh.model_rank + 1) * n]
                    errs[k] = _rel(g, want)
                return errs

            r["peak"] = torch.cuda.max_memory_allocated() - base
            # a planted fault: the rank's own gradients, not summed over data
            r["planted_errs"] = leaf_errs(grads)
            red, r["reduce_ms"] = _sync_ms(lambda: all_reduce_flat(list(grads),
                                                                   mesh.data_group))
            r["grad_norm"], r["planted_grad_norm"] = _mesh_norm(m, mesh, red)
            r["reckoned"] = 2 * out["param_bytes"]
            r.update(errs=leaf_errs(red), anchor_loss=a["loss"], anchor_grad_norm=a["grad_norm"],
                     planted_loss=a["planted_loss"])
            del a, red
        out[cf] = r
        del grads, loss, met
        gc.collect()

    # 15b: the compressed all-reduce of 15a's gradients over the data group
    zeros = {k: torch.zeros_like(v) for k, v in keep.items()}
    with count_collectives() as c_plain:
        exact, pms = _sync_ms(lambda: all_reduce_flat([v.clone() for v in keep.values()],
                                                      mesh.data_group))
    f = make_compressed_grad_allreduce(mesh, "data")
    with count_collectives() as c_comp:
        (o1, r1), cms = _sync_ms(lambda: f(keep, zeros))
    o2, _ = f(keep, r1)
    ex = torch.cat([e.float().reshape(-1) for e in exact])
    a1 = torch.cat([o1[k].reshape(-1) for k in keep])
    a2 = torch.cat([o2[k].reshape(-1) for k in keep])
    out["b"] = {"elements": int(ex.numel()), "plain_ms": pms, "compressed_ms": cms,
                "plain_bytes": c_plain["all-reduce"][1], "compressed_bytes": c_comp["all-reduce"][1],
                "rel_err": float((a1 - ex).norm() / ex.norm()),
                "fb_err": float((a1 + a2 - 2 * ex).norm() / (2 * ex).norm()),
                "nofb_err": float((2 * a1 - 2 * ex).norm() / (2 * ex).norm()),
                "residual_abs": float(torch.cat([v.reshape(-1) for v in tree_leaves(r1)]).abs().sum())}
    return out


def _pick(params, grads, names):
    """Layer-stacked gradients of block slot 0's router and attention leaves."""
    g = _tree_like(params, grads)
    blk = g["blocks"][0]
    return {k: (blk["ffn"][k] if k == "router" else blk["mixer"][k]).detach() for k in names}


def _tree_like(tree, leaves):
    from repro_torch.models.common import tree_map

    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def train_rank_c(rank, world, tmp):
    """15c in one rank of (data 1, model 2): three AdamW steps of
    ``make_train_step(mesh=)`` in 'full' mode, clipping active, the state
    after step 2 saved from both ranks in the reference's format; step 3's
    result and a sample of updated leaves held against the single rank's."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_test_mesh, mesh_axes
    from repro_torch.models import build_model
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.optim import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import state_sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_test_mesh(1, 2, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = build_model(_tr_cfg())
    params = model.init_sharded(SEED, mesh.model_rank, 2, "cuda", specs=model.ep_param_specs())
    opt_cfg = AdamWConfig(lr=TR_LR, clip_norm=TR_CLIP)
    step_fn, _ = make_train_step(model, TrainConfig(steps=3, lr=TR_LR, warmup=1, moe_impl="ep"),
                                 opt_cfg, mesh=mesh, axes=mesh_axes(mesh, fsdp=False))
    state = {"params": params, "opt": adamw_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    pb = _nbytes(params)
    out = {"logs": [], "ms": [], "reckoned": 2 * pb + _nbytes(state["opt"])}
    for s in range(3):
        if s == 2:
            mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
            _, out["save_ms"] = _sync_ms(lambda: mgr.save(
                state, 2, mesh=mesh,
                sharding_tree=state_sharding(model, mesh, mesh_axes(mesh, fsdp=False))))
            # a planted fault: the leaves with step 3's update lost
            lost = {k: _get(state["params"], path).clone() for k, path in TR_LEAVES.items()}
        (state, o), ms = _sync_ms(lambda: step_fn(state, _tr_batch(s)))
        out["logs"].append({k: float(v) for k, v in o.items()})
        out["ms"].append(ms)
    out["peak"] = torch.cuda.max_memory_allocated() - base
    c = torch.load(os.path.join(tmp, "anchor_c.pt"), map_location="cuda")
    errs, planted, maxabs = {}, {}, {}
    for k, path in TR_LEAVES.items():
        got, bad, want, start = _get(state["params"], path), lost[k], c["sample"][k], c["start"][k]
        if k == "w_gate":
            n = got.shape[-3]
            lo = mesh.model_rank * n
            got, bad, want, start = got[0], bad[0], want[lo:lo + n], start[lo:lo + n]
        errs[k], planted[k] = _upd_rel(got, want, start), _upd_rel(bad, want, start)
        maxabs[k] = _rel(got, want)
    out.update(errs=errs, planted_errs=planted, maxabs=maxabs, anchor_logs=c["logs"])
    return out


def pipe_rank(rank, world, tmp):
    """15e in one stage of 2: ``pipeline_apply`` of qwen2-1.5b's 28 blocks,
    14 a stage, 4 microbatches of 2 x 128, held against the single rank's
    forward of the same blocks; ms a call (the second)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import pipeline_apply, ring_shift
    from repro_torch.distributed.pipeline import stage_shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((PIPE_STAGES,), ("stage",), device="cuda")
    cfg = get_config(CONFIG)
    model = build_model(cfg)
    whole = model.init(SEED, device="cuda")
    blocks = tree_map(torch.clone, stage_shard(whole, mesh.coords["stage"],
                                               PIPE_STAGES)["blocks"])
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    e = torch.load(os.path.join(tmp, "anchor_e.pt"), map_location="cuda")
    ms = []
    with torch.no_grad():
        for _ in range(2):
            y, t = _sync_ms(lambda: pipeline_apply(mesh, "stage", lambda p, h: _pipe_stage(
                model, p, h), blocks, e["x"]))
            ms.append(t)
        _, ring = _sync_ms(lambda: ring_shift([e["x"][0]], mesh.groups["stage"]))
    # a planted fault: the microbatches' outputs one tick out of order
    return {"err": _rel(y, e["y"]), "planted": _rel(y.roll(1, 0), e["y"]), "ms": ms,
            "ring_ms": ring, "stage_bytes": _nbytes(blocks),
            "peak": torch.cuda.max_memory_allocated(), "finite": bool(torch.isfinite(y).all())}


def _tr_restore(tmp):
    """15d in this process, no job: the checkpoint of 15c's step 2 restored
    whole onto one rank, whose step 3 is held against 15c's step 3; then
    restored as rank 1 of a (data 1, model 4) layout, which reads a
    quarter of each expert leaf."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models.layers import MeshAxes
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.train_loop import expert_leaves, state_sharding

    model = build_model(_tr_cfg())
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    state, rms = _sync_ms(lambda: mgr.restore(2, "cuda"))
    whole_read = mgr.bytes_read
    opt_cfg = AdamWConfig(lr=TR_LR, clip_norm=TR_CLIP)
    step_fn, _ = make_train_step(model, TrainConfig(steps=3, lr=TR_LR, warmup=1, moe_impl="ep"),
                                 opt_cfg)
    (state, o), ms = _sync_ms(lambda: step_fn(state, _tr_batch(2)))
    out = {"restore_ms": rms, "whole_bytes": whole_read, "step_ms": ms,
           "loss": float(o["loss"]), "grad_norm": float(o["grad_norm"])}
    del state, o
    gc.collect()
    torch.cuda.empty_cache()
    # rank 1 of (data 1, model 4): its coordinates, no groups
    specs = state_sharding(model, RankMesh({"data": 1, "model": 4}, 1, {"data": 0, "model": 1},
                                           {}, torch.device("cuda"), "gloo"),
                           MeshAxes(fsdp=False))
    part, pms = _sync_ms(lambda: mgr.restore(2, "cuda", sharding_tree=specs))
    exp = [x for x, e in zip(tree_leaves(model.abstract()),
                             expert_leaves(model, model.abstract())) if e]
    # the expert leaves of params, mu and nu (f32 moments)
    expert_bytes = sum(x.numel() * (x.element_size() + 8) for x in exp)
    out.update(part_ms=pms, part_bytes=mgr.bytes_read, expert_bytes=expert_bytes,
               part_shape=tuple(part["params"]["blocks"][0]["ffn"]["w_gate"].shape))
    del part
    gc.collect()
    torch.cuda.empty_cache()
    return out


def multirank_train_phases(card):
    """Phase 15: multi-rank training on one card. The single rank's anchors
    here, then 15a/15b in 4 spawned ranks, 15c in 2, 15d here, 15e in 2 (each
    job's ranks gloo processes on cuda:0; a rank's failure fails the
    phase). Prints each sub-phase's checks, times and per-rank bytes."""
    import tempfile

    from repro_torch.launch.mesh import spawn

    # the anchors and 15c's ~22 GB checkpoint, under the process's TMPDIR
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        print(f"phase 15: temporary files in {tmp}", flush=True)
        t0 = time.perf_counter()
        anchors = _tr_anchors(tmp)
        secs = {"anchors": time.perf_counter() - t0}
        res = spawn(train_rank_ab, 4, "gloo", args=(tmp,), device="cuda")
        secs["15a-b"] = time.perf_counter() - t0 - sum(secs.values())
        c = spawn(train_rank_c, 2, "gloo", args=(tmp,), device="cuda")
        secs["15c"] = time.perf_counter() - t0 - sum(secs.values())
        d = _tr_restore(tmp)
        secs["15d"] = time.perf_counter() - t0 - sum(secs.values())
        e = spawn(pipe_rank, PIPE_STAGES, "gloo", args=(tmp,), device="cuda")
        secs["15e"] = time.perf_counter() - t0 - sum(secs.values())
    _tr_report(card, anchors, res, c, d, e, secs)


def _tr_report(card, anchors, res, c, d, e, secs):
    cf0, cf1 = TR_CF, _tr_cfg(1.25).capacity_factor
    a0 = res[0][cf0]
    # 15a: every rank's loss and norm against the single rank's; replicated
    # gradients bit for bit across each model group
    for r in res:
        x = r[cf0]
        if _off(x["loss"], x["anchor_loss"], TR_LOSS_TOL):
            fail(f"15a: rank {r['coords']} loss {x['loss']} vs the single rank's "
                 f"{x['anchor_loss']}")
        if _off(x["grad_norm"], x["anchor_grad_norm"], TR_NORM_TOL):
            fail(f"15a: rank {r['coords']} grad norm {x['grad_norm']} vs "
                 f"{x['anchor_grad_norm']}")
        bad = {k: v for k, v in x["errs"].items() if not v <= TR_GRAD_TOL}
        if bad:
            fail(f"15a: rank {r['coords']} gradients beyond {TR_GRAD_TOL} of the single "
                 f"rank's: {bad}")
        if x["drops"]["dropped"]:
            fail(f"15a: capacity {cf0} dropped {x['drops']['dropped']} assignments")
        if not r[cf1]["finite"]:
            fail(f"15a: the loss at capacity {cf1} is not finite")
    for cf in (cf0, cf1):
        for dr in range(2):
            grp = [r for r in res if r["coords"][0] == dr]
            if grp[0][cf]["digests"] != grp[1][cf]["digests"]:
                fail(f"15a: capacity {cf}: replicated gradients differ across model group {dr}")
    drops = {k: sum(r[cf1]["drops"][k] for r in res) for k in ("assignments", "dropped")}
    mean = statistics.mean
    print(f"15a Qwen3-MoE-30B-A3B full width, {TR_DEPTH} of 48 layers, (data 2, model 2), 4 "
          f"{TR_LABEL} ({card}): capacity {cf0}: loss {a0['loss']:.6f} vs the single rank's "
          f"{a0['anchor_loss']:.6f}, grad norm {a0['grad_norm']:.6f} vs "
          f"{a0['anchor_grad_norm']:.6f}; rank 0's reduced gradients within (of the leaf's "
          f"largest) {json.dumps({k: float(f'{v:.3g}') for k, v in a0['errs'].items()})} "
          f"(limit {TR_GRAD_TOL}); replicated gradients bit for bit across each model "
          f"group at both capacities; forward {mean(r[cf0]['fwd_ms'] for r in res):.1f} ms, "
          f"backward {mean(r[cf0]['bwd_ms'] for r in res):.1f}, gradient all-reduce over data "
          f"{mean(r[cf0]['reduce_ms'] for r in res):.1f} (one bucket a dtype) vs the single "
          f"rank's {anchors['a']['fwd_ms']:.1f} / {anchors['a']['bwd_ms']:.1f} ms; capacity "
          f"{cf1}: loss {res[0][cf1]['loss']:.6f}, {drops['dropped']} of {drops['assignments']} "
          f"assignments dropped ({100 * drops['dropped'] / drops['assignments']:.2f}%)",
          flush=True)
    print(f"15a bytes a rank ({TR_LABEL}): params {res[0]['param_bytes'] / 1e9:.2f} GB, "
          f"params + grads reckoned {a0['reckoned'] / 1e9:.2f} GB, peak measured "
          f"{mean(r[cf0]['peak'] for r in res) / 1e9:.2f} GB (max_memory_allocated above the "
          f"rank's start); the single rank's params {anchors['param_bytes'] / 1e9:.2f} GB, peak "
          f"{anchors['a']['peak'] / 1e9:.2f} GB", flush=True)
    b = res[0]["b"]
    if not b["fb_err"] < b["nofb_err"]:
        fail(f"15b: two calls with feedback err {b['fb_err']} not below {b['nofb_err']} without")
    print(f"15b compressed all-reduce over data of 15a's router and attention gradients "
          f"({b['elements']} elements, {TR_LABEL}; {card}): relative error "
          f"{b['rel_err']:.3g} against the plain sum; two calls with feedback "
          f"{b['fb_err']:.3g} vs {b['nofb_err']:.3g} without; bytes sent (ring "
          f"convention) {b['compressed_bytes']:.0f} compressed (int32 payload + f32 scales) vs "
          f"{b['plain_bytes']:.0f} plain; {b['compressed_ms']:.1f} ms vs {b['plain_ms']:.1f} ms "
          f"an all-reduce", flush=True)
    c0 = c[0]
    tols = {"loss": TR_LOSS_TOL, "grad_norm": TR_NORM_TOL}
    for r in c:
        for got, want in zip(r["logs"], r["anchor_logs"]):
            for k, tol in tols.items():
                if _off(got[k], want[k], tol):
                    fail(f"15c: {k} {got[k]} vs the single rank's {want[k]}")
            if not want["grad_norm"] > TR_CLIP:
                fail(f"15c: grad norm {want['grad_norm']} does not clip at {TR_CLIP}")
        bad = {k: v for k, v in r["errs"].items() if not v <= TR_UPD_TOL}
        if bad:
            fail(f"15c: updated leaves beyond {TR_UPD_TOL} of the single rank's update: {bad}")
    if c[0]["logs"] != c[1]["logs"]:
        fail("15c: the ranks' losses or grad norms differ")
    print(f"15c make_train_step(mesh=) (data 1, model 2), 2 {TR_LABEL} ({card}): 3 AdamW steps, "
          f"clip {TR_CLIP}: losses {[round(x['loss'], 6) for x in c0['logs']]} vs "
          f"{[round(x['loss'], 6) for x in c0['anchor_logs']]} single, grad norms "
          f"{[round(x['grad_norm'], 5) for x in c0['logs']]} vs "
          f"{[round(x['grad_norm'], 5) for x in c0['anchor_logs']]}; updated leaves within "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in c0['errs'].items()})} of their "
          f"update's norm (limit {TR_UPD_TOL}; largest difference over largest magnitude "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in c0['maxabs'].items()})}); "
          f"{[round(t, 1) for t in c0['ms']]} ms a step vs {[round(t, 1) for t in anchors['c']['ms']]} "
          f"single; save of step 2 {c0['save_ms']:.0f} ms; a rank's params + grads + moments "
          f"reckoned {c0['reckoned'] / 1e9:.2f} GB, peak {c0['peak'] / 1e9:.2f} GB "
          f"(single rank peak {anchors['c']['peak'] / 1e9:.2f} GB)", flush=True)
    want = c0["logs"][2]
    for k, tol in tols.items():
        if _off(d[k], want[k], tol):
            fail(f"15d: the restored single rank's step 3 {k} {d[k]} vs 15c's {want[k]}")
    quarter = d["whole_bytes"] - 3 * d["expert_bytes"] // 4
    if d["part_bytes"] != quarter:
        fail(f"15d: rank 1 of (1, 4) read {d['part_bytes']} B, a quarter of the experts is "
             f"{quarter}")
    print(f"15d elastic restore ({card}): 15c's step-2 checkpoint whole onto one rank "
          f"({d['whole_bytes'] / 1e9:.2f} GB read, {d['restore_ms']:.0f} ms): step 3 loss "
          f"{d['loss']:.6f} / grad norm {d['grad_norm']:.5f} vs 15c's {want['loss']:.6f} / "
          f"{want['grad_norm']:.5f}; as rank 1 of (data 1, model 4): "
          f"{d['part_bytes'] / 1e9:.2f} GB read ({d['part_ms']:.0f} ms), expert leaves "
          f"{d['part_shape']}", flush=True)
    for r in e:
        if not (r["finite"] and r["err"] <= TR_PIPE_TOL):
            fail(f"15e: pipeline_apply output {r['err']} of the single rank's (limit "
                 f"{TR_PIPE_TOL})")
    print(f"15e pipeline_apply qwen2-1.5b full width, {anchors['e']['layers']} blocks over "
          f"{PIPE_STAGES} stages "
          f"({PIPE_MICRO} microbatches of {PIPE_MB} x {TR_S}; {PIPE_STAGES} {TR_LABEL}; {card}): "
          f"hidden states within {e[0]['err']:.3g} of the single rank's forward; "
          f"{e[0]['ms'][1]:.1f} ms a call (first {e[0]['ms'][0]:.1f}) vs "
          f"{anchors['e']['ms']:.1f} ms the single rank's forward; a ring shift "
          f"{e[0]['ring_ms']:.1f} ms; a stage's blocks {e[0]['stage_bytes'] / 1e9:.2f} GB, peak "
          f"{e[0]['peak'] / 1e9:.2f} GB", flush=True)
    # each limit against its largest sound reading and a fault planted in
    # this run, which must lie beyond it, or the check is blind
    def rel(got, want):
        return abs(got / want - 1)

    runs = [(x["logs"][i], x["anchor_logs"][i]) for x in c for i in range(3)]
    runs.append((d, want))
    sound = {
        "loss": max([rel(r[cf0]["loss"], r[cf0]["anchor_loss"]) for r in res]
                    + [rel(g["loss"], w["loss"]) for g, w in runs]),
        "grad norm": max([rel(r[cf0]["grad_norm"], r[cf0]["anchor_grad_norm"]) for r in res]
                         + [rel(g["grad_norm"], w["grad_norm"]) for g, w in runs]),
        "gradient leaves": max(max(r[cf0]["errs"].values()) for r in res),
        "updates": max(max(r["errs"].values()) for r in c),
        "pipeline": max(r["err"] for r in e)}
    planted = {  # the loss as the shards' own means; the norm over the rank's
        # own experts; gradients not summed over data; step 3 lost;
        # microbatches out of order
        "loss": rel(a0["planted_loss"], a0["anchor_loss"]),
        "grad norm": max(rel(r[cf0]["planted_grad_norm"], r[cf0]["anchor_grad_norm"])
                         for r in res),
        "gradient leaves": min(min(r[cf0]["planted_errs"].values()) for r in res),
        "updates": min(min(r["planted_errs"].values()) for r in c),
        "pipeline": min(r["planted"] for r in e)}
    limits = dict(zip(planted, (TR_LOSS_TOL, TR_NORM_TOL, TR_GRAD_TOL, TR_UPD_TOL, TR_PIPE_TOL)))
    print("phase 15 limits, [largest sound reading, planted fault's reading, limit]: "
          + json.dumps({k: [float(f"{sound[k]:.4g}"), float(f"{planted[k]:.4g}"), limits[k]]
                        for k in limits}), flush=True)
    blind = [k for k, v in planted.items() if not v > limits[k]]
    if blind:
        fail(f"phase 15: planted faults within their limits: {blind}")
    print(f"phase 15: {json.dumps({k: round(v, 1) for k, v in secs.items()})} s", flush=True)


# ---------------------------------------------------------------------------
# phase 16: the FSDP train state, qwen2-1.5b whole on four ranks sharing one card

FS_LAYOUT = {"data": 2, "model": 2}  # the reference's test mesh
FS_STEPS = 2
# 16b against 16a, relative (a sampled leaf's difference over 16a's update):
# each limit between the largest sound reading on an H100 and the smallest
# of the faults planted in the same run, which must read beyond it. The
# sound readings are the split's rounding: each data rank's gradient comes
# from its own rows, is rounded to bf16, and the halves are summed in bf16;
# each model rank's row products are partials summed in f32; the first
# step's learning rate is 0, so the leaves carry one update. The split
# control (16a's rank rounding as the data and model split do) reads the
# same rounding against 16a, and 16b is held to it within TR_LOSS_TOL,
# TR_NORM_TOL and TR_UPD_TOL as well. The planted faults: the row
# products' forward sums left out (the loss), the data sum and the model
# region's backward sum left out (the grad norm, the leaves). On an H100,
# seeds 0 and 1, sound / planted: losses 7.1e-5 / 0.054, grad norms
# 4.7e-4 / 0.29, leaves 0.169 (the embedding) / 0.550.
FS_LOSS_TOL = 1e-3
FS_NORM_TOL = 5e-3
FS_UPD_TOL = 0.3
# what a rank may hold at its peak above its reckoned state: between the
# sound reading (0.81 GB on an H100) and the planted fault's (each layer's
# forward gather held: 2.18 GB), which must read beyond
FS_PEAK_ROOM = 1.4e9
# a rank's product FLOPs a step over 16a's on the same rows: the model split
# halves every product but MLA's latent and the router (none in qwen2), so
# about 0.5; the fsdp=False layout computes alike on both model ranks (1.0)
FS_FLOP_SHARE = 0.6
# the leaves 16b holds against the single rank: (path, the layer or site
# taken, None for an unstacked leaf)
FS_LEAVES = {"wq": (("blocks", 0, "mixer", "wq"), 0),
             "w_down": (("blocks", 0, "ffn", "w_down"), 27),
             "ramp_head": (("ramps", "head"), 11), "embed": (("tok", "embed"), None)}


def _fs_cfgs():
    """Phase 15's AdamW (``TR_LR``, ``TR_CLIP``), 'full' mode, remat on."""
    from repro_torch.training import TrainConfig
    from repro_torch.training.optim import AdamWConfig

    return (TrainConfig(steps=FS_STEPS, lr=TR_LR, warmup=1, train_mode="full", remat=True),
            AdamWConfig(lr=TR_LR, clip_norm=TR_CLIP))


def _fs_batch(step, seed):
    """Step ``step``'s global batch: 8 x 128 TokenPipeline tokens over
    qwen2's vocabulary (``seed``), -1 labels planted as ``_tr_batch`` plants
    them (data rank 0's rows keep 288 of 512 labels, data rank 1's 448)."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline

    b = TokenPipeline(get_config(CONFIG).vocab_size, TR_S, TR_B, seed=seed).batch_at(step)
    lab = b["labels"]
    lab[0, 10:], lab[2, :100], lab[5, 64:] = -1, -1, -1
    return b


def _fs_sample(tree, k, leaves=None):
    """Leaf ``k`` of ``leaves`` (FS_LEAVES) out of a tree of params (or of
    specs: a stacked leaf's spec loses its layer entry)."""
    path, i = (leaves or FS_LEAVES)[k]
    x = _get(tree, path)
    if i is None:
        return x
    return tuple(x[1:]) if isinstance(x, tuple) else x[i]


def _fs_marks():
    """A ``make_train_step(mark=)`` timer: (the hook, its list of (name,
    seconds)); each mark waits for the card."""
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    return mark, marks


def _fs_parts(marks, t0) -> dict:
    """ms of each part of a step from its marks: forward, backward, the
    gradient reduction and norm, the AdamW update."""
    out, last = {}, t0
    for name, t in marks:
        out[name] = out.get(name, 0.0) + 1e3 * (t - last)
        last = t
    return out


class _VirtualRank:
    """One of 16b's model ranks, played in turn by the split control's one
    process (``_model_split_played``): the ``layers.ModelSplit`` the rank's
    sublayers see, with its collectives taken apart. ``enter`` hands the
    rank an f32 copy of its input, shared by the group's ranks (so the
    ranks' gradients of it are summed in f32 and rounded once, as
    ``to_model_region`` sums them); ``row`` returns the rank's partial, a
    GEMM in the dtype, in f32, which the caller sums over the ranks in rank
    order and rounds once, as ``from_model_region`` sums it; ``heads`` is
    ``ModelSplit.heads``."""

    def __init__(self, m, index, shared):
        self.m, self.index, self.shared = m, index, shared

    def enter(self, x):
        if id(x) not in self.shared:
            self.shared[id(x)] = (x, x.float())
        return self.shared[id(x)][1].to(x.dtype)

    def row(self, h, w):
        return (h @ w).float()

    def heads(self, cfg, p):
        from repro_torch.models.layers import ModelSplit

        return ModelSplit.heads(self, cfg, p)


def _model_slice(p, schema, r, m):
    """Model rank ``r``'s part of each leaf of a sublayer's whole params:
    the contiguous block of the dim its schema spec splits over ``model``."""
    out = {}
    for k, x in p.items():
        spec = schema[k].spec
        d = spec.index("model") if "model" in spec else None
        out[k] = x if d is None else x.narrow(d, r * (x.shape[d] // m), x.shape[d] // m)
    return out


def _model_split_played(m):
    """A context in which the loss of one process rounds as the model split
    over ``m`` ranks rounds (16a's split control): each attention and FFN
    sublayer runs as its ``m`` ranks would (``attn_apply``/``ffn_apply`` on
    each rank's slices, the row partials summed in f32 in rank order), and
    each head computes its ``m`` vocabulary blocks as the ranks' products
    and its cross-entropy from their blocks (the max, the exponentials'
    sums in f32 and the label logit taken a block at a time, then over
    the blocks). It takes attention whose heads and kv heads divide by
    ``m`` (qwen2-1.5b's at 2), with no cache."""
    import contextlib

    from repro_torch.models import layers as LY
    from repro_torch.models import transformer as T

    sound = LY.attn_apply, LY.ffn_apply, LY.head_logits, T._nll_sum

    def sublayer(fn, schema, p, x):
        shared = {}
        parts = [fn(_model_slice(p, schema, r, m), _VirtualRank(m, r, shared))
                 for r in range(m)]
        total = parts[0]
        for y in parts[1:]:
            total = total + y
        return total.to(x.dtype)

    def attn(cfg, p, x, *, cache=None, ms=None, **kw):
        assert cache is None and ms is None
        assert cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
        return sublayer(lambda part, rank: sound[0](cfg, part, x, ms=rank, **kw)[0],
                        LY.gqa_schema(cfg), p, x), None

    def ffn(cfg, p, x, ms=None):
        assert ms is None
        return sublayer(lambda part, rank: sound[1](cfg, part, x, rank),
                        LY.ffn_schema(cfg, p["w_gate"].shape[-1]), p, x)

    def head(h, w, ms=None):
        assert ms is None
        shared, n = {}, w.shape[-1] // m
        return torch.cat([_VirtualRank(m, r, shared).enter(h) @ w[..., r * n:(r + 1) * n]
                          for r in range(m)], dim=-1)

    def nll(cfg, logits, labels, ms=None):
        assert ms is None
        logits = logits.float()
        valid = labels >= 0
        lab = torch.clamp(labels, min=0).long()
        n = logits.shape[-1] // m
        blocks = []
        for r in range(m):
            blk = logits[..., r * n:(r + 1) * n]
            if (r + 1) * n > cfg.vocab_size:
                col = r * n + torch.arange(n, device=blk.device)
                blk = torch.where(col < cfg.vocab_size, blk, -1e30)
            blocks.append(blk)
        mx = torch.max(blocks[0], dim=-1).values.detach()
        for blk in blocks[1:]:
            mx = torch.maximum(mx, torch.max(blk, dim=-1).values.detach())
        se = ll = None
        for r, blk in enumerate(blocks):
            e = torch.sum(torch.exp(blk - mx[..., None]), dim=-1)
            loc = lab - r * n
            mine = (loc >= 0) & (loc < n)
            at = torch.gather(blk, -1, torch.where(mine, loc, 0)[..., None])[..., 0]
            g = torch.where(mine, at, 0.0)
            se, ll = (e, g) if se is None else (se + e, ll + g)
        lse = mx + torch.log(se)
        return torch.sum((lse - ll) * valid), torch.sum(valid)

    @contextlib.contextmanager
    def played():
        LY.attn_apply, LY.ffn_apply, LY.head_logits, T._nll_sum = attn, ffn, head, nll
        try:
            yield
        finally:
            LY.attn_apply, LY.ffn_apply, LY.head_logits, T._nll_sum = sound

    return played()


def _fs_split_step(model, state, batch, tcfg, opt_cfg):
    """One step of 16a's split control, one rank on the whole model: each
    data rank's rows of 16b (rows 0-3, then 4-7) give their gradient under
    the whole batch's label counts (the LM and ramp terms scaled by the
    rows' share of the valid labels, as ``loss(mesh=)`` divides by the
    global count), each rounded to bf16 as autograd leaves it, the two
    summed in bf16 in rank order; then the norm and AdamW. Each half's loss
    rounds as 16b's model split does (``_model_split_played``). This is
    the rounding of 16b's data and model split without its ranks. Returns
    (the state, the grad norm, the loss)."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.training.optim import adamw_update, cosine_schedule

    params, opt, step = state["params"], state["opt"], state["step"]
    leaves = tree_leaves(params)
    lab = torch.as_tensor(batch["labels"])
    S = lab.shape[1]
    npos = min(16, S)  # the loss's ramp positions (LM.loss)
    pool = torch.linspace(S // npos - 1, S - 1, npos, dtype=torch.float32).to(torch.int64)
    D = FS_LAYOUT["data"]
    rows = lab.shape[0] // D
    total, loss = None, 0.0
    for r in range(D):
        half = {k: torch.as_tensor(v[r * rows:(r + 1) * rows]).cuda() for k, v in batch.items()}
        hl = lab[r * rows:(r + 1) * rows]
        a_lm = float((hl >= 0).sum()) / float((lab >= 0).sum())
        a_r = float((hl[:, pool] >= 0).sum()) / float((lab[:, pool] >= 0).sum())
        for p in leaves:
            p.requires_grad_(True)
        try:
            with _model_split_played(FS_LAYOUT["model"]):
                _, m = model.loss(params, half, moe_impl=tcfg.moe_impl, remat=tcfg.remat,
                                  train_mode=tcfg.train_mode)
                obj = m["lm_loss"] * a_lm + m["ramp_loss"] * a_r + 0.01 * m["moe_aux"]
                gs = torch.autograd.grad(obj, leaves, allow_unused=True)
            loss += float(obj.detach())
        finally:
            for p in leaves:
                p.requires_grad_(False)
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
        if total is None:
            total = gs
        else:
            for t, g in zip(total, gs):
                t.add_(g)  # in the leaf's dtype, as the reduce-scatter sums
        del gs, m, obj
    sched = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps)
    newp, newopt, gn = adamw_update(params, _tree_like(params, total), opt, opt_cfg,
                                    lr_scale=sched(step))
    return {"params": newp, "opt": newopt, "step": step + 1}, float(gn), loss


def _fs_anchor(tmp, seed):
    """16a in this process, before any rank starts: the whole model's two
    AdamW steps on one rank, the sampled leaves written to ``tmp`` at the
    start and after each step. Then, each from a fresh draw, the same steps
    on each batch's rows reversed (the same math summed in another order:
    the comparison's floor in bf16) and as the split control
    (``_fs_split_step``, whose sampled leaves are written too); each
    control's sampled leaves against the first run's. Frees every tensor.
    Returns losses, grad norms, times, the peak above the start and the
    controls' readings."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(get_config(CONFIG))
    tcfg, opt_cfg = _fs_cfgs()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = init_state(model, seed, opt_cfg, device="cuda")
    pb = _nbytes(state["params"])
    out = {"reckoned": 2 * pb + _nbytes(state["opt"]), "logs": [], "ms": [], "parts": []}

    def save(name):
        torch.save({k: _fs_sample(state["params"], k).to("cpu", copy=True) for k in FS_LEAVES},
                   os.path.join(tmp, f"{name}.pt"))

    save("fs_sample_0")
    mark, marks = _fs_marks()
    step_fn, _ = make_train_step(model, tcfg, opt_cfg, mark=mark)
    for s in range(FS_STEPS):
        marks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, o), ms = _sync_ms(lambda: step_fn(state, _fs_batch(s, seed)))
        out["logs"].append({k: float(v) for k, v in o.items()})
        out["ms"].append(ms)
        out["parts"].append(_fs_parts(marks, t0))
        save(f"fs_sample_{s + 1}")
    out["peak"] = torch.cuda.max_memory_allocated() - base
    out["flops"] = _step_flops(model, state["params"], _fs_batch(0, seed), tcfg)
    want = torch.load(os.path.join(tmp, f"fs_sample_{FS_STEPS}.pt"))
    start = torch.load(os.path.join(tmp, "fs_sample_0.pt"))
    for name in ("reversed", "split"):
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        state = init_state(model, seed, opt_cfg, device="cuda")
        step_fn, _ = make_train_step(model, tcfg, opt_cfg)
        norms, losses = [], []
        for s in range(FS_STEPS):
            b = _fs_batch(s, seed)
            if name == "reversed":
                state, o = step_fn(state, {k: v[::-1].copy() for k, v in b.items()})
                norms.append(float(o["grad_norm"]))
                losses.append(float(o["loss"]))
            else:
                state, gn, lo = _fs_split_step(model, state, b, tcfg, opt_cfg)
                norms.append(gn)
                losses.append(lo)
        if name == "split":
            save(f"fs_split_{FS_STEPS}")
        out[name] = {k: _upd_rel(_fs_sample(state["params"], k), want[k].cuda(),
                                 start[k].cuda()) for k in FS_LEAVES}
        out[f"{name}_norms"], out[f"{name}_losses"] = norms, losses
    del state, step_fn, want, start
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _flops(on):
    """``FlopCounterMode`` (a step's product FLOPs: forward, remat and
    backward) where ``on``, else a context that counts nothing. It is kept
    off the compared steps: on an H100 a step taken with the counter open
    gave a bf16 gradient other than the same step without it (a grad norm
    3.4e-5 apart, and the first moments with it)."""
    import contextlib

    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False) if on else contextlib.nullcontext()


def _step_flops(model, params, batch, tcfg):
    """16a's product FLOPs of one step on one rank: its loss and backward
    (the AdamW update has no product) at ``tcfg``'s settings, counted on
    their own after the compared steps."""
    from repro_torch.models.common import tree_leaves

    leaves = tree_leaves(params)
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    for p in leaves:
        p.requires_grad_(True)
    try:
        with _flops(True) as fc:
            loss, _ = model.loss(params, batch, moe_impl=tcfg.moe_impl, remat=tcfg.remat,
                                 train_mode=tcfg.train_mode)
            torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return fc.get_total_flops()


def _no_model_sum(x, group):
    """A planted fault: a model-region function without its sum over the
    group. As ``to_model_region`` each rank's partial gradient of a
    column-parallel product's input passes upstream as it is; as
    ``from_model_region`` each rank's partial (a row product, a vocabulary
    term) passes on as the group's sum."""
    return x


def _own_chunk(x, group, dim=0):
    """16b's planted fault: ``reduce_scatter_tiled`` without the sum, the
    rank's own chunk of its own gradient."""
    import torch.distributed as dist

    m = dist.get_world_size(group)
    i = dist.get_group_rank(group, dist.get_rank())
    k = x.shape[dim % x.dim()] // m
    return x.narrow(dim, i * k, k).contiguous()


def _held_gathers(n_layers, held):
    """16b's planted memory fault: ``transformer._gathered`` that keeps each
    layer's forward gather (the first ``n_layers`` gathered layers of a
    step) in ``held`` to the step's end, as autograd would keep them were
    the gathers outside the layers' remat regions."""
    from repro_torch.models import transformer as T

    sound = T._gathered

    def gathered(p, specs, mesh, keys=None):
        out = sound(p, specs, mesh, keys)
        if keys is None and isinstance(p, dict) and "mixer" in p and len(held) < n_layers:
            held.append(out)
        return out

    return gathered


def _fs_errs(params, specs, mesh, tmp, anchors, leaves=None, pre="fs"):
    """Each sampled leaf (``leaves``, FS_LEAVES) gathered from the ranks'
    parts; on rank 0 its difference from each anchor's (a file of ``tmp``:
    the single rank's or the split control's sampled leaves after FS_STEPS
    steps) over the single rank's update from the start (``_upd_rel``;
    the files ``{pre}_sample_*``). Every rank takes part in the gathers."""
    from repro_torch.distributed import fsdp_gather_ad

    leaves = leaves or FS_LEAVES
    want = start = None
    if mesh.rank == 0:
        want = {a: torch.load(os.path.join(tmp, f"{a}.pt")) for a in anchors}
        start = torch.load(os.path.join(tmp, f"{pre}_sample_0.pt"))
        upd = torch.load(os.path.join(tmp, f"{pre}_sample_{FS_STEPS}.pt"))
    errs = {a: {} for a in anchors}
    with torch.no_grad():
        for k in leaves:
            whole = fsdp_gather_ad(_fs_sample(params, k, leaves), _fs_sample(specs, k, leaves),
                                   mesh)
            if want is not None:
                norm = (upd[k].float() - start[k].float()).norm().clamp(min=1e-30).cuda()
                for a in anchors:
                    errs[a][k] = float((whole.float() - want[a][k].cuda().float()).norm() / norm)
            del whole
    return errs


def _fs_reckon(model, specs, mesh):
    """(all-gather bytes, reduce-scatter bytes) of one step, by hand from
    the sanitized specs: each use of a leaf gathers its part over data (the
    result twice the part), and reduce-scatters its gradient over data
    once (the result the part). A leaf split over model stays the rank's
    slice: every sublayer of qwen2-1.5b splits over 2 model ranks (12
    heads, 2 kv heads, 8960 hidden units, the vocabulary), so no leaf is
    gathered over model. With remat a layer's leaves and the ramp heads
    are gathered twice (forward, and again in the backward), the tied
    embedding three times (the lookup, then the LM head forward and again)
    and used twice. Also the bytes of the leaves left whole (the f32
    norms) and of one gathered layer (its model-split leaves a model
    rank's slice)."""
    from repro_torch.models.common import entry_axes, part_shape, spec_parts, tree_leaves

    ag = rs = whole = 0

    def walk(info, sp, path):
        nonlocal ag, rs, whole
        cuts = spec_parts(sp, mesh)
        part = math.prod(part_shape(info.shape, sp, mesh)) * info.dtype.itemsize
        if not cuts:
            whole += part
            return
        over_data = [n for d, _, n in cuts if entry_axes(sp[d]) != ("model",)]
        one = part * math.prod(over_data) if over_data else 0  # a model-only cut gathers nothing
        tied = path == ("tok", "embed") and model.cfg.tie_embeddings
        gathers, uses = (3, 2) if tied else (2, 1)
        ag += gathers * one
        if any(entry_axes(sp[d]) != ("model",) for d, _, _ in cuts):
            rs += uses * part

    def visit(sch, sp, path=()):
        if isinstance(sch, dict):
            for k in sorted(sch):
                visit(sch[k], sp[k], path + (k,))
        elif isinstance(sch, list):
            for i, (a, b) in enumerate(zip(sch, sp)):
                visit(a, b, path + (i,))
        else:
            walk(sch, sp, path)

    visit(model.schema(), specs)
    m = mesh.model_size
    layer = sum(math.prod(i.shape[1:]) * i.dtype.itemsize // (m if "model" in i.spec else 1)
                for i in tree_leaves(model.schema()["blocks"]))
    return ag, rs, whole, layer


def _fs_sums(model, rows, seq):
    """(calls, bytes) of the model group's all-reduces in one step with
    remat, by hand from the layers (``count_collectives``' convention: an
    all-reduce's result bytes twice): a layer's attention and FFN products
    summed forward (f32 (rows, seq, d)), the attention's again in the remat
    recompute (the FFN's sum is the layer's last op: nothing after it is
    saved, so the recompute stops before it), and their inputs' gradients
    summed backward; the embedding's lookup; the LM head's input gradient
    and its cross-entropy's max, exponentials' sum and label logit (f32
    (rows, seq)) forward and again in its recompute; at each ramp site the
    same over its positions; the grad norm's two scalars."""
    cfg = model.cfg
    npos = min(16, seq)
    act = lambda n: 2 * 4 * rows * n * cfg.d_model  # noqa: E731
    small = lambda n: 2 * 4 * rows * n  # noqa: E731
    sites = len(model.sites)
    calls = 5 * cfg.n_layers + 2 + sites + 6 * (1 + sites) + 2
    nbytes = ((5 * cfg.n_layers + 2) * act(seq) + sites * act(npos) + 6 * small(seq)
              + 6 * sites * small(npos) + 2 * 8)
    return calls, nbytes


def _fs_lap(out, name, t0):
    """Record ``out["secs"][name]``, the seconds since ``t0``; returns now."""
    now = time.perf_counter()
    out.setdefault("secs", {})[name] = now - t0
    return now


def fsdp_rank(rank, world, tmp, seed):
    """16b in one rank of (data 2, model 2): its part of every leaf drawn
    (``init_state(mesh=)``), two FSDP steps held against 16a and the split
    control, then from the state after step 1 (kept on the host: the
    warmup gives step 1 a learning rate of 0, so step 2 is the first to
    move a leaf) step 2 again with two planted faults (the missing data sum
    and the held layer gathers), step 2's loss alone (a forward) with
    ``from_model_region`` without its sum, and step 2 once more with
    ``to_model_region`` without its backward sum (its product FLOPs
    counted)."""
    import torch.distributed as dist

    import repro_torch.distributed as RD
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import count_collectives
    from repro_torch.launch.mesh import make_mesh, mesh_axes
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_map
    from repro_torch.training import init_state, layout_specs, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(tuple(FS_LAYOUT.values()), tuple(FS_LAYOUT), device="cuda")
    axes = mesh_axes(mesh, fsdp=True)
    model = build_model(get_config(CONFIG))
    specs = layout_specs(model, mesh, axes)
    tcfg, opt_cfg = _fs_cfgs()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state, init_ms = _sync_ms(lambda: init_state(model, seed, opt_cfg, "cuda", mesh=mesh,
                                                 axes=axes))
    pb = _nbytes(state["params"])
    ag, rs, whole, layer = _fs_reckon(model, specs, mesh)
    model_ranks = tuple(dist.get_process_group_ranks(mesh.model_group))
    out = {"coords": (mesh.data_rank, mesh.model_rank), "param_bytes": pb,
           "reckoned": 2 * pb + _nbytes(state["opt"]), "whole_param_bytes": whole,
           "layer_bytes": layer, "reckoned_ag": ag, "reckoned_rs": rs, "init_ms": init_ms,
           "reckoned_sums": _fs_sums(model, TR_B // mesh.data_size, TR_S),
           "logs": [], "ms": [], "parts": [], "counts": [], "sums": []}
    mark, marks = _fs_marks()
    step_fn, _ = make_train_step(model, tcfg, opt_cfg, mesh=mesh, axes=axes, mark=mark)
    t_run = time.perf_counter()
    for s in range(FS_STEPS):
        marks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count_collectives() as cc:
            (state, o), ms = _sync_ms(lambda: step_fn(state, _fs_batch(s, seed)))
        out["logs"].append({k: float(v) for k, v in o.items()})
        out["ms"].append(ms)
        out["parts"].append(_fs_parts(marks, t0))
        out["counts"].append({k: list(v) for k, v in cc.items()})
        out["sums"].append(cc.by_kind_group.get(("all-reduce", model_ranks), [0, 0.0]))
        if s == FS_STEPS - 2:
            snap = tree_map(lambda t: t.to("cpu", copy=True), state)
    out["peak"] = torch.cuda.max_memory_allocated() - base
    t_run = _fs_lap(out, "steps", t_run)
    anchors = (f"fs_sample_{FS_STEPS}", f"fs_split_{FS_STEPS}")
    out["errs"] = _fs_errs(state["params"], specs, mesh, tmp, anchors)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # the planted faults: the backward's reduce-scatter over data without the
    # sum (each data rank's part of its own rows' gradient only), and each
    # layer's forward gather held to the step's end
    state = tree_map(lambda t: t.to("cuda"), snap)
    step_fn, _ = make_train_step(model, tcfg, opt_cfg, mesh=mesh, axes=axes)
    held = []
    torch.cuda.reset_peak_memory_stats()
    sound = C.reduce_scatter_tiled, T._gathered
    C.reduce_scatter_tiled, T._gathered = _own_chunk, _held_gathers(model.cfg.n_layers, held)
    try:
        state, o = step_fn(state, _fs_batch(FS_STEPS - 1, seed))
        out["planted_peak"] = torch.cuda.max_memory_allocated() - base
        out["held_bytes"] = sum(_nbytes(t) for t in held)
    finally:
        C.reduce_scatter_tiled, T._gathered = sound
        held.clear()
    out["planted_errs"] = _fs_errs(state["params"], specs, mesh, tmp, anchors)
    out["planted_norm"] = float(o["grad_norm"])
    t_run = _fs_lap(out, "planted data sum", t_run)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # the third: step 2's loss with the row products' forward sums left out
    # (the model region's exit: each rank's partial passes as the sum)
    state = tree_map(lambda t: t.to("cuda"), snap)
    del snap
    rows = TR_B // mesh.data_size
    mine = {k: torch.as_tensor(v[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]).cuda()
            for k, v in _fs_batch(FS_STEPS - 1, seed).items()}
    sound = RD.from_model_region
    RD.from_model_region = _no_model_sum
    try:
        with torch.no_grad():
            loss, _ = model.loss(state["params"], mine, moe_impl=tcfg.moe_impl,
                                 train_mode=tcfg.train_mode, mesh=mesh, fsdp=specs)
        out["planted_exit_loss"] = float(loss)
    finally:
        RD.from_model_region = sound
    del mine, loss
    t_run = _fs_lap(out, "planted exit", t_run)
    # the fourth, on the same state: the model region's entry without its
    # backward sum
    sound = RD.to_model_region
    RD.to_model_region = _no_model_sum
    try:
        # its products are a sound step's, so the step's FLOPs are counted here,
        # apart from the compared steps (_step_flops)
        with _flops(True) as fc:
            state, o = step_fn(state, _fs_batch(FS_STEPS - 1, seed))
        out["flops"] = fc.get_total_flops()
    finally:
        RD.to_model_region = sound
    out["planted_region_errs"] = _fs_errs(state["params"], specs, mesh, tmp, anchors)
    out["planted_region_norm"] = float(o["grad_norm"])
    _fs_lap(out, "planted entry", t_run)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


# 16c: the split step on DeepSeek-V2-Lite at full width, its dense layer and
# one MoE layer: MLA, the shared experts and an untied LM head on a rank's
# slices, the routed experts expert-parallel
FC_DEPTH = 2  # of DeepSeek-V2-Lite's 27 layers (first_k_dense 1): one ramp site
# a sampled leaf's difference from the single rank's, over its update, as
# 16b is held to 16a (FS_UPD_TOL): on an H100 the sound readings reached
# 0.151 (the routed experts' w_gate), the planted missing model-region sum
# 0.640 or more on the leaves it reaches
FC_UPD_TOL = FS_UPD_TOL
FC_LEAVES = {"wq": (("prefix", 0, "mixer", "wq"), None),
             "w_dkv": (("prefix", 0, "mixer", "w_dkv"), None),
             "shared_w_down": (("blocks", 0, "ffn", "shared", "w_down"), 0),
             "w_gate": (("blocks", 0, "ffn", "w_gate"), 0),
             "lm_head": (("tok", "lm_head"), None)}
# the leaves whose gradient crosses the model region's entry (the LM head's
# does not: its input is right, its logits' gradient too), so the planted
# missing sum reads on them
FC_REGION = ("wq", "w_dkv", "shared_w_down", "w_gate")


def _fc_cfgs():
    """16c's config (capacity ``TR_CF``: nothing drops on one rank or on
    the mesh), 'full' mode with phase 15's AdamW, remat, 'ep' MoE."""
    from repro_torch.configs import get_config
    from repro_torch.training import TrainConfig
    from repro_torch.training.optim import AdamWConfig

    cfg = get_config(DS_CONFIG).replace(n_layers=FC_DEPTH, capacity_factor=TR_CF)
    return cfg, (TrainConfig(steps=FS_STEPS, lr=TR_LR, warmup=1, train_mode="full", remat=True,
                             moe_impl="ep"), AdamWConfig(lr=TR_LR, clip_norm=TR_CLIP))


def _fc_batch(step, seed):
    """16c's global batch: 8 x 128 TokenPipeline tokens over DeepSeek's
    vocabulary, -1 labels planted as ``_fs_batch`` plants them."""
    from repro_torch.data import TokenPipeline

    b = TokenPipeline(_fc_cfgs()[0].vocab_size, TR_S, TR_B, seed=seed).batch_at(step)
    lab = b["labels"]
    lab[0, 10:], lab[2, :100], lab[5, 64:] = -1, -1, -1
    return b


def _fc_anchor(tmp, seed):
    """16c's single rank, in this process before any rank starts: the
    2-layer model's two AdamW steps on the whole batch, its sampled leaves
    written to ``tmp`` at the start and after the last step. Frees every
    tensor. Returns losses, grad norms, times and the assignments
    dropped."""
    from repro_torch.models import build_model
    from repro_torch.models.moe import count_drops
    from repro_torch.training import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, (tcfg, opt_cfg) = _fc_cfgs()
    model = build_model(cfg)
    state = init_state(model, seed, opt_cfg, device="cuda")
    out = {"params": sum(x.numel() for x in _leaves(state["params"])), "logs": [], "ms": []}

    def save(name):
        torch.save({k: _fs_sample(state["params"], k, FC_LEAVES).to("cpu", copy=True)
                    for k in FC_LEAVES}, os.path.join(tmp, f"{name}.pt"))

    save("fc_sample_0")
    step_fn, _ = make_train_step(model, tcfg, opt_cfg)
    with count_drops() as drops:
        for s in range(FS_STEPS):
            (state, o), ms = _sync_ms(lambda: step_fn(state, _fc_batch(s, seed)))
            out["logs"].append({k: float(v) for k, v in o.items()})
            out["ms"].append(ms)
    out["dropped"] = drops["dropped"]
    save(f"fc_sample_{FS_STEPS}")
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    from repro_torch.models.common import tree_leaves

    return tree_leaves(tree)


def fc_rank(rank, world, tmp, seed):
    """16c in one rank of (data 2, model 2): its part of every leaf drawn,
    two split FSDP steps held against 16c's single rank, then step 2 again
    from the state after step 1 with ``to_model_region``'s backward sum
    left out (planted)."""
    import torch.distributed as dist

    import repro_torch.distributed as RD
    from repro_torch.distributed import count_collectives
    from repro_torch.launch.mesh import make_mesh, mesh_axes
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.models.moe import count_drops
    from repro_torch.training import init_state, layout_specs, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(tuple(FS_LAYOUT.values()), tuple(FS_LAYOUT), device="cuda")
    axes = mesh_axes(mesh, fsdp=True)
    cfg, (tcfg, opt_cfg) = _fc_cfgs()
    model = build_model(cfg)
    specs = layout_specs(model, mesh, axes)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = init_state(model, seed, opt_cfg, "cuda", mesh=mesh, axes=axes)
    model_ranks = tuple(dist.get_process_group_ranks(mesh.model_group))
    out = {"coords": (mesh.data_rank, mesh.model_rank), "param_bytes": _nbytes(state["params"]),
           "logs": [], "ms": [], "counts": [], "sums": []}
    step_fn, _ = make_train_step(model, tcfg, opt_cfg, mesh=mesh, axes=axes)
    with count_drops() as drops:
        for s in range(FS_STEPS):
            with count_collectives() as cc:
                (state, o), ms = _sync_ms(lambda: step_fn(state, _fc_batch(s, seed)))
            out["logs"].append({k: float(v) for k, v in o.items()})
            out["ms"].append(ms)
            out["counts"].append({k: list(v) for k, v in cc.items()})
            out["sums"].append(cc.by_kind_group.get(("all-reduce", model_ranks), [0, 0.0]))
            if s == FS_STEPS - 2:
                snap = tree_map(lambda t: t.to("cpu", copy=True), state)
    out["dropped"] = drops["dropped"]
    out["peak"] = torch.cuda.max_memory_allocated() - base
    anchors = (f"fc_sample_{FS_STEPS}",)
    out["errs"] = _fs_errs(state["params"], specs, mesh, tmp, anchors, FC_LEAVES, "fc")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    state = tree_map(lambda t: t.to("cuda"), snap)
    del snap
    sound = RD.to_model_region
    RD.to_model_region = _no_model_sum
    try:
        state, o = step_fn(state, _fc_batch(FS_STEPS - 1, seed))
    finally:
        RD.to_model_region = sound
    out["planted_errs"] = _fs_errs(state["params"], specs, mesh, tmp, anchors, FC_LEAVES, "fc")
    out["planted_norm"] = float(o["grad_norm"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def split_rank(rank, world, tmp, seed):
    """16b's rank (``fsdp_rank``), then 16c's (``fc_rank``), in one process
    of (data 2, model 2): one spawn for both. Returns their results and
    seconds."""
    t0 = time.perf_counter()
    b = fsdp_rank(rank, world, tmp, seed)
    t1 = time.perf_counter()
    c = fc_rank(rank, world, tmp, seed)
    return {"16b": b, "16c": c, "secs": (t1 - t0, time.perf_counter() - t1)}


def _fc_report(card, a, res, seed):
    """16c's checks, from its single rank (``a``, ``_fc_anchor``) and its
    four ranks' results (``fc_rank``): prints them and fails on any beyond
    its limit, or on a planted fault within it."""
    r0 = res[0]
    anchor = f"fc_sample_{FS_STEPS}"
    c = r0["counts"][-1]
    print(f"16c {DS_CONFIG} at full width, {FC_DEPTH} of 27 layers (the dense layer, one MoE "
          f"layer with its shared experts; {a['params'] / 1e9:.3f} B params), split FSDP "
          f"(data 2, model 2), {len(res)} {TR_LABEL} ({card}), seed {seed}, capacity {TR_CF}: "
          f"losses {[round(x['loss'], 6) for x in r0['logs']]} vs one rank's "
          f"{[round(x['loss'], 6) for x in a['logs']]}, grad norms "
          f"{[round(x['grad_norm'], 5) for x in r0['logs']]} vs "
          f"{[round(x['grad_norm'], 5) for x in a['logs']]} (limits {TR_LOSS_TOL}, "
          f"{TR_NORM_TOL}); sampled leaves over one rank's update {_fmt(r0['errs'][anchor])} "
          f"(limit {FC_UPD_TOL}); with the model region's backward sum left out (planted) "
          f"{_fmt(r0['planted_errs'][anchor])}, grad norm {r0['planted_norm']:.5g}; "
          f"assignments dropped {a['dropped']} (one rank), "
          f"{[r['dropped'] for r in res]} (ranks); a step "
          f"{[round(statistics.mean(r['ms'][s] for r in res), 1) for s in range(FS_STEPS)]} ms "
          f"(one rank {[round(t, 1) for t in a['ms']]}); a rank's params "
          f"{r0['param_bytes'] / 1e9:.3f} GB, peak {[round(r['peak'] / 1e9, 3) for r in res]} "
          f"GB; collectives a step, rank 0: all-gather {c['all-gather'][0]} calls "
          f"{c['all-gather'][1] / 1e9:.3f} GB, reduce-scatter {c['reduce-scatter'][1] / 1e9:.3f}"
          f" GB, all-to-all {c['all-to-all'][1] / 1e9:.3f} GB, the model group's all-reduces "
          f"{[[int(n), int(b)] for n, b in r0['sums']]} [calls, B]", flush=True)
    want = a["logs"]
    for r in res:
        if r["dropped"] or a["dropped"]:
            fail(f"16c: assignments dropped at capacity {TR_CF}: {r['dropped']}, {a['dropped']}")
        for s, got in enumerate(r["logs"]):
            for k, tol in (("loss", TR_LOSS_TOL), ("grad_norm", TR_NORM_TOL)):
                if _off(got[k], want[s][k], tol):
                    fail(f"16c: rank {r['coords']} step {s} {k} {got[k]} vs the single "
                         f"rank's {want[s][k]}")
    bad = {k: v for k, v in r0["errs"][anchor].items() if not v <= FC_UPD_TOL}
    if bad:
        fail(f"16c: sampled leaves beyond {FC_UPD_TOL} of the single rank's update: {bad}")
    region = {k: r0["planted_errs"][anchor][k] for k in FC_REGION}
    if not min(region.values()) > FC_UPD_TOL:
        fail(f"16c: the planted missing model-region sum reads {region}, within {FC_UPD_TOL}: "
             "the check is blind")
    if not _off(r0["planted_norm"], want[-1]["grad_norm"], TR_NORM_TOL):
        fail(f"16c: the planted missing model-region sum's grad norm {r0['planted_norm']} lies "
             f"within {TR_NORM_TOL} of {want[-1]['grad_norm']}: the check is blind")


def _fmt(d) -> str:
    return json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})


def fsdp_phase(card, seed=SEED):
    """Phase 16: 16a's single rank and its controls and 16c's single rank
    here, then four gloo ranks on cuda:0 that run 16b and then 16c (a
    rank's failure fails the phase). Prints the checks, each rank's peak
    against its reckoned state, the collectives' bytes against the
    reckoning, and the parts of a step's time."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import build_model

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fsdp_") as tmp:
        t0 = time.perf_counter()
        a = _fs_anchor(tmp, seed)
        secs = {"16a": time.perf_counter() - t0}
        fc_a = _fc_anchor(tmp, seed)
        secs["16c one rank"] = time.perf_counter() - t0 - sum(secs.values())
        both = spawn(split_rank, math.prod(FS_LAYOUT.values()), "gloo", args=(tmp, seed),
                     device="cuda")
        secs["16b ranks"], secs["16c ranks"] = both[0]["secs"]
        secs["spawn"] = time.perf_counter() - t0 - sum(secs.values())
    res = [r["16b"] for r in both]
    model = build_model(get_config(CONFIG))
    r0 = res[0]
    peaks = [r["peak"] for r in res]
    planted_peaks = [r["planted_peak"] for r in res]
    mean = statistics.mean
    n = len(res)
    vs_a, vs_split = (f"fs_sample_{FS_STEPS}", f"fs_split_{FS_STEPS}")
    print(f"16a qwen2-1.5b whole, full width and depth ({model.cfg.n_layers} layers, "
          f"{len(model.sites)} ramp heads), one rank ({card}), seed {seed}: {FS_STEPS} AdamW "
          f"steps, clip {TR_CLIP}, B {TR_B} x S {TR_S}, remat: losses "
          f"{[round(x['loss'], 6) for x in a['logs']]}, grad norms "
          f"{[round(x['grad_norm'], 5) for x in a['logs']]} (reversed rows "
          f"{[round(x, 6) for x in a['reversed_losses']]}, "
          f"{[round(x, 5) for x in a['reversed_norms']]}; split control "
          f"{[round(x, 6) for x in a['split_losses']]}, "
          f"{[round(x, 5) for x in a['split_norms']]}); "
          f"{[round(t, 1) for t in a['ms']]} ms a step "
          f"({json.dumps({k: round(v, 1) for k, v in a['parts'][-1].items()})} ms), "
          f"{a['flops'] / 1e12:.3f} TFLOP of products a step; state "
          f"reckoned {a['reckoned'] / 1e9:.2f} GB, peak {a['peak'] / 1e9:.2f} GB; sampled "
          f"leaves over 16a's update: reversed rows {_fmt(a['reversed'])}, split control "
          f"{_fmt(a['split'])}", flush=True)
    print(f"16b FSDP (data 2, model 2), {n} {TR_LABEL} ({card}): losses "
          f"{[round(x['loss'], 6) for x in r0['logs']]}, grad norms "
          f"{[round(x['grad_norm'], 5) for x in r0['logs']]} on every rank (limits "
          f"{FS_LOSS_TOL}, {FS_NORM_TOL} from 16a's, {TR_LOSS_TOL}, {TR_NORM_TOL} from the "
          f"split control's); sampled leaves after {FS_STEPS} steps over 16a's "
          f"update: from the split control {_fmt(r0['errs'][vs_split])} (limit {TR_UPD_TOL}), "
          f"from 16a {_fmt(r0['errs'][vs_a])} (limit {FS_UPD_TOL}); step {FS_STEPS} with the "
          f"planted missing data sum: {_fmt(r0['planted_errs'][vs_split])} and "
          f"{_fmt(r0['planted_errs'][vs_a])}, grad norm {r0['planted_norm']:.5g}; its loss "
          f"with the row products' forward sums left out (planted) "
          f"{[round(r['planted_exit_loss'], 6) for r in res]}; with the model region's "
          f"backward sum left out (planted): {_fmt(r0['planted_region_errs'][vs_split])} and "
          f"{_fmt(r0['planted_region_errs'][vs_a])}, grad norm "
          f"{r0['planted_region_norm']:.5g}", flush=True)
    print(f"16b bytes a rank ({TR_LABEL}): params {r0['param_bytes'] / 1e9:.3f} GB (whole "
          f"leaves, the f32 norms: {r0['whole_param_bytes']} B), state reckoned "
          f"{r0['reckoned'] / 1e9:.3f} GB, peak measured "
          f"{[round(p / 1e9, 3) for p in peaks]} GB (max_memory_allocated above the rank's "
          f"start; limit the state + {FS_PEAK_ROOM / 1e9:.2f} GB, which holds a gathered layer "
          f"and its gradient, {2 * r0['layer_bytes'] / 1e9:.3f} GB, a gathered ramp head and "
          f"its gradient, {4 * model.cfg.d_model * model.cfg.padded_vocab / 1e9:.3f} GB, and "
          f"the activations); with each layer's forward gather held (planted, "
          f"{r0['held_bytes'] / 1e9:.3f} GB held) {[round(p / 1e9, 3) for p in planted_peaks]}"
          f" GB; the {n} ranks' sum {sum(peaks) / 1e9:.2f} GB of 80; the fsdp=False layout "
          f"would hold {n} x {a['reckoned'] / 1e9:.1f} = {n * a['reckoned'] / 1e9:.1f} GB of "
          f"state", flush=True)
    c = r0["counts"][-1]
    share = 1 / FS_LAYOUT["data"]  # a rank's rows of the batch
    ratios = [r["flops"] / (share * a["flops"]) for r in res]
    print(f"16b product FLOPs a step (FlopCounterMode, step 2's third planted run): a rank "
          f"{[round(r['flops'] / 1e12, 3) for r in res]} TFLOP, over 16a's on the same rows "
          f"({a['flops'] / 1e12:.3f} x {share}): {[round(x, 4) for x in ratios]} (limit "
          f"{FS_FLOP_SHARE}); the model group's all-reduces a step: "
          f"{[[int(n), int(b)] for n, b in r0['sums']]} [calls, B] (reckoned "
          f"{list(r0['reckoned_sums'])})", flush=True)
    print(f"16b collectives a step, rank 0: all-gather {c['all-gather'][0]} calls "
          f"{c['all-gather'][1] / 1e9:.3f} GB (reckoned {r0['reckoned_ag'] / 1e9:.3f}), "
          f"reduce-scatter {c['reduce-scatter'][0]} calls {c['reduce-scatter'][1] / 1e9:.3f} GB "
          f"(reckoned {r0['reckoned_rs'] / 1e9:.3f}), all-reduce {c['all-reduce'][0]} calls "
          f"{c['all-reduce'][1]:.0f} B; a step "
          f"{[round(mean(r['ms'][s] for r in res), 1) for s in range(FS_STEPS)]} ms, the "
          f"last by part (mean of the ranks) "
          f"{json.dumps({k: round(mean(r['parts'][-1][k] for r in res), 1) for k in r0['parts'][-1]})}"
          f" ms; drawing a rank's parts {mean(r['init_ms'] for r in res):.0f} ms; rank 0's "
          f"runs {json.dumps({k: round(v, 1) for k, v in r0['secs'].items()})} s", flush=True)
    # 16b against 16a, each limit between its largest sound reading and the
    # planted faults' smallest
    rel = lambda got, want: abs(got - want) / abs(want)  # noqa: E731
    last = a["logs"][-1]
    region = lambda anchor: {k: v for k, v in r0["planted_region_errs"][anchor].items()  # noqa: E731
                             if k != "ramp_head"}  # its features are stop-grad
    sound = {k: max(rel(r["logs"][s][k], a["logs"][s][k]) for r in res for s in range(FS_STEPS))
             for k in ("loss", "grad_norm")}
    sound["leaves"] = max(r0["errs"][vs_a].values())
    planted = {"loss": min(rel(r["planted_exit_loss"], last["loss"]) for r in res),
               "grad_norm": min(rel(r[k], last["grad_norm"]) for r in res
                                for k in ("planted_norm", "planted_region_norm")),
               "leaves": min(min(r0["planted_errs"][vs_a].values()),
                             min(region(vs_a).values()))}
    limits = {"loss": FS_LOSS_TOL, "grad_norm": FS_NORM_TOL, "leaves": FS_UPD_TOL}
    print("16b limits against 16a, [largest sound reading, planted faults' smallest reading, "
          "limit]: " + json.dumps({k: [float(f"{sound[k]:.4g}"), float(f"{planted[k]:.4g}"),
                                       limits[k]] for k in limits}), flush=True)
    over = [k for k in limits if not sound[k] <= limits[k]]
    if over:
        fail(f"16b: beyond their limits from 16a: {over}")
    blind = [k for k in limits if not planted[k] > limits[k]]
    if blind:
        fail(f"16b: planted faults within their limits from 16a: {blind}")
    for r in res:
        for s, (got, want) in enumerate(zip(r["logs"], a["logs"])):
            # and to the split control, which rounds as 16b's data and model split do
            ctl = {"loss": a["split_losses"][s], "grad_norm": a["split_norms"][s]}
            for k, tol in (("loss", TR_LOSS_TOL), ("grad_norm", TR_NORM_TOL)):
                if _off(got[k], ctl[k], tol):
                    fail(f"16b: rank {r['coords']} step {s} {k} {got[k]} vs the split "
                         f"control's {ctl[k]} (the single rank's {want[k]})")
            if not want["grad_norm"] > TR_CLIP:
                fail(f"16a: grad norm {want['grad_norm']} does not clip at {TR_CLIP}")
        for s, c in enumerate(r["counts"]):
            if (c["all-gather"][1], c["reduce-scatter"][1]) != (r["reckoned_ag"],
                                                                r["reckoned_rs"]):
                fail(f"16b: rank {r['coords']} step {s} moved {c['all-gather'][1]:.0f} B "
                     f"all-gathered and {c['reduce-scatter'][1]:.0f} B reduce-scattered; "
                     f"reckoned {r['reckoned_ag']} and {r['reckoned_rs']}")
        if not max(ratios) <= FS_FLOP_SHARE:
            fail(f"16b: a rank's product FLOPs {ratios} of 16a's on its rows, over "
                 f"{FS_FLOP_SHARE}: the model split does not split the work")
        if r["peak"] > r["reckoned"] + FS_PEAK_ROOM:
            fail(f"16b: rank {r['coords']} peak {r['peak']} B over its state "
                 f"{r['reckoned']} B + {FS_PEAK_ROOM:.0f} B")
        if not r["planted_peak"] > r["reckoned"] + FS_PEAK_ROOM:
            fail(f"16b: rank {r['coords']} with its layer gathers held peaks at "
                 f"{r['planted_peak']} B, within its state + {FS_PEAK_ROOM:.0f} B: the check "
                 "is blind")
    bad = {k: v for k, v in r0["errs"][vs_split].items() if not v <= TR_UPD_TOL}
    if bad:
        fail(f"16b: sampled leaves beyond {TR_UPD_TOL} of 16a's update from the split control: "
             f"{bad}")
    if not min(r0["planted_errs"][vs_split].values()) > TR_UPD_TOL:
        fail(f"16b: the planted missing data sum reads {r0['planted_errs'][vs_split]} from the "
             f"split control, within {TR_UPD_TOL}: the check is blind")
    # the ramp head's gradient does not cross the region's entry, so the
    # fault reads on the others
    if not min(region(vs_split).values()) > TR_UPD_TOL:
        fail(f"16b: the planted missing model-region sum reads {region(vs_split)} from the "
             f"split control, within {TR_UPD_TOL}: the check is blind")
    if sum(peaks) > 80e9:
        fail(f"16b: the four ranks' peaks sum to {sum(peaks) / 1e9:.2f} GB, over 80 GB")
    _fc_report(card, fc_a, [r["16c"] for r in both], seed)
    print(f"phase 16: {json.dumps({k: round(v, 1) for k, v in secs.items()})} s", flush=True)


def _result_line() -> str:
    return json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}})


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the port on one NVIDIA GPU")
    ap.add_argument("--phase", type=int, choices=(16,),
                    help="run this phase alone (it reaches no kernel, so nothing is built)")
    ap.add_argument("--seed", type=int, default=SEED, help="phase 16's seed, with --phase 16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.launch.serve import serve, serve_generative
        from repro_torch.models import build_model
        from repro_torch.models.common import tree_leaves
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the repository root")
    t_all = time.perf_counter()
    if args.phase == 16:
        fsdp_phase(card, args.seed)
        print(f"phase 16 took {time.perf_counter() - t_all:.1f} s", flush=True)
        print(card, flush=True)
        print(_result_line(), flush=True)
        return

    # -- phase 2: build
    t0 = time.perf_counter()
    logs = build.build()
    print(f"built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        lines = [ln for ln in log.splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln]
        entries = demangle([ln.split("'")[1] for ln in lines if "entry function" in ln])
        for line in lines:  # smem is on the registers line
            if "entry function" in line:
                print(f"  [{name}] {entries.pop(0)}:", flush=True)
            else:
                print(f"  [{name}]   {line.strip()}", flush=True)

    # -- phase 3: kernels vs plain versions
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 versions stay f32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    # the served path's load: prompt 128 + 34 new tokens = a 162-slot cache,
    # every row decoding at pos 128..161
    da_main = check_decode_attention(8, 162, "B=8 H=12 KH=2 hd=128 S=162 pos 128..161 bf16",
                                     gen, pos_lo=128)
    check_decode_attention(32, 4096, "B=32 H=12 KH=2 hd=128 S=4096 bf16", gen)
    # -- phase 3b: the paged kernel, at the paged serving load (prompt 120 +
    # 40 new tokens = 10 blocks of 16, rows decoding at pos 120..159) and on
    # 4096-token rows
    pda_main = check_paged_decode_attention(
        8, 10, "B=8 H=12 KH=2 hd=128 bs=16 nb=10 pos 120..159 shuffled bf16", gen, 120, 160)
    check_paged_decode_attention(
        32, 256, "B=32 H=12 KH=2 hd=128 bs=16 nb=256 pos 0..4095 shuffled bf16", gen, 0, 4096)
    # -- phase 3c: the paged MLA kernel at DeepSeek-V2-Lite's served load
    # (the same 10 blocks of 16, rows at pos 120..159) and on 4096-token rows
    mla_main = check_paged_mla(
        8, 10, "B=8 H=16 r=512 dr=64 bs=16 nb=10 pos 120..159 shuffled bf16", gen, 120, 160)
    check_paged_mla(
        32, 256, "B=32 H=16 r=512 dr=64 bs=16 nb=256 pos 0..4095 shuffled bf16", gen, 0, 4096)
    # -- phase 3d: flash attention at qwen2-1.5b's served prefill (prompt 128
    # into a 160-slot cache, the causal mask from query 0) and on a 4096-token
    # prompt
    fa_main = check_flash_attention(1, 12, 2, 128, 160, 128,
                                    "B=1 H=12 KH=2 hd=128 Sq=128 Sk=160 causal bf16", gen)
    check_flash_attention(1, 12, 2, 4096, 4096, 128,
                          "B=1 H=12 KH=2 hd=128 Sq=Sk=4096 causal bf16", gen)
    # -- phase 3e: the SSD scan at Mamba2-2.7B's served prefill (128 steps, two
    # chunks), a ragged 120 and 4096 steps
    ssd_main = check_ssd(1, 80, 128, 64, 128, "B=1 H=80 S=128 hp=64 N=128 chunk 64 bf16", gen)
    check_ssd(1, 80, 120, 64, 128, "B=1 H=80 S=120 (ragged) hp=64 N=128 bf16", gen)
    check_ssd(1, 80, 4096, 64, 128, "B=1 H=80 S=4096 hp=64 N=128 bf16", gen)
    # -- phase 3f: flash attention with no mask at BERT-base's served shape (8
    # requests of 32 tokens, 12 heads of 64) and one 512-token row (its
    # max_position)
    fa_bert = check_flash_attention(8, 12, 12, 32, 32, 64,
                                    "B=8 H=KH=12 hd=64 Sq=Sk=32 no mask bf16", gen, causal=False)
    check_flash_attention(1, 12, 12, 512, 512, 64, "B=1 H=KH=12 hd=64 Sq=Sk=512 no mask bf16",
                          gen, causal=False)
    t = tick("2-3f build and kernels", t_all)
    cfg = get_config(CONFIG)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"drew {CONFIG} weights ({sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B "
          f"params, {cfg.dtype}) in {time.perf_counter() - t0:.1f} s", flush=True)
    rh = check_ramp_head(params, cfg, gen)
    check_ramp_styles(params, cfg, gen)

    # -- phase 4: the full-width model, then serving (the weights drawn above
    # are the ones serve_generative draws from the same seed)
    compare_paths(params, cfg, cfg.replace(decode_attn="dense", pallas_head="off"),
                  cfg.replace(decode_attn="kernel", pallas_head="kernel"), gen,
                  on_kw={"prefill_attn": "kernel"}, prefill_kernel="flash_attention")
    t = tick("qwen2-1.5b draw, ramp heads, ramp styles and 4 paths", t)
    del model
    torch.cuda.empty_cache()
    (out, resp), launches = counted(lambda: serve_generative(
        CONFIG, 8, decode_tokens=32, prompt_len=128, steps_per_sync=4, seed=SEED,
        device="cuda", verbose=False, params=params))
    _complete(resp, 8, 32, cfg.vocab_size, "4a")
    for name in ("decode_attention", "ramp_head_stats", "ramp_head_exit"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    check_prefill_launches("4a", cfg, launches, "flash_attention")
    m = out["measured"]
    print(f"served 8 requests x 32 tokens on {card}: prefill {m['prefill_ms_mean']:.3f} ms "
          f"(prompt 128), {m['window_ms_mean']:.3f} ms per window of up to 4 steps, "
          f"{m['decode_tokens_per_s']:.1f} decode tokens/s; {graph_note(m)}; launches "
          f"{json.dumps(launches)}", flush=True)
    print("engine summary (SIMULATED from the analytic H100 profile, not timed): "
          + json.dumps(out["simulated"]["apparate"], default=float), flush=True)
    t = tick("4a", t)
    _, paged_launches = serve_paged_vs_contiguous(params, cfg, serve_generative, "4b",
                                               "decode_attention", "paged_decode_attention",
                                               "flash_attention")
    t = tick("4b", t)
    serve_prefix_swap(params, cfg, serve_generative)
    serve_chunked(params, cfg, serve_generative)
    t = tick("4c-4d", t)
    graphs = {CONFIG: graph_vs_eager(params, cfg, serve_generative, "4e", SEED + 7)}
    t = tick("4e", t)
    lm_launches = lm_token_phase(params, cfg, gen, serve)
    t = tick("4f", t)
    loop_runner_phase(params, cfg)
    tick("4g", t)
    print(f"qwen2-1.5b phases done at {time.perf_counter() - t_all:.1f} s", flush=True)

    # -- phase 5: DeepSeek-V2-Lite, once qwen2-1.5b's weights are freed (the
    # serving engine's objects hold them in reference cycles until a collection)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ds_launches, ds_rh, graphs[DS_CONFIG] = deepseek_phases(gen, serve_generative)
    print(f"DeepSeek-V2-Lite phases done at {time.perf_counter() - t_all:.1f} s", flush=True)

    # -- phase 6: Mamba2-2.7B, once DeepSeek-V2-Lite's weights are freed
    gc.collect()
    torch.cuda.empty_cache()
    mb_launches, mb_rh, graphs[MB_CONFIG] = mamba_phases(gen, serve_generative)
    print(f"Mamba2-2.7B phases done at {time.perf_counter() - t_all:.1f} s", flush=True)

    # -- phase 7: the classifiers, once Mamba2-2.7B's weights are freed
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    resnet_phase(gen, serve)
    t = tick("7a", t)
    gc.collect()
    torch.cuda.empty_cache()
    bert_launches, bert_out = bert_phase(gen, serve)
    tick("7b", t)
    print(f"classifier phases done at {time.perf_counter() - t_all:.1f} s", flush=True)

    # -- phase 8: training, once the classifiers' weights are freed
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    qt_launches, _ = train_qwen_phase(gen)
    t = tick("8a", t)
    gc.collect()
    torch.cuda.empty_cache()
    bt_launches, _ = bert_train_phase(serve, bert_out)
    tick("8b", t)
    print(f"training phases done at {time.perf_counter() - t_all:.1f} s", flush=True)

    # -- phase 9: Gemma3-4B, once the trained models are freed
    gc.collect()
    torch.cuda.empty_cache()
    gm, gm_full, gm_paged = gemma_phases(gen, serve_generative)
    graphs[GM_CONFIG] = gm["graphs"]
    print(f"Gemma3-4B phases done at {time.perf_counter() - t_all:.1f} s", flush=True)

    # -- phase 10: Qwen3-MoE-30B-A3B whole, once Gemma3's weights are freed
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    q3, q3_cont, q3_paged = qwen3_phases(gen, serve_generative)
    graphs[Q3_CONFIG] = q3["graphs"]
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 11: one period of Llama-3.2-Vision, once Qwen3-MoE's are freed
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lv, lv_cont, lv_paged = llama_phases(gen, serve_generative)
    graphs[LV_CONFIG] = lv["graphs"]
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 12: SeamlessM4T-large-v2 whole, once Llama-3.2-Vision's are freed
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sm, sm_launches = seamless_phases(gen)
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 13: the dry run's counts and the kernels' meta contracts on the
    # card, then the runtime presets through the launcher
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dryrun_counts_phase(gen)
    meta_contracts_phase(gen)
    gc.collect()
    torch.cuda.empty_cache()
    presets_phase()
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 14: multi-rank serving, two ranks sharing the card over gloo,
    # then one NCCL rank
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mr, mr_launches = multirank_phases(gen)
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 15: multi-rank training, ranks sharing the card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    multirank_train_phases(card)
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 16: the FSDP train state, qwen2-1.5b whole on four ranks
    # sharing the card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fsdp_phase(card)
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)

    src = {"decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
           "paged_decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
           "ramp_head_stats": "src/repro_torch/kernels/csrc/ramp_head.cu",
           "ramp_head_exit": "src/repro_torch/kernels/csrc/ramp_head.cu",
           "paged_mla_decode_attention": "src/repro_torch/kernels/csrc/paged_mla_decode.cu",
           "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "ssd_chunked": "src/repro_torch/kernels/csrc/ssd_chunked.cu"}
    replaces = {"decode_attention": "src/repro/kernels/decode_attention/kernel.py:90",
                "paged_decode_attention": "src/repro/kernels/decode_attention/paged.py:107",
                "ramp_head_stats": "src/repro/kernels/ramp_head/kernel.py:98",
                "ramp_head_exit": "src/repro/kernels/ramp_head/kernel.py:145",
                "paged_mla_decode_attention":
                    "src/repro/kernels/decode_attention/paged_mla.py:117",
                "flash_attention": "src/repro/kernels/flash_attention/kernel.py:91",
                "ssd_chunked": "src/repro/kernels/ssd/kernel.py:73"}
    # (kernel, its phase-3 row, the counted run its launches come from); the
    # ramp heads have a row for each model's path, at that model's shapes
    ds_path = f"{DS_CONFIG} 5b paged"
    n_local, n_gm = gm["prefill_layers"]
    mb_path = f"{MB_CONFIG} 6b paged"
    entries = [("decode_attention", da_main, launches, f"{CONFIG} 4a"),
               ("paged_decode_attention", pda_main, paged_launches, f"{CONFIG} 4b paged"),
               ("ramp_head_stats", rh["ramp_head_stats"], launches, f"{CONFIG} 4a"),
               ("ramp_head_exit", rh["ramp_head_exit"], launches, f"{CONFIG} 4a"),
               ("ramp_head_stats", ds_rh["ramp_head_stats"], ds_launches, ds_path),
               ("ramp_head_exit", ds_rh["ramp_head_exit"], ds_launches, ds_path),
               ("paged_mla_decode_attention", mla_main, ds_launches, ds_path),
               ("flash_attention", fa_main, launches, f"{CONFIG} 4a"),
               ("ramp_head_stats", mb_rh["ramp_head_stats"], mb_launches, mb_path),
               ("ramp_head_exit", mb_rh["ramp_head_exit"], mb_launches, mb_path),
               ("ssd_chunked", ssd_main, mb_launches, mb_path),
               ("flash_attention", fa_bert, bert_launches, "bert-base 7b"),
               ("ramp_head_stats", rh["ramp_head_stats"], lm_launches, f"{CONFIG} 4f"),
               ("decode_attention", da_main, qt_launches, f"{CONFIG} 8a trained ramps"),
               ("ramp_head_stats", rh["ramp_head_stats"], qt_launches,
                f"{CONFIG} 8a trained ramps"),
               ("ramp_head_exit", rh["ramp_head_exit"], qt_launches, f"{CONFIG} 8a trained ramps"),
               ("flash_attention", fa_bert, bt_launches, "bert-base 8b trained"),
               ("decode_attention", gm["decode"], gm_full, f"{GM_CONFIG} 9c full"),
               ("paged_decode_attention", gm["paged"], gm_paged, f"{GM_CONFIG} 9c paged"),
               ("flash_attention", gm["flash_window"], gm_full,
                f"{GM_CONFIG} 9c full ({n_local} of a prefill's {n_gm} launches windowed)"),
               ("flash_attention", gm["flash_causal"], gm_full,
                f"{GM_CONFIG} 9c full ({n_gm - n_local} of a prefill's {n_gm} launches causal)"),
               ("ramp_head_stats", gm["ramp"]["ramp_head_stats"], gm_full,
                f"{GM_CONFIG} 9c full"),
               ("ramp_head_exit", gm["ramp"]["ramp_head_exit"], gm_full, f"{GM_CONFIG} 9c full")]
    for run, rows, cont, paged in ((f"{Q3_CONFIG} 10c", q3, q3_cont, q3_paged),
                                   (f"{LV_CONFIG} (one period) 11c", lv, lv_cont, lv_paged)):
        entries += [("decode_attention", rows["decode"], cont, f"{run} contiguous"),
                    ("paged_decode_attention", rows["paged"], paged, f"{run} paged"),
                    ("flash_attention", rows["flash"], cont, f"{run} contiguous"),
                    ("ramp_head_stats", rows["ramp"]["ramp_head_stats"], cont,
                     f"{run} contiguous"),
                    ("ramp_head_exit", rows["ramp"]["ramp_head_exit"], cont, f"{run} contiguous")]
    run = f"{SM_CONFIG} 12c (one prefill, {SM_STEPS} steps on each layout)"
    entries += [("flash_attention", sm["flash_enc"], sm_launches,
                 f"{run}: 24 of a prefill's 48 launches, the encoder"),
                ("flash_attention", sm["flash_dec"], sm_launches,
                 f"{run}: 24 of a prefill's 48 launches, the decoder"),
                ("decode_attention", sm["decode"], sm_launches, f"{run} contiguous"),
                ("paged_decode_attention", sm["paged"], sm_launches, f"{run} paged"),
                ("ramp_head_stats", sm["ramp"]["ramp_head_stats"], sm_launches, run),
                ("ramp_head_exit", sm["ramp"]["ramp_head_exit"], sm_launches, run)]
    run = f"14, rank 0 of {MR_RANKS} sharing one card (gloo)"
    entries += [("decode_attention", mr["da_q2"], mr_launches["14a"], f"{CONFIG} 14a tp 2 {run}"),
                ("paged_decode_attention", mr["pda_q2"], mr_launches["14a pages"],
                 f"{CONFIG} 14a tp 2 pool {run}"),
                ("ramp_head_stats", rh["ramp_head_stats"], mr_launches["14a"],
                 f"{CONFIG} 14a tp 2 {run}"),
                ("ramp_head_exit", rh["ramp_head_exit"], mr_launches["14a"],
                 f"{CONFIG} 14a tp 2 {run}"),
                ("flash_attention", mr["fa_q2"], mr_launches["14a prefill"],
                 f"{CONFIG} 14a replicated prefill {run}"),
                ("decode_attention", mr["da_q2"], mr_launches["14b rows"],
                 f"{CONFIG} 14b ShardedDecodeRunner rows {run}"),
                ("flash_attention", mr["fa_q2r"], mr_launches["14b rows"],
                 f"{CONFIG} 14b ShardedDecodeRunner rows, its TP prefill {run}"),
                ("paged_decode_attention", mr["pda_q2"], mr_launches["14b pages"],
                 f"{CONFIG} 14b ShardedDecodeRunner pool {run}"),
                ("decode_attention", mr["da_q3"], mr_launches["14c"],
                 f"{Q3_CONFIG} {Q3_DEPTH} layers 14c tp 2 EP {run}"),
                ("decode_attention", mr["da_q32"], mr_launches["14d"],
                 f"{Q32_CONFIG} {Q32_DEPTH} layers 14d tp 2 {run}"),
                ("flash_attention", mr["fa_q32"], mr_launches["14d"],
                 f"{Q32_CONFIG} {Q32_DEPTH} layers 14d TP prefill {run}"),
                ("ramp_head_stats", mr["rh_q32"]["ramp_head_stats"], mr_launches["14d"],
                 f"{Q32_CONFIG} {Q32_DEPTH} layers 14d tp 2 {run}"),
                ("ramp_head_exit", mr["rh_q32"]["ramp_head_exit"], mr_launches["14d"],
                 f"{Q32_CONFIG} {Q32_DEPTH} layers 14d tp 2 {run}"),
                ("decode_attention", mr["da_pipe"], mr_launches["14e"],
                 f"{CONFIG} {PIPE_DEPTH} layers 14e pipeline, 2 stages {run}")]
    if lm_launches["ramp_head_exit"]:
        entries.append(("ramp_head_exit", rh["ramp_head_exit"], lm_launches, f"{CONFIG} 4f"))
    kernels = []
    for name, r, counts, path in entries:
        kernels.append({
            "name": name, "route": "cuda", "source": src[name], "replaces": replaces[name],
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "path": path, "shape": r["shape"],
            **{k: r[k] for k in ("device_ms", "host_us") if k in r},
        })
    print("window graphs (4e, 5d, 6d, 9d, 10d, 11d): " + json.dumps(
        {name: {"host_ms_per_replayed_window": {lay: v[lay]["host_ms_per_replayed_window"]
                                                for lay in ("contiguous", "paged")},
                "host_ms_per_eager_window": {lay: v[lay]["host_ms_per_eager_window"]
                                             for lay in ("contiguous", "paged")},
                "device_busy_ms_per_window": {lay: v[lay]["device_busy_ms_per_window"]
                                              for lay in ("contiguous", "paged")},
                "served": v["serve"]} for name, v in graphs.items()}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_result_line(), flush=True)


if __name__ == "__main__":
    main()
