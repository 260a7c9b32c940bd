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
     pool with the kernels off and on; 5b. contiguous rows vs the paged pool
     on one schedule (the paged MLA kernel in all 27 layers of every decode
     step), the paged run on the contiguous run's MoE routing, then both
     layouts' aten ops a window counted (eager) and their times taken
     without hooks; 5c. swap preemption on a pool that runs dry; 5d. as 4e;
  6. full-width Mamba2-2.7B with seeded random weights, once DeepSeek's are
     freed: the ramp-head kernels at its d 2560 and V 51200, one layer's
     plain recurrent state update timed; 6a. prefill (the SSD kernel) + 8
     decode steps with the kernels off and on; 6b.
     contiguous state rows vs state pages on one schedule; 6c. swap of state
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
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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


def check_decode_attention(B, S, label, gen, pos_lo=0):
    """Per-row pos drawn from [pos_lo, S), int64 as the model holds it."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.decode_attention.kernel import decode_launch_info

    H, KH, hd = 12, 2, 128
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


def check_paged_decode_attention(B, nb, label, gen, pos_lo, pos_hi, bs=16):
    """The paged kernel over a shuffled block table (pool block 0 is the
    trash block no row owns), per-row pos drawn from [pos_lo, pos_hi):
    against its plain version, and bit for bit against the contiguous
    kernel on the same keys gathered into a contiguous cache."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        paged_decode_attention,
        paged_decode_attention_ref,
    )
    from repro_torch.kernels.decode_attention.kernel import decode_launch_info

    H, KH, hd = 12, 2, 128
    dt = torch.bfloat16
    S, P = nb * bs, B * nb + 1
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    k_pool = torch.randn(P, bs, KH, hd, generator=gen, device="cuda").to(dt)
    v_pool = torch.randn(P, bs, KH, hd, generator=gen, device="cuda").to(dt)
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(B, nb).to(torch.int32)
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


def check_flash_attention(B, H, KH, Sq, Sk, hd, label, gen, causal=True):
    """Phases 3d and 3f: the flash-attention kernel, causal from query 0 (3d)
    or with no mask (3f, BERT's encoder), against its plain version, q/k/v
    handed over as the model does (views of (B, S, heads, hd) storage);
    timed beside SDPA (top-left causal, or no mask)."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    dt = torch.bfloat16
    q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dt).transpose(1, 2)
    k = torch.randn(B, Sk, KH, hd, generator=gen, device="cuda").to(dt).transpose(1, 2)
    v = torch.randn(B, Sk, KH, hd, generator=gen, device="cuda").to(dt).transpose(1, 2)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    ref = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    # bf16 output: the kernel rounds once from f32; the plain version sums
    # in another order; 1e-2 covers bf16's 8-bit mantissa
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2):
        fail(f"flash_attention {label}: max abs err {err}")

    def library():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                enable_gqa=True)

    # what causal-from-0 needs: keys 0..Sq-1 of each head, (q_i, k_j) pairs
    # j <= i; with no mask every key and every pair
    nk = min(Sk, Sq) if causal else Sk
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    nbytes = 2 * (2 * q.numel() + 2 * B * KH * nk * hd)
    flops = 4 * B * H * pairs * hd  # q.k and p.v
    bm, by = bound_ms(nbytes, flops)
    row = {
        "shape": label, "max_abs_err": err,
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal)),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=causal)),
        "library_ms": time_ms(library),
        "library": "SDPA (is_causal, top-left)" if causal else "SDPA (no mask)",
        "bound_ms": bm, "bound_by": by, "bytes": nbytes, "flops": flops,
        "cuda_core_ms": 1e3 * flops / PEAK_F32,
    }
    row["tflop_per_s"] = flops / row["ms"] / 1e9  # of the counted flop
    row["device_ms"] = device_ms(lambda: flash_attention(q, k, v, causal=causal))
    row["library_device_ms"] = device_ms(library)
    row["host_us"] = host_us(lambda: flash_attention(q, k, v, causal=causal))
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
                  prefill_kernel=None, toks=None, T=8, thr=None):
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
    (Mamba2-2.7B's 64 layers: 0.571)."""
    from repro_torch.models import build_model
    from repro_torch.models import layers as LY

    off, on = build_model(off_cfg, **(off_kw or {})), build_model(on_cfg, **(on_kw or {}))
    act = [2, 5, 8, 11]
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
        lg_on, lg_off = f32_logits(seen_on), f32_logits(seen_off)
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

    cache_len = P + T + 1
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
        runs[name], pl = counted(lambda m=model: m.prefill(params, toks, cache_len=cache_len,
                                                            active_sites=act))
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
            params, toks, cache_len=cache_len, active_sites=act))
    print(f"model {cfg.name} kernels off ({off_cfg.decode_attn}, {off_cfg.pallas_head}, "
          f"{off_kw or {}}) vs on ({on_cfg.decode_attn}, {on_cfg.pallas_head}, {on_kw or {}}): "
          f"{stats['labels']} labels, {stats['near_ties']} near-ties, max logit eps "
          f"{stats['max_eps']:.4f} (cap {cap:.3f}; by step {stats['eps_by_step']}); "
          f"kernels-on ramp records: {stats['ramp_exits']} of {stats['ramp_records']} exit at "
          f"thresholds {[round(x, 4) for x in thr.tolist()]}, "
          f"{stats['ramp_maxprob_over_half']} with maxprob > 0.5; "
          + (f"MoE routing replayed from the off path: {routes.flip_count()} of "
             f"{routes.routes} token routes of the on path would have taken other experts "
             "(router near-ties); "
             if cfg.moe else "") + json.dumps(times), flush=True)
    return {**times, **{k: stats[k] for k in ("ramp_exits", "ramp_records",
                                              "ramp_maxprob_over_half", "near_ties",
                                              "max_eps")}}


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
    read just after, and count the model's prefills (``LM.prefill`` calls),
    the classifiers' forwards (``EncoderClassifier.forward`` and
    ``ResNet.forward`` calls) and the decode steps of every runner fn
    builds (``decode_steps``: a replayed window graph runs its steps without
    calling ``LM.decode``). Returns (fn's result, {kernel: launches,
    "prefills": n, "forwards": n, "decode_steps": n})."""
    from repro_torch.kernels import counted_wrappers
    from repro_torch.models.encdec import EncoderClassifier
    from repro_torch.models.resnet import ResNet
    from repro_torch.models.transformer import LM

    fns = counted_wrappers()
    for f in fns.values():
        f.launches = 0
    calls = {"prefills": 0, "forwards": 0}
    hooked = [(LM, "prefill", "prefills"), (EncoderClassifier, "forward", "forwards"),
              (ResNet, "forward", "forwards")]
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
    toks, through the dense path (no kernel, no launch counted); with
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
    model.prefill(params, toks, active_sites=None, with_cache=False)
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
                              prefill_kernel):
    """Phases 4b, 5b and 6b: 8 requests, prompt 120, 38 tokens, windows of
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
    times come from four more runs of each layout without any hook, in the
    order contiguous, paged, paged, contiguous, twice, and one more eager
    run of each counts the aten ops of a window (``window_ops``). Returns
    the compared paged run's launch counts."""
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
        for name, bs in (layouts + layouts[::-1]) * 2:
            gc.collect()  # earlier runs' engine objects sit in reference cycles
            timed.append((name, serve_once(name, bs)))
        hooked = " vs ".join(f"{runs[name][0]['measured']['window_ms_mean']:.3f}"
                             for name, _ in layouts)
        ops = [window_ops(lambda: serve_once(name, bs, graphs=False))[1]
               for name, bs in layouts]
        extra = (f"MoE routing replayed from the contiguous run: {routes.flip_count()} of "
                 f"{routes.routes} token routes of the paged run would have taken other "
                 f"experts; eager ms per window with the hooks {hooked}; eager aten ops per "
                 f"window {ops[0]['ops_per_window']['eager']:.1f} vs "
                 f"{ops[1]['ops_per_window']['eager']:.1f}, in LM.decode per step "
                 f"{ops[0]['decode_ops_per_step']:.1f} vs "
                 f"{ops[1]['decode_ops_per_step']:.1f}; times below from graphed runs without "
                 "hooks in the order c, p, p, c, c, p, p, c (median last); ")
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
    return p_l


def serve_prefix_swap(params, cfg, serve):
    """Phase 4c: 8 requests drawing on 4 prompts that share a 64-token
    prefix, each prompt sent twice, with the prefix cache and swap
    preemption on a 24-block pool (full capacity is 80): it runs dry with
    up to four streams decoding together."""
    import numpy as np

    base = np.random.default_rng(SEED + 3).integers(1, cfg.vocab_size, (4, PAGED_PROMPT))
    base[:, :64] = base[0, :64]
    prompts = np.concatenate([base, base])
    (out, resp), launches = counted(lambda: serve(
        CONFIG, decode_tokens=PAGED_TOKENS, steps_per_sync=4, seed=SEED, device="cuda",
        verbose=False, kv_block_size=16, kv_blocks=24, prefix_cache=True, preempt="swap",
        prompts=prompts, params=params))
    _complete(resp, 8, PAGED_TOKENS, cfg.vocab_size, "4c")
    kv = out["kv_cache"]
    for key in ("prefix_hits", "cow_copies", "swap_outs"):
        if kv[key] <= 0:
            fail(f"4c: {key} is {kv[key]}; the run must share, copy on write and swap")
    if kv["swap_ins"] != kv["swap_outs"]:
        fail(f"4c: {kv['swap_outs']} swaps out but {kv['swap_ins']} back in")
    if launches["paged_decode_attention"] <= 0:
        fail("4c: the paged kernel was not launched")
    check_prefill_launches("4c", cfg, launches, "flash_attention")
    print(f"4c prefix sharing + swap preemption, 24-block pool: {graph_note(out['measured'])}; "
          f"kv {json.dumps(kv)}; engine "
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


def serve_swap(params, cfg, serve, phase, seed, decode_kernel, prefill_kernel):
    """Phases 5c and 6c: 8 requests (prompt 120, 38 tokens) with swap
    preemption on a 24-block pool (full capacity is 80, a stream needs up
    to 10): the pool runs dry and streams are swapped out and back in. No
    prefix cache: latent and state pages are not shared. ``decode_kernel``
    (None: none) runs once a layer a decode step, ``prefill_kernel`` once a
    layer a prefill."""
    import numpy as np

    prompts = np.random.default_rng(seed).integers(1, cfg.vocab_size, (8, PAGED_PROMPT))
    (out, resp), launches = counted(lambda: serve(
        cfg.name, decode_tokens=PAGED_TOKENS, steps_per_sync=4, seed=SEED, device="cuda",
        verbose=False, kv_block_size=16, kv_blocks=24, preempt="swap", prompts=prompts,
        params=params))
    _complete(resp, 8, PAGED_TOKENS, cfg.vocab_size, phase)
    kv = out["kv_cache"]
    if not kv["swap_outs"] > 0 or kv["swap_ins"] != kv["swap_outs"]:
        fail(f"{phase}: {kv['swap_outs']} swaps out and {kv['swap_ins']} back in; the run "
             "must swap, and every stream swapped out must come back")
    steps = launches["decode_steps"]
    for k in ATTENTION:
        expect = cfg.n_layers * steps if k == decode_kernel else 0
        if launches[k] != expect or steps <= 0:
            fail(f"{phase}: {k} launched {launches[k]} times in {steps} decode steps")
    for k in ("ramp_head_stats", "ramp_head_exit"):
        if launches[k] <= 0:
            fail(f"{phase}: {k} launched {launches[k]} times")
    check_prefill_launches(phase, cfg, launches, prefill_kernel)
    print(f"{phase} {cfg.name} swap preemption, 24-block pool: {graph_note(out['measured'])}; "
          f"kv {json.dumps(kv)}; engine "
          f"{json.dumps(out['simulated']['engine'], default=float)}; launches "
          f"{json.dumps(launches)}", flush=True)


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
    # 5a: prefill + 8 decode steps on the paged pool, kernels off vs on
    compare_paths(params, cfg, cfg.replace(decode_attn="paged", pallas_head="off"),
                  cfg.replace(decode_attn="paged-kernel", pallas_head="kernel"), gen,
                  paged_bs=16)
    # 5b: contiguous rows (absorbed plain math, no attention kernel) vs the
    # pool (the paged MLA kernel in every layer)
    launches = serve_paged_vs_contiguous(params, cfg, serve, "5b", None,
                                         "paged_mla_decode_attention", None)
    serve_swap(params, cfg, serve, "5c", SEED + 5, "paged_mla_decode_attention", None)
    return launches, rh, graph_vs_eager(params, cfg, serve, "5d", SEED + 8)


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
    # 6a: prefill (the SSD kernel vs the plain scan) + 8 decode steps, kernels
    # off vs on, on contiguous state rows
    compare_paths(params, cfg, cfg.replace(decode_attn="dense", pallas_head="off"),
                  cfg.replace(decode_attn="kernel", pallas_head="kernel"), gen,
                  off_kw={"ssd_impl": "ref"}, on_kw={"ssd_impl": "kernel"},
                  prefill_kernel="ssd_chunked")
    # 6b: contiguous state rows vs state pages (no decode attention kernel)
    launches = serve_paged_vs_contiguous(params, cfg, serve, "6b", None, None, "ssd_chunked")
    serve_swap(params, cfg, serve, "6c", SEED + 6, None, "ssd_chunked")
    return launches, rh, graph_vs_eager(params, cfg, serve, "6d", SEED + 9)


# ---------------------------------------------------------------------------
# phases 4e, 5d and 6d: one sync window as one CUDA graph replay


def graph_vs_eager(params, cfg, serve, phase, seed):
    """Phases 4e, 5d and 6d. On each layout, two runners over the same
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

    prompts = np.random.default_rng(seed).integers(1, cfg.vocab_size, (8, PAGED_PROMPT))
    act = [2, 5, 8, 11]
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


def main() -> None:
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
    paged_launches = serve_paged_vs_contiguous(params, cfg, serve_generative, "4b",
                                               "decode_attention", "paged_decode_attention",
                                               "flash_attention")
    serve_prefix_swap(params, cfg, serve_generative)
    serve_chunked(params, cfg, serve_generative)
    graphs = {CONFIG: graph_vs_eager(params, cfg, serve_generative, "4e", SEED + 7)}
    lm_launches = lm_token_phase(params, cfg, gen, serve)
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
    resnet_phase(gen, serve)
    gc.collect()
    torch.cuda.empty_cache()
    bert_launches, bert_out = bert_phase(gen, serve)
    print(f"classifier phases done at {time.perf_counter() - t_all:.1f} s", flush=True)

    # -- phase 8: training, once the classifiers' weights are freed
    gc.collect()
    torch.cuda.empty_cache()
    qt_launches, _ = train_qwen_phase(gen)
    gc.collect()
    torch.cuda.empty_cache()
    bt_launches, _ = bert_train_phase(serve, bert_out)
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
               ("flash_attention", fa_bert, bt_launches, "bert-base 8b trained")]
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
    print("window graphs (4e, 5d, 6d): " + json.dumps(
        {name: {"host_ms_per_replayed_window": {lay: v[lay]["host_ms_per_replayed_window"]
                                                for lay in ("contiguous", "paged")},
                "host_ms_per_eager_window": {lay: v[lay]["host_ms_per_eager_window"]
                                             for lay in ("contiguous", "paged")},
                "device_busy_ms_per_window": {lay: v[lay]["device_busy_ms_per_window"]
                                              for lay in ("contiguous", "paged")},
                "served": v["serve"]} for name, v in graphs.items()}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
