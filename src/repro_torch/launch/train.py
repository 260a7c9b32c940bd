"""Training launcher of the port (the counterpart of the JAX package's
``launch/train.py``), on the CUDA card unless ``--device cpu``: ramp-only
or full training of a config's model from ``--seed``, checkpoint/restart
(atomic, async) and deterministic resumable data (``TokenPipeline``'s
batch of step s is the same whether or not the run was restarted).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --mode ramps_only --steps 8 --batch 4 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch tiny:qwen2-1.5b \\
      --device cpu --steps 100 --ckpt-dir CKPT --ckpt-every 20 [--resume]

Checkpoints are in the JAX package's format (``checkpoint/manager.py``),
so either package resumes the other's.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_tiny
from repro_torch.data import TokenPipeline
from repro_torch.launch.serve import _cuda_or_cpu
from repro_torch.models import build_model
from repro_torch.training import TrainConfig, init_state, make_train_step


def resolve_cfg(spec: str):
    if spec.startswith("tiny:"):
        return get_tiny(spec[5:])
    return get_config(spec)


def main(argv=None, history=None):
    """Parse ``argv``, train, return the final state. ``history`` (a list),
    when given, receives one dict a step: step, loss, ramp_loss, lm_loss,
    grad_norm and ms (CUDA events on a card, the host clock on the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, help="e.g. qwen2-1.5b or tiny:qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mode", default="full", choices=["full", "ramps_only"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = _cuda_or_cpu(args.device, "train")
    cfg = resolve_cfg(args.arch)
    model = build_model(cfg)
    tcfg = TrainConfig(steps=args.steps, lr=args.lr, train_mode=args.mode, seed=args.seed,
                       checkpoint_every=args.ckpt_every)
    step_fn, opt_cfg = make_train_step(model, tcfg)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    start = 0
    state = None
    if args.resume and mgr is not None and mgr.latest_step() is not None:
        state = mgr.restore(device=device)
        start = int(state["step"])
        print(f"resumed from step {start}")
    if state is None:
        state = init_state(model, args.seed, opt_cfg, device=device)

    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    on_card = device.type == "cuda"
    marks = []
    t0 = time.perf_counter()
    for s in range(start, args.steps):
        batch = pipe.batch_at(s)  # deterministic: resume == never-crashed
        if on_card:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        else:
            ev = time.perf_counter()
        state, out = step_fn(state, batch)
        if on_card:
            ev[1].record()
        else:
            ev = (ev, time.perf_counter())
        marks.append((s, ev, out))
        if s % max(args.steps // 10, 1) == 0 or s == args.steps - 1:
            print(f"step {s:5d} loss {float(out['loss']):.4f}", flush=True)
        if mgr is not None and args.ckpt_every and (s + 1) % args.ckpt_every == 0:
            mgr.save_async(state, step=s + 1)
    if mgr is not None:
        mgr.wait()
        mgr.save(state, step=args.steps)
    if on_card:
        torch.cuda.synchronize(device)
    print(f"done: {args.steps - start} steps in {time.perf_counter() - t0:.1f}s")
    if history is not None:
        for s, ev, out in marks:
            ms = ev[0].elapsed_time(ev[1]) if on_card else 1e3 * (ev[1] - ev[0])
            history.append({"step": s, "ms": ms, **{k: float(v) for k, v in out.items()}})
    return state


if __name__ == "__main__":
    main()
