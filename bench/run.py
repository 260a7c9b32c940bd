"""Run one cell of the port's benchmark once, on the card of this machine.

  python3 bench/run.py --workload deepseek-v2-lite-16b.decode --seed 7 --seconds 40 --trace 0

Measures ``repro_torch`` (found under ``src/`` beside this folder) serving
the cell's backlog, and prints, as the last line of its standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; ``checks`` last,
each compared number beside its limit. Standard error carries the parts of
set-up, the card, the windows by kind, the ramp sets seen and, last, the
compared numbers. Exits non-zero, with no result, without a CUDA card, or
if JAX or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The wall time this process started (``/proc``), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_START = _process_start()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"  # every build and kernel cache, inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
# one process with few threads: the host's CPU is shared, and idle worker
# threads of the BLAS and OpenMP pools only contend with the serving thread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    t = time.perf_counter()
    import torch

    from bench import harness, tracing

    log = harness.log
    cell = harness.load_cell(a.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import_s = time.perf_counter() - t

    card = harness.card_line()
    s = harness.Session(cell, a.seed)
    s.setup(PROCESS_START, trace=bool(a.trace))
    s.parts["imports"] += import_s
    log(f"card: {card}")
    log("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in s.parts.items())
        + f"; setup_s {s.setup_s:.3f} s; warm-up windows by kind {s.warm_kinds}")

    win = s.measure(a.seconds, trace=bool(a.trace))
    ctx = harness.context(s, win)
    steps = [c for c in win.calls if c["kind"] == "step"]
    kinds = {k: sum(1 for c in steps if c["graph"] == k) for k in sorted({c["graph"] for c in steps})}
    acts = sorted({c["act"] for c in steps})
    tpot = sorted(1e3 * (r["t_last"] - r["t_first"]) / (r["n"] - 1) for r in win.done if r["n"] > 1)
    n_tpot = len(tpot)
    log(f"window: {win.t_close - win.t_open:.3f} s, {len(steps)} windows by kind {kinds}, "
        f"{sum(1 for c in win.calls if c['kind'] == 'start')} prefills, "
        f"{sum(c['tokens'] for c in win.calls)} tokens, {len(win.done)} requests finished "
        f"({n_tpot} in tpot_p95_ms); active ramp sets seen {[list(x) for x in acts]}")
    log(f"timings: {harness.timings(win.calls)}")
    if tpot:
        log("tpot ms by percentile: " + ", ".join(
            f"p{q} {harness.percentile(tpot, q):.3f}" for q in (50, 90, 95, 99)))

    metrics = {}
    for m in (cell.per_layer if a.trace else cell.end_to_end):
        v = harness.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": win.peak_bytes}
    out = {}
    if a.trace:
        st = win.stretch
        device["busy_s"] = tracing.busy_ns(st) / 1e9 if st else 0.0
        device["window_s"] = (st.t1_ns - st.t0_ns) / 1e9 if st else 0.0
        if st:
            out["breakdown"] = tracing.breakdown(st)
            log(f"trace: {len(st.calls)} calls, {len(st.dev)} device operations over "
                f"{device['window_s']:.3f} s, {device['busy_s']:.3f} s busy")

    s.release()
    t = time.perf_counter()
    chk = s.check(win)
    counts = chk["counts"]
    log(f"check: {counts['requests']} requests, {counts['tokens']} tokens, "
        f"{counts['ramp_records']} ramp records against the reference in "
        f"{time.perf_counter() - t:.3f} s")
    checks = harness.compared(chk)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    bad = harness.forbidden_modules()
    if bad:
        log(f"no result: JAX or the JAX package is loaded: {bad}")
        return 3
    attempted = sum(1 for c in win.calls if c["kind"] == "start")
    out = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
           "device": device, **out, "checks": checks}
    for k, c in checks.items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
