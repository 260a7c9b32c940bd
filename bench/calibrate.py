"""The readings a cell's correctness limits are set from, in one process.

  python3 bench/calibrate.py --workload deepseek-v2-lite-16b.decode --seeds 101,102,103 --seconds 20

After one set-up, for each seed: the weights and traffic of that seed on
the same runner (``Session.reseed``), a short window at the cell's own
load, its end-to-end metrics, and the sample of its finished requests
compared as a run compares it: the program's three numbers, the float8
control's (the reference in the program's place at float8, ``check.py``)
and a bfloat16 witness's (the reference with every product in bfloat16). One JSON line a seed on
standard output. The benchmark's own runs never run the control.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run  # noqa: E402  (the caches, paths and process start)


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from bench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    seeds = [int(x) for x in a.seeds.split(",")]
    if not torch.cuda.is_available():
        harness.log("no result: no CUDA card")
        return 2
    cell = harness.load_cell(a.workload)
    s = harness.Session(cell, seeds[0])
    s.setup(run.PROCESS_START)
    harness.log(f"card: {harness.card_line()}; set-up {s.parts}")
    for i, seed in enumerate(seeds):
        if i:
            s.reseed(seed)
        win = s.measure(a.seconds)
        ctx = harness.context(s, win)
        metrics = {m["name"]: harness.reader(m["name"])(ctx) for m in cell.end_to_end}
        out = s.check(win, stand_ins=("fp8", "bf16"))
        print(json.dumps({"seed": seed, "finished": len(win.done), "metrics": metrics,
                          "timings": harness.timings(win.calls), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
