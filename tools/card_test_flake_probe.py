"""Run one card test in a pytest process of its own (alone, or with the
whole of its file: ``--whole-file``), in turns in this tree and in an
earlier one (parent, this, this, parent, ...), and count the runs in
which that test failed in each tree: a flaky test's rate at the pytest
level.

  python3 tools/card_test_flake_probe.py --parent DIR [--runs N] [--budget S]
      [--test NODEID] [--whole-file]

DIR holds the earlier tree (``git archive <commit> | tar -x -C DIR``, DIR
under the gitignored ``build/``). Each tree builds its own kernels on its
first run. Prints a line a run and, last, a JSON summary; stops starting
runs once ``--budget`` seconds have gone, after a whole turn of four.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST = "tests/test_torch_gpu.py::test_mla_and_ssd_wrappers_launch_only_their_kernel"


def run_once(tree: str, test: str, whole_file: bool) -> tuple:
    """(the test failed, the other tests that failed, pytest's exit code,
    seconds, the first error line)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          "-m", "gpu", test.split("::")[0] if whole_file else test],
                         cwd=tree, env=env, capture_output=True, text=True)
    failed = [ln.split()[1] for ln in out.stdout.splitlines() if ln.startswith("FAILED ")]
    why = next((ln.strip() for ln in out.stdout.splitlines() if ln.startswith("E ")), "")
    return (test in failed, [f for f in failed if f != test], out.returncode,
            time.perf_counter() - t0, why[:300])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--runs", type=int, default=40, help="runs a tree at most")
    ap.add_argument("--budget", type=float, default=900.0, help="seconds")
    ap.add_argument("--test", default=TEST)
    ap.add_argument("--whole-file", action="store_true", help="run the test's whole file")
    args = ap.parse_args()
    trees = {"parent": os.path.abspath(args.parent), "this": ROOT}
    res = {name: {"runs": 0, "failed": 0, "rc": [], "others_failed": [], "s": [], "why": []}
           for name in trees}
    t0 = time.perf_counter()
    order = ("parent", "this", "this", "parent")
    while res["this"]["runs"] < args.runs and time.perf_counter() - t0 < args.budget:
        for name in order:
            bad, others, rc, s, why = run_once(trees[name], args.test, args.whole_file)
            r = res[name]
            r["runs"] += 1
            r["failed"] += bad
            r["rc"].append(rc)
            r["others_failed"] += others
            r["s"].append(round(s, 2))
            if bad:
                r["why"].append(why)
            print(f"{name} run {r['runs']}: {'FAILED' if bad else 'passed'}, rc {rc}, "
                  f"{s:.1f} s, others failed {others} {why if bad else ''}", flush=True)
    print(json.dumps({"test": args.test, "whole_file": args.whole_file, **res}), flush=True)


if __name__ == "__main__":
    main()
