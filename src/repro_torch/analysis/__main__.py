"""CLI: ``python -m repro_torch.analysis [--audit] [--write]``.

Runs the meta-device support audit (no CUDA needed). Exit code 0 iff there
is no ``shape-error`` cell, the statuses equal the reference's committed
``support_matrix.json`` at the repo root but for ``REFERENCE_DIFFERENCES``,
and they match the port's committed snapshot beside this module.
``--write`` regenerates that snapshot (``support_matrix.json`` +
``SUPPORT_MATRIX.md``) instead of diffing it (commit the result).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
MATRIX_MD = "SUPPORT_MATRIX.md"
MATRIX_JSON = "support_matrix.json"
REFERENCE_JSON = HERE.parents[2] / MATRIX_JSON  # the reference's, at the repo root


def run_audit_pass(out_dir: Path, write: bool) -> int:
    from repro_torch.analysis.abstract import (
        audit_all,
        compare_matrices,
        reference_differences,
        render_markdown,
        shape_error_cells,
        to_json,
    )

    t0 = time.perf_counter()
    matrix = audit_all()
    fresh = to_json(matrix)
    bugs = shape_error_cells(matrix)
    for c in bugs:
        print(f"audit: SHAPE-ERROR {c.config} × {c.path}: {c.detail}")
    n_cells = sum(len(v) for v in fresh["configs"].values())
    print(f"audit: {len(fresh['configs'])} configs × {len(fresh['paths'])} paths "
          f"({n_cells} cells) on meta in {time.perf_counter() - t0:.1f} s, "
          f"{len(bugs)} shape-error(s)")
    diffs = reference_differences(json.loads(REFERENCE_JSON.read_text()), fresh)
    for p in diffs:
        print(f"audit: against the reference: {p}")
    print(f"audit: {len(diffs)} unlisted difference(s) from the reference's matrix")
    rc = 1 if (bugs or diffs) else 0

    md_path, json_path = out_dir / MATRIX_MD, out_dir / MATRIX_JSON
    if write:
        md_path.write_text(render_markdown(matrix))
        json_path.write_text(json.dumps(fresh, indent=2, sort_keys=True) + "\n")
        print(f"audit: wrote {md_path} + {json_path.name}")
        return rc
    if not json_path.is_file():
        print(f"audit: no committed {MATRIX_JSON} — run with --write and commit it")
        return 1
    problems = compare_matrices(json.loads(json_path.read_text()), fresh)
    for p in problems:
        print(f"audit: {p}")
    print(f"audit: {len(problems)} drift(s) from the committed snapshot")
    if problems:
        print("audit: matrix drifted — if intended, regenerate with "
              "`python -m repro_torch.analysis --audit --write` and commit")
    return 1 if (rc or problems) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--audit", action="store_true",
                    help="run the meta-device support audit (the only pass; the default)")
    ap.add_argument("--write", action="store_true",
                    help="regenerate the committed matrix snapshots")
    args = ap.parse_args(argv)
    return run_audit_pass(HERE, args.write)


if __name__ == "__main__":
    sys.exit(main())
