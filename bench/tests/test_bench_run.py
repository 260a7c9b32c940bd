"""The command as the driver runs it: no card, no result; a checkout that
holds only BENCHMARK.json and bench/ cannot run; on a card (``-m gpu``), a
short run prints the result line with every key the contract names."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "deepseek-v2-lite-16b.decode",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_benchmark_files_alone_cannot_run(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from bench import harness; "
            "s = harness.Session(harness.load_cell('deepseek-v2-lite-16b.decode'), 1, device='cpu', "
            "tiny=True); s.setup(0.0); print('ran')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "ran" not in out.stdout
    assert "repro_torch" in out.stderr


@pytest.mark.gpu
def test_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "deepseek-v2-lite-16b.decode",
                          "--seed", "3000000002", "--seconds", "5", "--trace", "1"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    d = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(d)[-1] == "checks" and d["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(d)
    assert d["device"]["platform"] == "gpu" and d["device"]["busy_s"] > 0
    for k, c in d["checks"].items():
        assert f"{k} {c['value']!r} limit {c['limit']!r}" in out.stderr
