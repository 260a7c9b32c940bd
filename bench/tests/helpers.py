"""Shared pieces of the benchmark's CPU tests: a cell served on the CPU at
a small size by the port's plain versions of its kernels."""
from __future__ import annotations

import atexit
import dataclasses
import functools
import json
import shutil
import tempfile
from pathlib import Path

from bench import harness

# a cell held out of BENCHMARK.json whose files stay under bench/: qwen2's
# decode cell, out for the host-bound spread of its runs (PERF.md). The
# tests load, serve and check it as they do the manifest's cells.
HELD = {
    "configs": [{"name": "qwen2-1.5b", "source": "https://huggingface.co/Qwen/Qwen2-1.5B",
                 "file": "bench/configs/qwen2-1.5b.json", "reduced": [],
                 "why": "dense GQA with q/k/v biases and a tied vocabulary"}],
    "workloads": [{"name": "qwen2-1.5b.decode", "config": "qwen2-1.5b",
                   "traffic": "azure-conv.p1024.o32-512", "chips": 1,
                   "why": "Azure conversation lengths (Splitwise, arXiv:2311.18677)"}],
}
CELLS = tuple(w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())
              ["workloads"] + HELD["workloads"])


@functools.lru_cache(maxsize=None)
def _root() -> Path:
    """A root whose BENCHMARK.json is the manifest with ``HELD`` added and
    whose bench/ is this one."""
    man = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for key, entries in HELD.items():
        man[key] = man[key] + entries
    root = Path(tempfile.mkdtemp(prefix="bench-cells-"))
    atexit.register(shutil.rmtree, root, True)
    (root / "bench").symlink_to(harness.ROOT / "bench")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def load_cell(name: str):
    """The cell ``name``, of the manifest or held out of it."""
    return harness.load_cell(name, root=_root())

# a small run of the cell's mix, at sizes the CPU holds; the window serves
# the whole backlog (a fixed amount of work, whatever the machine's speed)
# and closes when it runs dry
SMALL_MIX = {"slots": 4, "prompt_len": 16}
SMALL_SETTINGS = {"backlog": 24, "block": 8,
                  "warmup": {"requests": 8, "windows": 4, "max_s": 0.3}}


def small_cell(name: str, **mix):
    cell = load_cell(name)
    lo = 3 if cell.mix["output"]["lo"] < 100 else 6
    cell.mix = {**cell.mix, **SMALL_MIX,
                "output": {**cell.mix["output"], "lo": lo, "hi": 3 * lo},
                "check": {**cell.mix["check"], "min_tokens": 40}, **mix}
    return cell


def widen(monkeypatch, d: int = 256, vocab: int = 4096):
    """Serve the port's TINY configs at width ``d``, vocabulary ``vocab`` and
    the published depth, so the random model's logits spread, and depend on
    the context, as the full size's do."""
    import repro_torch.configs as configs

    tiny = configs.get_tiny

    def get(name):
        return dataclasses.replace(tiny(name), d_model=d, vocab_size=vocab,
                                   n_layers=configs.get_config(name).n_layers)

    monkeypatch.setattr(configs, "get_tiny", get)


def serve(cell, seed: int = 7, seconds: float = 600.0, stand_ins=()):
    """Set up, serve a window and check it, on the CPU. Returns (session,
    window, check)."""
    s = harness.Session(cell, seed, device="cpu", tiny=True)
    s.settings.update(SMALL_SETTINGS)
    s.setup(process_start=harness.time.time())
    win = s.measure(seconds)
    return s, win, s.check(win, stand_ins=stand_ins)


def correct(chk) -> bool:
    return all(c["value"] <= c["limit"] for c in harness.compared(chk).values())
