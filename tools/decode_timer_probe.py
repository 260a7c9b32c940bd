#!/usr/bin/env python3
"""What chip_smoke.py's first timed kernel row reads: #1 ``decode_attention``
at qwen2-1.5b's served load (B 8, S 162, pos 128..161, H 12, KH 2, hd 128,
bf16), the first row the script times, measured in a fresh process right
after the kernels are built, as the script measures it.

  python3 tools/decode_timer_probe.py

It times the row (chip_smoke.py's ``check_decode_attention``: ``time_ms``
with the L2 flushed before each launch, ``device_ms`` on the device alone,
``host_us``) three times back to back, reading the card's SM clock
(``nvidia-smi``) before each, then once more after a 2 s device spin has
held the card busy. A first ``time_ms`` far above the later ones while
``device_ms`` stays put says the first timing reads the card coming out
of idle, not the kernel.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import _head_start, card_line, check_decode_attention, fail  # noqa: E402


def sm_clock() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def main() -> None:
    if not torch.cuda.is_available():
        fail("needs an NVIDIA GPU")
    from repro_torch.kernels import build

    print(card_line(), flush=True)
    build.build(["decode_attention"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for i in range(4):
        if i == 3:  # the card held busy for 2 s first
            _head_start(2000.0)
            torch.cuda.synchronize()
        clock = sm_clock()
        r = check_decode_attention(8, 162, f"probe {i}", gen, pos_lo=128)
        rows.append({"run": i, "after_spin": i == 3, "clocks_before (sm, mem, power)": clock,
                     "ms": r["ms"], "device_ms": r["device_ms"], "host_us": r["host_us"],
                     "library_ms": r["library_ms"], "plain_ms": r["plain_ms"]})
    print("decode timer probe: " + json.dumps(rows), flush=True)


if __name__ == "__main__":
    main()
