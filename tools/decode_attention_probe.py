#!/usr/bin/env python3
"""Time the flash-decode kernels (#1 ``decode_attention``, #5
``paged_decode_attention``) against an earlier tree's on one NVIDIA GPU.

  python3 tools/decode_attention_probe.py --parent DIR

``DIR`` is a copy of an earlier tree (``git archive <commit> | tar -x -C
DIR``) whose ``src/repro_torch/kernels/csrc/decode_attention.cu`` has the
one-CTA-per-(row, KV head) C interface (int32 pos, no key split). It is
built with nvcc into ``build/probe/`` and called through that interface;
this tree's kernels are called through their public wrappers. At
chip_smoke.py's decode rows (B 8, S 162, pos 128..161; B 32, S 4096; paged
B 8, 10 blocks and B 32, 256 blocks of 16; H 12, KH 2, hd 128, bf16) it
prints, for each row, both kernels' time on the device alone
(chip_smoke.py's ``device_ms``) in turns (parent, tree, tree, parent), the
counted bytes over each time, and the tree's split count and CTAs an SM.
Then a scaling probe of the parent: full 4096-key rows for 1..66 rows, so
2..132 CTAs: where the time holds still as CTAs are added, each CTA is
bound by its own latency and issue, not by the card's bytes.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import HBM_BW, card_line, device_ms, fail  # noqa: E402

H, KH, HD, BS = 12, 2, 128, 16
ROWS = [  # (label, paged, B, S or nb, pos_lo, pos_hi)
    ("B=8 S=162 pos 128..161", False, 8, 162, 128, 162),
    ("B=32 S=4096 pos 0..4095", False, 32, 4096, 0, 4096),
    ("paged B=8 nb=10 bs=16 pos 120..159", True, 8, 10, 120, 160),
    ("paged B=32 nb=256 bs=16 pos 0..4095", True, 32, 256, 0, 4096),
]


def build_parent(cu: Path) -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    out = ROOT / "build" / "probe" / f"parent-{hashlib.sha256(cu.read_bytes()).hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(cu)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            fail(f"parent build failed:\n{r.stdout}{r.stderr}")
        print("parent ptxas:", flush=True)
        for ln in (r.stdout + r.stderr).splitlines():
            if "registers" in ln or "entry function" in ln or "spill" in ln:
                print("  " + ln.strip(), flush=True)
    lib = ctypes.CDLL(str(out))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attention_launch.argtypes = [P] * 5 + [I] * 5 + [L] * 8 + [ctypes.c_float, I, P]
    lib.paged_decode_attention_launch.argtypes = ([P] * 6 + [I] * 7 + [L] * 8
                                                  + [ctypes.c_float, I, P])
    return lib


def parent_call(lib, paged, r, pos32):
    """One launch through the parent's C interface."""
    q, k, v = r["q"], r["k"], r["v"]
    B = q.shape[0]
    out = torch.empty_like(q)
    st = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / math.sqrt(HD)
    if paged:
        t = r["table"]
        rc = lib.paged_decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), t.data_ptr(), pos32.data_ptr(),
            out.data_ptr(), B, H, KH, k.shape[0], k.shape[1], t.shape[1], HD, q.stride(0),
            q.stride(1), *k.stride()[:3], *v.stride()[:3], scale, 1, st)
    else:
        rc = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos32.data_ptr(), out.data_ptr(), B, H,
            KH, k.shape[2], HD, q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
            scale, 1, st)
    if rc != 0:
        fail(f"parent launch returned CUDA error {rc}")
    return out


def make_row(gen, paged, B, n, pos_lo, pos_hi):
    dt = torch.bfloat16
    q = torch.randn(B, H, HD, generator=gen, device="cuda").to(dt)
    pos = torch.randint(pos_lo, pos_hi, (B,), generator=gen, device="cuda")  # int64
    if not paged:
        kc = torch.randn(B, n, KH, HD, generator=gen, device="cuda").to(dt)
        vc = torch.randn(B, n, KH, HD, generator=gen, device="cuda").to(dt)
        return dict(q=q, k=kc.transpose(1, 2), v=vc.transpose(1, 2), pos=pos, S=n)
    P_ = B * n + 1
    k_pool = torch.randn(P_, BS, KH, HD, generator=gen, device="cuda").to(dt)
    v_pool = torch.randn(P_, BS, KH, HD, generator=gen, device="cuda").to(dt)
    table = ((torch.randperm(P_ - 1, generator=gen, device="cuda") + 1)
             .reshape(B, n).to(torch.int32))
    return dict(q=q, k=k_pool, v=v_pool, pos=pos, table=table, S=n * BS)


def row_bytes(r):
    """q read, out written, the keys each row attends to read once in K and
    V, int64 pos (the table's entries are left out: under 0.1%)."""
    B = r["q"].shape[0]
    nk = (torch.clamp(r["pos"], max=r["S"] - 1) + 1).sum().item()
    return r["q"].numel() * 2 * 2 + nk * KH * HD * 2 * 2 + B * 8


def run_rows(parent, gen):
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
        paged_decode_attention,
        paged_decode_attention_ref,
    )
    from repro_torch.kernels.decode_attention.kernel import decode_launch_info

    for label, paged, B, n, lo, hi in ROWS:
        r = make_row(gen, paged, B, n, lo, hi)
        q, k, v, pos = r["q"], r["k"], r["v"], r["pos"]
        if paged:
            def tree():
                return paged_decode_attention(q, k, v, r["table"], pos)
            ref = paged_decode_attention_ref(q, k, v, r["table"], pos)
        else:
            def tree():
                return decode_attention(q, k, v, pos)
            ref = decode_attention_ref(q, k, v, pos)
        pos32 = pos.to(torch.int32)
        fns = {"tree": tree, "parent": lambda: parent_call(parent, paged, r, pos32)}  # noqa: B023
        for name, fn in fns.items():
            err = (fn().float() - ref.float()).abs().max().item()
            if err > 2e-2:
                fail(f"{label}: {name} max abs err {err}")
        got = {"parent": [], "tree": []}
        for name in ("parent", "tree", "tree", "parent"):
            got[name].append(device_ms(fns[name]))
        nbytes = row_bytes(r)
        info = decode_launch_info(torch.bfloat16, B, H, KH, r["S"], HD, paged=paged,
                                  bs=BS if paged else 1)
        row = {"row": label, "device_ms": got["tree"], "parent_device_ms": got["parent"],
               "gb_per_s": nbytes / min(got["tree"]) / 1e6,
               "parent_gb_per_s": nbytes / min(got["parent"]) / 1e6,
               "bound_ms": 1e3 * nbytes / HBM_BW, "parent_ctas": B * KH, **info}
        print("row " + json.dumps(row), flush=True)
        del r, fns
        torch.cuda.empty_cache()


def scaling_probe(parent, gen):
    """Full 4096-key rows (pos = 4095) for B rows: 2 B CTAs of the parent."""
    S = 4096
    for B in (1, 2, 4, 8, 16, 33, 66):
        r = make_row(gen, False, B, S, S - 1, S)
        pos32 = r["pos"].to(torch.int32)
        ms = device_ms(lambda: parent_call(parent, False, r, pos32))  # noqa: B023
        nbytes = row_bytes(r)
        print("scaling " + json.dumps({"B": B, "ctas": B * KH, "device_ms": ms,
                                       "gb_per_s": nbytes / ms / 1e6,
                                       "gb_per_s_per_cta": nbytes / ms / 1e6 / (B * KH)}),
              flush=True)
        del r
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of a copy of an earlier tree")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        fail("needs a CUDA card")
    print(card_line(), flush=True)
    parent = build_parent(Path(a.parent) / "src/repro_torch/kernels/csrc/decode_attention.cu")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    run_rows(parent, gen)
    scaling_probe(parent, gen)


if __name__ == "__main__":
    main()
