#!/usr/bin/env python3
"""Time the paged MLA decode kernel (#6 ``paged_mla_decode_attention``) and
the SSD chunk scan (#7 ``ssd_chunked``) against an earlier tree's on one
NVIDIA GPU, and sweep #6's key-range count.

  python3 tools/mla_ssd_probe.py --parent DIR

``DIR`` is a copy of an earlier tree (``git archive <commit> | tar -x -C
DIR``) whose ``csrc/paged_mla_decode.cu`` has the int32-pos C interface with
a separate merge kernel and whose ``csrc/ssd_chunked.cu`` has the same C
interface as this tree's. Both are built with nvcc into ``build/probe/``.
At chip_smoke.py's rows (#6: B 8, 10 blocks, pos 120..159 and B 32, 256
blocks, pos 0..4095, bs 16, H 16, r 512, dr 64; #7: B 1, H 80, S 128 and
4096, and 6a's prefill at B 8, S 128; hp 64, N 128; bf16) it prints each
kernel's time on the device alone (chip_smoke.py's ``device_ms``) in turns
(parent, tree, tree, parent) and the counted bytes over each time. Then #6
at split counts around the planned one, through the C entry point with the
split given: what the merge costs as the ranges grow; and, at B 32, a few
split counts over 8 draws of pos with the live CTAs of each (ranges that
hold keys): where they pass one wave, the walk takes a second.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import HBM_BW, card_line, device_ms, fail  # noqa: E402

H, R, DR, BS = 16, 512, 64, 16
SCALE = 1.0 / 192 ** 0.5
MLA_ROWS = [("B=8 nb=10 pos 120..159", 8, 10, 120, 160),
            ("B=32 nb=256 pos 0..4095", 32, 256, 0, 4096)]
SSD_ROWS = [("B=1 H=80 S=128", 1, 128), ("B=1 H=80 S=4096", 1, 4096), ("B=8 H=80 S=128", 8, 128)]
P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build_parent(cu: Path) -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    digest = hashlib.sha256(cu.read_bytes()).hexdigest()[:12]
    out = ROOT / "build" / "probe" / f"parent-{cu.stem}-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(cu)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            fail(f"parent build failed:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(out))


def mla_row(gen, B, nb, lo, hi):
    dt = torch.bfloat16
    P = B * nb + 1
    q_lat = torch.randn(B, H, R, generator=gen, device="cuda").to(dt)
    q_pe = torch.randn(B, H, DR, generator=gen, device="cuda").to(dt)
    c_pool = torch.randn(P, BS, R, generator=gen, device="cuda").to(dt)
    kpe_pool = torch.randn(P, BS, DR, generator=gen, device="cuda").to(dt)
    table = ((torch.randperm(P - 1, generator=gen, device="cuda") + 1)
             .reshape(B, nb).to(torch.int32))
    pos = torch.randint(lo, hi, (B,), generator=gen, device="cuda")  # int64
    return q_lat, q_pe, c_pool, kpe_pool, table, pos


def mla_bytes(B, nb, pos):
    """q read, out written, each attended key's latent and rope key read
    once, the table entries the walk reads, int64 pos."""
    nk = torch.clamp(pos, max=nb * BS - 1) + 1
    nblk = ((nk + BS - 1) // BS).sum().item()
    return 2 * B * H * (R + DR) + nk.sum().item() * (R + DR) * 2 + nblk * 4 + B * 8 \
        + 2 * B * H * R


def parent_mla(lib, n_sm):
    """The parent's call: int32 pos, one CTA an SM, a second merge kernel."""
    fn = lib.paged_mla_decode_attention_launch
    fn.argtypes = [P_] * 8 + [I_] * 8 + [L_] * 8 + [ctypes.c_float, I_, P_]

    def call(q_lat, q_pe, c_pool, kpe_pool, table, pos):
        B, nb = table.shape
        tiles = -(-nb * BS // 32)
        want = max(1, min(tiles, n_sm // B))
        splits = -(-tiles // -(-tiles // want))
        part = torch.empty(B * splits * H * (R + 2), dtype=torch.float32, device="cuda")
        out = torch.empty(B, H, R, dtype=q_lat.dtype, device="cuda")
        rc = fn(q_lat.data_ptr(), q_pe.data_ptr(), c_pool.data_ptr(), kpe_pool.data_ptr(),
                table.data_ptr(), pos.to(torch.int32).data_ptr(), out.data_ptr(),
                part.data_ptr(), B, H, R, DR, c_pool.shape[0], BS, nb, splits,
                *q_lat.stride()[:2], *q_pe.stride()[:2], *c_pool.stride()[:2],
                *kpe_pool.stride()[:2], SCALE, 1, torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"parent MLA launch returned CUDA error {rc}")
        return out
    return call


def tree_mla_at(splits):
    """This tree's kernel through its C entry point with the split given."""
    from repro_torch.kernels.decode_attention import kernel as K

    def call(q_lat, q_pe, c_pool, kpe_pool, table, pos):
        B, nb = table.shape
        dev = q_lat.get_device()
        stream = torch._C._cuda_getCurrentRawStream(dev)
        part = K._workspace(dev, stream, 0, B * splits * (H * R + 2 * K.MLA_MAX_HEADS))[1]
        out = torch.empty(B, H, R, dtype=q_lat.dtype, device="cuda")
        rc = K._fn("paged_mla_decode_attention_launch")(
            q_lat.data_ptr(), q_pe.data_ptr(), c_pool.data_ptr(), kpe_pool.data_ptr(),
            table.data_ptr(), pos.data_ptr(), out.data_ptr(), part, B, H, R, DR,
            c_pool.shape[0], BS, nb, splits, *q_lat.stride()[:2], *q_pe.stride()[:2],
            *c_pool.stride()[:2], *kpe_pool.stride()[:2], table.stride(0), pos.stride(0), 0, 1,
            SCALE, 1, stream)
        if rc:
            fail(f"MLA launch at {splits} splits returned CUDA error {rc}")
        return out
    return call


def in_turns(fns):
    got = {"parent": [], "tree": []}
    for name in ("parent", "tree", "tree", "parent"):
        got[name].append(device_ms(fns[name]))
    return got


def run_mla(parent, gen, n_sm):
    from repro_torch.kernels.decode_attention import (
        paged_mla_decode_attention,
        paged_mla_decode_attention_ref,
    )
    from repro_torch.kernels.decode_attention.kernel import MLA_TILE, mla_launch_info

    old = parent_mla(parent, n_sm)
    for label, B, nb, lo, hi in MLA_ROWS:
        args = mla_row(gen, B, nb, lo, hi)
        ref = paged_mla_decode_attention_ref(*args, scale=SCALE).float()
        fns = {"tree": lambda: paged_mla_decode_attention(*args, scale=SCALE),  # noqa: B023
               "parent": lambda: old(*args)}  # noqa: B023
        for name, fn in fns.items():
            err = (fn().float() - ref).abs().max().item()
            if err > 2e-2:
                fail(f"#6 {label}: {name} max abs err {err}")
        got = in_turns(fns)
        nbytes = mla_bytes(B, nb, args[5])
        info = mla_launch_info(torch.bfloat16, B, H, R, DR, BS, nb)
        print("mla " + json.dumps({
            "row": label, "device_ms": got["tree"], "parent_device_ms": got["parent"],
            "tb_per_s": nbytes / min(got["tree"]) / 1e9,
            "parent_tb_per_s": nbytes / min(got["parent"]) / 1e9,
            "bound_ms": 1e3 * nbytes / HBM_BW, **info}), flush=True)
        # the split sweep: the planned count, fewer and more
        tiles = -(-nb * BS // MLA_TILE)
        counts = sorted({s for s in (1, 2, 3, 4, 5, 6, 8, 10, 13, 16, 20, 26, 32, 43, 64)
                         if s <= tiles and -(-tiles // -(-tiles // s)) == s})
        sweep = {}
        for s in counts:
            fn = tree_mla_at(s)
            err = (fn(*args).float() - ref).abs().max().item()
            if err > 2e-2:
                fail(f"#6 {label} at {s} splits: max abs err {err}")
            sweep[s] = device_ms(lambda: fn(*args))  # noqa: B023
        print("mla_sweep " + json.dumps({"row": label, "planned": info["splits"],
                                         "device_ms_by_splits": sweep}), flush=True)
        del args, fns
        torch.cuda.empty_cache()
    for d in range(8):  # B 32 x 4096 keys: split counts over draws of pos
        B, nb = 32, 256
        args = mla_row(gen, B, nb, 0, 4096)
        nk = torch.clamp(args[5], max=nb * BS - 1) + 1
        row = {}
        for s in (10, 13, 16, 20):
            chunk = -(-(-(-nb * BS // MLA_TILE)) // s) * MLA_TILE
            fn = tree_mla_at(s)
            row[s] = {"device_ms": device_ms(lambda: fn(*args)),  # noqa: B023
                      "live_ctas": int(((nk + chunk - 1) // chunk).sum())}
        print("mla_draw " + json.dumps({"draw": d, "max_keys": int(nk.max()),
                                        "by_splits": row}), flush=True)
        del args
        torch.cuda.empty_cache()


def run_ssd(parent, gen):
    from repro_torch.kernels.ssd import ssd, ssd_chunked
    from repro_torch.kernels.ssd.kernel import ssd_launch_info

    fn = parent.ssd_chunked_launch
    fn.argtypes = [P_] * 7 + [I_] * 5 + [L_] * 13 + [I_, P_]

    def old(x, dts, A, Bm, Cm):
        B, Hh, S, hp = x.shape
        y = torch.empty(B, S, Hh, hp, dtype=torch.float32, device="cuda").transpose(1, 2)
        st = torch.empty(B, Hh, hp, Bm.shape[2], dtype=torch.float32, device="cuda")
        rc = fn(x.data_ptr(), dts.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                y.data_ptr(), st.data_ptr(), B, Hh, S, hp, Bm.shape[2], *x.stride()[:3],
                *dts.stride(), *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3], 1,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"parent SSD launch returned CUDA error {rc}")
        return y, st

    Hh, hp, N = 80, 64, 128
    for label, B, S in SSD_ROWS:
        dt = torch.bfloat16
        x = torch.randn(B, S, Hh, hp, generator=gen, device="cuda").to(dt).transpose(1, 2)
        dts = torch.nn.functional.softplus(
            torch.randn(B, S, Hh, generator=gen, device="cuda") - 2).transpose(1, 2)
        A = -torch.exp(torch.rand(Hh, generator=gen, device="cuda") * 2.7726)
        Bm = torch.randn(B, S, N, generator=gen, device="cuda").to(dt)
        Cm = torch.randn(B, S, N, generator=gen, device="cuda").to(dt)
        args = (x, dts, A, Bm, Cm)
        y_ref, st_ref = ssd(*args, use_kernel=False)
        fns = {"tree": lambda: ssd_chunked(*args), "parent": lambda: old(*args)}  # noqa: B023
        for name, f in fns.items():
            y, st = f()
            for a, r in ((y, y_ref), (st, st_ref)):
                if not torch.allclose(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max())):
                    fail(f"#7 {label}: {name} off by {(a - r).abs().max().item()}")
        got = in_turns(fns)
        nbytes = 2 * (x.numel() + Bm.numel() + Cm.numel()) + 4 * (dts.numel() + Hh) \
            + 4 * (y_ref.numel() + st_ref.numel())
        print("ssd " + json.dumps({
            "row": label, "device_ms": got["tree"], "parent_device_ms": got["parent"],
            "tb_per_s": nbytes / min(got["tree"]) / 1e9,
            "parent_tb_per_s": nbytes / min(got["parent"]) / 1e9,
            "bound_ms": 1e3 * nbytes / HBM_BW, **ssd_launch_info(dt, B, Hh, hp, N)}),
            flush=True)
        del args, fns
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of a copy of an earlier tree")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        fail("needs a CUDA card")
    print(card_line(), flush=True)
    csrc = Path(a.parent) / "src/repro_torch/kernels/csrc"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    run_mla(build_parent(csrc / "paged_mla_decode.cu"), gen, n_sm)
    run_ssd(build_parent(csrc / "ssd_chunked.cu"), gen)


if __name__ == "__main__":
    main()
