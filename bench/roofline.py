"""The yardstick's arithmetic: the H100's peaks, the bytes and operations
of each of the port's kernels (#1-#6 of PERF.md's kernel table) and of a
whole step, from the shapes of a call.

A kernel's bound is the larger of its bytes over the HBM rate and its
operations over the dense bf16 rate, with each input read once and each
output written once, and only the positions actually attended counted.
``arch`` is ``shapes.arch``'s dict.
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple

HBM_BW = 3.35e12  # B/s, H100 SXM, NVIDIA's data sheet
PEAK_BF16 = 989e12  # dense bf16 FLOP/s, H100 SXM
BF16, F32 = 2, 4  # bytes an element
VOCAB_PAD = 2048  # the params' vocabulary rows are padded to a multiple of this


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a call that moves ``nbytes`` and does ``flops``."""
    return max(nbytes / HBM_BW, flops / PEAK_BF16)


# -- kernels -------------------------------------------------------------------


def decode_attn(arch: dict, pos: Iterable[int], bs: int = 0) -> Tuple[float, float]:
    """(bytes, flops) of one layer's decode attention over rows at ``pos``
    (keys 0..pos attended): #1 (contiguous, ``bs`` 0) or #5 (paged, a
    table entry read per block walked) for GQA; #6 (paged MLA, absorbed:
    the query in latent space against the latent and rope-key streams) for
    MLA."""
    pos = list(pos)
    B = len(pos)
    nk = sum(p + 1 for p in pos)
    nblk = sum(-(-(p + 1) // bs) for p in pos) if bs else 0
    if arch["mla"]:
        H, r, dr = arch["H"], arch["r"], arch["dr"]
        nbytes = B * H * (r + dr) * BF16 + nk * (r + dr) * BF16 + nblk * 4 + B * 8 \
            + B * H * r * BF16
        return nbytes, nk * H * (2 * (r + dr) + 2 * r)
    H, KH, hd = arch["H"], arch["KH"], arch["hd"]
    nbytes = B * H * hd * BF16 + nk * KH * hd * BF16 * 2 + nblk * 4 + B * 8 + B * H * hd * BF16
    return nbytes, nk * H * hd * 4


def prefill_attn(arch: dict, B: int, S: int) -> Tuple[float, float]:
    """(bytes, flops) of #4, one layer's causal prefill attention of B rows
    of S tokens: q, k, v read and the output written once; q.k and p.v
    over the S (S + 1) / 2 pairs attended."""
    H, KH, hd = arch["H"], arch["KH"], arch["hd"]
    nbytes = BF16 * (2 * B * S * H * hd + 2 * B * KH * S * hd)
    pairs = S * (S + 1) // 2
    return nbytes, 4 * B * H * pairs * hd


def ramp_head(arch: dict, B: int, exit_out: bool = False) -> Tuple[float, float]:
    """(bytes, flops) of #2 (stats) or #3 (``exit_out``: stats and the exit
    bit) over B rows: the (d, V) head read once over the real vocabulary,
    the rows read, 16 bytes of stats a row (and the exit bit's 4)
    written."""
    d, V = arch["d"], arch["V"]
    return d * V * BF16 + B * d * BF16 + B * (16 + (4 if exit_out else 0)), 2.0 * B * d * V


# -- a whole step ----------------------------------------------------------------


def _layer_kinds(arch):
    L = arch["L"]
    mixer = "mla" if arch["mla"] else "attn"
    if not arch["moe"]:
        return [(mixer, "dense")] * L
    k = arch["first_dense"]
    return [(mixer, "dense")] * k + [(mixer, "moe")] * (L - k)


def _mixer_params(arch, mixer):
    """(bf16 elements, f32 elements) of one mixer."""
    d, H = arch["d"], arch["H"]
    if mixer == "mla":
        r, dn, dr, dv = arch["r"], arch["dn"], arch["dr"], arch["dv"]
        return d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) + H * dv * d, r
    KH, hd = arch["KH"], arch["hd"]
    n = d * (H + 2 * KH) * hd + H * hd * d
    if arch["qkv_bias"]:
        n += (H + 2 * KH) * hd
    return n, 0


def _ffn_params(arch, ffn):
    d = arch["d"]
    if ffn == "moe":
        return 3 * arch["E"] * d * arch["ff"] + 3 * d * arch["n_shared"] * arch["ff"], d * arch["E"]
    return 3 * d * arch["d_ff"], 0


def param_bytes(arch: dict) -> dict:
    """Bytes of the params as they are stored, by part: the layers, the
    embedding (and an untied LM head), the final norm and the ramps (a
    gain and a head a site)."""
    layers = 0
    for mixer, ffn in _layer_kinds(arch):
        mb, mf = _mixer_params(arch, mixer)
        fb, ff = _ffn_params(arch, ffn)
        layers += (mb + fb) * BF16 + (mf + ff + 2 * arch["d"]) * F32
    d = arch["d"]
    Vp = -(-arch["V"] // VOCAB_PAD) * VOCAB_PAD
    S = len(arch["sites"])
    return {"layers": layers, "embed": Vp * d * BF16,
            "lm_head": 0 if arch["tie"] else d * Vp * BF16,
            "final_norm": d * F32, "ramps": S * d * F32 + S * d * Vp * BF16}


def kv_row_bytes(arch: dict) -> int:
    """Cache bytes one token leaves in one layer."""
    if arch["mla"]:
        return (arch["r"] + arch["dr"]) * BF16
    return 2 * arch["KH"] * arch["hd"] * BF16


def step_floor(arch: dict, B: int, pos: int, n_active: int) -> dict:
    """The least one decode step of B rows at ``pos`` moves, by part, each
    input read once: the params it reads (all but the inactive ramps and,
    untied, the embedding rows not looked up; every expert, as the dense
    dispatch reads them), the cache rows up to ``pos`` and the new row
    written. ``total`` in bytes, ``ms`` over the HBM rate."""
    p = param_bytes(arch)
    S = len(arch["sites"])
    embed = p["embed"] if arch["tie"] else B * arch["d"] * BF16
    parts = {"layers": p["layers"], "head": embed + p["lm_head"] + p["final_norm"],
             "ramps": p["ramps"] * n_active / S,
             "cache": arch["L"] * B * kv_row_bytes(arch) * (pos + 2)}
    parts["total"] = sum(parts.values())
    parts["ms"] = 1e3 * parts["total"] / HBM_BW
    return parts


def _token_matmul_params(arch):
    """Weights a token's products touch in the layers (the experts its
    routing picks, not every expert)."""
    d, H = arch["d"], arch["H"]
    n = 0
    for mixer, ffn in _layer_kinds(arch):
        if mixer == "mla":
            r, dn, dr, dv = arch["r"], arch["dn"], arch["dr"], arch["dv"]
            n += d * H * (dn + dr) + d * (r + dr) + H * dv * d
            # decode: the query and the context carried into and out of the
            # latent space; prefill: keys and values expanded from it (the
            # same products a token)
            n += H * r * (dn + dv)
        else:
            n += d * (arch["H"] + 2 * arch["KH"]) * arch["hd"] + H * arch["hd"] * d
        if ffn == "moe":
            n += d * arch["E"] + 3 * d * arch["ff"] * (arch["top_k"] + arch["n_shared"])
        else:
            n += 3 * d * arch["d_ff"]
    return n


def _attn_flops_per_key(arch):
    """Operations a query head spends on one attended key."""
    if arch["mla"]:
        return 2 * (arch["r"] + arch["dr"]) + 2 * arch["r"]
    return 4 * arch["hd"]


def decode_flops(arch: dict, pos: Iterable[int], n_active: int) -> float:
    """Operations a decode step needs for rows at ``pos``: the layers'
    products, attention over keys 0..pos, the final head and the active
    ramp heads."""
    pos = list(pos)
    per_tok = 2 * _token_matmul_params(arch) + 2 * arch["d"] * arch["V"] * (1 + n_active)
    keys = sum(p + 1 for p in pos)
    return len(pos) * per_tok + arch["L"] * arch["H"] * _attn_flops_per_key(arch) * keys


def prefill_flops(arch: dict, S: int) -> float:
    """Operations a whole-prompt prefill of S tokens needs: the layers'
    products on every token, causal attention over the S (S + 1) / 2
    pairs (MLA: q.k over the nope and rope widths, p.v over the value
    width), the final head on the last token."""
    pairs = S * (S + 1) // 2
    if arch["mla"]:
        per_pair = 2 * (arch["dn"] + arch["dr"]) + 2 * arch["dv"]
    else:
        per_pair = 4 * arch["hd"]
    return (2 * _token_matmul_params(arch) * S + arch["L"] * arch["H"] * per_pair * pairs
            + 2 * arch["d"] * arch["V"])


def mfu_share(flops: float, seconds: float) -> float:
    """A share of the dense bf16 peak, in %."""
    return 100.0 * flops / (seconds * PEAK_BF16) if seconds > 0 else math.nan
