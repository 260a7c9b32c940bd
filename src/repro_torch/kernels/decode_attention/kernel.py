"""ctypes wrapper of the CUDA flash-decode kernel (``csrc/decode_attention.cu``).

Replaces the JAX package's Pallas ``decode_attention``. The kernel reads
k and v by stride, so the caller's (B, KH, S, hd) view of a (B, S, KH, hd)
cache costs no copy. Launches on PyTorch's current stream, never syncs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import check_launch, load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    lib = load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 5 + [_L] * 8 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


def _check_16b(name, t):
    if t.data_ptr() % 16 or any((s * t.element_size()) % 16 for s in t.stride()[:-1]):
        raise ValueError(f"decode_attention: {name} rows must be 16-byte aligned "
                         f"(strides {t.stride()})")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos) -> torch.Tensor:
    """q (B, H, hd); k, v (B, KH, S, hd) views with a contiguous last dim;
    pos an int or an int (B,) tensor (attend to key slots <= pos).
    Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    KH, S = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be a CUDA tensor on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"decode_attention: {name} dtype {t.dtype}; needs one of "
                             "float32/bfloat16, alike for q, k, v")
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name} needs a contiguous last dim")
    if hd not in (64, 128) or KH == 0 or H % KH or H // KH > 8:
        raise ValueError(f"decode_attention: needs hd in (64, 128) and H/KH <= 8, "
                         f"got hd={hd} H={H} KH={KH}")
    _check_16b("k", k)
    _check_16b("v", v)
    if torch.is_tensor(pos):
        pos = pos.to(device=q.device, dtype=torch.int32).reshape(-1).expand(B).contiguous()
    else:
        pos = torch.full((B,), int(pos), dtype=torch.int32, device=q.device)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    fn = _fn()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, H, KH, S, hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
