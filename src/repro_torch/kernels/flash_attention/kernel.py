"""ctypes wrapper of the CUDA prefill attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` replaces the JAX package's Pallas ``flash_attention``:
causal and/or sliding-window attention of Sq queries against Sk keys with
GQA, an online softmax over 64-key tiles in f32 (bf16 on the tensor cores,
float32 on the CUDA cores). It reads q, k and v by
stride, so the model's (B, H, S, hd) views of (B, S, H, hd) projections and
of its (B, S, KH, hd) cache cost no copy, and it writes the output into
(B, Sq, H, hd) storage, returned as a (B, H, Sq, hd) view, so the caller's
``transpose(1, 2).reshape(B, Sq, H * hd)`` is free. Sq and Sk need not be
multiples of the tiles. Launches on PyTorch's current stream, never syncs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import KernelShapeError
from repro_torch.kernels.build import check_launch, load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [_P] * 4 + [_I] * 6 + [_L] * 12 + [ctypes.c_float, _I, _I, _I, _P]
MAX_HD = 256  # Gemma3's head width: the f32 kernel's eight output columns a lane
_MISALIGNED = 716  # cudaErrorMisalignedAddress, returned before any launch
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = load("flash_attention").flash_attention_launch
        fn.argtypes = _ARGS
        fn.restype = _I
        _fn = fn
    return _fn


def _check(what, q, k, v, H, KH, hd, window, on_card=True):
    """Raise the reason q, k and v are refused, if any: not on one card (or,
    ``on_card`` false, not all on meta), dtypes, a strided last dim, a head
    width or grouping the kernel does not take, a window under 1."""
    dev = q.get_device()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if on_card and (not t.is_cuda or t.get_device() != dev):
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {q.device}")
        if not on_card and t.device.type != "meta":
            raise ValueError(f"{what}: {name} must be a meta tensor, beside q")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{what}: {name} dtype {t.dtype}; needs one of "
                             "float32/bfloat16, alike for q, k, v")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim")
    if not (1 <= hd <= MAX_HD and KH >= 1 and H % KH == 0):
        raise KernelShapeError(f"{what}: needs hd <= {MAX_HD} and H a multiple of KH, "
                               f"got hd={hd} H={H} KH={KH}")
    if window is not None and int(window) < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window=None) -> torch.Tensor:
    """q (B, H, Sq, hd); k, v (B, KH, Sk, hd), views with a contiguous last
    dim, one dtype (float32 or bfloat16), on one CUDA device; H a multiple
    of KH, hd <= 256. Query i and key j are positions from 0. Returns
    (B, H, Sq, hd) in q's dtype.

    bfloat16 takes q, k and v through 16-byte copies: each base pointer and
    each batch, head and position stride (of a dim longer than 1) must be a
    multiple of 16 bytes (8 elements), else it raises. The models' (B, H, S,
    hd) views of (B, S, H, hd) storage qualify whenever hd % 8 == 0."""
    what = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    dev = q.get_device()
    _check(what, q, k, v, H, KH, hd, window)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    if B == 0 or Sq == 0 or H == 0:
        return out
    if Sk == 0:
        raise ValueError(f"{what}: no keys to attend to")
    # the raw current stream: torch.cuda.current_stream() builds a Stream
    # object, a few us of host time in a call that launches one ~10 us kernel
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KH, Sq,
                     Sk, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *out.stride()[:3], 1.0 / math.sqrt(hd), int(bool(causal)),
                     0 if window is None else int(window), _DTYPES[q.dtype],
                     torch._C._cuda_getCurrentRawStream(dev))
    if rc == _MISALIGNED:
        raise ValueError(f"{what}: bfloat16 q, k and v need 16-byte aligned bases and "
                         f"strides of multiples of 8 elements, got {q.stride()}, "
                         f"{k.stride()}, {v.stride()}")
    check_launch(rc, what)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window=None) -> torch.Tensor:
    """``flash_attention``'s contract on meta tensors: its checks, the C
    entry point's (bfloat16 strides 16-byte multiples, from strides alone),
    its (B, H, Sq, hd) output view of (B, Sq, H, hd) storage, no launch."""
    what = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    _check(what, q, k, v, H, KH, hd, window, on_card=False)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device="meta").transpose(1, 2)
    if B == 0 or Sq == 0 or H == 0:
        return out
    if Sk == 0:
        raise ValueError(f"{what}: no keys to attend to")
    if B > 65535 or H > 65535:
        raise KernelShapeError(f"{what}: needs B and H <= 65535, got B={B} H={H}")
    if q.dtype == torch.bfloat16 and not all(
            t.shape[i] == 1 or (t.stride(i) * 2) % 16 == 0 for t in (q, k, v) for i in range(3)):
        raise ValueError(f"{what}: bfloat16 q, k and v need 16-byte aligned bases and "
                         f"strides of multiples of 8 elements, got {q.stride()}, "
                         f"{k.stride()}, {v.stride()}")
    return out
