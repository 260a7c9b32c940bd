"""Dispatcher for flash-decode: the plain version for CPU tensors, the CUDA
kernel for CUDA tensors (it raises rather than fall back)."""
from __future__ import annotations

from repro_torch.kernels.decode_attention.kernel import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def attend_decode(q, k, v, pos, *, use_kernel=True):
    if not use_kernel or q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos)
    if q.device.type != "cuda":
        raise ValueError(f"attend_decode: no kernel for device {q.device}")
    return decode_attention(q, k, v, pos)
