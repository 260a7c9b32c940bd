"""Dispatcher for prefill attention: the plain version for CPU tensors, the
CUDA kernel for CUDA tensors (it raises rather than fall back)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q, k, v, *, causal=True, window=None, use_kernel=True):
    if not use_kernel or q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}")
    return flash_attention(q, k, v, causal=causal, window=window)
