"""Dispatchers for flash-decode, contiguous and paged, and for the paged MLA
latent decode: the plain version for CPU tensors, the CUDA kernel for CUDA
tensors (it raises rather than fall back)."""
from __future__ import annotations

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention,
    paged_decode_attention,
    paged_mla_decode_attention,
)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
    paged_mla_decode_attention_ref,
)


def attend_decode(q, k, v, pos, *, use_kernel=True):
    refuse_autograd("attend_decode", q, k, v)
    if not use_kernel or q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos)
    if q.device.type != "cuda":
        raise ValueError(f"attend_decode: no kernel for device {q.device}")
    return decode_attention(q, k, v, pos)


def attend_decode_paged(q, k_pool, v_pool, block_table, pos, *, use_kernel=True):
    refuse_autograd("attend_decode_paged", q, k_pool, v_pool)
    if not use_kernel or q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_table, pos)
    if q.device.type != "cuda":
        raise ValueError(f"attend_decode_paged: no kernel for device {q.device}")
    return paged_decode_attention(q, k_pool, v_pool, block_table, pos)


def attend_decode_paged_mla(q_lat, q_pe, c_pool, kpe_pool, block_table, pos, *, scale):
    refuse_autograd("attend_decode_paged_mla", q_lat, q_pe, c_pool, kpe_pool)
    if q_lat.device.type == "cpu":
        return paged_mla_decode_attention_ref(q_lat, q_pe, c_pool, kpe_pool, block_table,
                                              pos, scale=scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"attend_decode_paged_mla: no kernel for device {q_lat.device}")
    return paged_mla_decode_attention(q_lat, q_pe, c_pool, kpe_pool, block_table, pos,
                                      scale=scale)
