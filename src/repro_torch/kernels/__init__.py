"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""
from __future__ import annotations

import torch


def refuse_autograd(what: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad. A kernel
    returns tensors with no ``grad_fn``, so a backward through it would
    skip its inputs without a word; the loss paths call the plain
    counterparts instead (``sdpa``, the plain SSD scan, the dense ramp
    outputs), as the reference's loss does."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel dispatchers have no backward; call it under "
                           "torch.no_grad() or use its plain counterpart")


def counted_wrappers() -> dict:
    """The seven kernel wrappers by name. Each carries a ``launches`` count
    that it raises by one where it launches its kernel (a CUDA graph's
    capture and replays keep it true: ``serving/graphs.py``)."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention,
        paged_decode_attention,
        paged_mla_decode_attention,
    )
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.ramp_head.kernel import ramp_head_exit, ramp_head_stats
    from repro_torch.kernels.ssd.kernel import ssd_chunked

    return {"decode_attention": decode_attention,
            "paged_decode_attention": paged_decode_attention,
            "ramp_head_stats": ramp_head_stats, "ramp_head_exit": ramp_head_exit,
            "paged_mla_decode_attention": paged_mla_decode_attention,
            "flash_attention": flash_attention, "ssd_chunked": ssd_chunked}
