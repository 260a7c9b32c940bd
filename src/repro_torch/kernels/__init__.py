"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""
from __future__ import annotations


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
