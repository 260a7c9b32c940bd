"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each kernel's wrapper checks its operands against the kernel's contract
(shapes, dtypes, head widths, groups, ranks, table widths, what fits in
shared memory) before it launches; its ``*_meta`` twin runs the same
checks on ``meta`` tensors and returns empty ``meta`` outputs of the
kernel's shapes and dtypes, so a full-width model traced on ``meta``
(``analysis/abstract.py``) meets every kernel's contract without a card.
"""
from __future__ import annotations

import torch

# the SMs of the H100 SXM that the sm_90a build targets: a meta contract
# reckons its split counts for it, since no card is there to ask
H100_SMS = 132


class KernelShapeError(ValueError, NotImplementedError):
    """A shape the kernel does not take (a head width, a group, a rank, a
    width that does not fit its shared memory): a documented gap, so the
    support audit records it as ``rejected`` with these words."""


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
