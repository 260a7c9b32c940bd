"""Plain PyTorch version of the ramp-head record (mirrors the JAX package's
ref, plus the kernel's ``v_limit`` pad-vocab mask)."""
from __future__ import annotations

import torch


def ramp_head_stats_ref(h, w, v_limit=None):
    """Returns (m, s, t, argmax) with the same semantics as the kernel.
    Columns >= v_limit (padded vocab) are masked to -1e30."""
    logits = h.float() @ w.float()
    if v_limit is not None and v_limit < logits.shape[-1]:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < v_limit, logits, -1e30)
    m = logits.max(dim=-1).values
    e = torch.exp(logits - m[:, None])
    s = e.sum(dim=-1)
    t = (logits * e).sum(dim=-1)
    idx = logits.argmax(dim=-1).to(torch.int32)
    return m, s, t, idx


def ramp_head_exit_ref(h, w, thresholds, v_limit=None):
    """Stats plus the per-row exit mask ``(1 - maxprob) < threshold``.
    Strict ``<``: a zero threshold can never trigger an exit."""
    m, s, t, idx = ramp_head_stats_ref(h, w, v_limit)
    unc = 1.0 - 1.0 / s  # maxprob = 1/s on the streaming accumulators
    mask = (unc < thresholds.float()).to(torch.int32)
    return m, s, t, idx, mask


def stats_to_confidence(m, s, t, idx):
    """(label, maxprob, entropy, lse) from the streaming accumulators."""
    lse = m + torch.log(s)
    maxprob = 1.0 / s  # exp(m - lse)
    entropy = lse - t / s  # H = lse - E[l]
    return idx, maxprob, entropy, lse
