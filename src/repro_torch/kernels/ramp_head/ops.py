"""Dispatchers for the ramp-head record: the plain version for CPU tensors,
the CUDA kernel for CUDA tensors (it raises rather than fall back), the
kernel's contract for meta tensors (its checks, empty outputs)."""
from __future__ import annotations

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.ramp_head.kernel import (
    ramp_head_exit,
    ramp_head_exit_meta,
    ramp_head_stats,
    ramp_head_stats_meta,
)
from repro_torch.kernels.ramp_head.ref import (
    ramp_head_exit_ref,
    ramp_head_stats_ref,
    stats_to_confidence,
)


def _on_cpu(h):
    if h.device.type == "cpu":
        return True
    if h.device.type not in ("cuda", "meta"):
        raise ValueError(f"ramp head: no kernel for device {h.device}")
    return False


def ramp_confidence(h, w, *, v_limit=None):
    """h: (B, d) pooled hiddens; w: (d, V) head. Returns the paper's per-ramp
    record {label, maxprob, entropy, lse} without writing (B, V) logits."""
    refuse_autograd("ramp_confidence", h, w)
    if _on_cpu(h):
        m, s, t, idx = ramp_head_stats_ref(h, w, v_limit)
    elif h.device.type == "meta":
        m, s, t, idx = ramp_head_stats_meta(h, w, v_limit=v_limit)
    else:
        m, s, t, idx = ramp_head_stats(h, w, v_limit=v_limit)
    label, maxprob, entropy, lse = stats_to_confidence(m, s, t, idx)
    return {"label": label, "maxprob": maxprob, "entropy": entropy, "lse": lse}


def ramp_exit_decision(h, w, thresholds, *, v_limit=None):
    """The per-ramp record plus the on-device exit bit
    ``(1 - maxprob) < threshold``."""
    refuse_autograd("ramp_exit_decision", h, w, thresholds)
    if _on_cpu(h):
        m, s, t, idx, mask = ramp_head_exit_ref(h, w, thresholds, v_limit)
    elif h.device.type == "meta":
        m, s, t, idx, mask = ramp_head_exit_meta(h, w, thresholds, v_limit=v_limit)
    else:
        m, s, t, idx, mask = ramp_head_exit(h, w, thresholds, v_limit=v_limit)
    label, maxprob, entropy, lse = stats_to_confidence(m, s, t, idx)
    return {"label": label, "maxprob": maxprob, "entropy": entropy, "lse": lse,
            "exit": mask}
