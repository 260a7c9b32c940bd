from repro_torch.kernels.ramp_head.kernel import ramp_head_exit, ramp_head_stats
from repro_torch.kernels.ramp_head.ops import ramp_confidence, ramp_exit_decision
from repro_torch.kernels.ramp_head.ref import (
    ramp_head_exit_ref,
    ramp_head_stats_ref,
    stats_to_confidence,
)
