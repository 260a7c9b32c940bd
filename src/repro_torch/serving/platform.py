"""Discrete-event serving simulator (single-worker facade).

Reproduces the serving-platform behaviors the paper runs atop:

  * ``tfserve`` policy — tunable ``max_batch_size`` / ``batch_timeout_ms``
    knobs (paper Fig 3);
  * ``clockwork`` policy — work-conserving, SLO-aware max-batch selection
    with drop-on-miss (paper §2.1).

Apparate runs ON TOP: batch execution calls the model runner once
(inputs always run to completion), streams ramp records to the
controller, and per-request *results* are released at their exit ramp's
time offset (§3). Batch execution time = vanilla + active ramp overheads
(the ramp-budget guarantee is directly visible in the tail latency).

Batch formation lives in `repro.serving.policies`; the event loop lives
in `repro.serving.engine` (the unified event-driven core shared with the
generative decode adapter). ``ServingSimulator`` is the 1-worker special
case of ``ClusterSimulator`` (the paper's single-GPU setup) and keeps
the original call signature.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.cluster import ClusterConfig, ClusterSimulator, release_offset
from repro_torch.serving.policies import PlatformConfig  # noqa: F401  (re-export)
from repro_torch.serving.request import Request, Response


class ServingSimulator:
    """Single-worker discrete-event loop (the paper's single-GPU setup)."""

    def __init__(
        self,
        profile,
        platform: PlatformConfig,
        runner=None,
        controller=None,
        *,
        admission=None,
    ):
        self.profile = profile
        self.pf = platform
        self.runner = runner
        self.controller = controller
        self.admission = admission  # optional SLO-aware AdmissionPolicy

    def exec_time(self, bs: int) -> float:
        t = self.profile.vanilla_time(bs)
        if self.controller is not None:
            t += self.controller.total_ramp_overhead(bs)
        return t

    def _release_offset(self, site: int, bs: int, active: Sequence[int]) -> float:
        """Time into batch execution at which a result exiting at `site`
        leaves the platform."""
        return release_offset(self.profile, site, bs, active)

    def run(self, requests: List[Request]) -> List[Response]:
        sim = ClusterSimulator(
            self.profile,
            ClusterConfig(n_workers=1, platform=self.pf, admission=self.admission),
            runner=self.runner,
            controllers=[self.controller] if self.controller is not None else None,
        )
        return sim.run(requests)


def make_requests(arrivals: np.ndarray, slo_ms: float, items=None) -> List[Request]:
    items = items if items is not None else np.arange(len(arrivals))
    return [
        Request(rid=k, arrival_ms=float(t), slo_ms=slo_ms, item=int(items[k]))
        for k, t in enumerate(arrivals)
    ]
