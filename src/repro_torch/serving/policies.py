"""Batching-policy strategy layer.

The serving platforms the paper runs atop differ only in *batch
formation*; everything else (queueing, execution, release) is shared.
Each policy answers two questions for one worker:

  * ``form_batch`` — given the worker's queue at time ``now``, either
    return the batch to launch (a request list), the ``DROP`` sentinel
    (clockwork sheds a hopeless head-of-line request), or ``None``
    (keep waiting);
  * ``next_wake`` — when waiting, the next instant at which the
    decision could change (arrival or timeout expiry).

Policies are pure and per-worker, so the N-worker cluster engine
(`repro.serving.cluster`) instantiates one per worker and the 1-worker
``ServingSimulator`` stays a special case of the same code path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass
class PlatformConfig:
    policy: str = "clockwork"  # 'clockwork' | 'tfserve'
    max_batch_size: int = 16
    batch_timeout_ms: float = 5.0
    drop_on_slo_miss: bool = False  # clockwork drops hopeless requests


#: sentinel returned by ``form_batch``: drop the head-of-line request.
DROP: List[Request] = []


class BatchPolicy:
    """One worker's batch-formation strategy."""

    name = "base"

    def __init__(self, cfg: PlatformConfig):
        self.cfg = cfg

    def form_batch(
        self,
        queue: List[Request],
        now: float,
        next_arrival_ms: float,
        exec_time: Callable[[int], float],
    ) -> Optional[List[Request]]:
        raise NotImplementedError

    def next_wake(self, queue: List[Request], now: float, next_arrival_ms: float) -> float:
        """Earliest future time a waiting decision could change."""
        return next_arrival_ms


class TFServePolicy(BatchPolicy):
    """Tunable ``max_batch_size`` / ``batch_timeout_ms`` knobs (paper Fig 3)."""

    name = "tfserve"

    def form_batch(self, queue, now, next_arrival_ms, exec_time):
        cfg = self.cfg
        if len(queue) >= cfg.max_batch_size:
            return queue[: cfg.max_batch_size]
        oldest_wait = now - queue[0].arrival_ms
        if oldest_wait + 1e-9 >= cfg.batch_timeout_ms:
            return queue[: cfg.max_batch_size]
        if not np.isfinite(next_arrival_ms):  # no more arrivals: flush
            return queue[: cfg.max_batch_size]
        return None

    def next_wake(self, queue, now, next_arrival_ms):
        return min(next_arrival_ms, queue[0].arrival_ms + self.cfg.batch_timeout_ms)


class ClockworkPolicy(BatchPolicy):
    """Work-conserving, SLO-aware max-batch selection with drop-on-miss
    (paper §2.1): the largest batch whose completion meets the earliest
    deadline among its members."""

    name = "clockwork"

    def form_batch(self, queue, now, next_arrival_ms, exec_time):
        cfg = self.cfg
        cap = min(len(queue), cfg.max_batch_size)
        for b in range(cap, 0, -1):
            dl = min(q.arrival_ms + q.slo_ms for q in queue[:b])
            if now + exec_time(b) <= dl + 1e-9:
                return queue[:b]
        if cfg.drop_on_slo_miss:
            return DROP  # shed hopeless head-of-line request
        return queue[:1]  # serve anyway (degraded)


@dataclasses.dataclass
class AdmissionConfig:
    """Knobs for SLO-aware admission (shared by both workload adapters)."""

    slack: float = 1.0  # deadline multiplier before a request is hopeless
    shed_after: int = 3  # consecutive SLO-violating tokens before a shed
    drop_on_admit: bool = True  # shed hopeless requests at admission
    shed_mid_stream: bool = True  # shed doomed generative slots mid-run


class AdmissionPolicy:
    """SLO-aware admission shared by the classification and generative
    adapters of the unified engine (`repro.serving.engine`).

    The paper's platforms only shed *after* queueing (clockwork's
    drop-on-miss); InferLine/SuperServe-style serving sheds at admission,
    before a hopeless request wastes queue or slot capacity:

      * classification (request granularity): a request whose earliest
        estimated completion on its routed worker — residual busy time +
        backlog, the same estimate ``slo_aware`` dispatch ranks by —
        already misses ``arrival + slack * slo`` is dropped at arrival;
      * generative admission (stream granularity): a request whose
        per-token SLO is tighter than even an unbatched decode step can
        ever meet is dropped instead of occupying a slot;
      * generative mid-stream (token granularity): a live slot whose
        observed per-token latency has violated its SLO for
        ``shed_after`` consecutive tokens is shed at the next step
        boundary, freeing the slot for admissible work (the partial
        response is marked ``shed`` and reported by
        ``summarize_generative``).
    """

    def __init__(self, cfg: Optional[AdmissionConfig] = None):
        self.cfg = cfg or AdmissionConfig()
        if self.cfg.shed_after < 1:
            raise ValueError(f"shed_after must be >= 1, got {self.cfg.shed_after}")
        self.n_admit_drops = 0
        self.n_sheds = 0
        self._viol: dict = {}  # stream key -> consecutive SLO violations

    def admit_request(self, req, now: float, eta_ms: float) -> bool:
        """Classification: False = drop (projected completion misses the
        deadline even on the best-estimate worker)."""
        if not self.cfg.drop_on_admit or not np.isfinite(req.slo_ms):
            return True
        if now + eta_ms <= req.arrival_ms + self.cfg.slack * req.slo_ms + 1e-9:
            return True
        self.n_admit_drops += 1
        return False

    def admit_token_stream(self, req, now: float, best_step_ms: float) -> bool:
        """Generative: False = drop (the per-token SLO is tighter than the
        best achievable step time — the stream is doomed before it starts)."""
        if not self.cfg.drop_on_admit or not np.isfinite(req.slo_ms):
            return True
        if best_step_ms <= self.cfg.slack * req.slo_ms + 1e-9:
            return True
        self.n_admit_drops += 1
        return False

    def note_token(self, key, tpt_ms: float, slo_ms: float) -> bool:
        """Generative mid-stream: record one decode token's TPT sample for
        stream ``key``; True = shed the slot now (``shed_after``
        consecutive violations)."""
        if not self.cfg.shed_mid_stream or not np.isfinite(slo_ms):
            return False
        if tpt_ms <= self.cfg.slack * slo_ms + 1e-9:
            self._viol.pop(key, None)
            return False
        n = self._viol.get(key, 0) + 1
        if n >= self.cfg.shed_after:
            self._viol.pop(key, None)
            self.n_sheds += 1
            return True
        self._viol[key] = n
        return False

    def preempt_stream(self, req, now: float, best_step_ms: float) -> str:
        """Generative overload: the KV pool is exhausted and ``req``'s slot
        was chosen as the preemption victim — pick the reaction by SLO
        slack (InferLine's currency, SuperServe's reactive fine-grained
        overload handling). A stream whose per-token SLO a best-case step
        still meets has slack to absorb a swap round-trip, so its work is
        preserved ('swap'); a stream already doomed against its SLO frees
        the pool permanently ('shed')."""
        if not np.isfinite(req.slo_ms):
            return "swap"  # no deadline: never discard work
        if best_step_ms <= self.cfg.slack * req.slo_ms + 1e-9:
            return "swap"
        return "shed"

    def forget(self, key) -> None:
        """Drop stream ``key``'s violation streak. The engine calls this
        when a stream ends (finish or shed): ``(wid, slot, rid)`` keys
        repeat across runs and slot reuse, so a streak left behind by a
        stream that ended mid-streak must not be inherited by the next
        stream with the same key."""
        self._viol.pop(key, None)

    def stats(self) -> dict:
        return {"admit_drops": float(self.n_admit_drops),
                "sheds": float(self.n_sheds)}


POLICIES = {
    TFServePolicy.name: TFServePolicy,
    ClockworkPolicy.name: ClockworkPolicy,
}


def get_policy(cfg: PlatformConfig) -> BatchPolicy:
    try:
        return POLICIES[cfg.policy](cfg)
    except KeyError:
        raise ValueError(f"unknown platform policy {cfg.policy!r}; have {sorted(POLICIES)}")
