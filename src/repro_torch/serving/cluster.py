"""Scale-out serving facades over the unified engine core.

Generalizes the single-GPU ``ServingSimulator`` to N replicas: a
dispatcher routes each request to a worker at its arrival instant, and
every worker runs its own batching policy (`repro.serving.policies`)
plus — when serving with Apparate — its **own** ``ApparateController``
adapting from its own ramp-record stream. This mirrors the paper's
CPU/GPU controller split per replica: records never cross workers, so
threshold tuning and ramp adjustment stay an O(window) host-side loop
regardless of cluster size.

The event loop itself lives in `repro.serving.engine` (shared with the
generative decode adapter); ``ClusterSimulator`` and
``MixedClusterSimulator`` are thin facades that build a
``ClassificationAdapter`` (and, for the mixed case, generative adapters)
on ONE ``EngineCore`` — one heap, one clock — and stay bit-identical to
the pre-refactor loops (`repro.serving.reference`).

Dispatch strategies:

  * ``round_robin`` — arrival-order striping (the baseline most serving
    frontends ship);
  * ``jsq`` — join-shortest-queue on queued + in-flight requests;
  * ``slo_aware`` — earliest-estimated-completion: residual busy time +
    backlog batches at the worker's current (ramp-aware) batch latency,
    i.e. the replica most likely to meet this request's deadline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import ClassificationAdapter, EngineCore, GenerativeAdapter, release_offset  # noqa: F401  (release_offset re-exported)
from repro_torch.serving.policies import PlatformConfig, get_policy
from repro_torch.serving.request import Request, Response


@dataclasses.dataclass
class ClusterConfig:
    n_workers: int = 1
    dispatch: str = "round_robin"  # 'round_robin' | 'jsq' | 'slo_aware'
    platform: PlatformConfig = dataclasses.field(default_factory=PlatformConfig)
    # SLO-aware admission control (None = queue everything, the paper's
    # platforms): an AdmissionPolicy shared with the generative adapter
    admission: Optional[object] = None


class Worker:
    """One serving replica: its own queue, batching policy, and (optional)
    Apparate controller fed exclusively by this replica's batches."""

    def __init__(self, wid: int, profile, platform: PlatformConfig, runner=None, controller=None):
        self.wid = wid
        self.profile = profile
        self.policy = get_policy(platform)
        self.runner = runner
        self.controller = controller
        self.queue: List[Request] = []
        self.free_at = 0.0
        self.busy_ms = 0.0
        self.n_batches = 0
        self.n_served = 0
        self.inflight_bs = 0  # size of the batch executing until free_at

    def exec_time(self, bs: int) -> float:
        t = self.profile.vanilla_time(bs)
        if self.controller is not None:
            t += self.controller.total_ramp_overhead(bs)
        return t

    def backlog_eta(self, now: float) -> float:
        """Estimated completion delay for a request enqueued at ``now``."""
        mbs = self.policy.cfg.max_batch_size
        q = len(self.queue) + 1
        n_batches = -(-q // mbs)
        return max(self.free_at - now, 0.0) + n_batches * self.exec_time(min(q, mbs))

    def execute(self, batch: List[Request], start: float) -> List[Response]:
        bs = len(batch)
        t_exec = self.exec_time(bs)
        self.free_at = start + t_exec
        self.busy_ms += t_exec
        self.n_batches += 1
        self.n_served += bs
        self.inflight_bs = bs
        ctl = self.controller
        out: List[Response] = []
        if self.runner is None or ctl is None:
            for r in batch:
                out.append(
                    Response(r.rid, start + t_exec, 0, -1, start + t_exec - r.arrival_ms,
                             bs, worker=self.wid, slo_ms=r.slo_ms)
                )
            return out
        items = np.asarray([r.item for r in batch])
        active = sorted(ctl.active)
        ramp_labels, ramp_unc, final_labels = self.runner.infer(items, active)
        dec = ctl.observe(ramp_labels, ramp_unc, final_labels)
        for j, r in enumerate(batch):
            site = int(dec.exit_sites[j])
            off = release_offset(self.profile, site, bs, active) if site >= 0 else t_exec
            rel = start + off
            out.append(
                Response(r.rid, rel, int(dec.released_labels[j]), site, rel - r.arrival_ms,
                         bs, worker=self.wid, slo_ms=r.slo_ms)
            )
        return out

    def stats(self) -> Dict[str, float]:
        out = {
            "busy_ms": self.busy_ms,
            "batches": float(self.n_batches),
            "served": float(self.n_served),
            "mean_batch": self.n_served / self.n_batches if self.n_batches else 0.0,
        }
        if self.controller is not None:
            out["ramp_overhead_ms"] = self.controller.total_ramp_overhead(1)
            out["active_ramps"] = float(len(self.controller.active))
        return out


class Dispatcher:
    name = "base"

    def pick(self, workers: List[Worker], req: Request, now: float) -> Worker:
        raise NotImplementedError


class RoundRobinDispatcher(Dispatcher):
    name = "round_robin"

    def __init__(self):
        self._next = 0

    def pick(self, workers, req, now):
        w = workers[self._next % len(workers)]
        self._next += 1
        return w


class JSQDispatcher(Dispatcher):
    """Join-shortest-queue on queued + in-flight requests."""

    name = "jsq"

    def pick(self, workers, req, now):
        return min(
            workers,
            key=lambda w: (
                len(w.queue) + (w.inflight_bs if w.free_at > now + 1e-9 else 0),
                w.wid,
            ),
        )


class SLOAwareDispatcher(Dispatcher):
    """Earliest-estimated-completion routing (ramp-aware batch latency)."""

    name = "slo_aware"

    def pick(self, workers, req, now):
        return min(workers, key=lambda w: (w.backlog_eta(now), w.wid))


DISPATCHERS = {
    d.name: d for d in (RoundRobinDispatcher, JSQDispatcher, SLOAwareDispatcher)
}


def get_dispatcher(name: str) -> Dispatcher:
    try:
        return DISPATCHERS[name]()
    except KeyError:
        raise ValueError(f"unknown dispatch strategy {name!r}; have {sorted(DISPATCHERS)}")


class ClusterSimulator:
    """N-worker serving facade over the unified engine core.

    ``controllers`` — one per worker (each replica adapts independently),
    or ``None`` for vanilla serving. The runner is shared: it is a pure
    batch→records function, so replicas reuse its compile cache the way
    replicas of one model reuse a compiled executable.
    """

    def __init__(self, profile, cluster: Optional[ClusterConfig] = None, runner=None,
                 controllers: Optional[Sequence] = None):
        cluster = cluster or ClusterConfig()
        if cluster.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {cluster.n_workers}")
        if controllers is not None and len(controllers) != cluster.n_workers:
            raise ValueError(
                f"need one controller per worker: got {len(controllers)} "
                f"for {cluster.n_workers} workers"
            )
        self.profile = profile
        self.cfg = cluster
        self.workers = [
            Worker(i, profile, cluster.platform, runner,
                   controllers[i] if controllers is not None else None)
            for i in range(cluster.n_workers)
        ]
        self.dispatcher = get_dispatcher(cluster.dispatch)
        self.makespan_ms = 0.0
        self.core: Optional[EngineCore] = None  # last run's engine core

    def _make_adapter(self, requests: Sequence[Request]) -> ClassificationAdapter:
        """The engine-core adapter over THIS simulator's workers/dispatcher
        (shared with ``MixedClusterSimulator``, which co-schedules it with
        generative adapters on one core)."""
        return ClassificationAdapter(self.workers, self.dispatcher, requests,
                                     admission=self.cfg.admission)

    def run(self, requests: List[Request]) -> List[Response]:
        core = EngineCore()
        adapter = core.add(self._make_adapter(requests))
        core.run()
        self.core = core
        self.makespan_ms = adapter.makespan()
        return adapter.responses

    def worker_stats(self) -> Dict[int, Dict[str, float]]:
        return {w.wid: w.stats() for w in self.workers}


class MixedClusterSimulator:
    """Heterogeneous replica pools in one cluster: classification workers
    (a ``ClusterSimulator``) + generative decode replicas
    (``GenerativeEngine`` from ``repro.serving.generative``) behind one
    frontend — the ROADMAP's CV/NLP/generative mixture.

    Replicas share nothing (a generative replica holds an LM plus its KV
    slots, a classification replica its classifier), but since the
    unification all pools run on ONE ``EngineCore``: a single event heap
    and a single monotone clock, so cross-pool event interleavings are
    globally time-ordered (``self.core.completions``) instead of each
    pool living on its own clock — the property the pre-refactor
    independent-pool frontend could never even observe. Per-pool results
    are unchanged (pools still share no state).

    Generative dispatch is arrival-order greedy on outstanding token work
    (the decode analogue of join-shortest-queue: queued tokens, not queued
    requests, measure a generative replica's backlog).
    """

    def __init__(self, cls_sim: Optional[ClusterSimulator] = None,
                 gen_engines: Sequence = ()):
        if cls_sim is None and not gen_engines:
            raise ValueError("need at least one pool (cls_sim or gen_engines)")
        self.cls_sim = cls_sim
        self.gen_engines = list(gen_engines)
        self.makespan_ms = 0.0
        self.core: Optional[EngineCore] = None  # last run's shared engine core

    def run(self, cls_requests: Sequence[Request] = (), gen_requests: Sequence = ()):
        """Returns (classification Responses, GenResponses)."""
        if cls_requests and self.cls_sim is None:
            raise ValueError("classification requests but no classification pool")
        if gen_requests and not self.gen_engines:
            raise ValueError("generative requests but no generative pool")
        core = EngineCore()
        cls_adapter = None
        if cls_requests:
            cls_adapter = core.add(self.cls_sim._make_adapter(list(cls_requests)))
        buckets: List[list] = [[] for _ in self.gen_engines]
        load = [0.0] * len(self.gen_engines)
        for r in sorted(gen_requests, key=lambda q: (q.arrival_ms, q.rid)):
            k = min(range(len(load)), key=lambda j: (load[j], j))
            buckets[k].append(r)
            load[k] += r.n_tokens
        gen_adapters = [
            core.add(GenerativeAdapter(eng, buckets[k]))
            for k, eng in enumerate(self.gen_engines)
        ]
        core.run()
        self.core = core
        cls_resp: List[Response] = []
        if cls_adapter is not None:
            cls_resp = cls_adapter.responses
            self.cls_sim.core = core
            self.cls_sim.makespan_ms = cls_adapter.makespan()
        gen_resp: List = []
        for k, ad in enumerate(gen_adapters):
            rs = ad.finalize()
            for r in rs:
                r.worker = k
            gen_resp.extend(rs)
        gen_resp.sort(key=lambda r: r.rid)
        spans = [eng.makespan_ms for eng in self.gen_engines]
        if self.cls_sim is not None and cls_requests:
            spans.append(self.cls_sim.makespan_ms)
        self.makespan_ms = max(spans) if spans else 0.0
        return cls_resp, gen_resp
