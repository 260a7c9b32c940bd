"""Frozen pre-refactor serving loops — the facade-equivalence oracles.

When the three hand-rolled discrete-event loops were unified onto the
event-driven core (`repro.serving.engine`), the original loop bodies
moved here VERBATIM, following the PR 3/4 pattern (``LoopDecodeRunner``,
``tune_thresholds_reference``): the refactored facades must stay
bit-identical to these references, and
``tests/test_engine_equivalence.py`` fuzzes seeded arrival schedules
through both to prove it. Do not "improve" this module — its only value
is being exactly the pre-refactor behavior.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.cluster import ClusterConfig, Worker, get_dispatcher
from repro_torch.serving.engine import release_offset
from repro_torch.serving.request import GenRequest, GenResponse, Request, Response


class ReferenceClusterSimulator:
    """The pre-refactor N-worker discrete-event loop (PR 1), kept as the
    oracle the ``ClusterSimulator`` facade is fuzzed against."""

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

    def run(self, requests: List[Request]) -> List[Response]:
        workers = self.workers
        responses: List[Response] = []
        i, n = 0, len(requests)
        now = 0.0
        while i < n or any(w.queue for w in workers):
            # dispatch arrivals up to `now` (routing sees the state at arrival)
            while i < n and requests[i].arrival_ms <= now + 1e-9:
                self.dispatcher.pick(workers, requests[i], now).queue.append(requests[i])
                i += 1
            nxt = requests[i].arrival_ms if i < n else np.inf
            # let every free worker with queued requests act at `now`
            acted = False
            for w in workers:
                if not w.queue or now + 1e-9 < w.free_at:
                    continue
                batch = w.policy.form_batch(w.queue, now, nxt, w.exec_time)
                if batch is None:
                    continue
                acted = True
                if not batch:  # DROP sentinel: shed head-of-line request
                    r = w.queue.pop(0)
                    responses.append(
                        Response(r.rid, now, -1, -1, now - r.arrival_ms, 0, True,
                                 worker=w.wid, slo_ms=r.slo_ms)
                    )
                    continue
                del w.queue[: len(batch)]
                responses.extend(w.execute(batch, now))
            if acted:
                continue
            # advance to the next decision point: arrival, a busy worker
            # freeing up, or a waiting policy's timeout expiry
            cand = [nxt]
            for w in workers:
                if not w.queue:
                    continue
                if now < w.free_at:
                    cand.append(w.free_at)
                else:
                    cand.append(w.policy.next_wake(w.queue, now, nxt))
            t = min(cand)
            if not np.isfinite(t):
                break  # defensive: nothing can ever progress
            now = max(now, t)
        self.makespan_ms = max([now] + [w.free_at for w in workers])
        return responses

    def worker_stats(self) -> Dict[int, Dict[str, float]]:
        return {w.wid: w.stats() for w in self.workers}


class ReferenceGenerativeEngine:
    """The pre-refactor generative decode loop (PR 2), kept as the oracle
    the ``GenerativeEngine`` facade is fuzzed against."""

    def __init__(self, profile, cfg=None, runner=None, controller=None, *,
                 wid: int = 0, prefill_ms=None):
        from repro_torch.serving.generative import GenerativeConfig

        self.profile = profile
        self.cfg = cfg or GenerativeConfig()
        if self.cfg.max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {self.cfg.max_batch_size}")
        if (runner is None) != (controller is None):
            raise ValueError("runner and controller must be supplied together (or neither)")
        self.runner = runner
        self.controller = controller
        self.wid = wid
        self.prefill_ms = prefill_ms or (
            lambda plen: plen * self.cfg.prefill_frac * profile.vanilla_time(1)
        )
        self.makespan_ms = 0.0
        self.busy_ms = 0.0
        self.kv_ms = 0.0
        self.n_steps = 0
        self.n_tokens = 0
        self.peak_slots = 0
        self.slot_history: List[int] = []

    def run(self, requests: Sequence[GenRequest]) -> List[GenResponse]:
        reqs = sorted(requests, key=lambda r: (r.arrival_ms, r.rid))
        queue: deque = deque()
        slots: Dict[int, dict] = {}
        free = list(range(self.cfg.max_batch_size))
        responses: List[GenResponse] = []
        now, i, n = 0.0, 0, len(reqs)
        pending_kv = 0.0

        def finish(sid: int):
            sl = slots.pop(sid)
            free.append(sid)
            free.sort()
            if self.runner is not None:
                self.runner.free(sid)
            responses.append(sl["resp"])

        while i < n or queue or slots:
            while i < n and reqs[i].arrival_ms <= now + 1e-9:
                queue.append(reqs[i])
                i += 1
            if not slots and not queue:
                now = max(now, reqs[i].arrival_ms)  # idle: jump to next arrival
                continue
            while queue and free:
                r = queue.popleft()
                sid = free.pop(0)
                now += self.prefill_ms(r.prompt_len)
                tok = self.runner.start(sid, r.item) if self.runner is not None else 0
                resp = GenResponse(
                    rid=r.rid, arrival_ms=r.arrival_ms, release_ms=[now],
                    exit_sites=[-1], tokens=[tok], final_tokens=[tok],
                    worker=self.wid, slo_ms=r.slo_ms,
                )
                slots[sid] = {"req": r, "resp": resp}
                self.n_tokens += 1
                if r.n_tokens <= 1:
                    finish(sid)
            if not slots:
                continue
            sids = sorted(slots)
            B = len(sids)
            self.peak_slots = max(self.peak_slots, B)
            self.slot_history.append(B)
            ctl = self.controller
            act = sorted(ctl.active) if ctl is not None else []
            if self.runner is not None and ctl is not None:
                labels, unc, finals = self.runner.step(sids, act)
                dec = ctl.observe(labels, unc, finals)
                ex = np.asarray(dec.exit_sites, np.int64)
                released = np.asarray(dec.released_labels)
            else:
                finals = np.zeros(B, np.int64)
                ex = np.full(B, -1, np.int64)
                released = finals
            kv_now = pending_kv
            step_ms = self.profile.decode_step_time(ex, act)
            start = now
            end = start + kv_now + step_ms
            pending_kv = 0.0
            self.kv_ms += kv_now
            kv_by_site: Dict[int, int] = {}
            for j, sid in enumerate(sids):
                sl = slots[sid]
                site = int(ex[j])
                if site >= 0:
                    off = release_offset(self.profile, site, B, act)
                    rel = min(start + kv_now + off, end)
                else:
                    rel = end
                resp = sl["resp"]
                resp.release_ms.append(rel)
                resp.exit_sites.append(site)
                resp.tokens.append(int(released[j]))
                resp.final_tokens.append(int(finals[j]))
                self.n_tokens += 1
                done = len(resp.tokens)
                if done >= sl["req"].n_tokens:
                    finish(sid)
                elif site >= 0:
                    kv_by_site[site] = kv_by_site.get(site, 0) + 1
            for site, cnt in kv_by_site.items():
                pending_kv += self.profile.kv_fill_cost(site, cnt)
            self.busy_ms += kv_now + step_ms
            self.n_steps += 1
            now = end
        self.makespan_ms = now
        responses.sort(key=lambda r: r.rid)
        return responses


class ReferenceMixedClusterSimulator:
    """The pre-refactor mixed-pool frontend (PR 2): pools simulated fully
    independently, each on its own clock."""

    def __init__(self, cls_sim=None, gen_engines: Sequence = ()):
        if cls_sim is None and not gen_engines:
            raise ValueError("need at least one pool (cls_sim or gen_engines)")
        self.cls_sim = cls_sim
        self.gen_engines = list(gen_engines)
        self.makespan_ms = 0.0

    def run(self, cls_requests: Sequence[Request] = (), gen_requests: Sequence = ()):
        if cls_requests and self.cls_sim is None:
            raise ValueError("classification requests but no classification pool")
        if gen_requests and not self.gen_engines:
            raise ValueError("generative requests but no generative pool")
        cls_resp: List[Response] = (
            self.cls_sim.run(list(cls_requests)) if cls_requests else []
        )
        buckets: List[list] = [[] for _ in self.gen_engines]
        load = [0.0] * len(self.gen_engines)
        for r in sorted(gen_requests, key=lambda q: (q.arrival_ms, q.rid)):
            k = min(range(len(load)), key=lambda j: (load[j], j))
            buckets[k].append(r)
            load[k] += r.n_tokens
        gen_resp: List = []
        for k, eng in enumerate(self.gen_engines):
            rs = eng.run(buckets[k])
            for r in rs:
                r.worker = k
            gen_resp.extend(rs)
        gen_resp.sort(key=lambda r: r.rid)
        spans = [eng.makespan_ms for eng in self.gen_engines]
        if self.cls_sim is not None and cls_requests:
            spans.append(self.cls_sim.makespan_ms)
        self.makespan_ms = max(spans) if spans else 0.0
        return cls_resp, gen_resp
