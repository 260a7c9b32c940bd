"""Unified event-driven serving engine core.

Every serving workload in this repo used to hand-roll its own
discrete-event loop — ``ServingSimulator`` (single worker),
``ClusterSimulator``/``MixedClusterSimulator`` (scale-out + mixed pools),
and the generative decode engine — each re-implementing clock advance,
queue draining, and controller feedback. This module is the single core
they are now thin facades over:

  * ``EngineCore`` — ONE event heap and ONE monotone clock. Adapters
    schedule wake events; completions are themselves heap events, so
    ``EngineCore.completions`` pops globally time-ordered across every
    pool (the property ``MixedClusterSimulator`` could never test while
    its pools ran on independent clocks).
  * ``ClassificationAdapter`` — per-replica queues (``Worker`` objects),
    the `repro.serving.policies` batch-formation strategies, dispatcher
    routing at arrival, and the Apparate controller hookpoint in
    ``Worker.execute``.
  * ``GenerativeAdapter`` — slot-based continuous batching, per-token
    early exits with deferred KV catch-up, plus the two capabilities the
    split loops made impossible: **chunked prefill interleaving**
    (``GenerativeConfig.prefill_chunk`` splits a long prompt into chunks
    co-scheduled with in-flight decode steps, so TPT never stalls behind
    a monolithic prefill) and **SLO-aware admission / mid-stream shedding**
    via the shared ``AdmissionPolicy`` (`repro.serving.policies`).

Exactness contract: with ``prefill_chunk == 0`` and no admission policy,
both adapters reproduce the pre-refactor loops bit-for-bit — pinned by
the facade-vs-reference fuzz in ``tests/test_engine_equivalence.py``
against the frozen oracles in `repro.serving.reference`.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import GenResponse, Request, Response
from repro_torch.serving.runner import PoolExhausted


def release_offset(profile, site: int, bs: int, active: Sequence[int]) -> float:
    """Time into batch execution at which a result exiting at ``site``
    leaves the platform: the trunk compute through the site's layer plus
    every active ramp head at or before it (all on the critical path)."""
    ovh = 0.0
    for s in sorted(active):
        if s <= site:
            ovh += profile.ramp_overhead(s, bs)
    return profile.time_to_layer(profile.sites[site], bs) + ovh


class EngineCore:
    """Single discrete-event core: one heap, one clock, N adapters.

    Adapters schedule their own wake events (``schedule``) and log
    completions (``emit``); the core pops events in global time order, so
    ``now`` is monotone across every pool and ``completions`` interleaves
    classification and generative releases in true time order.
    """

    def __init__(self):
        self.now = 0.0
        self.adapters: List = []
        self._heap: List = []  # (time, seq, adapter | None, completion)
        self._seq = 0
        #: (time, pool, record) tuples appended as the clock passes them —
        #: globally time-ordered across every adapter on this core.
        self.completions: List = []

    def add(self, adapter):
        adapter.core = self
        self.adapters.append(adapter)
        return adapter

    def schedule(self, t: float, adapter) -> None:
        """Wake ``adapter`` when the clock reaches ``t`` (FIFO at ties)."""
        heapq.heappush(self._heap, (float(t), self._seq, adapter, None))
        self._seq += 1

    def emit(self, t: float, pool: str, record) -> None:
        """Log a completion at time ``t``. The record rides the heap, so it
        lands in ``completions`` only when the clock reaches it — later
        emissions with earlier timestamps still order correctly."""
        heapq.heappush(self._heap, (float(t), self._seq, None, (pool, record)))
        self._seq += 1

    def run(self) -> "EngineCore":
        for a in self.adapters:
            a.prime(self)
        while self._heap:
            t, _, adapter, rec = heapq.heappop(self._heap)
            if t > self.now:
                self.now = t
            if adapter is None:
                self.completions.append((t, rec[0], rec[1]))
            else:
                adapter.wake(self, self.now)
        return self


class ClassificationAdapter:
    """Classification-batch workload on the shared core.

    Exact port of the pre-refactor ``ClusterSimulator`` loop: dispatch at
    arrival (routing sees the state at that instant), every free worker
    acts until quiescent at each decision point, then one wake is
    scheduled at the next decision instant (arrival, a busy worker with
    backlog freeing up, or a waiting policy's timeout expiry).

    ``admission`` (an ``AdmissionPolicy``) adds SLO-aware admission
    control: a request whose earliest estimated completion on its routed
    worker already misses its deadline is shed at arrival instead of
    wasting queue capacity — the InferLine-style early drop the
    ``slo_aware`` dispatcher estimates but never acts on.
    """

    pool = "classification"

    def __init__(self, workers, dispatcher, requests, admission=None):
        self.workers = workers
        self.dispatcher = dispatcher
        self.reqs = list(requests)
        self.admission = admission
        self.responses: List[Response] = []
        self._i = 0
        self._now = 0.0  # last decision instant (the old loop's final `now`)

    def prime(self, core: EngineCore) -> None:
        if self.reqs:
            core.schedule(0.0, self)

    def _pending(self) -> bool:
        return self._i < len(self.reqs) or any(w.queue for w in self.workers)

    def wake(self, core: EngineCore, now: float) -> None:
        workers = self.workers
        self._now = now
        nxt = np.inf
        while True:
            # dispatch arrivals up to `now` (routing sees the state at arrival)
            while self._i < len(self.reqs) and self.reqs[self._i].arrival_ms <= now + 1e-9:
                req = self.reqs[self._i]
                self._i += 1
                w = self.dispatcher.pick(workers, req, now)
                if self.admission is not None and not self.admission.admit_request(
                    req, now, w.backlog_eta(now)
                ):
                    r = Response(req.rid, now, -1, -1, now - req.arrival_ms, 0, True,
                                 worker=w.wid, slo_ms=req.slo_ms)
                    self.responses.append(r)
                    core.emit(now, self.pool, r)
                    continue
                w.queue.append(req)
            nxt = self.reqs[self._i].arrival_ms if self._i < len(self.reqs) else np.inf
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
                    resp = Response(r.rid, now, -1, -1, now - r.arrival_ms, 0, True,
                                    worker=w.wid, slo_ms=r.slo_ms)
                    self.responses.append(resp)
                    core.emit(now, self.pool, resp)
                    continue
                del w.queue[: len(batch)]
                out = w.execute(batch, now)
                self.responses.extend(out)
                for r in out:
                    core.emit(r.release_ms, self.pool, r)
            if not acted:
                break
        if not self._pending():
            return
        # next decision point: arrival, a busy worker freeing up, or a
        # waiting policy's timeout expiry
        cand = [nxt]
        for w in workers:
            if not w.queue:
                continue
            cand.append(w.free_at if now < w.free_at else w.policy.next_wake(w.queue, now, nxt))
        t = min(cand)
        if np.isfinite(t):
            core.schedule(t, self)
        # else: defensive — nothing can ever progress (the old loop's break)

    def makespan(self) -> float:
        return max([self._now] + [w.free_at for w in self.workers])


class GenerativeAdapter:
    """Generative decode workload on the shared core.

    Owns slot admission and decode steps for one ``GenerativeEngine``
    (the engine object carries config/profile/runner/controller and
    accumulates the run stats). The legacy path (``prefill_chunk == 0``,
    no admission) is an exact port of the pre-refactor engine loop:
    admission prefills serially at the step boundary and the whole batch
    stalls behind it.

    With ``prefill_chunk > 0`` admission only *claims* the slot; the
    prompt then prefills in ``prefill_chunk``-token chunks co-scheduled
    with the in-flight decode steps (one chunk per prefilling slot per
    step, priced by ``prefill_ms``), and the first token releases at the
    end of the step that completes the prompt. Runners exposing
    ``prefill_begin``/``prefill_resume`` (``DecodeRunner``) fill the real
    slot cache incrementally; other runners are started once the last
    chunk lands (timing-only chunking).

    With an ``AdmissionPolicy``, a request whose per-token SLO is hopeless
    is dropped at admission, and a live slot whose observed TPT has
    violated its SLO for ``shed_after`` consecutive tokens is shed at the
    next step boundary (partial response marked ``shed=True``).

    With ``GenerativeConfig.preempt != 'none'``, a mid-run
    ``PoolExhausted`` from the paged KV pool no longer propagates: the
    adapter preempts the victim slot with the most SLO slack — swapping
    its KV blocks to a host buffer for later readmission ('swap', via
    ``DecodeRunner.swap_out``/``swap_in``) or discarding it ('shed') —
    and retries. An ``AdmissionPolicy`` refines the swap-vs-shed choice
    per victim by SLO slack (``preempt_stream``).
    """

    pool = "generative"

    def __init__(self, eng, requests):
        self.eng = eng
        self.reqs = sorted(requests, key=lambda r: (r.arrival_ms, r.rid))
        self.queue: deque = deque()
        self.slots: Dict[int, dict] = {}  # slot id -> {req, resp, [pf_left, pf_fed]}
        self.free = list(range(eng.cfg.max_batch_size))
        self.swapped: deque = deque()  # preempted streams awaiting readmission
        self.responses: List[GenResponse] = []
        self._i = 0
        self._now = 0.0  # pool-local clock (the old loop's `now`)
        self._pending_kv = 0.0

    def prime(self, core: EngineCore) -> None:
        if self.reqs:
            core.schedule(0.0, self)

    # -- helpers -------------------------------------------------------------

    def _finish(self, sid: int, core: EngineCore, shed: bool = False):
        sl = self.slots.pop(sid)
        self.free.append(sid)
        self.free.sort()
        if self.eng.runner is not None:
            self.eng.runner.free(sid)
        if self.eng.admission is not None:
            # the stream ended: drop its violation streak so the next
            # stream reusing this (wid, slot, rid) key starts fresh
            self.eng.admission.forget((self.eng.wid, sid, sl["req"].rid))
        resp = sl["resp"]
        if shed:
            resp.shed = True
            self.eng.n_shed += 1
        self.responses.append(resp)

    def _cached_tokens(self, r) -> int:
        """Prompt tokens the runner's prefix cache already holds for ``r``
        — the engine prices prefill on the uncached tail only."""
        eng = self.eng
        if eng.runner is None or not hasattr(eng.runner, "cached_prefix_tokens"):
            return 0
        return min(int(eng.runner.cached_prefix_tokens(r.item)), int(r.prompt_len))

    def _preempt_one(self, core: EngineCore, exclude: Optional[int] = None) -> bool:
        """Pick a preemption victim for an exhausted KV pool and evict it.
        Victim = the decoding slot with the most per-token SLO slack
        (ties: lowest slot id); with no decoding slot, a prefilling slot
        (excluding ``exclude``, the one mid-feed) is shed — its partial
        prefill cannot swap. Returns False when nothing is evictable."""
        eng = self.eng

        def slack(sid):
            s = self.slots[sid]["req"].slo_ms
            return s if np.isfinite(s) else np.inf

        decoding = [s for s in sorted(self.slots)
                    if self.slots[s]["resp"] is not None and s != exclude]
        if decoding:
            victim = max(decoding, key=lambda s: (slack(s), -s))
            sl = self.slots[victim]
            action = eng.cfg.preempt
            if action == "swap":
                if eng.admission is not None:
                    action = eng.admission.preempt_stream(
                        sl["req"], self._now, eng.profile.vanilla_time(1)
                    )
                if not hasattr(eng.runner, "swap_out"):
                    action = "shed"
            if action == "swap":
                handle = eng.runner.swap_out(victim)
                sl = self.slots.pop(victim)
                self.free.append(victim)
                self.free.sort()
                if eng.admission is not None:
                    eng.admission.forget((eng.wid, victim, sl["req"].rid))
                self.swapped.append({"req": sl["req"], "resp": sl["resp"],
                                     "handle": handle})
                eng.n_preempt_swaps += 1
            else:
                self._finish(victim, core, shed=True)
                eng.n_preempt_sheds += 1
            return True
        prefilling = [s for s in sorted(self.slots)
                      if self.slots[s]["resp"] is None and s != exclude]
        if not prefilling:
            return False
        victim = max(prefilling, key=lambda s: (slack(s), -s))
        sl = self.slots.pop(victim)
        self.free.append(victim)
        self.free.sort()
        if eng.runner is not None:
            eng.runner.free(victim)
        if eng.admission is not None:
            eng.admission.forget((eng.wid, victim, sl["req"].rid))
        resp = GenResponse(rid=sl["req"].rid, arrival_ms=sl["req"].arrival_ms,
                           release_ms=[], exit_sites=[], tokens=[],
                           final_tokens=[], worker=eng.wid,
                           slo_ms=sl["req"].slo_ms, shed=True)
        self.responses.append(resp)
        eng.n_shed += 1
        eng.n_preempt_sheds += 1
        return True

    def _readmit(self, core: EngineCore) -> None:
        """Swap preempted streams back into free slots while the pool has
        room (FIFO — the earliest victim resumes first)."""
        eng = self.eng
        while self.swapped and self.free:
            sid = self.free[0]
            try:
                eng.runner.swap_in(sid, self.swapped[0]["handle"])
            except PoolExhausted:
                return
            ent = self.swapped.popleft()
            self.free.pop(0)
            self.slots[sid] = {"req": ent["req"], "resp": ent["resp"]}
            eng.n_swap_ins += 1

    def _admit_one(self, r, core: EngineCore) -> bool:
        """Claim a slot for ``r``. Legacy path: serial prefill advances the
        pool clock and the first token releases immediately. Chunked path:
        the slot enters the prefilling state; chunks run inside steps.
        Returns False when the KV pool rejected the prompt and ``r`` was
        put back at the queue head to wait for live slots to drain."""
        eng = self.eng
        sid = self.free.pop(0)
        if eng.cfg.prefill_chunk > 0:
            self.slots[sid] = {"req": r, "resp": None,
                               "pf_left": r.prompt_len, "pf_fed": 0}
            return True
        skip = self._cached_tokens(r)
        while True:
            try:
                tok = eng.runner.start(sid, r.item) if eng.runner is not None else 0
                break
            except PoolExhausted:
                if eng.cfg.preempt != "none" and self._preempt_one(core):
                    continue
                self.free.append(sid)
                self.free.sort()
                if self.slots:
                    # live slots will free blocks: retry at a later boundary
                    self.queue.appendleft(r)
                    return False
                # an empty engine still can't fit the prompt: hopeless
                resp = GenResponse(rid=r.rid, arrival_ms=r.arrival_ms,
                                   release_ms=[], exit_sites=[], tokens=[],
                                   final_tokens=[], worker=eng.wid,
                                   slo_ms=r.slo_ms, dropped=True)
                self.responses.append(resp)
                core.emit(self._now, self.pool, (r.rid, -1))
                return True
        self._now += eng.prefill_ms(max(int(r.prompt_len) - skip, 0))
        resp = GenResponse(
            rid=r.rid, arrival_ms=r.arrival_ms, release_ms=[self._now],
            exit_sites=[-1], tokens=[tok], final_tokens=[tok],
            worker=eng.wid, slo_ms=r.slo_ms,
        )
        self.slots[sid] = {"req": r, "resp": resp}
        eng.n_tokens += 1
        core.emit(self._now, self.pool, (r.rid, 0))
        if r.n_tokens <= 1:
            self._finish(sid, core)
        return True

    def _prefill_chunks(self, core: EngineCore) -> float:
        """Run one prefill chunk per prefilling slot; returns the chunk time
        co-scheduled into this step. Completed prompts are recorded in the
        slot state; their first token releases at step end."""
        eng = self.eng
        incremental = eng.runner is not None and hasattr(eng.runner, "prefill_begin")
        chunk_ms = 0.0
        for sid in sorted(self.slots):
            if sid not in self.slots:  # preempted earlier in this pass
                continue
            sl = self.slots[sid]
            if sl["resp"] is not None:
                continue
            r = sl["req"]
            if incremental and sl["pf_fed"] == 0 and "pf_skip" not in sl:
                # prompt tokens the prefix cache covers cost no chunk time;
                # the runner shares their cached blocks at prefill_begin
                sl["pf_skip"] = min(self._cached_tokens(r), sl["pf_left"])
                sl["pf_left"] -= sl["pf_skip"]
            c = min(eng.cfg.prefill_chunk, sl["pf_left"])
            if c > 0:
                chunk_ms += eng.prefill_ms(c)
                eng.n_chunks += 1
                if incremental and "pf_tok" not in sl:
                    tok = self._feed_chunk(sid, sl, r, c, core)
                    if sid not in self.slots:  # shed: its prompt can't fit
                        continue
                    if tok is not None:  # runner's prompt exhausted: first token
                        sl["pf_tok"] = int(tok)
                sl["pf_left"] -= c
                sl["pf_fed"] += c
            if sl["pf_left"] <= 0 and "pf_tok" not in sl:
                # non-incremental runner (or None), a zero-length prompt, or
                # a fully prefix-cached one: one-shot start at the
                # completing chunk
                sl["pf_tok"] = int(eng.runner.start(sid, r.item)) if (
                    eng.runner is not None) else 0
        eng.chunk_ms += chunk_ms
        return chunk_ms

    def _feed_chunk(self, sid: int, sl: dict, r, c: int, core: EngineCore):
        """Feed one prefill chunk into the runner, preempting victims on
        pool exhaustion when configured; as a last resort the slot itself
        is shed (its prompt cannot fit even a drained pool)."""
        eng = self.eng
        while True:
            try:
                if sl["pf_fed"] == 0:
                    return eng.runner.prefill_begin(sid, r.item, sl.get("pf_skip", 0) + c)
                return eng.runner.prefill_resume(sid, c)
            except PoolExhausted:
                if eng.cfg.preempt == "none":
                    raise
                if not self._preempt_one(core, exclude=sid):
                    if not self._preempt_one(core):  # shed sid itself
                        raise
                    return None

    # -- event loop ----------------------------------------------------------

    def wake(self, core: EngineCore, t: float) -> None:
        eng = self.eng
        self._now = max(self._now, t)
        n = len(self.reqs)
        while self._i < n or self.queue or self.slots or self.swapped:
            now = self._now
            while self._i < n and self.reqs[self._i].arrival_ms <= now + 1e-9:
                r = self.reqs[self._i]
                self._i += 1
                if eng.admission is not None and not eng.admission.admit_token_stream(
                    r, now, eng.profile.vanilla_time(1)
                ):
                    resp = GenResponse(rid=r.rid, arrival_ms=r.arrival_ms,
                                       release_ms=[], exit_sites=[], tokens=[],
                                       final_tokens=[], worker=eng.wid,
                                       slo_ms=r.slo_ms, dropped=True)
                    self.responses.append(resp)
                    core.emit(now, self.pool, (r.rid, -1))
                    continue
                self.queue.append(r)
            # swapped victims get their slots back before new admissions
            if self.swapped:
                self._readmit(core)
            if not self.slots and not self.queue:
                if self.swapped:
                    # an EMPTY engine still can't readmit the head stream —
                    # its blocks exceed the drained pool: hopeless, shed it
                    ent = self.swapped.popleft()
                    ent["resp"].shed = True
                    eng.n_shed += 1
                    self.responses.append(ent["resp"])
                    continue
                if self._i >= n:
                    break
                core.schedule(self.reqs[self._i].arrival_ms, self)  # idle
                return
            # admit queued requests into free slots (FCFS, step boundary)
            while self.queue and self.free:
                if not self._admit_one(self.queue.popleft(), core):
                    break  # pool-blocked: wait for live slots to drain
            if not self.slots:
                continue
            self._step(core)
            core.schedule(self._now, self)
            return

    def _step(self, core: EngineCore) -> None:
        """One engine step — or one SYNC WINDOW when the runner exposes
        ``step_multi``: up to ``steps_per_sync`` decode steps run in ONE
        dispatch with exit decisions made on-device against the
        controller's (stale-between-syncs) threshold copy, and the packed
        per-step records are REPLAYED here through the exact per-step
        accounting (observe → releases → KV deferral → shed), so the
        controller still sees every token and timing/SLO semantics are
        per-step. Chunked prefills are co-scheduled with the first decode
        step; windows shrink to 1 while any slot is prefilling (chunks
        must interleave every step) and never extend past the earliest
        finishing stream. The legacy per-step path is the special case of
        a runner without ``step_multi`` (and the equivalence tests pin
        ``steps_per_sync=1`` bit-identical across both)."""
        eng = self.eng
        chunk_ms = self._prefill_chunks(core) if eng.cfg.prefill_chunk > 0 else 0.0
        ctl = eng.controller
        act = sorted(ctl.active) if ctl is not None else []
        multi = eng.runner is not None and ctl is not None and hasattr(
            eng.runner, "step_multi"
        )
        exits_d = None
        while True:
            sids = [s for s in sorted(self.slots) if self.slots[s]["resp"] is not None]
            B = len(sids)
            if not (B and eng.runner is not None and ctl is not None):
                break
            try:
                if multi:
                    prefilling = any(v["resp"] is None for v in self.slots.values())
                    n_window = 1 if prefilling else max(1, min(
                        eng.cfg.steps_per_sync,
                        min(self.slots[s]["req"].n_tokens
                            - len(self.slots[s]["resp"].tokens) for s in sids),
                    ))
                    # per-active-site thresholds as of DISPATCH time — the
                    # device copy the window's exits are decided against
                    thr = (ctl.thresholds[np.asarray(act, np.int64)].astype(np.float32)  # repro: allow[host-sync] — host index build from a python list — no device operand
                           if act else np.zeros(0, np.float32))
                    labels, unc, finals, exits_d = eng.runner.step_multi(
                        sids, act, n_window, thr
                    )
                    eng.n_windows += 1
                else:
                    l1, u1, f1 = eng.runner.step(sids, act)
                    labels, unc, finals = l1[None], u1[None], f1[None]
                break
            except PoolExhausted:
                # a stepped slot needs a block the pool can't give: preempt
                # the slackest victim and retry with the survivors
                if eng.cfg.preempt == "none" or not self._preempt_one(core):
                    raise
        eng.peak_slots = max(eng.peak_slots, B)
        live = bool(B and eng.runner is not None and ctl is not None)
        nd = finals.shape[0] if live else 1
        for t in range(nd):
            if live:
                # replay one window step: the device-decided exits are
                # honored (forced), the records still feed adaptation, and
                # ``act`` pins the gather set even if a mid-window _adjust
                # changes the controller's active ramps. The per-step path
                # keeps the bare legacy signature (stub controllers in the
                # tests implement exactly that protocol).
                if exits_d is None:
                    dec = ctl.observe(labels[t], unc[t], finals[t])
                else:
                    dec = ctl.observe(labels[t], unc[t], finals[t],
                                      forced_exits=exits_d[t], act=act)
                fin = finals[t]
                ex = np.asarray(dec.exit_sites, np.int64)  # repro: allow[host-sync] — controller decisions are already host numpy
                released = np.asarray(dec.released_labels)  # repro: allow[host-sync] — controller decisions are already host numpy
            else:
                fin = np.zeros(B, np.int64)
                ex = np.full(B, -1, np.int64)
                released = fin
            eng.slot_history.append(B)
            kv_now = self._pending_kv
            step_ms = eng.profile.decode_step_time(ex, act) + (
                chunk_ms if t == 0 else 0.0
            )
            start = self._now
            end = start + kv_now + step_ms
            self._pending_kv = 0.0
            eng.kv_ms += kv_now
            # releases + next-step KV deferral, grouped by exit site so the
            # catch-up's weight traffic amortizes across this step's exits
            kv_by_site: Dict[int, int] = {}
            for j, sid in enumerate(sids):
                sl = self.slots.get(sid)
                if sl is None or sl["resp"] is None:
                    continue  # shed at an earlier replayed step of this window
                site = int(ex[j])
                if site >= 0:
                    off = release_offset(eng.profile, site, B, act)
                    rel = min(start + kv_now + off, end)
                else:
                    rel = end
                resp = sl["resp"]
                resp.release_ms.append(rel)
                resp.exit_sites.append(site)
                resp.tokens.append(int(released[j]))
                resp.final_tokens.append(int(fin[j]))
                eng.n_tokens += 1
                core.emit(rel, self.pool, (sl["req"].rid, len(resp.tokens) - 1))
                done = len(resp.tokens)
                if done >= sl["req"].n_tokens:
                    self._finish(sid, core)  # slot reusable at the next step boundary
                elif eng.admission is not None and eng.admission.note_token(
                    (eng.wid, sid, sl["req"].rid), rel - resp.release_ms[-2],
                    sl["req"].slo_ms,
                ):
                    self._finish(sid, core, shed=True)  # doomed mid-stream: shed
                elif site >= 0:
                    kv_by_site[site] = kv_by_site.get(site, 0) + 1
            for site, cnt in kv_by_site.items():
                self._pending_kv += eng.profile.kv_fill_cost(site, cnt)
            eng.busy_ms += kv_now + step_ms
            eng.n_steps += 1
            self._now = end
        # completed prefills release their first token at step end
        for sid in sorted(self.slots):
            sl = self.slots[sid]
            if sl["resp"] is not None or sl.get("pf_left", 1) > 0:
                continue
            r, tok = sl["req"], sl.pop("pf_tok")
            del sl["pf_left"], sl["pf_fed"]
            sl.pop("pf_skip", None)
            sl["resp"] = GenResponse(
                rid=r.rid, arrival_ms=r.arrival_ms, release_ms=[end],
                exit_sites=[-1], tokens=[tok], final_tokens=[tok],
                worker=eng.wid, slo_ms=r.slo_ms,
            )
            eng.n_tokens += 1
            core.emit(end, self.pool, (r.rid, 0))
            if r.n_tokens <= 1:
                self._finish(sid, core)

    def finalize(self) -> List[GenResponse]:
        self.eng.makespan_ms = self._now
        self.responses.sort(key=lambda r: r.rid)
        return self.responses
