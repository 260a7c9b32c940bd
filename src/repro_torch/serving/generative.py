"""Generative autoregressive decode serving (paper §5, Table 4).

Discrete-event engine over decode *steps*: each request is a
(prompt, n_tokens) pair that occupies one continuous-batching slot from
admission until its last token; finished requests free their slot
mid-run, and queued requests join at the next step boundary (slot-based
continuous batching).

Every step consults the replica's ``ApparateController`` with one ramp
record per in-flight token. A token that exits at ramp ``s``:

  * releases early within the step (the client sees it at its exit
    offset, not at step end);
  * lets the per-layer batch shrink — deeper layers run with fewer
    tokens, and a layer with zero alive tokens is skipped entirely
    (``LatencyProfile.decode_step_time``), which is where the paper's
    22.6–77.9% median time-per-token wins come from;
  * still owes the deeper layers its KV / recurrent state so FUTURE
    tokens can attend to it — the paper's hidden-state catch-up. That
    deferred ``kv_fill_cost`` is amortized into the NEXT decode step
    (grouped by exit site so weight traffic amortizes across the step's
    exits). Exits are never free; a request's LAST token owes nothing.

The event loop itself lives in `repro.serving.engine`
(``GenerativeAdapter`` on the shared ``EngineCore``); this class is the
replica facade holding config, profile, runner/controller, and run
stats. Unification opened two capabilities the bespoke loop could not
express:

  * **chunked prefill** — ``GenerativeConfig.prefill_chunk > 0`` splits
    each prompt into chunks co-scheduled with in-flight decode steps
    (one chunk per prefilling slot per step), so TPT never stalls behind
    a monolithic prefill; ``DecodeRunner`` prefills the real slot cache
    incrementally via ``prefill_begin``/``prefill_resume``;
  * **SLO-aware admission** — an ``AdmissionPolicy``
    (`repro.serving.policies`) drops hopeless requests at admission and
    sheds doomed slots mid-stream (reported by ``summarize_generative``).

TTFT = queue wait + prefill; per-token TPT = successive release deltas —
the split `summarize_generative` reports.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import EngineCore, GenerativeAdapter
from repro_torch.serving.request import GenRequest, GenResponse


@dataclasses.dataclass
class GenerativeConfig:
    max_batch_size: int = 8  # continuous-batching decode slots
    # prefill cost per prompt token relative to a bs=1 decode step: prefill
    # is compute-dense (weights amortize over the whole prompt), so a prompt
    # token costs a fraction of a memory-bound decode step. Overridable per
    # engine via ``prefill_ms``.
    prefill_frac: float = 0.3
    # > 0: chunked prefill — split each prompt into chunks of this many
    # tokens, co-scheduled with in-flight decode steps (0 = legacy serial
    # prefill at admission, which stalls the whole batch)
    prefill_chunk: int = 0
    # overload reaction when the paged KV pool exhausts mid-run:
    #   'none' — propagate PoolExhausted (legacy: pool sizing is a hard cap)
    #   'shed' — shed the slackest victim slot (its work is discarded)
    #   'swap' — swap the victim's KV blocks to a host buffer and readmit
    #            it when the pool drains; an AdmissionPolicy (if present)
    #            refines the choice per victim by SLO slack
    preempt: str = "none"
    # decode steps per controller sync (host round-trip). > 1 dispatches a
    # SYNC WINDOW: up to this many decode steps in one jitted while_loop
    # with exit decisions made on-device against a deliberately STALE
    # threshold copy; the window's packed records stream back at the sync
    # boundary and the controller replays every one of them, so
    # adaptation sees every token at most one window late. 1 = classic
    # per-step sync (bit-identical records either way — the equivalence
    # oracle the tests pin). Needs a runner exposing ``step_multi``;
    # others fall back to per-step.
    steps_per_sync: int = 1


def offered_decode_qps(profile, *, max_batch_size: int, tokens_per_request: int,
                       load: float) -> float:
    """Request arrival rate (req/s) offering ``load`` of one generative
    replica's decode capacity: a fully-batched replica retires one request
    per ``tokens_per_request`` steps at the batched step time (batching
    amortizes memory-bound decode — sizing from ``vanilla_time(1)`` would
    look ~max_batch_size times lighter than intended)."""
    step = profile.vanilla_time(max_batch_size)
    return load * max_batch_size * 1000.0 / (tokens_per_request * step)


class GenerativeEngine:
    """One generative serving replica (the decode analogue of ``Worker``).

    ``runner``/``controller`` may both be None for the vanilla (no-EE)
    baseline: identical admission and batching, every token runs to
    completion, no ramp overhead, no KV catch-up. ``admission`` is an
    optional ``AdmissionPolicy`` for SLO-aware drop/shed behavior.
    """

    def __init__(
        self,
        profile,
        cfg: Optional[GenerativeConfig] = None,
        runner=None,
        controller=None,
        *,
        wid: int = 0,
        prefill_ms: Optional[Callable[[int], float]] = None,
        admission=None,
    ):
        self.profile = profile
        self.cfg = cfg or GenerativeConfig()
        if self.cfg.max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {self.cfg.max_batch_size}")
        if self.cfg.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got {self.cfg.prefill_chunk}")
        if self.cfg.preempt not in ("none", "swap", "shed"):
            raise ValueError(
                f"preempt must be 'none'|'swap'|'shed', got {self.cfg.preempt!r}"
            )
        if self.cfg.steps_per_sync < 1:
            raise ValueError(
                f"steps_per_sync must be >= 1, got {self.cfg.steps_per_sync}"
            )
        if (runner is None) != (controller is None):
            raise ValueError("runner and controller must be supplied together (or neither)")
        self.runner = runner
        self.controller = controller
        self.admission = admission
        self.wid = wid
        self.prefill_ms = prefill_ms or (
            lambda plen: plen * self.cfg.prefill_frac * profile.vanilla_time(1)
        )
        # run stats
        self.makespan_ms = 0.0
        self.busy_ms = 0.0
        self.kv_ms = 0.0  # total deferred KV catch-up paid
        self.chunk_ms = 0.0  # co-scheduled chunked-prefill time
        self.n_steps = 0
        self.n_tokens = 0
        self.n_windows = 0  # sync windows dispatched (step_multi runners)
        self.n_chunks = 0  # prefill chunks co-scheduled into steps
        self.n_shed = 0  # slots shed mid-stream by the admission policy
        self.n_preempt_swaps = 0  # pool-exhaustion victims swapped to host
        self.n_preempt_sheds = 0  # pool-exhaustion victims shed outright
        self.n_swap_ins = 0  # swapped streams readmitted
        self.peak_slots = 0
        self.slot_history: List[int] = []  # per-step decoding batch sizes
        self.core: Optional[EngineCore] = None  # last run's engine core

    # -- event loop (delegated to the unified engine core) -------------------

    def _make_adapter(self, requests: Sequence[GenRequest]) -> GenerativeAdapter:
        """The engine-core adapter for this replica (shared with
        ``MixedClusterSimulator``, which co-schedules several replicas on
        one core)."""
        return GenerativeAdapter(self, requests)

    def run(self, requests: Sequence[GenRequest]) -> List[GenResponse]:
        core = EngineCore()
        adapter = core.add(self._make_adapter(requests))
        core.run()
        self.core = core
        return adapter.finalize()

    def stats(self) -> Dict[str, float]:
        out = {
            "busy_ms": self.busy_ms,
            "kv_catchup_ms": self.kv_ms,
            "steps": float(self.n_steps),
            "tokens": float(self.n_tokens),
            "peak_slots": float(self.peak_slots),
            "mean_step_batch": float(np.mean(self.slot_history)) if self.slot_history else 0.0,
        }
        if self.cfg.prefill_chunk > 0:
            out["prefill_chunks"] = float(self.n_chunks)
            out["prefill_chunk_ms"] = self.chunk_ms
        if self.cfg.preempt != "none":
            out["preempt_swaps"] = float(self.n_preempt_swaps)
            out["preempt_sheds"] = float(self.n_preempt_sheds)
            out["swap_ins"] = float(self.n_swap_ins)
        if self.admission is not None:
            out["shed"] = float(self.n_shed)
            out.update({f"admission_{k}": v for k, v in self.admission.stats().items()})
        if self.controller is not None:
            out["ramp_overhead_ms"] = self.controller.total_ramp_overhead(1)
            out["active_ramps"] = float(len(self.controller.active))
        if self.n_windows:
            # host round-trips: one controller sync per window instead of
            # one per decode step (host_syncs / tokens is the bench metric)
            out["sync_windows"] = float(self.n_windows)
        if self.runner is not None and hasattr(self.runner, "dispatches"):
            # accelerator dispatches issued by the runner across the run:
            # 1/step for the batched DecodeRunner, B/step for the per-slot
            # loop — the tension bench_decode_dispatch measures
            out["decode_dispatches"] = float(self.runner.dispatches)
        return out
