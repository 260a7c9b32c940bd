"""The Apparate controller (paper §3, Fig 7).

Consumes per-batch ramp records streamed from the accelerator (top-1 label
+ confidence per active ramp + the original model's top-1 — ~1KB/batch),
maintains the record window, issues exit decisions, and runs the two
adaptation loops:

  * accuracy monitor: 16-sample windowed agreement; tuning triggered the
    moment it drops below the constraint (§3.2);
  * periodic ramp adjustment every `adjust_every` samples (§3.3).

The controller is pure host-side numpy — on real hardware it runs on CPU
while the TPU streams records non-blocking, exactly like the paper's
CPU/GPU split.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.exits import RecordWindow, evaluate_config, simulate_exits
from repro_torch.core.ramp_adjust import adjust_ramps
from repro_torch.core.threshold_tuning import tune_thresholds


@dataclasses.dataclass
class ControllerConfig:
    acc_constraint: float = 0.99  # min agreement w/ original model
    ramp_budget_frac: float = 0.02  # max Σ ramp-overhead / vanilla latency
    max_slots: int = 8  # K gather slots on the accelerator
    monitor_window: int = 16  # paper: accuracy over past 16 samples
    tune_window: int = 512  # samples used to evaluate threshold configs
    adjust_every: int = 128  # paper: ramp adjustment every 128 samples
    metric: str = "maxprob"  # 'maxprob' -> unc = 1-maxprob | 'entropy'
    min_samples_to_tune: int = 32
    uniform_init: bool = True  # evenly space initial ramps (paper)


@dataclasses.dataclass
class BatchDecisions:
    exit_sites: np.ndarray  # (B,) site index or -1
    released_labels: np.ndarray  # (B,) label released to the client
    exited_early: np.ndarray  # (B,) bool


class ApparateController:
    def __init__(self, n_sites: int, profile, cfg: ControllerConfig = ControllerConfig()):
        self.n_sites = n_sites
        self.profile = profile
        self.cfg = cfg
        self.window = RecordWindow(n_sites, capacity=max(cfg.tune_window * 4, 2048))
        self.thresholds = np.zeros(n_sites, np.float32)
        self.active: List[int] = self._initial_ramps()
        self._since_adjust = 0
        self.stats = {
            "tunes": 0,
            "adjusts": 0,
            "ramp_changes": 0,
            "samples": 0,
            "tune_wall_s": 0.0,
        }
        self.history: List[dict] = []

    # -- initial placement (paper §3.1: evenly space max allowable ramps) ----

    def _initial_ramps(self) -> List[int]:
        k = min(
            self.cfg.max_slots,
            self.profile.max_ramps_within_budget(self.cfg.ramp_budget_frac, bs=1),
            self.n_sites,
        )
        if k <= 0:
            return []
        pos = np.linspace(0, self.n_sites - 1, k + 1, endpoint=False)[1:]
        return sorted({int(round(p)) for p in pos})

    # -- record ingestion ------------------------------------------------------

    def uncertainty(self, stats: dict) -> np.ndarray:
        if self.cfg.metric == "entropy":
            # normalized entropy in [0, 1]: H / log(n_classes). The class
            # count must come from the caller — inferring it from the
            # observed entropy can under-estimate the normalizer and yield
            # uncertainties > 1 (thresholds in [0,1] then never preclude
            # exiting on those records).
            if "n_classes" not in stats:
                raise KeyError(
                    "entropy metric requires 'n_classes' in the stats dict "
                    "(normalizer log(n_classes))"
                )
            return np.asarray(stats["entropy"]) / np.log(max(float(stats["n_classes"]), 2.0))
        return 1.0 - np.asarray(stats["maxprob"])

    def observe(
        self,
        ramp_labels: np.ndarray,  # (K, B)
        ramp_unc: np.ndarray,  # (K, B) uncertainty (already metric-mapped)
        final_labels: np.ndarray,  # (B,)
        *,
        forced_exits: Optional[np.ndarray] = None,  # (B,) device-decided sites
        act: Optional[Sequence[int]] = None,  # pin the record's active set
    ) -> BatchDecisions:
        """Ingest one batch of records; return exit decisions for it.

        ``forced_exits`` replays exit sites already decided ON DEVICE (the
        sync-window runner's fused kernel): the records still enter the
        adaptation window — replay-completeness — but the serving
        decision honors what the device did under its (possibly stale)
        threshold copy instead of re-simulating under thresholds that may
        have just been retuned. ``act`` pins the active-site set the
        records were GATHERED under: a mid-window ``_adjust`` can change
        ``self.active``, and later replayed steps of that window must
        still land their rows against the sites that produced them."""
        act = list(self.active) if act is None else list(act)
        B = final_labels.shape[0]
        K = len(act)
        correct = ramp_labels[:K] == final_labels[None, :]
        self.window.append(act, ramp_unc[:K], correct)
        self.stats["samples"] += B
        self._since_adjust += B

        # decisions for THIS batch under current thresholds
        unc_m = np.full((B, self.n_sites), np.nan, np.float32)
        val_m = np.zeros((B, self.n_sites), bool)
        cor_m = np.zeros((B, self.n_sites), bool)
        for j, s in enumerate(act):
            unc_m[:, s] = ramp_unc[j]
            val_m[:, s] = True
            cor_m[:, s] = correct[j]
        if forced_exits is None:
            ex = simulate_exits(unc_m, val_m, self.thresholds, act)
        else:
            ex = np.asarray(forced_exits, np.int64).copy()
        released = np.asarray(final_labels).copy()
        for j, s in enumerate(act):
            m = ex == s
            released[m] = ramp_labels[j][m]

        # --- monitor: windowed accuracy triggers tuning (paper 16 samples)
        wd = self.window.last(self.cfg.monitor_window)
        mon = evaluate_config(wd, self.thresholds, act, self.profile)
        if (
            mon.accuracy < self.cfg.acc_constraint
            and self.window.count >= self.cfg.min_samples_to_tune
        ):
            self._tune()

        # --- periodic ramp adjustment
        if self._since_adjust >= self.cfg.adjust_every:
            self._since_adjust = 0
            self._adjust()

        return BatchDecisions(ex, released, ex >= 0)

    # -- adaptation -------------------------------------------------------------

    def _tune(self):
        wd = self.window.last(self.cfg.tune_window)
        res = tune_thresholds(
            wd,
            self.active,
            self.profile,
            n_sites=self.n_sites,
            acc_constraint=self.cfg.acc_constraint,
        )
        self.thresholds = res.thresholds
        self.stats["tunes"] += 1
        self.stats["tune_wall_s"] += res.wall_s
        self.history.append(
            {"kind": "tune", "acc": res.accuracy, "sav": res.savings_ms,
             "sample": self.stats["samples"]}
        )

    def _adjust(self):
        if self.window.count < self.cfg.min_samples_to_tune:
            return
        wd = self.window.last(self.cfg.tune_window)
        res = adjust_ramps(
            wd,
            self.active,
            self.thresholds,
            self.profile,
            n_sites=self.n_sites,
            acc_constraint=self.cfg.acc_constraint,
            budget_frac=self.cfg.ramp_budget_frac,
            max_slots=self.cfg.max_slots,
        )
        changed = set(res.active) != set(self.active)
        self.active = list(res.active)
        self.thresholds = res.thresholds
        self.stats["adjusts"] += 1
        if changed:
            self.stats["ramp_changes"] += 1
            # fresh trial ramps need records before thresholds move; tuning
            # will re-trigger via the monitor as data accrues
        self.history.append(
            {"kind": "adjust", "reason": res.reason, "active": list(res.active),
             "sample": self.stats["samples"]}
        )

    # -- serving-side helpers ----------------------------------------------------

    def active_slots(self, pad_to: Optional[int] = None) -> np.ndarray:
        """Active site indices padded to the accelerator's K gather slots."""
        k = pad_to or self.cfg.max_slots
        act = sorted(self.active)[:k]
        pad = act + [act[-1] if act else 0] * (k - len(act))
        return np.asarray(pad, np.int32)

    def total_ramp_overhead(self, bs: int = 1) -> float:
        return sum(self.profile.ramp_overhead(s, bs) for s in self.active)
