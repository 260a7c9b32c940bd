"""Latency-focused ramp adjustment (paper §3.3).

Periodic (every `adjust_every` samples): score each active ramp's utility
(savings − overheads) from recorded exit patterns; deactivate negative
ramps (after a rescue threshold-tuning round); propose replacement ramps
after the latest positive ramp using *upper-bound exit rates* (a
candidate's exit rate is bounded by the summed profiled rates of the
nearest downstream deactivated ramp and earlier deactivations — Fig 12);
when all utilities are positive, probe earlier ramps (add before the best
ramp if budget remains, else shift the worst ramp one site earlier).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.exits import evaluate_config, exit_rates, ramp_utilities, simulate_exits
from repro_torch.core.threshold_tuning import tune_thresholds


@dataclasses.dataclass
class AdjustResult:
    active: List[int]
    thresholds: np.ndarray
    deactivated: List[int]
    added: List[int]
    utilities: Dict[int, float]
    reason: str


def _within_budget(profile, active, budget_frac: float, bs: int) -> bool:
    ovh = sum(profile.ramp_overhead(s, bs) for s in active)
    return ovh <= budget_frac * profile.vanilla_time(bs) + 1e-12


def _candidates_between(lo: int, hi: int) -> Optional[int]:
    """Midpoint site in the open interval (lo, hi); None if empty."""
    if hi - lo <= 1:
        return None
    return (lo + hi) // 2


def adjust_ramps(
    window_data,
    active: Sequence[int],
    thresholds: np.ndarray,
    profile,
    *,
    n_sites: int,
    acc_constraint: float = 0.99,
    budget_frac: float = 0.02,
    max_slots: int = 8,
    bs: int = 1,
) -> AdjustResult:
    act = sorted(active)
    thr = thresholds.copy()
    # one exit simulation of the current (window, thr, act) shared by both
    # scorers — they used to each re-simulate the identical pattern
    ex0 = simulate_exits(window_data[0], window_data[2], thr, act)
    utils = ramp_utilities(window_data, thr, act, profile, bs, ex=ex0)
    rates = exit_rates(window_data, thr, act, ex=ex0)
    negatives = [s for s in act if utils[s] < 0]

    if negatives:
        # rescue round: can tuning alone fix the negatives without hurting savings?
        before = evaluate_config(window_data, thr, act, profile, bs)
        res = tune_thresholds(
            window_data, act, profile, n_sites=n_sites,
            acc_constraint=acc_constraint, bs=bs,
        )
        utils2 = ramp_utilities(window_data, res.thresholds, act, profile, bs)
        if all(u >= 0 for u in utils2.values()) and res.savings_ms >= before.mean_saved_ms:
            return AdjustResult(act, res.thresholds, [], [], utils2, "rescued-by-tuning")
        # deactivate all negative-utility ramps
        deact = sorted(negatives)
        survivors = [s for s in act if s not in deact]
        positives = [s for s in survivors if utils.get(s, 0) >= 0]
        latest_pos = max(positives) if positives else -1
        # interval structure after latest positive ramp, split by deactivations
        walls = [s for s in deact if s > latest_pos]
        bounds = [latest_pos] + walls + [n_sites]
        added: List[int] = []
        # iterative candidate search: midpoints, then later midpoints
        search = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
        tried = 0
        while search and not added and tried < 2 * n_sites:
            tried += 1
            best = None
            nxt = []
            for lo, hi in search:
                c = _candidates_between(lo, hi)
                if c is None or c in survivors:
                    continue
                # upper-bound exit rate: nearest downstream deactivated ramp
                # + any earlier deactivations inside (lo, hi)  (Fig 12)
                ub = sum(rates.get(w, 0.0) for w in deact if lo < w <= hi)
                sav = profile.savings_at_site(c, bs)
                ovh = profile.ramp_overhead(c, bs)
                n = window_data[0].shape[0]
                util_ub = ub * n * sav - (1.0 - ub) * n * ovh
                if util_ub > 0 and (best is None or util_ub > best[1]):
                    best = (c, util_ub)
                nxt.append((c, hi))  # later candidates next round
            if best is not None:
                added.append(best[0])
                break
            search = nxt
        new_active = sorted(survivors + added)
        # enforce slots + budget
        new_active = new_active[: max_slots]
        while new_active and not _within_budget(profile, new_active, budget_frac, bs):
            new_active.pop()
        for s in added:
            thr[s] = 0.0  # trial ramps start closed (paper)
        return AdjustResult(
            new_active, thr, deact, [a for a in added if a in new_active],
            utils, "deactivated-negative",
        )

    # all positive: first re-enforce the budget (it may have tightened)
    if act and not _within_budget(profile, act, budget_frac, bs):
        keep = sorted(act, key=lambda s: -utils[s])
        pruned = []
        for s in keep:
            if _within_budget(profile, pruned + [s], budget_frac, bs):
                pruned.append(s)
        return AdjustResult(
            sorted(pruned), thr, [s for s in act if s not in pruned], [],
            utils, "budget-shrink",
        )
    # low-risk earlier-ramp probing
    if not act:
        mid = n_sites // 2
        if not _within_budget(profile, [mid], budget_frac, bs):
            # even one mid ramp busts the budget (e.g. untied full-vocab
            # heads): stay ramp-less rather than violate the guarantee
            return AdjustResult([], thr, [], [], utils, "noop")
        thr[mid] = 0.0
        return AdjustResult([mid], thr, [], [mid], utils, "bootstrap")
    best_site = max(act, key=lambda s: utils[s])
    worst_site = min(act, key=lambda s: utils[s])
    can_add = len(act) < max_slots and _within_budget(
        profile, act + [max(best_site - 1, 0)], budget_frac, bs
    )
    if can_add:
        cand = best_site - 1
        prev_active = [s for s in act if s < best_site]
        floor = max(prev_active) + 1 if prev_active else 0
        cand = max(cand, floor)
        if cand not in act and cand >= 0:
            thr[cand] = 0.0
            return AdjustResult(sorted(act + [cand]), thr, [], [cand], utils, "probe-add")
        return AdjustResult(act, thr, [], [], utils, "noop")
    # no budget: shift worst ramp one earlier (keep best untouched)
    tgt = worst_site - 1
    if tgt >= 0 and tgt not in act and worst_site != best_site:
        new_active = sorted([s for s in act if s != worst_site] + [tgt])
        thr[tgt] = 0.0
        return AdjustResult(new_active, thr, [worst_site], [tgt], utils, "probe-shift")
    return AdjustResult(act, thr, [], [], utils, "noop")
