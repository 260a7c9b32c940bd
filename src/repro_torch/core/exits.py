"""Exit-pattern evaluation over recorded ramp statistics.

The paper's key enabler: because inputs always run to completion, every
active ramp's (top-1 result, error score) is recorded for every sample —
so *any* threshold configuration can be evaluated offline against the
original model's outputs, accounting for inter-ramp dependencies (§3.2).

`RecordWindow` is the controller-side ring buffer of those records;
evaluation functions are vectorized numpy (the controller runs on host,
off the accelerator critical path).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


class RecordWindow:
    """Ring buffer over samples × feasible sites.

    unc[n, s]     uncertainty (1 - maxprob by default) of ramp s on sample n
    correct[n, s] ramp-s top-1 == original model top-1
    valid[n, s]   ramp s was active (recorded) when sample n was served
    """

    def __init__(self, n_sites: int, capacity: int = 2048):
        self.capacity = capacity
        self.n_sites = n_sites
        self.unc = np.full((capacity, n_sites), np.nan, np.float32)
        self.correct = np.zeros((capacity, n_sites), bool)
        self.valid = np.zeros((capacity, n_sites), bool)
        self.ptr = 0
        self.count = 0  # total samples ever observed

    def append(self, sites: Sequence[int], unc: np.ndarray, correct: np.ndarray):
        """sites: (K,) site indices; unc/correct: (K, B).

        When ``B > capacity`` only the newest ``capacity`` samples can
        survive; keep exactly those (``(ptr + arange(B)) % capacity``
        would produce duplicate ring indices, corrupting row order while
        ``count`` silently advanced past the write)."""
        B = unc.shape[1]
        keep = min(B, self.capacity)
        if keep < B:
            unc = unc[:, B - keep:]
            correct = correct[:, B - keep:]
        idx = (self.ptr + np.arange(keep)) % self.capacity
        self.unc[idx] = np.nan
        self.correct[idx] = False
        self.valid[idx] = False
        for j, s in enumerate(sites):
            self.unc[idx, s] = unc[j]
            self.correct[idx, s] = correct[j]
            self.valid[idx, s] = True
        self.ptr = int((self.ptr + keep) % self.capacity)
        self.count += B

    def last(self, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = min(n, self.count, self.capacity)
        idx = (self.ptr - n + np.arange(n)) % self.capacity
        return self.unc[idx], self.correct[idx], self.valid[idx]


def simulate_exits(
    unc: np.ndarray,
    valid: np.ndarray,
    thresholds: np.ndarray,
    active: Sequence[int],
) -> np.ndarray:
    """First active site (ascending site order) whose uncertainty clears its
    threshold; -1 = no exit. unc/valid: (N, S); thresholds: (S,)."""
    if len(active) == 0 or unc.shape[0] == 0:
        return np.full(unc.shape[0], -1, np.int64)
    act = np.asarray(sorted(active))
    # STRICT comparison: threshold 0 precludes exiting (paper's bootstrap
    # state) even for saturated uncertainty-0 records.
    sub = valid[:, act] & (unc[:, act] < thresholds[act][None, :])
    anyx = sub.any(axis=1)
    first = sub.argmax(axis=1)
    return np.where(anyx, act[first], -1)


def simulate_exits_many(
    unc: np.ndarray,
    valid: np.ndarray,
    thr_batch: np.ndarray,
    active: Sequence[int],
) -> np.ndarray:
    """Vectorized `simulate_exits` over C candidate threshold vectors in
    one pass. thr_batch: (C, S); returns (C, N) exit sites (-1 = none).
    Row c is bit-identical to `simulate_exits(unc, valid, thr_batch[c],
    active)` — the adaptation hot loop depends on that."""
    C, N = thr_batch.shape[0], unc.shape[0]
    if len(active) == 0 or N == 0:
        return np.full((C, N), -1, np.int64)
    act = np.asarray(sorted(active))
    sub = valid[None, :, act] & (unc[None, :, act] < thr_batch[:, None, act])
    anyx = sub.any(axis=2)
    first = sub.argmax(axis=2)
    return np.where(anyx, act[first], -1)


@dataclasses.dataclass
class EvalResult:
    accuracy: float  # agreement w/ original model (non-exits count correct)
    mean_saved_ms: float  # mean latency delta vs vanilla (can be < 0)
    exit_rate: float
    exit_sites: np.ndarray  # per-sample site (-1 = none)


def site_cost_vectors(profile, active: Sequence[int], bs: int = 1):
    """Per-active-site (overhead, savings) vectors, in sorted-site order.
    Hoisted out of the evaluation loop so a tuning round prices its K
    candidates without re-walking the latency profile K times."""
    act = sorted(active)
    ovh = np.asarray([profile.ramp_overhead(s, bs) for s in act]) if act else np.zeros(0)
    sav = np.asarray([profile.savings_at_site(s, bs) for s in act]) if act else np.zeros(0)
    return ovh, sav


def evaluate_configs(
    window_data,
    thr_batch: np.ndarray,
    active: Sequence[int],
    profile,
    bs: int = 1,
    *,
    ovh: Optional[np.ndarray] = None,
    sav: Optional[np.ndarray] = None,
):
    """Vectorized `evaluate_config` over C candidate threshold vectors:
    one `simulate_exits_many` pass instead of C sequential evaluations
    (the threshold-tuning hot loop). thr_batch: (C, S). Returns
    (accuracy (C,), mean_saved_ms (C,), exit_rate (C,), exit_sites (C, N));
    row c is bit-identical to `evaluate_config(..., thr_batch[c], ...)`.
    ``ovh``/``sav`` accept the precomputed `site_cost_vectors` output."""
    unc, correct, valid = window_data
    thr_batch = np.asarray(thr_batch)
    C, N = thr_batch.shape[0], unc.shape[0]
    if N == 0:
        return (np.ones(C), np.zeros(C), np.zeros(C), np.full((C, 0), -1, np.int64))
    ex = simulate_exits_many(unc, valid, thr_batch, active)
    acc = np.where(
        ex >= 0, correct[np.arange(N)[None, :], np.clip(ex, 0, None)], True
    ).mean(axis=1)
    act = np.asarray(sorted(active))
    if ovh is None or sav is None:
        ovh, sav = site_cost_vectors(profile, active, bs)
    total_ovh = ovh.sum()
    if len(act):
        # released after ramp s: save downstream layers; pay ramps <= s.
        # Python-loop prefix sums match evaluate_config's sequential
        # `ovh[:i+1].sum()` accumulation exactly (np.cumsum may not).
        val = np.asarray([sav[i] - ovh[: i + 1].sum() for i in range(len(act))])
        pos = np.searchsorted(act, np.clip(ex, 0, None))
        saved = np.where(ex >= 0, val[pos], -total_ovh)
    else:
        saved = np.full((C, N), -total_ovh)
    return acc, saved.mean(axis=1), (ex >= 0).mean(axis=1), ex


def evaluate_config(
    window_data,
    thresholds: np.ndarray,
    active: Sequence[int],
    profile,
    bs: int = 1,
) -> EvalResult:
    """Evaluate (thresholds, active-set) on recorded samples against the
    latency profile. window_data = (unc, correct, valid)."""
    unc, correct, valid = window_data
    N = unc.shape[0]
    if N == 0:
        return EvalResult(1.0, 0.0, 0.0, np.full(0, -1, np.int64))
    acc, saved, rate, ex = evaluate_configs(
        window_data, np.asarray(thresholds)[None, :], active, profile, bs
    )
    return EvalResult(float(acc[0]), float(saved[0]), float(rate[0]), ex[0])


def ramp_utilities(
    window_data,
    thresholds: np.ndarray,
    active: Sequence[int],
    profile,
    bs: int = 1,
    *,
    ex: Optional[np.ndarray] = None,
) -> dict:
    """Paper §3.3: utility(r) = Σ savings(exits at r) − Σ ovh(r)·(alive non-
    exits at r). Returns {site: utility_ms_total} over the window. ``ex``
    accepts a precomputed `simulate_exits` result so callers evaluating the
    same (window, thresholds, active) don't re-simulate."""
    unc, correct, valid = window_data
    N = unc.shape[0]
    if ex is None:
        ex = simulate_exits(unc, valid, thresholds, active)
    act = sorted(active)
    out = {}
    alive = np.ones(N, bool)
    for s in act:
        exits_here = ex == s
        savings = profile.savings_at_site(s, bs)
        ovh = profile.ramp_overhead(s, bs)
        util = exits_here.sum() * savings - (alive & ~exits_here).sum() * ovh
        out[s] = float(util)
        alive = alive & ~exits_here
    return out


def exit_rates(window_data, thresholds, active, *, ex: Optional[np.ndarray] = None) -> dict:
    unc, correct, valid = window_data
    if ex is None:
        ex = simulate_exits(unc, valid, thresholds, active)
    N = max(len(ex), 1)
    return {s: float((ex == s).sum() / N) for s in sorted(active)}
