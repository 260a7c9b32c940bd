"""Generative decode runner: drives the real model over a batched slot cache
and streams one ramp record per in-flight token to the controller.

The port's counterpart of the JAX package's contiguous ``DecodeRunner``
(``serving/runner.py``). Only ~KB record arrays (top-1 label, max-prob per
ramp, the final label) travel to the host, never logits. The paged pool,
prefix cache, swap and chunked prefill are not ported yet.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class PoolExhausted(RuntimeError):
    """Raised when a paged KV pool has no free block for an allocation (the
    engine's preemption path catches it; the contiguous runner never raises
    it)."""


class DecodeRunner:
    """Real-model generative runner over ONE batched contiguous slot cache.

    ``start`` prefills a prompt into a slot row, ``step(slots, active)``
    gathers the live rows, runs one decode step with per-row positions and
    scatters the rows back; ``step_multi`` runs a SYNC WINDOW of up to N
    steps with the exit decisions taken on device; ``free`` releases the
    row. Live rows are padded to a power-of-two bucket with FREE rows, then
    duplicates of stepped rows, exactly as the reference pads them, so the
    two runners see equal batch shapes.

    Records are replay-complete: the full model and the active ramp heads
    run for every token, because the controller needs agreement labels to
    adapt; serving *time* is simulated by the engine from the latency
    profile. The decoded trajectory follows the model's greedy tokens.
    """

    def __init__(self, model, params, prompts: np.ndarray, *, max_new_tokens: int = 64,
                 max_slots: int = 8, n_slots: Optional[int] = None):
        if str(model.cfg.decode_attn).startswith("paged"):
            raise NotImplementedError("the paged KV pool is not ported yet")
        self.model = model
        self.params = params
        self.device = params["tok"]["embed"].device
        self.prompts = np.asarray(prompts, np.int32)  # (N, S)
        self.max_new = max_new_tokens
        self.max_slots = max_slots  # K ramp slots (not decode rows)
        self.n_sites = len(model.sites)
        self.dispatches = 0  # decode calls: 1 per step or per window
        self._cache = None  # batched slot cache; rows grown on demand
        self._rows = 0 if n_slots is None else _bucket(max(n_slots, 1))
        self._cache_len = self.prompts.shape[1] + self.max_new
        self._live = set()
        self._pos = np.zeros(0, np.int64)
        self._tok = np.zeros(0, np.int64)
        self._axes: Optional[Tuple[int, ...]] = None  # per-leaf batch axis
        # device-resident exit thresholds: pushed once per sync window and
        # ONLY when the controller actually changed them
        self._thr_host = None
        self._thr_dev = None

    # -- host <-> device -----------------------------------------------------

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device without a host sync (pinned, async copy)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- batched-cache plumbing ---------------------------------------------

    @staticmethod
    def _diff_axes(a, b) -> Tuple[int, ...]:
        """Per-leaf axis where two schema variants disagree: the batch axis
        (1 for the stacked (L, B, S, K, hd) leaves)."""
        return tuple(
            next(i for i, (x, y) in enumerate(zip(la.shape, lb.shape)) if x != y)
            for la, lb in zip(tree_leaves(a), tree_leaves(b))
        )

    def _grow_rows(self, rows: int) -> None:
        self._rows = rows
        self._pos = np.concatenate([self._pos, np.zeros(rows - len(self._pos), np.int64)])
        self._tok = np.concatenate([self._tok, np.zeros(rows - len(self._tok), np.int64)])

    def _ensure_rows(self, n: int) -> None:
        """Allocate (or grow) the batched cache to >= n power-of-two rows.
        Growth copies live rows once; steady state never reallocates."""
        if self._cache is not None and n <= self._rows:
            return
        rows = _bucket(max(n, self._rows, 1))
        new = self.model.init_cache(rows, self._cache_len, device=self.device)
        if self._axes is None:
            self._axes = self._diff_axes(
                self.model.cache_schema(1, 2), self.model.cache_schema(2, 2)
            )
        if self._cache is not None:
            for nl, ol, ax in zip(tree_leaves(new), tree_leaves(self._cache), self._axes):
                nl.narrow(ax, 0, ol.shape[ax]).copy_(ol)
        self._cache = new
        self._grow_rows(rows)

    def _tree_take(self, cache, rows: torch.Tensor):
        leaves = iter(self._axes)
        return tree_map(lambda l: l.index_select(next(leaves), rows), cache)

    def _tree_put(self, cache, sub, rows: torch.Tensor) -> None:
        """Scatter ``sub``'s rows into ``cache`` IN PLACE along each leaf's
        batch axis (the reference donates the cache to its jitted program;
        here the update is in place). Duplicate rows carry identical values."""
        for l, s, ax in zip(tree_leaves(cache), tree_leaves(sub), self._axes):
            l.index_copy_(ax, rows, s)

    def cache_bytes(self) -> int:
        """Device bytes held by the KV cache."""
        if self._cache is None:
            return 0
        return int(sum(l.numel() * l.element_size() for l in tree_leaves(self._cache)))

    def kv_stats(self) -> dict:
        return {"paged": False, "cache_bytes": float(self.cache_bytes())}

    def _check_admission_capacity(self) -> None:
        """A slot started now writes ``prompt_len + max_new`` tokens into a
        cache sized at construction time: refuse here rather than let the
        clamped writes overwrite the slot's tail."""
        plen = int(self.prompts.shape[1])
        need = plen + self.max_new
        if need > self._cache_len:
            raise ValueError(
                f"cannot admit: prompt_len({plen}) + max_new({self.max_new}) "
                f"= {need} tokens exceeds the slot cache capacity — contiguous "
                f"cache_len {self._cache_len}; rebuild the runner with a larger "
                "max_new_tokens/cache"
            )

    # -- engine interface ----------------------------------------------------

    def start(self, slot: int, item: int) -> int:
        """Prefill ``item``'s prompt into ``slot``'s cache row; returns the
        first generated (greedy) token."""
        self._check_admission_capacity()
        self._ensure_rows(slot + 1)
        toks = self._to_dev(self.prompts[item][None, :].astype(np.int64))
        cache, outs = self.model.prefill(self.params, toks, cache_len=self._cache_len,
                                         active_sites=None, with_cache=True)
        self._tree_put(self._cache, cache, torch.full((1,), slot, device=self.device))
        # the sanctioned first-token read: admission needs the prefill label
        tok = int(outs["final"]["label"].reshape(-1)[0])
        self._live.add(slot)
        self._pos[slot] = self.prompts.shape[1]
        self._tok[slot] = tok
        return tok

    def _validate_active(self, active: Sequence[int]) -> List[int]:
        """Sorted active set, refusing (not silently truncating) oversize sets."""
        act = sorted(int(a) for a in active)
        if len(act) > self.max_slots:
            raise ValueError(
                f"active ramp set has {len(act)} sites, max_slots={self.max_slots}"
            )
        return act

    def _validate_slots(self, slots: Sequence[int]) -> List[int]:
        slots = [int(s) for s in slots]
        for s in slots:
            if s not in self._live:
                raise KeyError(f"slot {s} is not live (freed or never started)")
        return slots

    def _batch_rows(self, slots: List[int]) -> np.ndarray:
        """Stepped slots, then FREE rows (their state is garbage a future
        start() overwrites wholesale), then duplicates of stepped slots
        (gather precedes every write, so duplicates scatter identical
        values) up to the bucket. NEVER a live-but-unstepped row."""
        B = len(slots)
        bucket = min(_bucket(B), self._rows)
        free = [r for r in range(self._rows) if r not in self._live][: bucket - B]
        dup = [slots[i % B] for i in range(bucket - B - len(free))]
        return np.asarray(slots + free + dup, np.int64)

    def step(self, slots: Sequence[int], active: Sequence[int]):
        """ONE decode step for every slot in ``slots``. Returns
        (ramp_labels (K,B), ramp_unc (K,B), final (B,)) with rows in
        sorted(active) order and columns in ``slots`` order."""
        slots = self._validate_slots(slots)
        act = self._validate_active(active)
        B, k = len(slots), len(act)
        if B == 0:  # nothing in flight: no dispatch
            return (np.zeros((k, 0), np.int64), np.zeros((k, 0), np.float32),
                    np.zeros(0, np.int64))
        rows = self._batch_rows(slots)
        rows_d = self._to_dev(rows)
        toks = self._to_dev(self._tok[rows].reshape(-1, 1))
        pos = self._to_dev(self._pos[rows])
        sub = self._tree_take(self._cache, rows_d)
        sub, outs = self.model.decode(self.params, sub, toks, pos,
                                      active_sites=act if k else None)
        self._tree_put(self._cache, sub, rows_d)
        self.dispatches += 1
        # the sanctioned per-step record drain (the sync step_multi amortizes)
        final = outs["final"]["label"].cpu().numpy().reshape(-1)[:B].astype(np.int64)
        if k:
            labels = outs["ramps"]["label"].cpu().numpy()[:, :B].astype(np.int64)
            mp = outs["ramps"]["maxprob"].float().cpu().numpy()[:, :B]
            unc = (np.float32(1.0) - mp).astype(np.float32)
        else:
            labels = np.zeros((0, B), np.int64)
            unc = np.zeros((0, B), np.float32)
        self._pos[rows[:B]] += 1
        self._tok[rows[:B]] = final  # vanilla greedy trajectory (agreement baseline)
        return labels, unc, final

    def _thr_device(self, thr: np.ndarray) -> torch.Tensor:
        """Device-resident per-site exit thresholds, padded to ``max_slots``
        with 0.0 (strict ``<``: pad sites never fire). Re-pushed ONLY when
        the controller's values changed."""
        pad = np.zeros(self.max_slots, np.float32)
        pad[: len(thr)] = thr
        if self._thr_host is None or not np.array_equal(pad, self._thr_host):
            self._thr_host = pad
            self._thr_dev = self._to_dev(pad)
        return self._thr_dev

    def step_multi(self, slots: Sequence[int], active: Sequence[int],
                   n_steps: int, thresholds: np.ndarray):
        """A SYNC WINDOW: up to ``n_steps`` decode steps with per-row exit
        decisions made ON DEVICE against ``thresholds`` (the controller's
        per-active-site values, deliberately stale between syncs). The host
        reads ONE scalar per window, the executed-step count ``nd``, then
        drains the records.

        Returns ``(labels, unc, finals, exits)``: ``labels``/``unc`` are
        ``(nd, K, B)`` in sorted(active) x ``slots`` order, ``finals``/
        ``exits`` are ``(nd, B)``; ``exits[t, b]`` is the FIRST active site
        whose on-device mask fired for slot ``b`` at window step ``t``
        (-1 = none). The window ends after the first step where every
        stepped row exits."""
        slots = self._validate_slots(slots)
        act = self._validate_active(active)
        k = len(act)
        if int(n_steps) < 1:
            raise ValueError(f"sync window needs n_steps >= 1, got {n_steps}")
        thr = np.asarray(thresholds, np.float32).reshape(-1)
        if thr.shape[0] != k:
            raise ValueError(
                f"thresholds has {thr.shape[0]} entries for {k} active sites"
            )
        B = len(slots)
        if B == 0:
            return (np.zeros((0, k, 0), np.int64), np.zeros((0, k, 0), np.float32),
                    np.zeros((0, 0), np.int64), np.zeros((0, 0), np.int64))
        headroom = min(self._cache_len - int(self._pos[s]) for s in slots)
        n = min(int(n_steps), max(1, headroom))
        rows = self._batch_rows(slots)
        rows_d = self._to_dev(rows)
        toks = self._to_dev(self._tok[rows].reshape(-1, 1))
        pos = self._to_dev(self._pos[rows])
        # FREE pad rows hold garbage: mask them out of the all-exited vote
        valid = np.zeros(len(rows), bool)
        valid[:B] = True
        sub = self._tree_take(self._cache, rows_d)
        sub, (rl, rm, fl, ex, ndv) = self.model.decode_multi(
            self.params, sub, toks, pos, n, n_max=_bucket(n),
            active_sites=act if k else None,
            thresholds=self._thr_device(thr) if k else None,
            row_valid=self._to_dev(valid),
        )
        self._tree_put(self._cache, sub, rows_d)
        self.dispatches += 1  # ONE call per window, however many steps ran
        # the ONE host sync per window; the record copies below find the
        # device idle
        nd = int(ndv)
        labels = rl[:nd, :k, :B].cpu().numpy().astype(np.int64)
        unc = (np.float32(1.0) - rm[:nd, :k, :B].cpu().numpy()).astype(np.float32)
        finals = fl[:nd, :B].cpu().numpy().astype(np.int64)
        exits = ex[:nd, :B].cpu().numpy().astype(np.int64)
        self._pos[rows[:B]] += nd
        self._tok[rows[:B]] = finals[nd - 1]
        return labels, unc, finals, exits

    def free(self, slot: int) -> None:
        self._live.discard(slot)
