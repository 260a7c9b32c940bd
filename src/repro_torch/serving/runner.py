"""Model runners: execute the real model per batch and stream ramp records to
the controller.

The port's counterparts of the JAX package's ``serving/runner.py``: the
classification runners (``ClassifierRunner`` for ResNet and BERT,
``LMTokenRunner`` for next-token serving, and the model-free
``SyntheticRunner``, a verbatim copy) and the generative ``DecodeRunner``,
over a contiguous slot cache or a paged block pool with prefix sharing,
copy-on-write, swap preemption and chunked prefill.
Only ~KB record arrays (top-1 label, max-prob per ramp, the final label)
travel to the host, never logits. ``BlockAllocator`` and ``PrefixCache``
are host numpy, copied verbatim from the JAX package (a test pins each copy
to its source): the port imports nothing of it.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.serving.graphs import WindowGraphs


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device without a host sync (pinned, async copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class PoolExhausted(RuntimeError):
    """Raised when the paged KV pool has no free block for an allocation
    (the engine's preemption path catches it; the contiguous runner never
    raises it). The allocator checks capacity BEFORE mutating any state, so
    a failed allocation never corrupts the block table."""


class BlockAllocator:
    """Host-side allocator for the paged KV-cache pool.

    The device pool holds ``n_blocks + 1`` physical blocks: block 0 is
    RESERVED as the trash block — bucket-padding rows point their zeroed
    table rows at it, so their (discarded) scatters land in memory no live
    slot ever reads. Allocatable ids are ``1..n_blocks``; the free heap
    always hands out the lowest id, so identical schedules produce
    identical tables (determinism the equivalence harness relies on).

    Physical blocks are REFCOUNTED: ``alloc`` hands out private blocks
    (refcount 1), ``share`` maps an already-live block into another slot's
    table (refcount += 1 — N slots with a common prompt prefix reference
    ONE physical block set), and the prefix cache holds references via
    ``pin``/``unpin``. A block returns to the free heap only when its last
    reference drops. ``cow`` implements copy-on-write: it swaps one table
    entry for a fresh private block so the caller can copy-then-mutate
    without touching the shared original.

    Invariants (asserted by the property tests):
      * every table entry (and every pinned id) references a live block;
      * ``refcount.sum() == sum(owned) + pins`` across any schedule;
      * ``n_free + (refcount > 0).sum() == n_blocks`` — no block is both
        free and referenced, none leaks;
      * allocation at exhaustion raises ``PoolExhausted`` atomically —
        no table/free-list/refcount mutation happens on the failing call.
    """

    def __init__(self, n_blocks: int, max_blocks_per_slot: int, n_slots: int = 0):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        self.n_blocks = n_blocks
        self.max_blocks = max_blocks_per_slot
        self._free = list(range(1, n_blocks + 1))  # min-heap of free ids
        heapq.heapify(self._free)
        self.table = np.zeros((n_slots, max_blocks_per_slot), np.int32)
        self.owned = np.zeros(n_slots, np.int32)
        self.refcount = np.zeros(n_blocks + 1, np.int32)  # per physical block
        self.pins = 0  # live cache (non-slot) references
        self.peak_blocks = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def grow_slots(self, n_slots: int) -> None:
        add = n_slots - self.table.shape[0]
        if add > 0:
            self.table = np.concatenate(
                [self.table, np.zeros((add, self.max_blocks), np.int32)]
            )
            self.owned = np.concatenate([self.owned, np.zeros(add, np.int32)])

    def grow_pool(self, n_blocks: int) -> None:
        """Extend the pool with fresh block ids (existing ownership kept)."""
        if n_blocks > self.n_blocks:
            self.refcount = np.concatenate(
                [self.refcount, np.zeros(n_blocks - self.n_blocks, np.int32)]
            )
        for b in range(self.n_blocks + 1, n_blocks + 1):
            heapq.heappush(self._free, b)
        self.n_blocks = max(self.n_blocks, n_blocks)

    def require(self, n: int) -> None:
        """Check ``n`` free blocks exist WITHOUT claiming anything — the
        all-or-nothing precondition for multi-slot claims."""
        if len(self._free) < n:
            raise PoolExhausted(
                f"paged KV pool exhausted: need {n} block(s), "
                f"{len(self._free)}/{self.n_blocks} free"
            )

    def alloc(self, slot: int, n: int = 1) -> List[int]:
        """Claim ``n`` private blocks for ``slot`` (atomic: all or nothing)."""
        if self.owned[slot] + n > self.max_blocks:
            raise ValueError(
                f"slot {slot} would exceed max_blocks={self.max_blocks}"
            )
        self.require(n)
        ids = [heapq.heappop(self._free) for _ in range(n)]
        k = int(self.owned[slot])
        self.table[slot, k : k + n] = ids
        self.owned[slot] += n
        self.refcount[ids] = 1
        self.peak_blocks = max(self.peak_blocks, self.live_blocks)
        return ids

    def alloc_pinned(self, n: int) -> List[int]:
        """Claim ``n`` blocks under a cache (non-slot) reference — the
        read-only pinned pages (cross-attention encoder KV) the runner
        owns directly rather than through a slot's table row. They are
        prefilled once, never appended, and freed via ``unpin``. Atomic:
        all or nothing."""
        self.require(n)
        ids = [heapq.heappop(self._free) for _ in range(n)]
        self.refcount[ids] = 1
        self.pins += n
        self.peak_blocks = max(self.peak_blocks, self.live_blocks)
        return ids

    def share(self, slot: int, ids: Sequence[int]) -> None:
        """Map already-live blocks into ``slot``'s table (prefix sharing):
        the slot references the SAME physical blocks, refcount += 1 each."""
        if not ids:
            return
        if self.owned[slot] + len(ids) > self.max_blocks:
            raise ValueError(
                f"slot {slot} would exceed max_blocks={self.max_blocks}"
            )
        for b in ids:
            if not (1 <= b <= self.n_blocks) or self.refcount[b] < 1:
                raise ValueError(f"cannot share non-live block {b}")
        k = int(self.owned[slot])
        self.table[slot, k : k + len(ids)] = ids
        self.owned[slot] += len(ids)
        for b in ids:
            self.refcount[b] += 1

    def cow(self, slot: int, idx: int) -> Tuple[int, int]:
        """Copy-on-write: replace ``slot``'s ``idx``-th table entry with a
        fresh private block and drop the reference on the old one. Returns
        ``(old_id, new_id)`` — the caller copies the block's contents on
        device before writing. Atomic: raises before any mutation."""
        self.require(1)
        old = int(self.table[slot, idx])
        new = heapq.heappop(self._free)
        self.refcount[new] = 1
        self.table[slot, idx] = new
        self._deref(old)
        self.peak_blocks = max(self.peak_blocks, self.live_blocks)
        return old, new

    def pin(self, b: int) -> None:
        """Take a cache (non-slot) reference on a live block."""
        if not (1 <= b <= self.n_blocks) or self.refcount[b] < 1:
            raise ValueError(f"cannot pin non-live block {b}")
        self.refcount[b] += 1
        self.pins += 1

    def unpin(self, b: int) -> None:
        """Drop a cache reference; the block frees once nothing else holds it."""
        self.pins -= 1
        self._deref(b)

    def _deref(self, b: int) -> None:
        self.refcount[b] -= 1
        if self.refcount[b] == 0:
            heapq.heappush(self._free, b)

    def release_tail(self, slot: int, keep: int) -> None:
        """Drop ``slot``'s table entries beyond the first ``keep`` — a sync
        window that terminated early unwinds its over-claimed appends here,
        restoring the exact allocator state the per-step path would hold.
        ``peak_blocks`` is deliberately NOT rewound: it records the
        transient high-water mark the window really reached."""
        k = int(self.owned[slot])
        if keep >= k:
            return
        for b in self.table[slot, keep:k]:
            self._deref(int(b))
        self.table[slot, keep:k] = 0
        self.owned[slot] = keep

    def free_slot(self, slot: int) -> None:
        """Drop every reference ``slot`` holds (blocks free at refcount 0)."""
        k = int(self.owned[slot])
        for b in self.table[slot, :k]:
            self._deref(int(b))
        self.table[slot, :] = 0  # stale entries must stay valid pool ids
        self.owned[slot] = 0

    def owned_ids(self, slot: int) -> List[int]:
        return [int(b) for b in self.table[slot, : int(self.owned[slot])]]


class PrefixCache:
    """Host-side prompt-prefix trie over the paged KV pool.

    Edges are full ``block_size``-token chunks (keyed by their raw bytes);
    a node pins the physical block holding that chunk's KV, so N prompts
    sharing a prefix resolve to ONE block chain. A whole-prompt entry
    additionally records the partial tail block (when the prompt doesn't
    end on a block boundary) plus the prompt's greedy first token — a
    fully cached prompt starts with ZERO device work (TTFT ~ host time).

    The cache holds one ``pin`` reference per cached block; slots that hit
    ``share`` the same ids. When the pool runs dry, ``evict_for`` unpins
    LRU leaf entries whose block nobody else references (refcount == 1),
    so eviction can never yank a block from under a live slot — and never
    strands a parent, since any slot using a child's chain walked (and
    shares) every ancestor too.
    """

    def __init__(self, alloc: BlockAllocator, block_size: int):
        self._alloc = alloc
        self.bs = int(block_size)
        self._root = {"children": {}, "block": 0, "tick": 0, "tails": {}, "first": None}
        self._tick = 0
        self.hits = 0
        self.tokens_saved = 0
        self.blocks_shared = 0  # cumulative blocks a lookup let a slot skip
        self.evictions = 0

    def lookup(self, toks: np.ndarray, limit: Optional[int] = None):
        """Longest cached cover of ``toks[:limit]`` in whole blocks:
        returns ``(block_ids, n_covered, first_tok)``. ``first_tok`` is
        non-None only on a whole-prompt hit (tail block included)."""
        toks = np.asarray(toks)
        S = len(toks) if limit is None else min(len(toks), int(limit))
        self._tick += 1
        node, ids, m = self._root, [], 0
        while (m + 1) * self.bs <= S:
            child = node["children"].get(toks[m * self.bs : (m + 1) * self.bs].tobytes())
            if child is None:
                break
            child["tick"] = self._tick
            ids.append(child["block"])
            node, m = child, m + 1
        covered = m * self.bs
        if covered == S and node is not self._root and node["first"] is not None:
            return ids, S, node["first"]
        if m == S // self.bs and S % self.bs and S == len(toks):
            tail = node["tails"].get(toks[covered:].tobytes())
            if tail is not None:
                tail["tick"] = self._tick
                return ids + [tail["block"]], S, tail["first"]
        return ids, covered, None

    def register(self, toks: np.ndarray, ids: Sequence[int], first_tok: int) -> None:
        """Record a fully prefilled prompt: ``ids`` are the owning slot's
        blocks in order. New chunks pin their block; chunks already cached
        keep their first-registered block (the slot shares it anyway)."""
        toks = np.asarray(toks)
        S = len(toks)
        self._tick += 1
        node = self._root
        for m in range(S // self.bs):
            key = toks[m * self.bs : (m + 1) * self.bs].tobytes()
            child = node["children"].get(key)
            if child is None:
                child = {"children": {}, "block": int(ids[m]), "tick": self._tick,
                         "tails": {}, "first": None}
                self._alloc.pin(int(ids[m]))
                node["children"][key] = child
            child["tick"] = self._tick
            node = child
        if S % self.bs:
            key = toks[S - S % self.bs :].tobytes()
            tail = node["tails"].get(key)
            if tail is None:
                node["tails"][key] = {"block": int(ids[S // self.bs]),
                                      "first": int(first_tok), "tick": self._tick}
                self._alloc.pin(int(ids[S // self.bs]))
            else:
                tail["tick"] = self._tick
        elif node is not self._root and node["first"] is None:
            node["first"] = int(first_tok)

    def _evictable(self):
        """All LRU-evictable entries: tails, plus chunk nodes with no
        descendants, whose block only the cache still references."""
        out = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            for key, tail in node["tails"].items():
                if self._alloc.refcount[tail["block"]] == 1:
                    out.append((tail["tick"], 1, key, node, tail))
            for key, ch in node["children"].items():
                if (not ch["children"] and not ch["tails"]
                        and self._alloc.refcount[ch["block"]] == 1):
                    out.append((ch["tick"], 0, key, node, ch))
                stack.append(ch)
        return out

    def evict_for(self, n: int) -> None:
        """Unpin least-recently-used cache-only entries until ``n`` blocks
        are free (or nothing evictable remains — the caller's ``require``
        then raises). Deterministic: ties break on kind then key bytes."""
        while self._alloc.n_free < n:
            cands = self._evictable()
            if not cands:
                return
            _, kind, key, parent, entry = min(cands, key=lambda c: c[:3])
            if kind == 1:
                del parent["tails"][key]
            else:
                del parent["children"][key]
            self._alloc.unpin(entry["block"])
            self.evictions += 1

    def clear(self) -> None:
        """Drop every cache reference (slots keep theirs)."""
        stack = [self._root]
        while stack:
            node = stack.pop()
            for tail in node["tails"].values():
                self._alloc.unpin(tail["block"])
            for ch in node["children"].values():
                self._alloc.unpin(ch["block"])
                stack.append(ch)
        self._root = {"children": {}, "block": 0, "tick": 0, "tails": {}, "first": None}


class SyntheticRunner:
    """Profile-only serving: deterministic ramp records without a model.

    A fixed fraction of items is "easy" — confidently predictable from
    ``exit_site`` onward — so controllers activate ramps and exit traffic
    exactly as with a trained model, at zero model cost. Used by the
    scale-out demos/benchmarks where training one model per replica-count
    sweep would dominate runtime.
    """

    def __init__(self, n_sites: int, exit_site: int, easy_frac: float = 0.7,
                 n_classes: int = 17):
        self.n_sites = n_sites
        self.exit_site = exit_site
        self.easy_frac = easy_frac
        self.n_classes = n_classes

    def infer(self, items: np.ndarray, active: Sequence[int]):
        items = np.asarray(items)  # repro: allow[host-sync] — host input normalization — items never lives on device
        k = len(active)
        B = len(items)
        final = (items % self.n_classes).astype(np.int64)
        easy = (items % 100) < self.easy_frac * 100
        # hard items DISAGREE with the original model at every ramp (like
        # SyntheticDecodeRunner): an over-opened threshold that releases
        # them costs accuracy, exactly as with a trained model. Tiling the
        # final label into every row made hard exits free.
        wrong = (final + 1) % self.n_classes
        labels = np.tile(wrong, (max(k, 1), 1))
        unc = np.full((max(k, 1), B), 0.9, np.float32)
        for j, s in enumerate(sorted(active)):
            if s >= self.exit_site:
                labels[j] = np.where(easy, final, wrong)
                unc[j] = np.where(easy, 0.02, 0.9)
        if k == 0:
            return labels[:0], unc[:0], final
        return labels[:k], unc[:k], final

    def vanilla_labels(self, n: int) -> np.ndarray:
        return np.arange(n, dtype=np.int64) % self.n_classes


class _BatchRunner:
    """One batch of classification requests through the model and its active
    ramps, with ONE device-to-host read of the records (the hot path makes
    no other sync). Items are padded to a power-of-two bucket by repeating
    the last one, as the reference pads them. The subclass's ``_forward``
    runs the model on a device batch.

    There is no jit: ``compiles`` and ``noramp_compiles`` count the variants
    the first time each runs, as the reference's compile cache would (a new
    (bucket, active set) key, a ramp-set change: the paper's model
    re-upload; a new bucket of the no-ramp variant)."""

    VANILLA_CHUNK = 128  # items a ``vanilla_labels`` batch

    def __init__(self, model, params, data: np.ndarray, max_slots: int = 8):
        self.model = model
        self.params = params
        self.data = data  # (N, ...) model inputs on the host
        self.max_slots = max_slots
        self.device = tree_leaves(params)[0].device
        self._variants = set()
        self.compiles = 0  # ramp-set changes (paper: model re-upload)
        self.noramp_compiles = 0  # no-ramp (vanilla) variants

    def _forward(self, x: torch.Tensor, act: Optional[List[int]]):
        """(ramp labels (K, B), ramp maxprob (K, B), final labels (B,)) on the
        device; ``act`` None is the no-ramp variant (ramp entries None)."""
        raise NotImplementedError

    def _count(self, key) -> None:
        if key not in self._variants:
            self._variants.add(key)
            if key[1] is None:
                self.noramp_compiles += 1
            else:
                self.compiles += 1

    def infer(self, items: np.ndarray, active: Sequence[int]):
        """Records of one batch: (ramp labels (K, n), ramp uncertainties
        1 - maxprob (K, n), final labels (n,)), rows in sorted(active)
        order. With no active ramp the model runs without any ramp head."""
        items = np.asarray(items)
        # sorted: the controller consumes record rows in ascending-site order
        act = sorted(int(s) for s in active)
        if len(act) > self.max_slots:
            # silently truncating would return fewer record rows than the
            # controller asked for: rows would land against the wrong sites
            raise ValueError(
                f"active ramp set has {len(act)} sites, max_slots={self.max_slots}")
        n, k = len(items), len(act)
        bs = _bucket(n)
        x = _to_device(self.data[np.pad(items, (0, bs - n), mode="edge")], self.device)
        self._count((bs, tuple(act) if k else None))
        labels, maxprob, final = self._forward(x, act if k else None)
        if not k:
            final = final.to(torch.int32).cpu().numpy()[:n].astype(np.int64)
            return np.zeros((0, n), np.int64), np.zeros((0, n), np.float32), final
        unc = (1.0 - maxprob.float()).view(torch.int32)
        rec = torch.cat([labels.to(torch.int32), unc, final.to(torch.int32)[None]])
        rec = rec.cpu().numpy()[:, :n]  # the sanctioned record drain: one read a batch
        return (rec[:k].astype(np.int64), rec[k:2 * k].view(np.float32).copy(),
                rec[2 * k].astype(np.int64))

    def vanilla_labels(self, n: Optional[int] = None) -> np.ndarray:
        """Original-model labels for the first ``n`` items (None: all), the
        accuracy ground truth, through the no-ramp variant."""
        # `n or len` would remap an explicit n=0 to the whole dataset
        n = n if n is not None else len(self.data)
        if n < 1:
            return np.zeros(0, np.int64)
        return np.concatenate([self.infer(np.arange(lo, min(lo + self.VANILLA_CHUNK, n)), [])[2]
                               for lo in range(0, n, self.VANILLA_CHUNK)])


class ClassifierRunner(_BatchRunner):
    """ResNet / BERT-style classifier serving (the paper's workloads): the
    model's ``forward`` on a batch of images or token sequences."""

    # the reference takes 256: a 256-image batch of ResNet-50 at 224 px holds
    # 13 GB f32 activations a stage-1 tensor
    VANILLA_CHUNK = 64

    def _forward(self, x, act):
        outs = self.model.forward(self.params, x, active_sites=act)
        if act is None:
            return None, None, outs["final"]["label"]
        return outs["ramps"]["label"], outs["ramps"]["maxprob"], outs["final"]["label"]


class LMTokenRunner(_BatchRunner):
    """Per-token early-exit serving for decoder LMs: each request is a
    context, the served result its next token (``LM.prefill`` without a
    cache, at the last position)."""

    def _forward(self, toks, act):
        _, outs = self.model.prefill(self.params, toks, active_sites=act, with_cache=False)
        if act is None:
            return None, None, outs["final"]["label"]
        return outs["ramps"]["label"], outs["ramps"]["maxprob"], outs["final"]["label"]


class DecodeRunner:
    """Real-model generative runner over ONE batched slot cache.

    ``start`` prefills a prompt into a slot, ``step(slots, active)`` runs
    one decode step with per-row positions; ``step_multi`` runs a SYNC
    WINDOW of up to N steps with the exit decisions taken on device;
    ``free`` releases the slot. Live rows are padded to a power-of-two
    bucket with FREE rows, then duplicates of stepped rows, exactly as the
    reference pads them, so the two runners see equal batch shapes.

    The cache is contiguous (one row per slot, gathered and scattered back
    around each call) or, with a ``decode_attn='paged*'`` model config,
    PAGED: one global pool of ``kv_blocks`` blocks of ``kv_block_size``
    tokens plus a per-slot block table kept by a host ``BlockAllocator``,
    decoded in place. ``start`` claims ``ceil(prompt_len / block_size)``
    blocks, a step appends a block only when a slot's current block fills,
    and ``free`` returns the slot's blocks, so KV memory scales with live
    tokens instead of ``n_slots * max_len``. ``kv_blocks=None`` sizes the
    pool to full slot capacity; a smaller pool raises ``PoolExhausted``
    cleanly when it runs dry. ``prefix_cache`` shares cached prompt-prefix
    blocks between slots (refcounted, copy-on-write); ``swap_out`` /
    ``swap_in`` move a preempted slot's blocks to the host and back;
    ``prefill_begin`` / ``prefill_resume`` prefill a prompt in chunks.

    Records are replay-complete: the full model and the active ramp heads
    run for every token, because the controller needs agreement labels to
    adapt; serving *time* is simulated by the engine from the latency
    profile. The decoded trajectory follows the model's greedy tokens.

    ``graphs`` runs each sync window as one CUDA graph replay
    (``serving/graphs.py``; one graph per bucket, step count and active
    set, captured when the key comes a second time): None captures on a
    CUDA device and runs eager on the CPU, False runs eager, True captures
    and refuses a CPU device. ``step`` and resumed prefill tokens always
    run eager.
    """

    def __init__(self, model, params, prompts: np.ndarray, *, max_new_tokens: int = 64,
                 max_slots: int = 8, n_slots: Optional[int] = None,
                 kv_block_size: int = 16, kv_blocks: Optional[int] = None,
                 prefix_cache: bool = False, graphs: Optional[bool] = None):
        self.model = model
        self.params = params
        self.device = params["tok"]["embed"].device
        self.prompts = np.asarray(prompts, np.int32)  # (N, S)
        self.max_new = max_new_tokens
        self.max_slots = max_slots  # K ramp slots (not decode rows)
        self.n_sites = len(model.sites)
        self.dispatches = 0  # decode calls: 1 per step or per window
        self.decode_steps = 0  # decode steps run, gated window steps included
        if graphs is True and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device; the params are on {self.device}")
        self.graphs: Optional[WindowGraphs] = (
            WindowGraphs(self.device, capture=True)
            if graphs or (graphs is None and self.device.type == "cuda") else None)
        self._cache = None  # batched slot cache or block pool; grown on demand
        self._rows = 0 if n_slots is None else _bucket(max(n_slots, 1))
        self._cache_len = self.prompts.shape[1] + self.max_new
        self._live = set()
        self._pos = np.zeros(0, np.int64)
        self._tok = np.zeros(0, np.int64)
        self._axes: Optional[Tuple[int, ...]] = None  # per-leaf batch axis
        self._pf_progress = {}  # slot -> item for in-flight chunked prefills
        # -- paged-KV state (decode_attn='paged' | 'paged-kernel')
        self.paged = str(model.cfg.decode_attn).startswith("paged")
        self._bs_blk = int(kv_block_size)
        self._kv_blocks = kv_blocks
        if self.paged and self._bs_blk < 1:
            raise ValueError(f"paged decode needs kv_block_size >= 1, got {kv_block_size}")
        if prefix_cache and not self.paged:
            raise ValueError("prefix_cache requires a paged decode_attn config")
        if prefix_cache and not model.paged_sharing_ok:
            raise ValueError(
                "prefix_cache: prefix sharing/CoW is unsound for this model "
                "family (recurrent-state, ring-window, or cross-attention "
                "pages cannot be shared between slots)"
            )
        self._max_blocks = -(-self._cache_len // self._bs_blk) if self.paged else 0
        self._alloc: Optional[BlockAllocator] = None
        self._pool_axes: Optional[Tuple[int, ...]] = None  # per-leaf pool axis
        # per-leaf page kinds steering the prefill scatter: 'tokens', or
        # 'state' (a mamba slot's recurrent state, one page at its first
        # table entry)
        self._kinds: Optional[Tuple[str, ...]] = (
            tuple(model.paged_cache_kinds(2, self._bs_blk)) if self.paged else None
        )
        self._want_prefix = bool(prefix_cache)
        self._prefix: Optional[PrefixCache] = None  # built with the allocator
        self.cow_copies = 0
        self.saved_blocks = 0  # cumulative blocks prefix hits let slots skip
        self.swap_outs = 0
        self.swap_ins = 0
        self.swapped_blocks = 0  # cumulative blocks moved to host buffers

    # -- host <-> device -----------------------------------------------------

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return _to_device(a, self.device)

    # -- batched-cache plumbing ---------------------------------------------

    @staticmethod
    def _diff_axes(a, b) -> Tuple[int, ...]:
        """Per-leaf axis where two schema variants disagree: the batch axis
        (contiguous) or the pool axis (paged), 1 for the stacked leaves."""
        return tuple(
            next(i for i, (x, y) in enumerate(zip(la.shape, lb.shape)) if x != y)
            for la, lb in zip(tree_leaves(a), tree_leaves(b))
        )

    @staticmethod
    def _grow_leaves(new, old, axes) -> None:
        """Copy every ``old`` leaf into the head of its ``new`` leaf along
        the per-leaf axis (rows or pool blocks)."""
        for nl, ol, ax in zip(tree_leaves(new), tree_leaves(old), axes):
            nl.narrow(ax, 0, ol.shape[ax]).copy_(ol)

    def _grow_rows(self, rows: int) -> None:
        self._rows = rows
        self._pos = np.concatenate([self._pos, np.zeros(rows - len(self._pos), np.int64)])
        self._tok = np.concatenate([self._tok, np.zeros(rows - len(self._tok), np.int64)])

    def _ensure_rows(self, n: int) -> None:
        """Allocate (or grow) the batched cache to >= n power-of-two rows.
        Growth copies live rows once; steady state never reallocates."""
        if self._cache is not None and n <= self._rows:
            return
        if self.paged:
            self._ensure_rows_paged(n)
            return
        rows = _bucket(max(n, self._rows, 1))
        new = self.model.init_cache(rows, self._cache_len, device=self.device)
        if self._axes is None:
            self._axes = self._diff_axes(
                self.model.cache_schema(1, 2), self.model.cache_schema(2, 2)
            )
        if self._cache is not None:
            self._grow_leaves(new, self._cache, self._axes)
        self._set_cache(new)
        self._grow_rows(rows)

    def _set_cache(self, new) -> None:
        """Replace the cache (or pool): the window graphs built over the old
        leaves go with it."""
        self._cache = new
        if self.graphs is not None:
            self.graphs.clear()

    def _tree_take(self, cache, rows: torch.Tensor):
        leaves = iter(self._axes)
        return tree_map(lambda l: l.index_select(next(leaves), rows), cache)

    def _tree_put(self, cache, sub, rows: torch.Tensor) -> None:
        """Scatter ``sub``'s rows into ``cache`` IN PLACE along each leaf's
        batch axis (the reference donates the cache to its jitted program;
        here the update is in place). Duplicate rows carry identical values."""
        for l, s, ax in zip(tree_leaves(cache), tree_leaves(sub), self._axes):
            l.index_copy_(ax, rows, s)

    # -- paged-pool plumbing -------------------------------------------------

    def _ensure_rows_paged(self, n: int) -> None:
        """Grow table rows (and, when ``kv_blocks`` is auto, the block pool)
        to cover >= n power-of-two slots. The pool holds ``n_blocks + 1``
        physical blocks: block 0 is the allocator's reserved trash block.
        Pool growth copies the old pool into the new one along the pool
        axis."""
        bs = self._bs_blk
        rows = _bucket(max(n, self._rows, 1))
        nblk = self._kv_blocks if self._kv_blocks is not None else rows * self._max_blocks
        if self._alloc is None:
            if self._pool_axes is None:
                self._pool_axes = self._diff_axes(
                    self.model.paged_cache_schema(1, bs), self.model.paged_cache_schema(2, bs)
                )
            self._alloc = BlockAllocator(nblk, self._max_blocks, rows)
            self._set_cache(self.model.init_paged_cache(nblk + 1, bs, device=self.device))
            if self._want_prefix:
                self._prefix = PrefixCache(self._alloc, bs)
        else:
            self._alloc.grow_slots(rows)
            if nblk > self._alloc.n_blocks:
                new = self.model.init_paged_cache(nblk + 1, bs, device=self.device)
                self._grow_leaves(new, self._cache, self._pool_axes)
                self._set_cache(new)
                self._alloc.grow_pool(nblk)
        self._grow_rows(rows)

    def cache_bytes(self) -> int:
        """Device bytes held by the KV cache (pool or contiguous rows)."""
        if self._cache is None:
            return 0
        return int(sum(l.numel() * l.element_size() for l in tree_leaves(self._cache)))

    def kv_stats(self) -> dict:
        out = {"paged": self.paged, "cache_bytes": float(self.cache_bytes())}
        if self.paged and self._alloc is not None:
            out.update(
                block_size=self._bs_blk,
                n_blocks=self._alloc.n_blocks,
                live_blocks=self._alloc.live_blocks,
                peak_blocks=self._alloc.peak_blocks,
                peak_token_capacity=self._alloc.peak_blocks * self._bs_blk,
                shared_blocks=int((self._alloc.refcount > 1).sum()),
                cow_copies=self.cow_copies,
                swap_outs=self.swap_outs,
                swap_ins=self.swap_ins,
                swapped_blocks=self.swapped_blocks,
            )
            if self._prefix is not None:
                out.update(
                    prefix_hits=self._prefix.hits,
                    prefix_tokens_saved=self._prefix.tokens_saved,
                    saved_blocks=self.saved_blocks,
                    prefix_evictions=self._prefix.evictions,
                    pinned_blocks=self._alloc.pins,
                )
        return out

    def _prefill_paged(self, toks: torch.Tensor, blk_ids: Sequence[int]):
        """Prefill ``toks`` (1, n) contiguously, then scatter the first
        ``len(blk_ids) * bs`` tokens' KV into pool blocks ``blk_ids`` (zero
        padded past the cache). Ids of shared blocks arrive as the trash
        block 0, so only the slot's own blocks are written. A "state" leaf
        (mamba) writes batch row 0's whole recurrent state into the slot's
        FIRST block, the id token leaves use for tokens 0..bs-1: distinct
        leaves, so the double use never collides. Returns the prefill's
        final-label tensor."""
        cache, outs = self.model.prefill(self.params, toks, cache_len=self._cache_len,
                                         active_sites=None, with_cache=True)
        bs, nb = self._bs_blk, len(blk_ids)
        ids = self._to_dev(np.asarray(blk_ids, np.int64))
        for pool, cont, ax, kind in zip(tree_leaves(self._cache), tree_leaves(cache),
                                        self._pool_axes, self._kinds):
            if kind == "state":
                pool.select(ax, int(blk_ids[0])).copy_(cont.select(ax, 0))
                continue
            if kind != "tokens":
                raise NotImplementedError(f"paged prefill of {kind!r} pages is not ported")
            # cont: batch (size 1) at ax, tokens at ax + 1; pool: P at ax,
            # then bs. Regroup the first nb*bs tokens into blocks.
            t = cont.select(ax, 0)
            need = nb * bs
            if t.shape[ax] < need:
                pad = list(t.shape)
                pad[ax] = need - t.shape[ax]
                t = torch.cat([t, t.new_zeros(pad)], dim=ax)
            t = t.narrow(ax, 0, need)
            t = t.reshape(t.shape[:ax] + (nb, bs) + t.shape[ax + 1:])
            pool.index_copy_(ax, ids, t.to(pool.dtype))
        return outs["final"]["label"]

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate physical block ``src`` into ``dst``
        across every cache leaf, in place."""
        for l, ax in zip(tree_leaves(self._cache), self._pool_axes):
            l.select(ax, dst).copy_(l.select(ax, src))

    # -- prefix sharing / CoW / swap plumbing --------------------------------

    def _reserve(self, n: int) -> None:
        """Guarantee ``n`` free blocks, evicting cache-only prefix entries
        (LRU) if needed; raises ``PoolExhausted`` without mutating slot
        state when even a drained cache can't cover the claim."""
        if self._prefix is not None:
            self._prefix.evict_for(n)
        self._alloc.require(n)

    def _claim_step_blocks(self, slots: Sequence[int], offset: int = 0) -> None:
        """All-or-nothing block claim for one decode-token write per slot:
        totals the appends (slot's current block full) and CoW copies
        (append lands in a block another slot or the prefix cache still
        references) across ALL stepped slots, reserves them in one pass,
        THEN mutates — a mid-loop ``PoolExhausted`` cannot leave earlier
        slots holding freshly appended blocks.

        ``offset`` claims for the write at ``pos + offset``: a sync window
        pre-claims its N steps as N sequential calls with offsets 0..N-1,
        the per-step claim (and prefix-eviction) order exactly, so block
        ids off the min-heap equal those of N separate ``step`` calls."""
        al, bs = self._alloc, self._bs_blk
        need_app, need_cow, total = [], [], 0
        for s in dict.fromkeys(slots):
            k, p = int(al.owned[s]), int(self._pos[s]) + offset
            na = max(0, p // bs + 1 - k)
            if k + na > al.max_blocks:
                raise ValueError(
                    f"slot {s} would exceed max_blocks={al.max_blocks}"
                )
            if na:
                need_app.append((s, na))
                total += na
            elif al.refcount[al.table[s, p // bs]] > 1:
                need_cow.append((s, p // bs))
                total += 1
        if not total:
            return
        self._reserve(total)
        for s, na in need_app:
            al.alloc(s, na)
        for s, bi in need_cow:
            old, new = al.cow(s, bi)
            self._copy_block(old, new)
            self.cow_copies += 1

    def _tables(self, rows: np.ndarray, zero_lo: int, zero_hi: int) -> np.ndarray:
        """Host block tables for ``rows``. Rows in ``[zero_lo, zero_hi)``,
        the FREE bucket-padding rows whose stale entries may reference
        blocks live slots now own, are redirected wholesale to the reserved
        trash block 0."""
        t = self._alloc.table[rows].copy()
        t[zero_lo:zero_hi] = 0
        return t

    def _check_admission_capacity(self) -> None:
        """A slot started now writes ``prompt_len + max_new`` tokens into a
        cache sized at construction time: refuse here rather than let the
        writes overflow the slot (contiguous: clamped writes overwrite its
        tail; paged: the table walk would leave the slot's blocks)."""
        plen = int(self.prompts.shape[1])
        need = plen + self.max_new
        if self.paged:
            cap = self._max_blocks * self._bs_blk
            layout = (f"paged capacity {cap} tokens "
                      f"({self._max_blocks} blocks x {self._bs_blk})")
        else:
            cap = self._cache_len
            layout = f"contiguous cache_len {cap}"
        if need > cap:
            raise ValueError(
                f"cannot admit: prompt_len({plen}) + max_new({self.max_new}) "
                f"= {need} tokens exceeds the slot cache capacity — {layout}; "
                "rebuild the runner with a larger max_new_tokens/cache"
            )

    def cached_prefix_tokens(self, item: int) -> int:
        """Prompt tokens of ``item`` already covered by the prefix cache
        (0 without one): the engine prices prefill on the uncached tail."""
        if self._prefix is None:
            return 0
        _, covered, _ = self._prefix.lookup(self.prompts[item])
        return covered

    def swap_out(self, slot: int) -> dict:
        """Preempt ``slot``: gather its KV blocks into host buffers, drop
        its block references, and retire the slot, so the pool space funds
        other streams. Returns an opaque handle for ``swap_in``. Shared
        blocks stay live (the other holders keep them); the handle carries
        their CONTENT, so restore never depends on cache survival."""
        if not self.paged:
            raise ValueError("swap_out requires a paged KV cache")
        if slot not in self._live:
            raise KeyError(f"slot {slot} is not live")
        if slot in self._pf_progress:
            raise KeyError(f"slot {slot} is mid-prefill (cannot swap)")
        ids = self._alloc.owned_ids(slot)
        idx = self._to_dev(np.asarray(ids, np.int64))
        # owned ids cover the "state" leaves too: a mamba slot's state page IS
        # its first table entry's block, and swap_in scatters in table order,
        # so the state rides along at position 0 of the ids.
        # the copy to the host IS swap-out's job, so its sync is sanctioned
        bufs = [l.index_select(ax, idx).cpu()
                for l, ax in zip(tree_leaves(self._cache), self._pool_axes)]
        self._alloc.free_slot(slot)
        self._live.discard(slot)
        self.swap_outs += 1
        self.swapped_blocks += len(ids)
        return {"bufs": bufs, "n_blocks": len(ids),
                "pos": int(self._pos[slot]), "tok": int(self._tok[slot])}

    def swap_in(self, slot: int, handle: dict) -> None:
        """Readmit a swapped stream into ``slot`` (any free slot): claim
        fresh blocks, scatter the host buffers back, restore pos/token.
        The restored blocks are private copies with identical content, so
        the decode trajectory is unchanged by the round trip."""
        if not self.paged:
            raise ValueError("swap_in requires a paged KV cache")
        self._ensure_rows(slot + 1)
        if slot in self._live:  # engine frees before reuse; be defensive
            self._alloc.free_slot(slot)
        n = int(handle["n_blocks"])
        self._reserve(n)
        ids = self._alloc.alloc(slot, n)
        idx = self._to_dev(np.asarray(ids, np.int64))
        for l, b, ax in zip(tree_leaves(self._cache), handle["bufs"], self._pool_axes):
            l.index_copy_(ax, idx, b.to(self.device, non_blocking=True))
        self._live.add(slot)
        self._pos[slot] = handle["pos"]
        self._tok[slot] = handle["tok"]
        self._pf_progress.pop(slot, None)
        self.swap_ins += 1

    # -- engine interface ----------------------------------------------------

    def start(self, slot: int, item: int) -> int:
        """Prefill ``item``'s prompt into ``slot``'s cache row (contiguous)
        or its freshly claimed pool blocks (paged); returns the first
        generated (greedy) token.

        With a prefix cache, cached blocks are SHARED into the slot's table
        instead of recomputed: a whole-prompt hit returns the cached first
        token with no device work; a partial hit runs the same one-shot
        prefill but redirects the cached chunks' scatters to the trash
        block, so only the uncached tail blocks are written."""
        self._check_admission_capacity()
        self._ensure_rows(slot + 1)
        toks = self._to_dev(self.prompts[item][None, :].astype(np.int64))
        if self.paged:
            if slot in self._live:  # engine frees before reuse; be defensive
                self._alloc.free_slot(slot)
            S = self.prompts.shape[1]
            nb_pf = -(-S // self._bs_blk)
            shared, covered, first = ([], 0, None)
            if self._prefix is not None:
                shared, covered, first = self._prefix.lookup(self.prompts[item])
                if covered:
                    self._prefix.hits += 1
                    self._prefix.tokens_saved += covered
                    self.saved_blocks += len(shared)
            if shared:
                # share BEFORE reserving: the extra reference protects the
                # cached blocks from the eviction a reserve may trigger
                self._alloc.share(slot, shared)
            if first is not None:
                tok = int(first)  # whole prompt cached: TTFT ~ 0
            else:
                n_new = nb_pf - len(shared)
                try:
                    if n_new:
                        self._reserve(n_new)
                    blks = self._alloc.alloc(slot, n_new) if n_new else []
                except PoolExhausted:
                    self._alloc.free_slot(slot)  # unwind the shares: retry-safe
                    raise
                lab = self._prefill_paged(toks, [0] * len(shared) + blks)
                # the sanctioned first-token read: admission needs the label
                tok = int(lab.reshape(-1)[0])
            if self._prefix is not None:
                self._prefix.register(self.prompts[item], self._alloc.owned_ids(slot), tok)
        else:
            cache, outs = self.model.prefill(self.params, toks, cache_len=self._cache_len,
                                             active_sites=None, with_cache=True)
            self._tree_put(self._cache, cache, torch.full((1,), slot, device=self.device))
            # the sanctioned first-token read: admission needs the prefill label
            tok = int(outs["final"]["label"].reshape(-1)[0])
        self._live.add(slot)
        self._pos[slot] = self.prompts.shape[1]
        self._tok[slot] = tok
        self._pf_progress.pop(slot, None)  # one-shot start supersedes chunks
        return tok

    # -- chunked prefill (resumable against the same slot cache) ------------

    def prefill_begin(self, slot: int, item: int, n_tokens: int) -> Optional[int]:
        """First chunk of a chunked prefill: prefill the prompt's first
        ``n_tokens`` into the slot row (contiguous) or its freshly claimed
        pool blocks (paged). Returns the first generated token when
        ``n_tokens`` already covers the whole prompt (== ``start``), else
        None: resume with ``prefill_resume``. The slot cache is valid
        mid-prompt, so decode steps for OTHER slots interleave freely."""
        self._check_admission_capacity()
        S = self.prompts.shape[1]
        n = min(int(n_tokens), S)
        if n >= S:
            return self.start(slot, item)
        if n < 1:
            raise ValueError(f"prefill chunk must be >= 1 token, got {n_tokens}")
        self._ensure_rows(slot + 1)
        toks = self._to_dev(self.prompts[item][None, :n].astype(np.int64))
        if self.paged:
            if slot in self._live:  # engine frees before reuse; be defensive
                self._alloc.free_slot(slot)
            shared, covered = [], 0
            if self._prefix is not None:
                # cached FULL chunks inside the first chunk are shared, not
                # recomputed (tail entries only apply to whole prompts)
                shared, covered, _ = self._prefix.lookup(self.prompts[item], limit=n)
                if covered:
                    self._prefix.hits += 1
                    self._prefix.tokens_saved += covered
                    self.saved_blocks += len(shared)
                if shared:
                    self._alloc.share(slot, shared)
                if covered == n:  # chunk fully cached: no device work
                    self._live.add(slot)
                    self._pos[slot] = n
                    self._pf_progress[slot] = item
                    return None
            n_new = -(-n // self._bs_blk) - len(shared)
            try:
                if self._prefix is not None:
                    self._reserve(n_new)
                blks = self._alloc.alloc(slot, n_new)
            except PoolExhausted:
                self._alloc.free_slot(slot)  # unwind the shares: retry-safe
                raise
            self._prefill_paged(toks, [0] * len(shared) + blks)
        else:
            cache, _ = self.model.prefill(self.params, toks, cache_len=self._cache_len,
                                          active_sites=None, with_cache=True)
            self._tree_put(self._cache, cache, torch.full((1,), slot, device=self.device))
        self._live.add(slot)
        self._pos[slot] = n
        self._pf_progress[slot] = item
        return None

    def prefill_resume(self, slot: int, n_tokens: int) -> Optional[int]:
        """Resume a chunked prefill: feed the next ``n_tokens`` prompt
        tokens through the no-ramp decode path, one token per call. Each
        token writes its KV at the slot's position exactly as a decode step
        would (appending pool blocks as they fill on the paged layout).
        Returns the first generated token (the greedy continuation of the
        last prompt token) once the prompt is exhausted, else None."""
        if int(n_tokens) < 1:
            raise ValueError(f"prefill chunk must be >= 1 token, got {n_tokens}")
        item = self._pf_progress[slot]
        S = self.prompts.shape[1]
        lab = None
        end = min(int(self._pos[slot]) + int(n_tokens), S)
        for p in range(int(self._pos[slot]), end):
            lab = self._feed_prompt_token(slot, int(self.prompts[item][p]))
        if int(self._pos[slot]) >= S:
            del self._pf_progress[slot]
            self._tok[slot] = int(lab)
            if self._prefix is not None:
                self._prefix.register(
                    self.prompts[item], self._alloc.owned_ids(slot), int(lab)
                )
            return int(lab)
        return None

    def _feed_prompt_token(self, slot: int, tok: int) -> int:
        """One resumed-prefill token through the (no-ramp) decode path at
        B=1 with the slot's position, so the cache layout cannot diverge
        between chunked and one-shot prefill."""
        rows = np.asarray([slot], np.int64)
        toks = self._to_dev(np.asarray([[tok]], np.int64))
        pos = self._to_dev(self._pos[rows])
        if self.paged:
            self._claim_step_blocks([slot])
            _, outs = self.model.decode(self.params, self._cache, toks, pos,
                                        block_tables=self._to_dev(self._tables(rows, 1, 1)))
        else:
            rows_d = self._to_dev(rows)
            sub = self._tree_take(self._cache, rows_d)
            sub, outs = self.model.decode(self.params, sub, toks, pos)
            self._tree_put(self._cache, sub, rows_d)
        self.dispatches += 1
        self.decode_steps += 1
        self._pos[slot] += 1
        # the sanctioned token read: resumed prefill feeds it to the next chunk
        return int(outs["final"]["label"].reshape(-1)[0])

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
            if s in self._pf_progress:
                raise KeyError(f"slot {s} is mid-prefill (resume its chunks first)")
        return slots

    def _batch_rows(self, slots: List[int]) -> Tuple[np.ndarray, int]:
        """Stepped slots, then FREE rows (their state is garbage a future
        start() overwrites wholesale), then duplicates of stepped slots
        (gather precedes every write, so duplicates scatter identical
        values) up to the bucket. NEVER a live-but-unstepped row. Returns
        the rows and the number of FREE rows."""
        B = len(slots)
        bucket = min(_bucket(B), self._rows)
        free = [r for r in range(self._rows) if r not in self._live][: bucket - B]
        dup = [slots[i % B] for i in range(bucket - B - len(free))]
        return np.asarray(slots + free + dup, np.int64), len(free)

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
        rows, n_free = self._batch_rows(slots)
        toks = self._to_dev(self._tok[rows].reshape(-1, 1))
        pos = self._to_dev(self._pos[rows])
        if self.paged:
            # append a block only when a stepped slot's current block is
            # full (CoW-copying it first if it is shared); the claim totals
            # every stepped slot's needs in ONE pass, so an empty pool
            # raises PoolExhausted here BEFORE any state changes. FREE pad
            # rows' tables point at the trash block 0.
            self._claim_step_blocks(slots)
            tables = self._to_dev(self._tables(rows, B, B + n_free))
            _, outs = self.model.decode(self.params, self._cache, toks, pos,
                                        active_sites=act if k else None, block_tables=tables)
        else:
            rows_d = self._to_dev(rows)
            sub = self._tree_take(self._cache, rows_d)
            sub, outs = self.model.decode(self.params, sub, toks, pos,
                                          active_sites=act if k else None)
            self._tree_put(self._cache, sub, rows_d)
        self.dispatches += 1
        self.decode_steps += 1
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

    def _thr_pad(self, thr: np.ndarray) -> np.ndarray:
        """Per-site exit thresholds padded to ``max_slots`` with 0.0 (strict
        ``<``: pad sites never fire)."""
        pad = np.zeros(self.max_slots, np.float32)
        pad[: len(thr)] = thr
        return pad

    def _window(self, inp: dict, n: int, act: List[int], cache):
        """One sync window of ``n`` decode steps over the device inputs
        ``inp`` (toks, pos, valid, thr, and rows or tables) and ``cache``:
        the body a window graph captures, so it reads nothing else but the
        params. Returns ``(rl, rm, fl, ex, n_done)``."""
        k = len(act)
        kw = dict(n_max=_bucket(n), active_sites=act if k else None,
                  thresholds=inp["thr"] if k else None, row_valid=inp["valid"])
        if self.paged:
            return self.model.decode_multi(self.params, cache, inp["toks"], inp["pos"], n,
                                           block_tables=inp["tables"], **kw)[1]
        sub = self._tree_take(cache, inp["rows"])
        sub, recs = self.model.decode_multi(self.params, sub, inp["toks"], inp["pos"], n, **kw)
        self._tree_put(cache, sub, inp["rows"])
        return recs

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
        stepped row exits. On the paged pool the window's blocks are
        claimed up front (unwound on ``PoolExhausted``) and its tables
        cross to the device once; blocks of steps that never ran are
        released after an early end."""
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
        rows, n_free = self._batch_rows(slots)
        # FREE pad rows hold garbage: mask them out of the all-exited vote
        valid = np.zeros(len(rows), bool)
        valid[:B] = True
        if self.paged:
            # pre-claim the window as n sequential per-step claims (the
            # claim and eviction order of n ``step`` calls); on
            # PoolExhausted unwind the appended tail to the pre-window
            # watermark (CoW copies stay: private, content-identical)
            al = self._alloc
            base_owned = {s: int(al.owned[s]) for s in slots}
            try:
                for i in range(n):
                    self._claim_step_blocks(slots, offset=i)
            except PoolExhausted:
                for s in slots:
                    al.release_tail(s, base_owned[s])
                raise
        host = {"toks": self._tok[rows].reshape(-1, 1), "pos": self._pos[rows], "valid": valid,
                "thr": self._thr_pad(thr)}
        host["tables" if self.paged else "rows"] = (
            self._tables(rows, B, B + n_free) if self.paged else rows)
        if self.graphs is not None:
            rl, rm, fl, ex, ndv = self.graphs.run(
                (len(rows), n, tuple(act), self.paged), host,
                lambda st: self._window(st, n, act, self._cache))
        else:
            rl, rm, fl, ex, ndv = self._window(
                {name: self._to_dev(a) for name, a in host.items()}, n, act, self._cache)
        self.dispatches += 1  # ONE call per window, however many steps ran
        self.decode_steps += n
        # the ONE host sync per window; the record copies below find the
        # device idle
        nd = int(ndv)
        labels = rl[:nd, :k, :B].cpu().numpy().astype(np.int64)
        unc = (np.float32(1.0) - rm[:nd, :k, :B].cpu().numpy()).astype(np.float32)
        finals = fl[:nd, :B].cpu().numpy().astype(np.int64)
        exits = ex[:nd, :B].cpu().numpy().astype(np.int64)
        self._pos[rows[:B]] += nd
        self._tok[rows[:B]] = finals[nd - 1]
        if self.paged and nd < n:
            # early end: release the blocks pre-claimed for steps that never
            # ran (their gated writes left them unchanged); ``peak_blocks``
            # keeps the window's high-water mark by design
            bs = self._bs_blk
            for s in slots:
                keep = max(base_owned[s], (int(self._pos[s]) - 1) // bs + 1)
                self._alloc.release_tail(s, keep)
        return labels, unc, finals, exits

    def free(self, slot: int) -> None:
        if self.paged and self._alloc is not None and slot in self._live:
            self._alloc.free_slot(slot)
        self._live.discard(slot)
        self._pf_progress.pop(slot, None)
