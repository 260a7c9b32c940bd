"""The one traffic generator: a cell's mix, as its workload file gives it,
drawn from ``--seed``.

A mix is a backlog of requests, each a prompt of ``prompt_len`` token ids
and a number of tokens to serve (the prefill's token included), with an
arrival time. Output lengths come block by block: each block of ``BLOCK``
requests holds the same lengths, the distribution's quantiles at (i + 0.5)
/ block, in an order drawn from the seed. So every seed serves the same
sizes in another order, and any prefix of whole blocks holds the same work
whatever the seed. Token ids are uniform over [1, vocab). Every request
arrives at time 0: a saturated replica working through a queue.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

STREAMS = {"backlog": 0, "warmup": 1, "sample": 2}
BACKLOG = 2000  # requests a backlog holds: more than any cell finishes in a window
BLOCK = 64  # requests a block of the same output lengths holds


def rng(seed: int, stream: str) -> np.random.Generator:
    """The generator of one named stream of ``seed``."""
    return np.random.default_rng([int(seed) % (1 << 64), STREAMS[stream]])


@dataclasses.dataclass
class Backlog:
    prompts: np.ndarray  # (N, prompt_len) int32
    n_tokens: np.ndarray  # (N,) int64, the prefill's token included
    arrival_ms: np.ndarray  # (N,) float64


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """The ``n`` lengths at the quantiles (i + 0.5) / n of ``spec``:
    ``{"dist": "loguniform" | "uniform", "lo": a, "hi": b}``, integers in
    [a, b]."""
    lo, hi = int(spec["lo"]), int(spec["hi"])
    q = (np.arange(n) + 0.5) / n
    if spec["dist"] == "loguniform":
        x = np.exp(math.log(lo) + q * (math.log(hi + 1) - math.log(lo)))
    elif spec["dist"] == "uniform":
        x = lo + q * (hi + 1 - lo)
    else:
        raise ValueError(f"output dist {spec['dist']!r}: 'loguniform' | 'uniform'")
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def generate(mix: dict, vocab: int, seed: int, stream: str = "backlog",
             n: int = BACKLOG, block: int = BLOCK) -> Backlog:
    """The backlog of ``mix`` (a cell's workload file) for ``seed``: ``n``
    requests in blocks of ``block``."""
    g = rng(seed, stream)
    n, block = int(n), int(block)
    base = quantile_lengths(mix["output"], block)
    n_blocks = -(-n // block)
    lens = np.concatenate([g.permutation(base) for _ in range(n_blocks)])[:n]
    prompts = g.integers(1, vocab, (n, int(mix["prompt_len"]))).astype(np.int32)
    return Backlog(prompts, lens, np.zeros(n))
