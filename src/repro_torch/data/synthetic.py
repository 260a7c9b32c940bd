"""Synthetic drifting workloads.

The paper's phenomena to reproduce:
  * CV streams (video): strong temporal correlation — object difficulty
    persists across frames; drift is slow (scene changes).
  * NLP streams (reviews): weak continuity — difficulty is closer to iid
    with abrupt topic shifts; past data is less predictive (§5.2).

``make_image_stream``: class = one of C spatial patterns; difficulty =
noise level following a Markov dwell process (CV) or iid-with-shifts (NLP
mode). ``make_token_stream``: class-indicative tokens mixed with noise
tokens at a difficulty-controlled rate.

Also here: the deterministic, resumable token pipeline for LM training.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Stream:
    data: np.ndarray  # (N, ...) model inputs
    labels: np.ndarray  # (N,) generative class ids (NOT used as accuracy truth)
    difficulty: np.ndarray  # (N,) in [0,1]


def _difficulty_process(
    n: int, *, mode: str, rng, lo=0.05, hi=0.9, dwell=300, shift_every=800
) -> np.ndarray:
    if mode == "cv":  # Markov dwell: easy/hard scenes persisting ~dwell frames
        d = np.empty(n)
        cur = rng.uniform(lo, hi)
        i = 0
        while i < n:
            k = int(rng.exponential(dwell)) + 30
            d[i : i + k] = np.clip(cur + rng.normal(0, 0.02, min(k, n - i)), 0, 1)
            cur = np.clip(rng.uniform(lo, hi), 0, 1)
            i += k
        return d
    # nlp: iid difficulty with abrupt regime shifts of the mean
    d = np.empty(n)
    i = 0
    while i < n:
        k = int(rng.exponential(shift_every)) + 100
        mean = rng.uniform(lo, hi)
        d[i : i + k] = np.clip(rng.normal(mean, 0.15, min(k, n - i)), 0, 1)
        i += k
    return d


def make_image_stream(
    n: int,
    *,
    img_size: int = 16,
    n_classes: int = 10,
    mode: str = "cv",
    seed: int = 0,
    proto_mix: float = 0.0,
) -> Stream:
    """proto_mix > 0 blends each class prototype with its neighbor's,
    making classes confusable (harder streams: confidence stops being
    perfectly separable, so threshold tuning genuinely matters)."""
    rng = np.random.default_rng(seed)
    # class prototypes: smooth random patterns, renormalized to unit power
    protos = rng.normal(0, 1, (n_classes, img_size, img_size, 3)).astype(np.float32)
    for c in range(n_classes):  # low-pass for spatial structure
        for _ in range(2):
            protos[c] = (
                protos[c]
                + np.roll(protos[c], 1, 0)
                + np.roll(protos[c], 1, 1)
                + np.roll(protos[c], -1, 0)
                + np.roll(protos[c], -1, 1)
            ) / 5.0
        protos[c] /= protos[c].std() + 1e-9
    if proto_mix > 0:
        base = protos.copy()
        for c in range(n_classes):
            protos[c] = (1 - proto_mix) * base[c] + proto_mix * base[(c + 1) % n_classes]
            protos[c] /= protos[c].std() + 1e-9
    diff = _difficulty_process(n, mode=mode, rng=rng)
    if mode == "cv":  # objects persist across frames
        labels = np.empty(n, np.int64)
        i = 0
        while i < n:
            k = int(rng.exponential(300)) + 15
            labels[i : i + k] = rng.integers(n_classes)
            i += k
    else:
        labels = rng.integers(0, n_classes, n)
    noise = rng.normal(0, 1, (n, img_size, img_size, 3)).astype(np.float32)
    scale = (0.15 + 1.6 * diff)[:, None, None, None].astype(np.float32)
    data = protos[labels] + noise * scale
    return Stream(data.astype(np.float32), labels, diff)


def make_token_stream(
    n: int,
    *,
    seq_len: int = 32,
    vocab: int = 512,
    n_classes: int = 10,
    mode: str = "nlp",
    seed: int = 0,
) -> Stream:
    rng = np.random.default_rng(seed)
    # Compositional class code: label = (a + b) mod C where `a` is carried by
    # tokens from range-A slice a and `b` by range-B slice b. Single-token
    # statistics are insufficient (each slice is shared across classes), so
    # shallow ramps genuinely underperform deep ones on noisy inputs.
    C = n_classes
    half = (vocab - 2) // 2
    perA = max(half // C, 2)
    perB = max(half // C, 2)
    diff = _difficulty_process(n, mode=mode, rng=rng)
    labels = rng.integers(0, C, n)
    if mode == "cv":
        labels = make_image_stream(n, mode="cv", n_classes=C, seed=seed).labels
    data = np.empty((n, seq_len), np.int64)
    for i in range(n):
        c = labels[i]
        a = rng.integers(C)
        b = (c - a) % C
        tokA = rng.integers(1 + a * perA, 1 + (a + 1) * perA, seq_len)
        tokB = rng.integers(1 + half + b * perB, 1 + half + (b + 1) * perB, seq_len)
        sig = np.where(rng.random(seq_len) < 0.5, tokA, tokB)
        noise = rng.integers(1, vocab, seq_len)
        m = rng.random(seq_len) < (0.15 + 0.8 * diff[i])
        data[i] = np.where(m, noise, sig)
        data[i, 0] = 0  # CLS token
    return Stream(data, labels, diff)


def make_decode_stream(
    n: int,
    *,
    seq_len: int = 24,
    vocab: int = 512,
    predict: float = 0.9,
    shift: int = 17,
    mode: str = "nlp",
    seed: int = 0,
) -> Stream:
    """Prompts for generative decode serving: Markov chains where token
    ``t+1 = t + shift (mod vocab)`` with per-position probability scaled by
    the stream's difficulty process, else a uniform noise token.

    The transition needs only the *current* token, so both the final head
    and mid-depth ramps of a briefly-trained tiny LM learn it — easy
    (predictable) decode steps become confidently exitable while noisy
    steps stay uncertain: the generative analogue of the paper's easy/hard
    traffic mix. ``difficulty`` follows the same drift process as the
    classification streams, so controllers see regime shifts here too."""
    rng = np.random.default_rng(seed)
    diff = _difficulty_process(n, mode=mode, rng=rng)
    p = np.clip(predict * (1.0 - 0.7 * diff), 0.05, 1.0)
    data = np.empty((n, seq_len), np.int64)
    for i in range(n):
        x = int(rng.integers(1, vocab))
        for t in range(seq_len):
            data[i, t] = x
            if rng.random() < p[i]:
                x = 1 + (x - 1 + shift) % (vocab - 1)
            else:
                x = int(rng.integers(1, vocab))
    return Stream(data, np.zeros(n, np.int64), diff)


# ---------------------------------------------------------------------------
# deterministic resumable LM token pipeline (training substrate)


class TokenPipeline:
    """Synthetic LM pretraining stream: Zipfian unigrams + Markov bigram
    structure; deterministic given (seed, step) — checkpoint-resumable by
    construction (store just the step)."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab, self.seq_len, self.batch, self.seed = vocab, seq_len, batch, seed
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.shift = rng.integers(1, vocab - 1)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        base = rng.choice(self.vocab, (self.batch, self.seq_len + 1), p=self.probs)
        # inject predictable bigrams: token t follows (t - shift) 50% of time
        m = rng.random((self.batch, self.seq_len)) < 0.5
        nxt = (base[:, :-1] + self.shift) % self.vocab
        base[:, 1:] = np.where(m, nxt, base[:, 1:])
        return {
            "tokens": base[:, :-1].astype(np.int32),
            "labels": base[:, 1:].astype(np.int32),
        }
