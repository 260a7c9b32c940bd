"""Serving request/response records (classification + generative)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    arrival_ms: float
    slo_ms: float
    item: int  # index into the workload stream


@dataclasses.dataclass
class Response:
    rid: int
    release_ms: float
    label: int
    exit_site: int  # -1 = full model
    latency_ms: float
    batch_size: int
    dropped: bool = False
    worker: int = 0  # serving replica that handled the request
    slo_ms: float = float("nan")  # copied from the request (goodput accounting)


@dataclasses.dataclass
class GenRequest:
    """Generative request: decode ``n_tokens`` from ``item``'s prompt.
    ``slo_ms`` is a per-token (TPT) SLO — the paper's generative unit."""

    rid: int
    arrival_ms: float
    slo_ms: float
    item: int  # index into the prompt stream
    prompt_len: int
    n_tokens: int  # tokens to generate (incl. the prefill token)


@dataclasses.dataclass
class GenResponse:
    """One served generative request: per-token release times / exit sites /
    released tokens, plus the original model's greedy tokens for agreement
    accounting. ``release_ms[0]`` is the first (prefill) token: TTFT =
    release_ms[0] - arrival_ms; TPT samples are diff(release_ms)."""

    rid: int
    arrival_ms: float
    release_ms: List[float]
    exit_sites: List[int]  # per token; -1 = full model
    tokens: List[int]  # released (possibly ramp) tokens
    final_tokens: List[int]  # original-model greedy tokens
    worker: int = 0
    slo_ms: float = float("nan")
    dropped: bool = False  # shed at admission (SLO-aware admission policy)
    shed: bool = False  # shed mid-stream (doomed slot; partial tokens kept)

    @property
    def ttft_ms(self) -> float:
        return self.release_ms[0] - self.arrival_ms

    @property
    def tpt_ms(self) -> np.ndarray:
        return np.diff(np.asarray(self.release_ms))


def make_gen_requests(
    arrivals: np.ndarray,
    *,
    n_tokens,
    prompt_len: int,
    slo_ms: float,
    items: Optional[Sequence[int]] = None,
) -> List[GenRequest]:
    """``n_tokens`` may be a scalar or a per-request array."""
    nt = np.broadcast_to(np.asarray(n_tokens, np.int64), (len(arrivals),))
    items = items if items is not None else np.arange(len(arrivals))
    return [
        GenRequest(rid=k, arrival_ms=float(t), slo_ms=slo_ms, item=int(items[k]),
                   prompt_len=prompt_len, n_tokens=int(nt[k]))
        for k, t in enumerate(arrivals)
    ]
