"""Serving metrics: latency percentiles, throughput, goodput (on-time
completions/sec), accuracy-vs-original — per worker and cluster-wide.

The percentile/span/rate plumbing is shared by every summary
(``summarize``, ``summarize_cluster``, ``summarize_generative``) via the
``_percentile_block`` / ``_span_ms`` / ``_per_sec`` helpers below, with
the NaN-proofing contract from PR 4 kept: an empty stream never produces
NaN where a downstream win%/JSON consumer would choke (generative
percentiles pin 0.0; the classification summary keeps its historical
NaN sentinels for empty latency sets).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import Response


def _percentile_block(values, spec: Dict[str, float], empty: float) -> Dict[str, float]:
    """Shared percentile plumbing: ``spec`` maps output key -> percentile.
    An empty stream yields ``empty`` for every key (np.nan for the
    classification summary's historical sentinels, 0.0 for the NaN-proof
    generative keys)."""
    vals = np.asarray(values, float)
    if vals.size == 0:
        return {key: empty for key in spec}
    return {key: float(np.percentile(vals, q)) for key, q in spec.items()}


def _span_ms(horizon_ms: Optional[float], last: float, earliest: float) -> float:
    """Shared horizon plumbing: an explicit horizon wins; otherwise the
    stream spans from 0 (or ``earliest``, if negative) to ``last``."""
    return horizon_ms if horizon_ms is not None else last - min(0.0, earliest)


def _per_sec(count: float, span_ms: float) -> float:
    """Rate over a span. A zero (or degenerate negative) span yields 0.0:
    a single-instant stream has no meaningful rate, and the old
    ``count / max(span, 1e-9)`` guard turned it into an astronomically
    large bogus value. Clean under ``np.errstate(raise)`` — no inf/NaN."""
    if span_ms <= 0.0:
        return 0.0
    return float(count) / (float(span_ms) / 1000.0)


def summarize(
    responses: List[Response],
    *,
    vanilla_labels: Optional[np.ndarray] = None,
    horizon_ms: Optional[float] = None,
) -> Dict[str, float]:
    ok = [r for r in responses if not r.dropped]
    lat = np.asarray([r.latency_ms for r in ok])
    out = {
        "n": float(len(responses)),
        "dropped": float(sum(r.dropped for r in responses)),
        **_percentile_block(
            lat, {"p25_ms": 25, "p50_ms": 50, "p95_ms": 95, "p99_ms": 99}, np.nan
        ),
        "mean_batch": float(np.mean([r.batch_size for r in ok])) if ok else np.nan,
        "exit_rate": float(np.mean([r.exit_site >= 0 for r in ok])) if ok else 0.0,
    }
    if ok:
        span = _span_ms(horizon_ms, max(r.release_ms for r in ok),
                        min(r.release_ms for r in ok))
        out["throughput_qps"] = _per_sec(len(ok), span)
        slo = np.asarray([r.slo_ms for r in ok])
        if np.isfinite(slo).all():
            on_time = lat <= slo + 1e-9
            out["goodput_qps"] = _per_sec(float(on_time.sum()), span)
            # misses count drops too: a shed request is a violated SLO
            out["slo_miss_rate"] = 1.0 - float(on_time.sum()) / max(len(responses), 1)
    if vanilla_labels is not None and ok:
        # accuracy = agreement with the original model's label (paper metric)
        agree = [r.label == vanilla_labels[r.rid] for r in ok]
        out["accuracy"] = float(np.mean(agree))
    return out


def summarize_cluster(
    responses: List[Response],
    *,
    vanilla_labels: Optional[np.ndarray] = None,
    horizon_ms: Optional[float] = None,
    n_workers: Optional[int] = None,
) -> Dict[str, object]:
    """Aggregate + per-worker summaries over one cluster run.

    Per-worker throughput/goodput use the *shared* horizon (the cluster
    run's span), so worker rates sum to the aggregate rate instead of
    each worker normalizing by its own last release. Pass ``n_workers``
    (the cluster size) explicitly — under light load an idle replica
    answers nothing and would be invisible in the responses.
    """
    ok = [r for r in responses if not r.dropped]
    span = (
        _span_ms(horizon_ms, max(r.release_ms for r in ok), min(r.release_ms for r in ok))
        if ok
        else horizon_ms
    )
    agg = summarize(responses, vanilla_labels=vanilla_labels, horizon_ms=span)
    by_worker: Dict[int, List[Response]] = {}
    for r in responses:
        by_worker.setdefault(r.worker, []).append(r)
    agg["n_workers"] = float(n_workers if n_workers is not None else len(by_worker))
    return {
        "aggregate": agg,
        "workers": {
            w: summarize(rs, vanilla_labels=vanilla_labels, horizon_ms=span)
            for w, rs in sorted(by_worker.items())
        },
    }


#: summarize_generative's full key set, all zeroed (the NaN-proof shape a
#: degenerate stream must still return)
_GEN_EMPTY = {
    "n": 0.0, "tokens": 0.0, "dropped": 0.0, "shed": 0.0,
    "ttft_p50_ms": 0.0, "ttft_p95_ms": 0.0,
    "tpt_p50_ms": 0.0, "tpt_p95_ms": 0.0, "tpt_mean_ms": 0.0,
    "tokens_per_sec": 0.0, "exit_rate": 0.0, "agreement": 1.0,
    "ttft_frac": 0.0,
}


def summarize_generative(
    responses: List,
    *,
    horizon_ms: Optional[float] = None,
) -> Dict[str, float]:
    """Generative serving metrics (paper §5): per-token TPT percentiles,
    tokens/sec, TTFT vs TPT split, exit rate over decode tokens, and
    agreement of released tokens with the original model's greedy stream.

    TPT samples are successive release deltas within each request
    (``diff(release_ms)``); the first token is TTFT's job, not TPT's.

    Requests shed by the SLO-aware admission policy are reported:
    ``dropped`` counts admission drops (no tokens served; excluded from
    every token metric) and ``shed`` counts mid-stream sheds (partial
    token streams, which DO contribute their served tokens). A shed
    stream that never released a token — a mid-prefill preemption
    victim — still counts under ``shed`` but, like a drop, is excluded
    from every latency/token statistic.

    Degenerate streams stay NaN-free: an empty (or fully-dropped) stream
    returns the full key set zeroed, and a stream of single-token
    requests (no TPT samples at all) reports 0.0 TPT percentiles rather
    than NaN — downstream win%/JSON consumers choke on NaN.
    """
    served = [r for r in responses if not getattr(r, "dropped", False)]
    n_shed = float(sum(getattr(r, "shed", False) for r in served))
    # zero-token sheds (mid-prefill preemption victims) have no releases
    # to take statistics over — count them, then set them aside
    voiced = [r for r in served if len(r.release_ms) > 0]
    if not voiced:
        return dict(_GEN_EMPTY, n=float(len(responses)), shed=n_shed,
                    dropped=float(len(responses) - len(served)))
    ttft = np.asarray([r.ttft_ms for r in voiced])
    tpt = np.concatenate([r.tpt_ms for r in voiced if len(r.release_ms) > 1] or
                         [np.zeros(0)])
    decode_sites = np.concatenate(
        [np.asarray(r.exit_sites[1:], np.int64) for r in voiced if len(r.exit_sites) > 1]
        or [np.zeros(0, np.int64)]
    )
    total_tokens = int(sum(len(r.tokens) for r in voiced))
    last = max(max(r.release_ms) for r in voiced)
    first = min(r.arrival_ms for r in voiced)
    span = _span_ms(horizon_ms, last, first)
    # agreement over DECODE tokens only (same denominator as exit_rate):
    # the prefill token is the final model's own output by construction
    agree = np.concatenate(
        [np.asarray(r.tokens[1:]) == np.asarray(r.final_tokens[1:]) for r in voiced]
        or [np.zeros(0, bool)]
    )
    out = {
        "n": float(len(responses)),
        "tokens": float(total_tokens),
        "dropped": float(len(responses) - len(served)),
        "shed": n_shed,
        **_percentile_block(ttft, {"ttft_p50_ms": 50, "ttft_p95_ms": 95}, 0.0),
        **_percentile_block(tpt, {"tpt_p50_ms": 50, "tpt_p95_ms": 95}, 0.0),
        "tpt_mean_ms": float(tpt.mean()) if len(tpt) else 0.0,
        "tokens_per_sec": _per_sec(total_tokens, span),
        "exit_rate": float((decode_sites >= 0).mean()) if len(decode_sites) else 0.0,
        "agreement": float(agree.mean()) if len(agree) else 1.0,
        # per-request latency split: how much of a request's life is TTFT
        "ttft_frac": float(
            np.mean([r.ttft_ms / max(max(r.release_ms) - r.arrival_ms, 1e-9)
                     for r in voiced])
        ),
    }
    slo = np.asarray([r.slo_ms for r in voiced])
    if np.isfinite(slo).all() and len(tpt):
        # per-token SLO: a request is on time if its median TPT meets it
        per_req = [
            float(np.median(r.tpt_ms)) <= r.slo_ms + 1e-9
            for r in voiced if len(r.release_ms) > 1
        ]
        if per_req:
            out["tpt_slo_miss_rate"] = 1.0 - float(np.mean(per_req))
    return out


def savings_vs(base: Dict[str, float], ours: Dict[str, float]) -> Dict[str, float]:
    out = {}
    for k in ("p25_ms", "p50_ms", "p95_ms", "p99_ms"):
        if np.isfinite(base.get(k, np.nan)) and np.isfinite(ours.get(k, np.nan)):
            out[k.replace("_ms", "_win_pct")] = 100.0 * (base[k] - ours[k]) / base[k]
    if base.get("throughput_qps") and ours.get("throughput_qps"):
        out["throughput_delta_pct"] = (
            100.0 * (ours["throughput_qps"] - base["throughput_qps"]) / base["throughput_qps"]
        )
    return out
