"""Arrival-trace generation.

``video_trace``: fixed-fps arrivals (the paper's CV workloads — 30 fps).
``maf_trace``: bursty arrivals emulating the Microsoft Azure Functions
shape the paper uses for NLP: per-bucket rates drawn from a lognormal
rate process with temporal correlation, Poisson arrivals within buckets.
"""
from __future__ import annotations

import numpy as np


def video_trace(n: int, fps: float = 30.0, start_ms: float = 0.0) -> np.ndarray:
    return start_ms + np.arange(n) * (1000.0 / fps)


def maf_trace(
    n: int,
    mean_qps: float,
    *,
    burstiness: float = 0.8,
    bucket_ms: float = 1000.0,
    corr: float = 0.85,
    seed: int = 0,
) -> np.ndarray:
    """Arrival times (ms) for n requests with lognormal AR(1) rate process."""
    if mean_qps <= 0:
        raise ValueError(f"mean_qps must be positive, got {mean_qps}")
    rng = np.random.default_rng(seed)
    times = []
    t = 0.0
    z = 0.0
    while len(times) < n:
        z = corr * z + np.sqrt(1 - corr**2) * rng.normal()
        rate = mean_qps * np.exp(burstiness * z - 0.5 * burstiness**2)
        lam = max(rate * bucket_ms / 1000.0, 1e-6)
        k = rng.poisson(lam)
        if k:
            ts = np.sort(rng.uniform(t, t + bucket_ms, k))
            times.extend(ts.tolist())
        t += bucket_ms
    return np.asarray(times[:n])
