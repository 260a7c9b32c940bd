"""Shared pytest config: deterministic RNG seeding + the `slow` marker.

Suite policy (recorded in ROADMAP.md): tier-1 (`pytest -x -q`) must run
with stdlib + numpy + jax + pytest only — no `hypothesis`, no plugins.
Long-running tests (interpret-mode Pallas kernel sweeps) carry the
``slow`` marker and are skipped unless the marker expression mentions
them (`-m slow` for the full sweep, `-m "not slow"` to be explicit in
CI); plain `pytest -x -q` therefore finishes in minutes.
"""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running (interpret-mode Pallas sweeps); skipped unless -m mentions 'slow'",
    )
    config.addinivalue_line(
        "markers", "flaky: tolerated-rerun annotation (no-op without a rerun plugin)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one; run with -m gpu on the card)"
    )


def pytest_collection_modifyitems(config, items):
    if "slow" in (config.getoption("markexpr", "") or ""):
        return  # the caller took an explicit stance on slow tests
    skip = pytest.mark.skip(reason="slow: opt in with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True, scope="session")
def _seed_global_rng():
    """Session-wide seed for legacy ``np.random`` consumers; tests needing
    local randomness should build their own ``np.random.default_rng``."""
    # deliberate: this fixture IS the sanctioned global seed point
    np.random.seed(0)  # repro: allow[seeded-rng]


@pytest.fixture
def rng():
    """Deterministic per-test generator."""
    return np.random.default_rng(0)
