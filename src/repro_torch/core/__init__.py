"""Apparate core: early-exit management (the paper's contribution).

Numpy-only copies of the JAX package's `repro.core` modules; only the
imports and the roofline constants in `profiles.py` differ."""
from repro_torch.core.controller import ApparateController, ControllerConfig
from repro_torch.core.exits import (
    RecordWindow,
    evaluate_config,
    evaluate_configs,
    exit_rates,
    ramp_utilities,
    simulate_exits,
    simulate_exits_many,
    site_cost_vectors,
)
from repro_torch.core.profiles import LatencyProfile, build_profile
from repro_torch.core.ramp_adjust import adjust_ramps
from repro_torch.core.threshold_tuning import (
    grid_search_thresholds,
    tune_thresholds,
    tune_thresholds_reference,
)

__all__ = [
    "ApparateController",
    "ControllerConfig",
    "RecordWindow",
    "evaluate_config",
    "evaluate_configs",
    "exit_rates",
    "ramp_utilities",
    "simulate_exits",
    "simulate_exits_many",
    "site_cost_vectors",
    "LatencyProfile",
    "build_profile",
    "adjust_ramps",
    "tune_thresholds",
    "tune_thresholds_reference",
    "grid_search_thresholds",
]
