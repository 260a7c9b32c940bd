"""Bootstrap ramp training (paper §3.1; the port's counterpart of the JAX
package's ``training/ramp_training.py``).

Properties enforced:
  * backbone FROZEN: optimizer masking (ramps_only) + stop-gradient on
    pooled features inside the model, so non-EE behavior and accuracy
    feedback are unchanged;
  * NO exiting during training: every ramp sees every input, making ramps
    independent of whichever upstream ramps happen to be active at runtime;
  * per-ramp losses are independent terms of one scalar loss: a single
    backward pass trains all ramps in parallel.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.training.train_loop import TrainConfig, train


def train_ramps(model, batches: Callable[[int], Dict[str, np.ndarray]], *,
                steps: int = 150, lr: float = 1e-3, state=None, verbose=True, device="cuda"):
    """Train only ramp parameters on bootstrap data (10% split per paper §4)."""
    tcfg = TrainConfig(steps=steps, lr=lr, train_mode="ramps_only", log_every=max(steps // 5, 1))
    return train(model, batches, tcfg, state=state, verbose=verbose, device=device)
