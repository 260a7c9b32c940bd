"""Ramp placement & architecture policy (paper §3.1).

Placement rule — **cut vertices**: a ramp may only attach where the
operator graph would split into two disjoint subgraphs, i.e. no edge may
start before the ramp and re-enter after it. For residual families
(ResNet blocks, transformer blocks, Mamba blocks, MoE blocks) those are
exactly the *block boundaries* — the residual add is the cut vertex;
nothing inside a block qualifies because the skip edge bypasses it. For
chain models (VGG-style) every layer qualifies.

In this JAX build the models are schema-defined (not ONNX graphs), so the
cut-vertex analysis is realized structurally:

  * transformer/SSM/hybrid LMs  -> after every block (``transformer.ramp_sites``:
    thinned to ≤12 sites for very deep models, matching the paper's
    9.2–68.4% feasible-layer coverage),
  * enc-dec                     -> decoder block boundaries only,
  * encoder classifiers         -> every encoder block,
  * ResNets                     -> every residual-block output.

Architecture rule — **shallowest viable ramp**: lightweight pooling +
the model's final FC with input width matched to the site (§3.1):

  * LMs: last-position hidden -> ramp RMSNorm -> per-site LM head,
  * BERT-style: CLS-token pool -> classifier FC,
  * ResNet: global-average-pool -> classifier FC.

A heavier 'mlp' style (cfg.ramp_style) exists for the paper's Fig 9
comparison. Ramps are trained with the backbone frozen and with exiting
disabled so every ramp sees every input (training independence, §3.1);
see training/ramp_training.py.
"""
from __future__ import annotations

from typing import Tuple


def feasible_sites(model) -> Tuple[int, ...]:
    """Cut-vertex ramp sites for any built model (see module docstring)."""
    return tuple(model.sites)


def describe(model) -> str:
    cfg = model.cfg
    sites = feasible_sites(model)
    n_layers = getattr(cfg, "n_layers", len(sites) + 1)
    cov = 100.0 * len(sites) / max(n_layers, 1)
    return (
        f"{cfg.name}: {len(sites)} feasible ramp sites over {n_layers} blocks "
        f"({cov:.1f}% coverage; paper range 9.2-68.4%)"
    )
