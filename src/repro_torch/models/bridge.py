"""Reference param pytrees -> the port's params, under the same leaf paths.

The contract is the JAX package's ``ParamInfo`` schema: a reference tree
handed over as numpy arrays (``jax.tree.map(np.asarray, params)``) keeps its
exact structure here. ``blocks`` stays a list with one dict per period slot,
and its leaves keep their leading ``L`` axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_map


def _tensor(x, device) -> torch.Tensor:
    # always a copy: the port updates caches in place, and the caller's array
    # may also back a JAX array on the CPU that a computation still reads
    a = np.array(x, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: carry the raw bits over
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_numpy_params(tree, device="cuda"):
    """A reference param (or cache) tree of numpy arrays -> torch tensors on
    ``device``, same tree (dicts, lists) and leaf paths."""
    return tree_map(lambda x: _tensor(x, device), tree)


def to_numpy(tree):
    """The port's tree -> numpy arrays (f32 for bf16 leaves), for comparisons."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)
