"""Reference param pytrees (and train states) -> the port's, under the same
leaf paths.

The contract is the JAX package's ``ParamInfo`` schema: a reference tree
handed over as numpy arrays (``jax.tree.map(np.asarray, params)``) keeps its
exact structure here. ``blocks`` stays a list with one dict per period slot,
and its leaves keep their leading ``L`` axis; ``prefix`` and ``suffix``
(Gemma3's trailing local layers) stay lists of unstacked slots.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_map


def _tensor(x, device) -> torch.Tensor:
    # always a copy: the port updates caches in place, and the caller's array
    # may also back a JAX array on the CPU that a computation still reads
    a = np.array(x, order="C")
    # ml_dtypes bf16, or a checkpoint's bf16 leaf as np.load returns it (raw
    # two-byte words, V2): carry the raw bits over
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_numpy_params(tree, device="cuda"):
    """A reference param or cache tree, or a whole train state (``{"params",
    "opt": {"step", "mu", "nu"}, "step"}``, its steps 0-d int32), of numpy
    arrays -> torch tensors on ``device``, same tree (dicts, lists) and
    leaf paths. bf16 leaves come as ml_dtypes arrays or as a checkpoint's
    raw V2 words."""
    return tree_map(lambda x: _tensor(x, device), tree)


def to_numpy(tree):
    """The port's tree -> numpy arrays (f32 for bf16 leaves), for comparisons."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)
