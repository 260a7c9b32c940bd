"""Runtime tuning presets: allocator and device environment for serving runs
(the port's counterpart of the reference's XLA-flag presets).

PyTorch reads these variables when CUDA starts in the process (the caching
allocator parses ``PYTORCH_CUDA_ALLOC_CONF`` at its first use, CUDA
reads ``CUDA_VISIBLE_DEVICES`` when it initializes), so a preset must land
before anything touches CUDA: ``--runtime-preset`` on the serve launcher
applies it first thing. Presets, by the reference's intent:

  * ``serve``  — production serving: PyTorch's caching allocator with
    expandable segments, so the long-lived KV cache, pool and window-graph
    buffers grow in place instead of fragmenting into fixed segments over
    a long run; quiet C++ logs.
  * ``bench``  — benchmarking: PyTorch's caching allocator with fixed
    segments (``expandable_segments:False``, its default layout), so a
    benchmark measures the allocator a user starts with; quiet C++ logs.
    The reference's intent, allocation cost visible rather than hidden in
    a warm arena, has no setting a preset can apply that keeps the window
    graphs: the uncached mode (``PYTORCH_NO_CUDA_MEMORY_CACHING=1``)
    invalidates their capture (``cudaErrorStreamCaptureInvalidated``: a
    capture cannot call ``cudaMalloc``), and CUDA's own stream-ordered
    allocator (``backend:cudaMallocAsync``) is read when torch is
    imported, before the launcher can apply a preset (PyTorch asserts at
    CUDA's start); exported before the launcher starts, it serves with
    the graphs captured.
  * ``host-sim`` — host-only simulation (CI, laptops): no CUDA device is
    visible (``CUDA_VISIBLE_DEVICES=""``), so the launcher must be run with
    ``--device cpu``.

``PYTORCH_CUDA_ALLOC_CONF`` is MERGED key by key, never clobbered: keys
already set in the environment win over the preset's (an operator override
outranks a default). Every other variable is set only if absent unless
``force=True``.
"""
from __future__ import annotations

import os
import sys
import warnings
from typing import Dict, MutableMapping, Optional

ALLOC_CONF = "PYTORCH_CUDA_ALLOC_CONF"

PRESETS: Dict[str, Dict[str, str]] = {
    "serve": {
        ALLOC_CONF: "expandable_segments:True",
        "TORCH_CPP_LOG_LEVEL": "ERROR",
    },
    "bench": {
        ALLOC_CONF: "expandable_segments:False",
        "TORCH_CPP_LOG_LEVEL": "ERROR",
    },
    "host-sim": {
        "CUDA_VISIBLE_DEVICES": "",
        "TORCH_CPP_LOG_LEVEL": "ERROR",
    },
}


def _key(tok: str) -> str:
    return tok.split(":", 1)[0].strip()


def merge_alloc_conf(preset_conf: str, existing: Optional[str]) -> str:
    """Merge the preset's ``key:value`` allocator settings under any already
    exported: a key set in the environment shadows the preset's value for
    that key; order is existing-first, and shadowed preset entries are
    dropped so the result reads cleanly."""
    have = [t.strip() for t in (existing or "").split(",") if t.strip()]
    keys = {_key(t) for t in have}
    add = [t for t in preset_conf.split(",") if t.strip() and _key(t) not in keys]
    return ",".join(have + add)


def _cuda_live() -> bool:
    """True once CUDA has started in this process. Importing torch is fine
    (nothing is read until CUDA starts); the check fails safe to False when
    torch is not imported."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def apply_preset(
    name: Optional[str],
    env: Optional[MutableMapping[str, str]] = None,
    *,
    force: bool = False,
) -> Dict[str, str]:
    """Apply preset ``name`` to ``env`` (default ``os.environ``); returns the
    variables actually written. Warns (but still writes, for any child
    processes) when CUDA has already started here: variables set after that
    do not reach this process's allocator or CUDA runtime."""
    if name in (None, "", "none"):
        return {}
    if name not in PRESETS:
        raise ValueError(f"unknown runtime preset {name!r}; have {sorted(PRESETS)}")
    env = os.environ if env is None else env
    if env is os.environ and _cuda_live():
        warnings.warn(
            "runtime preset applied after CUDA initialized: allocator and device "
            "variables will not affect this process",
            RuntimeWarning,
            stacklevel=2,
        )
    written: Dict[str, str] = {}
    for k, v in PRESETS[name].items():
        if k == ALLOC_CONF:
            merged = merge_alloc_conf(v, env.get(k))
            if env.get(k) != merged:
                env[k] = written[k] = merged
        elif force or k not in env:
            env[k] = written[k] = v
    return written
