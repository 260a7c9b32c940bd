"""The weights a run serves, drawn by the benchmark from ``--seed``.

The tree has the leaf paths, shapes and dtypes of the program's params
(``layout`` is the program's schema walked into ``(path, shape, dtype)``),
so the program takes it as its own, and the plain reference reads the same
tensors. The values are the benchmark's: a standard normal draw on the
device from one ``torch.Generator``, a few large calls a dtype, scaled by
``init_rule``, a copy of the program's init scales (a CPU test holds the
two together). Leaves are views into one flat buffer a dtype, each at a
256-byte-aligned offset, so the program's alignment checks hold.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ALIGN = 256  # bytes: every leaf's offset in its buffer
CHUNK = 1 << 28  # elements a draw


def init_rule(path: Tuple[str, ...], n_layers: int) -> str:
    """The init of the leaf at ``path``: 'zeros', 'ones' or 'normal:<std>',
    the program's scales (norm gains and biases zero, the embedding and
    every input projection 0.02, the output projections 0.02 / sqrt(2 L),
    the MoE router 0.006)."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if parent in ("ln1", "ln2", "lnx", "final_norm") or name in (
            "norm_w", "kv_norm", "qnorm", "knorm"):
        return "zeros"
    if name in ("bq", "bk", "bv"):
        return "zeros"
    if name in ("wo", "w_down"):
        return f"normal:{0.02 / math.sqrt(2 * max(n_layers, 1))}"
    if name == "router":
        return "normal:0.006"
    return "normal:0.02"


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def layout(schema) -> List[Tuple[Tuple[str, ...], tuple, torch.dtype]]:
    """``(path, shape, dtype)`` of every leaf of a schema (a tree of dicts
    and lists whose leaves carry ``shape`` and ``dtype``), in sorted-key
    order."""
    return [(p, tuple(leaf.shape), leaf.dtype) for p, leaf in _walk(schema)]


def _rebuild(tree, leaves, path=()):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves, path + (str(i),)) for i, v in enumerate(tree)]
    return leaves[path]


def _offsets(leaves, dtype):
    per = max(1, ALIGN // torch.empty((), dtype=dtype).element_size())
    offs, n = [], 0
    for _, shape, dt in leaves:
        if dt != dtype:
            offs.append(None)
            continue
        offs.append(n)
        n += -(-math.prod(shape) // per) * per
    return offs, n


def draw(schema, seed: int, n_layers: int, device, buffers: Dict = None):
    """The params tree of ``schema`` (the program's) drawn from ``seed`` on
    ``device``. With ``buffers`` (the dict a previous draw filled) the
    values are drawn again into the same storage, so whatever holds views
    of the leaves (captured window graphs) sees the new weights. Returns
    (tree, buffers)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    lay = layout(schema)
    fresh = buffers is None
    buffers = {} if fresh else buffers
    leaves: Dict = {}
    for dtype in sorted({dt for _, _, dt in lay}, key=str):
        offs, total = _offsets(lay, dtype)
        if fresh:
            buffers[dtype] = torch.empty(total, dtype=dtype, device=device)
        buf = buffers[dtype]
        for a in range(0, total, CHUNK):
            b = min(total, a + CHUNK)
            buf[a:b].normal_(generator=gen)
        for (path, shape, dt), off in zip(lay, offs):
            if off is None:
                continue
            x = buf[off:off + math.prod(shape)].view(shape)
            kind, _, arg = init_rule(path, n_layers).partition(":")
            if kind == "zeros":
                x.zero_()
            elif kind == "ones":
                x.fill_(1.0)
            else:
                x.mul_(float(arg))
            leaves[path] = x
    return _rebuild(schema, leaves), buffers


def leaf(tree, path):
    """The leaf of ``tree`` at ``path``."""
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree
