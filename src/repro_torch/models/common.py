"""Parameter schemas as plain shapes, dtypes and init kinds.

A model declares a *schema*: a tree (dicts and lists) of ``ParamInfo``
leaves, under the same leaf paths as the JAX package's schema. Params,
caches and the bridge from reference pytrees all derive from it, so their
trees never drift apart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Tree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """``ArchConfig.dtype`` names (JAX/numpy spelling) -> torch dtypes."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    shape: tuple
    dtype: torch.dtype = torch.float32
    # 'normal:<scale>' | 'embed:<scale>' | 'zeros' | 'ones' | 'ssm_a' | 'dt_bias'
    init: str = "normal:0.02"

    def initialize(self, gen: torch.Generator, device, keep=None) -> torch.Tensor:
        """The leaf drawn from ``gen``. ``keep=(axis, i, m)`` returns only
        part ``i`` of ``m`` equal parts along ``axis``, drawing ``gen`` as
        the whole leaf does, so the part equals the same slice of the
        whole leaf and ``gen`` ends where the whole draw leaves it
        (``LM.init_sharded``)."""
        kind, _, arg = self.init.partition(":")
        shape = tuple(self.shape)
        if keep is not None:
            ax, part, m = keep
            ax %= len(shape)
            n = shape[ax] // m
            lo = part * n
            shape = shape[:ax] + (n,) + shape[ax + 1:]
        if kind == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=device)
        if kind == "ones":
            return torch.ones(shape, dtype=self.dtype, device=device)
        if kind in ("normal", "embed"):
            scale = float(arg) if arg else 0.02
            out = torch.empty(shape, dtype=self.dtype, device=device)
            full = self.shape
            last = full[-1] if len(full) > 1 else math.prod(full)
            n_rows = math.prod(full) // max(last, 1)
            out2d = out.view(-1, out.shape[-1]) if out.dim() > 1 else out.view(1, -1)
            # draw in f32, then cast; one leading slice at a time so a
            # (12, d, V) ramp-head stack never needs an f32 copy of itself
            step = max(1, (1 << 26) // max(last, 1))
            for r0 in range(0, n_rows, step):
                r1 = min(n_rows, r0 + step)
                x = torch.randn((r1 - r0, last), generator=gen, device=device,
                                dtype=torch.float32) * scale
                if keep is None:
                    out2d[r0:r1] = x
                elif ax == len(full) - 1:  # a column slice of every row
                    out2d[r0:r1] = x[:, lo:lo + n]
                else:  # rows whose index along ax falls in the part
                    inner = math.prod(full[ax + 1:-1])
                    rows = torch.arange(r0, r1, device=device)
                    ia = (rows // inner) % full[ax]
                    sel = (ia >= lo) & (ia < lo + n)
                    dst = (rows // (inner * full[ax])) * (n * inner) + (ia - lo) * inner \
                        + rows % inner
                    out2d[dst[sel]] = x[sel].to(out.dtype)
            return out
        if kind in ("ssm_a", "dt_bias"):
            u = torch.rand(self.shape, generator=gen, device=device, dtype=torch.float32)
            if kind == "ssm_a":  # A_log in [log(1), log(16)) per Mamba2
                x = torch.log(1.0 + u * 15.0)
            else:  # softplus^-1 of dt in [1e-3, 1e-1]
                dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
                x = dt + torch.log(-torch.expm1(-dt))
            x = x.to(self.dtype)
            return x if keep is None else x.narrow(ax, lo, n).contiguous()
        raise ValueError(f"unknown init {self.init!r}")


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """Map over the leaves of a tree of dicts and lists, visiting dict keys
    in sorted order (the JAX flatten order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def init_from_schema(schema: Tree, gen: torch.Generator, device) -> Tree:
    """Initialize every leaf from one explicit generator, in flatten order."""
    return tree_map(lambda i: i.initialize(gen, device), schema)


def zeros_from_schema(schema: Tree, device) -> Tree:
    return tree_map(lambda i: torch.zeros(i.shape, dtype=i.dtype, device=device), schema)


def meta_from_schema(schema: Tree) -> Tree:
    """The schema's leaves as ``meta`` tensors: shapes and dtypes, no
    storage (the counterpart of the reference's ``abstract_from_schema``).
    A model traced on them computes nothing and allocates nothing."""
    return tree_map(lambda i: torch.empty(i.shape, dtype=i.dtype, device="meta"), schema)


def param_count(schema_or_params: Tree) -> int:
    """Elements of every leaf: ``ParamInfo`` shapes or tensors."""
    return sum(math.prod(x.shape) for x in tree_leaves(schema_or_params))


def param_bytes(schema: Tree) -> int:
    """Bytes of every leaf at its dtype."""
    return sum(math.prod(i.shape) * i.dtype.itemsize for i in tree_leaves(schema))


def pad_vocab(v: int, multiple: int = 2048) -> int:
    return ((v + multiple - 1) // multiple) * multiple
