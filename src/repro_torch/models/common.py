"""Parameter schemas as plain shapes, dtypes, init kinds and partition
specs.

A model declares a *schema*: a tree (dicts and lists) of ``ParamInfo``
leaves, under the same leaf paths as the JAX package's schema. Params,
caches, partition specs and the bridge from reference pytrees all derive
from it, so their trees never drift apart.

A partition spec is a plain tuple, one entry a dim from the first: None
(whole), a mesh axis name, or a tuple of axis names (the dim split over
their product, row-major), the reference's ``PartitionSpec`` entries with
no JAX type. A schema writes the placeholders ``"data"`` and ``"model"``;
``layers.resolve_schema`` maps them onto a mesh's axes, and
``sanitize_specs`` drops the entries a mesh does not divide. Since a spec
is a tuple, trees of specs are walked along the structure of a schema or a
param tree (``tree_map2``), never on their own.
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
    spec: tuple = ()  # the partition spec (module docstring); () is whole

    def initialize(self, gen: torch.Generator, device, keep=None) -> torch.Tensor:
        """The leaf drawn from ``gen``. ``keep=(axis, i, m)`` returns only
        part ``i`` of ``m`` equal parts along ``axis``, and a list of such
        triples the part that each of their axes cuts (``spec_parts``),
        drawing ``gen`` as the whole leaf does, so the part equals the same
        slice of the whole leaf and ``gen`` ends where the whole draw leaves
        it (``LM.init_sharded``, ``init_parts``)."""
        kind, _, arg = self.init.partition(":")
        full = tuple(self.shape)
        if keep is not None and not isinstance(keep[0], (tuple, list)):
            keep = [keep]
        cut = {}  # axis -> (lo, n)
        for ax, part, m in keep or ():
            ax %= len(full)
            n = full[ax] // m
            cut[ax] = (part * n, n)
        shape = tuple(cut[a][1] if a in cut else f for a, f in enumerate(full))
        if kind == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=device)
        if kind == "ones":
            return torch.ones(shape, dtype=self.dtype, device=device)
        if kind in ("normal", "embed"):
            scale = float(arg) if arg else 0.02
            out = torch.empty(shape, dtype=self.dtype, device=device)
            last = full[-1] if len(full) > 1 else math.prod(full)
            n_rows = math.prod(full) // max(last, 1)
            out2d = out.view(-1, out.shape[-1]) if out.dim() > 1 else out.view(1, -1)
            lead = len(full) - 1 if len(full) > 1 else 0  # the axes that index rows
            col = cut.get(lead) if len(full) > 1 else cut.get(0)
            row_cuts = {a: c for a, c in cut.items() if a < lead}
            # draw in f32, then cast; one leading slice at a time so a
            # (12, d, V) ramp-head stack never needs an f32 copy of itself
            step = max(1, (1 << 26) // max(last, 1))
            for r0 in range(0, n_rows, step):
                r1 = min(n_rows, r0 + step)
                x = torch.randn((r1 - r0, last), generator=gen, device=device,
                                dtype=torch.float32) * scale
                if col is not None:  # a column slice of every row
                    x = x[:, col[0]:col[0] + col[1]]
                if not row_cuts:
                    out2d[r0:r1] = x
                    continue
                # rows whose index along each cut axis falls in the part
                rows = torch.arange(r0, r1, device=device)
                sel = torch.ones_like(rows, dtype=torch.bool)
                dst = torch.zeros_like(rows)
                for a in range(lead):
                    ia = (rows // math.prod(full[a + 1:lead])) % full[a]
                    lo, n = row_cuts.get(a, (0, full[a]))
                    sel &= (ia >= lo) & (ia < lo + n)
                    dst += (ia - lo) * math.prod(shape[a + 1:lead])
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
            for ax, (lo, n) in cut.items():
                x = x.narrow(ax, lo, n)
            return x.contiguous()
        raise ValueError(f"unknown init {self.init!r}")


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """Map over the leaves of a tree of dicts and lists, visiting dict keys
    in sorted order (the JAX flatten order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_map2(fn: Callable, a: Tree, b: Tree) -> Tree:
    """``fn(x, y)`` over the leaves of ``a`` and the nodes of ``b`` at the
    same paths, in ``tree_map``'s order: ``a``'s structure drives the walk,
    so ``b`` may hold tuples (partition specs) at its leaves."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in sorted(a)}
    if isinstance(a, (list, tuple)):
        return [tree_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


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


# ---------------------------------------------------------------------------
# partition specs (the reference's sharding helpers)


def specs_from_schema(schema: Tree) -> Tree:
    """The spec of every leaf, a tuple at each leaf path."""
    return tree_map(lambda i: tuple(i.spec), schema)


def axis_specs(schema: Tree, axes: Tree, name: str = "model") -> Tree:
    """The partition specs of a tree of split axes: at each leaf an int (the
    dim split over ``name``, as ``tp_param_specs``/``ep_param_specs`` give
    it) or None (whole)."""
    def one(info, ax):
        spec = [None] * len(info.shape)
        if ax is not None:
            spec[ax % len(spec)] = name
        return tuple(spec)

    return tree_map2(one, schema, axes)


def shard_if_divisible(dim: int, axis, mesh_axis_sizes: dict):
    """``axis`` if ``dim`` divides evenly over it on every mesh we target."""
    if axis is None:
        return None
    size = mesh_axis_sizes.get(axis, 1)
    return axis if dim % size == 0 else None


# Mesh axis sizes we must remain divisible under (the production meshes).
PRODUCTION_AXES = {"data": 32, "model": 16}  # data worst case = pod*data = 32


def mk_spec(*axes) -> tuple:
    return tuple(axes)


def entry_axes(entry) -> tuple:
    """The mesh axes a spec entry names (none for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def mesh_sizes(mesh) -> dict:
    """Axis name -> size of a ``launch.mesh.RankMesh`` (its ``shape``) or of
    a dict that names them (``PRODUCTION_AXES``, a meta layout)."""
    return dict(mesh) if isinstance(mesh, dict) else dict(mesh.shape)


def sanitize_specs(specs: Tree, shapes: Tree, mesh) -> Tree:
    """Drop sharding-axis entries whose mesh size doesn't divide the dim.
    Keeps every spec valid on the given mesh (e.g. kv_heads=8 on model=16
    falls back to replication; batch=1 long-decode drops the data axis).
    ``shapes`` is a tree of the same structure whose leaves have a
    ``shape`` (``ParamInfo``s, tensors); ``mesh`` a ``RankMesh`` or a dict
    of axis sizes (``mesh_sizes``)."""
    sizes = mesh_sizes(mesh)

    def fix(x, spec):
        return tuple(None if e is None or x.shape[d] % math.prod(
            sizes.get(a, 1) for a in entry_axes(e)) else e for d, e in enumerate(spec))

    return tree_map2(fix, shapes, specs)


def spec_parts(spec, mesh) -> list:
    """For each dim a (sanitized) spec splits on ``mesh`` (a ``RankMesh``),
    ``(dim, this rank's part, parts)``: the part is the rank's row-major
    index over the entry's axes. An entry over axes of size 1 splits
    nothing and is left out."""
    out = []
    for d, e in enumerate(spec):
        n, i = 1, 0
        for a in entry_axes(e):
            n, i = n * mesh.shape.get(a, 1), i * mesh.shape.get(a, 1) + mesh.coords.get(a, 0)
        if n > 1:
            out.append((d, i, n))
    return out


def part_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's part of a leaf of ``shape`` split by ``spec``
    over ``mesh`` (a ``RankMesh`` or a dict of axis sizes)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        out[d] //= math.prod(sizes.get(a, 1) for a in entry_axes(e))
    return tuple(out)


def take_part(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The rank's part of a whole leaf ``x`` (a view)."""
    for d, i, n in spec_parts(spec, mesh):
        k = x.shape[d] // n
        x = x.narrow(d, i * k, k)
    return x


def init_parts(schema: Tree, specs: Tree, gen: torch.Generator, device, mesh) -> Tree:
    """The rank's part of every leaf of ``init_from_schema(schema, gen)``,
    drawn leaf by leaf in the same order, so each part equals the same
    slice of the whole leaf and no rank holds a whole split leaf."""
    return tree_map2(lambda i, sp: i.initialize(gen, device, spec_parts(sp, mesh) or None),
                     schema, specs)


def pad_vocab(v: int, multiple: int = 2048) -> int:
    return ((v + multiple - 1) // multiple) * multiple
