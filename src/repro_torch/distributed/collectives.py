"""The collectives of multi-rank serving and training (the port's
counterparts of the ``jax.lax`` collectives the JAX package calls inside
``shard_map``, and of its ``distributed/collectives.py``):

* the tiled all-gather of the tensor-parallel combine (``tp_gather``,
  ``jax.lax.all_gather(tiled=True)``), the tiled all-to-all of expert
  parallelism (``all_to_all_tiled``, ``jax.lax.all_to_all``), a sum over a
  group (``sum_over``, ``jax.lax.psum``) and the pipeline ring
  (``ring_shift``, ``jax.lax.ppermute`` to the next rank);
* their versions with a gradient, for the expert-parallel loss
  (``all_to_all_ad``, ``take_chunk_ad``, ``all_gather_ad``: the backward
  of an all-to-all is the inverse all-to-all, of a rank's chunk of an
  activation alike on every rank an all-gather of the chunks' gradients,
  of an all-gather the rank's own slice);
* the FSDP gather of a param leaf where it is used (``fsdp_gather_ad``,
  ``fsdp_gather_tree``: the rank's part all-gathered over the axes its
  sanitized spec names; the backward reduce-scatters over ``data``, whose
  ranks see different rows, and takes the rank's own slice over
  ``model``, whose ranks compute alike) and its reduce-scatter
  (``reduce_scatter_tiled``), the layout the reference's GSPMD gives a
  train step's params, gradients and AdamW moments. A use spec
  (``KeepModel``) leaves a leaf's ``model`` part the rank's own, gathered
  over the data axes only, where the loss computes the rank's slice; a
  ``SumModel`` spec gathers a leaf whole and sums its gradient over
  ``model``, where a whole leaf acts on the rank's slice;
* the model region of a loss that splits its compute over ``model``
  (Megatron's conjugate pair): ``to_model_region``, identity forward and
  a sum over the model group backward, before the column-parallel
  products; ``from_model_region``, a sum forward and identity backward,
  after the row-parallel ones; ``max_over``, a forward-only max (the
  vocabulary-parallel log-sum-exp's shift). Their sums run in f32;
* the bucketed gradient all-reduce of a data-parallel step
  (``all_reduce_flat``), and the reference's int8 error-feedback
  all-reduce (``quantize_int8``, ``dequantize_int8``, ``compressed_psum``,
  ``make_compressed_grad_allreduce``). As the reference does, the
  compressed all-reduce sums the int8 payload as int32 (int8 sums
  overflow at two ranks), so it sends 4 bytes an element, as an f32
  all-reduce does; its scales add one f32 a block of 256.

Backends: with 'nccl' each collective runs on the card's tensors. With
'gloo' (ranks that share one card, or ranks on the CPU) a CUDA tensor is
copied to the host, the collective runs there, and the result is copied
back: gloo takes only some collectives on CUDA tensors, so every one here
stages through host memory on purpose, and only under gloo. The copy back
waits for the collective, so a window that calls these cannot be captured
as a CUDA graph under gloo.

``count_collectives`` counts, while it is open, each collective called
here by kind with its bytes, by the convention of the reference's dry run
(``COLLECTIVE_W``): the result's bytes, twice for an all-reduce (a ring
sends each byte twice), once for a reduce-scatter (its result is the
rank's chunk); a 1-rank group sends nothing and is not counted.
It also sums the bytes by group (the group's global ranks), so a
reckoning can price each group at the link its members share, and the
calls and bytes by kind and group (``by_kind_group``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

KINDS = ("all-gather", "reduce-scatter", "all-to-all", "all-reduce", "collective-permute")


class CollectiveCounts(dict):
    """``{kind: [calls, bytes]}``; ``by_group``: ``{the group's global
    ranks: bytes}`` over every kind; ``by_kind_group``: ``{(kind, the
    group's global ranks): [calls, bytes]}``."""

    def __init__(self):
        super().__init__({k: [0, 0.0] for k in KINDS})
        self.by_group: Dict[Tuple[int, ...], float] = {}
        self.by_kind_group: Dict[Tuple[str, Tuple[int, ...]], list] = {}


_COUNTS: Optional[CollectiveCounts] = None


@contextlib.contextmanager
def count_collectives():
    """Yields a ``CollectiveCounts``, filled by every collective of this
    module called inside the block (module docstring)."""
    global _COUNTS
    prev, _COUNTS = _COUNTS, CollectiveCounts()
    try:
        yield _COUNTS
    finally:
        _COUNTS = prev


def _count(kind: str, nbytes: float, group) -> None:
    if _COUNTS is not None and dist.get_world_size(group) > 1:
        c = _COUNTS[kind]
        c[0] += 1
        c[1] += float(nbytes)
        ranks = tuple(dist.get_process_group_ranks(group or dist.group.WORLD))
        _COUNTS.by_group[ranks] = _COUNTS.by_group.get(ranks, 0.0) + float(nbytes)
        kg = _COUNTS.by_kind_group.setdefault((kind, ranks), [0, 0.0])
        kg[0] += 1
        kg[1] += float(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _staged(t: torch.Tensor, group) -> bool:
    """True when ``t`` crosses to the host for the collective: a CUDA
    tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_tiled(y: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``y`` concatenated along ``dim`` in the group's rank
    order: a pure concatenation, no arithmetic. Under gloo a CUDA ``y``
    stages through host memory."""
    staged = _staged(y, group)
    x = (y.cpu() if staged else y).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    _count("all-gather", _nbytes(out), group)
    return out.to(y.device) if staged else out


def reduce_scatter_tiled(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over the group of every rank's ``x``, cut into ``m`` equal
    chunks along ``dim``; this rank gets the chunk at its group index.
    Under NCCL it is ``reduce_scatter_tensor``. Gloo has no reduce-scatter,
    so there each rank sends chunk ``j`` to rank ``j``
    (``all_to_all_single``) and sums the chunks it receives in rank order:
    the bytes of a reduce-scatter, where an all-reduce would move twice as
    many. Under gloo a CUDA ``x`` stages through host memory."""
    m = dist.get_world_size(group)
    if m == 1:
        return x
    dim %= x.dim()
    staged = _staged(x, group)
    src = x.cpu() if staged else x
    if dist.get_backend(group) == "gloo":
        send = torch.stack(torch.chunk(src, m, dim=dim)).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        out = recv[0]
        for j in range(1, m):
            out = out + recv[j]
    else:
        whole = src.movedim(dim, 0).contiguous()
        out = torch.empty((whole.shape[0] // m,) + tuple(whole.shape[1:]), dtype=whole.dtype,
                          device=whole.device)
        dist.reduce_scatter_tensor(out, whole, op=dist.ReduceOp.SUM, group=group)
        out = out.movedim(0, dim)
    out = out.contiguous()
    _count("reduce-scatter", _nbytes(out), group)
    return out.to(x.device) if staged else out


def tp_gather(y: torch.Tensor, group) -> torch.Tensor:
    """The tensor-parallel combine (the reference's ``_tp_gather``): each
    rank's column slice of ``y`` concatenated along the last axis in rank
    order, which is column order, so the result is the dense array."""
    return all_gather_tiled(y, group, y.dim() - 1)


def all_to_all_tiled(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, split_axis, concat_axis, tiled=True)``: ``x``
    split into ``m`` equal chunks along ``split_axis``, chunk ``j`` sent to
    rank ``j``, the chunks received concatenated along ``concat_axis`` in
    rank order. Under gloo a CUDA ``x`` stages through host memory."""
    m = dist.get_world_size(group)
    staged = _staged(x, group)
    src = x.cpu() if staged else x
    send = torch.stack(torch.chunk(src, m, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out = torch.cat(list(recv.unbind(0)), dim=concat_axis)
    _count("all-to-all", _nbytes(out), group)
    return out.to(x.device) if staged else out


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` (``jax.lax.psum``), on ``t``'s device.
    Under gloo a CUDA ``t`` stages through host memory."""
    return _all_reduce(t, group, dist.ReduceOp.SUM)


def max_over(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of every rank's ``t`` over the group, forward
    only (``t`` is detached): the shift of a vocabulary-parallel
    log-sum-exp, whose value the shift does not change."""
    return _all_reduce(t.detach(), group, dist.ReduceOp.MAX)


def _sum_f32(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over the group, taken in f32 and
    returned in ``t``'s dtype (one rounding)."""
    return _all_reduce(t.float(), group, dist.ReduceOp.SUM).to(t.dtype)


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    """``t`` reduced by ``op`` over the group (a new tensor on ``t``'s
    device; staged through the host under gloo)."""
    staged = _staged(t, group)
    x = (t.cpu() if staged else t).clone()
    dist.all_reduce(x, op=op, group=group)
    _count("all-reduce", 2 * _nbytes(x), group)
    return x.to(t.device) if staged else x


def all_reduce_flat(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The sum over the group of each tensor, IN PLACE, bucketed: one flat
    buffer and one all-reduce per dtype (a data-parallel step's
    gradients), not one call a tensor. Under gloo CUDA tensors are packed
    straight into a host buffer, so the card holds no second copy. Returns
    ``tensors``. Every rank passes tensors of the same shapes and dtypes."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        staged = _staged(ts[0], group)
        n = sum(t.numel() for t in ts)
        flat = torch.empty(n, dtype=ts[0].dtype, device="cpu" if staged else ts[0].device)
        lo = 0
        for t in ts:
            flat[lo:lo + t.numel()].copy_(t.reshape(-1))
            lo += t.numel()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        _count("all-reduce", 2 * _nbytes(flat), group)
        lo = 0
        for t in ts:
            t.copy_(flat[lo:lo + t.numel()].view(t.shape))
            lo += t.numel()
    return list(tensors)


# -- collectives with a gradient (the expert-parallel loss) --------------------


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return all_to_all_tiled(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return all_to_all_tiled(g.contiguous(), group, concat_axis, split_axis), None, None, None


class _TakeChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, n):
        i = dist.get_group_rank(group, dist.get_rank())
        ctx.args = (group, dim)
        return x.narrow(dim, i * n, n)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return all_gather_tiled(g.contiguous(), group, dim), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, dim):
        ctx.args = (group, dim, y.shape[dim])
        return all_gather_tiled(y, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, n = ctx.args
        i = dist.get_group_rank(group, dist.get_rank())
        return g.narrow(dim, i * n, n), None, None


class _FsdpGather(torch.autograd.Function):
    """Under gloo a CUDA leaf crosses to the host once a call, whatever the
    number of cuts: its part before the gathers, the whole after them; in
    the backward the gradient's own model slice, then its reduced part."""

    @staticmethod
    def forward(ctx, x, cuts):
        ctx.cuts = cuts
        staged = any(_staged(x, c[1]) for c in cuts)
        h = x.cpu() if staged else x
        for dim, group, _, _, _ in cuts:
            h = all_gather_tiled(h, group, dim)
        return h.to(x.device) if staged else h

    @staticmethod
    def backward(ctx, g):
        dev = g.device
        staged = any(_staged(g, c[1]) for c in ctx.cuts)
        for dim, group, n, i, sums in reversed(ctx.cuts):
            if sums:
                if staged and g.is_cuda:
                    g = g.contiguous().cpu()
                g = reduce_scatter_tiled(g.contiguous(), group, dim)
            else:
                k = g.shape[dim] // n
                g = g.narrow(dim, i * k, k)
        return g.to(dev).contiguous(), None


class KeepModel(tuple):
    """A use spec (``fsdp_gather_ad``): the sanitized spec of a leaf whose
    ``model`` part stays the rank's own where it is used, so it is
    gathered over the data axes only. The loss's column-, row- and
    vocabulary-parallel products take such a slice, as the expert-parallel
    dispatch takes the rank's experts."""


class SumModel(tuple):
    """A use spec (``fsdp_gather_ad``): the sanitized spec of a leaf that is
    used whole on the rank's model slice (qk-norm's weight on the rank's
    heads, a kv projection whose heads do not split over ``model``). It is
    gathered whole, and since each rank's gradient of it is partial, the
    gradient is summed over the model group."""


def _fsdp_cuts(spec, mesh) -> list:
    """``(dim, group, parts, this rank's part, sums)`` for each dim a
    sanitized spec splits on ``mesh`` (a ``launch.mesh.RankMesh``), the
    data cuts first: a data entry names every data axis of the mesh, in
    order (its group is the mesh's ``"batch"`` group) and sums in the
    backward; the ``model`` entry takes the rank's own slice, sums over the
    model group under a ``SumModel`` spec, and is no cut under a
    ``KeepModel`` spec."""
    from repro_torch.launch.mesh import DATA_AXES
    from repro_torch.models.common import entry_axes, spec_parts

    out = []
    for dim, i, n in spec_parts(spec, mesh):
        axes = entry_axes(spec[dim])
        if set(axes) <= set(DATA_AXES):
            if axes != mesh.data_axes:
                raise ValueError(f"spec entry {spec[dim]!r}: a data entry names the mesh's data "
                                 f"axes {mesh.data_axes}")
            out.insert(sum(c[4] for c in out), (dim, mesh.data_group, n, i, True))
        elif axes == ("model",):
            if not isinstance(spec, KeepModel):
                out.append((dim, mesh.model_group, n, i, isinstance(spec, SumModel)))
        else:
            raise ValueError(f"spec entry {spec[dim]!r}: FSDP splits over data axes or 'model'")
    return out


def fsdp_gather_ad(shard: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf of this rank's part ``shard`` of a param split by the
    sanitized ``spec`` over ``mesh``: all-gathered over the data group, then
    over the model group, along the dims the spec names. The backward takes
    the rank's own slice over ``model`` (the model group computes alike, so
    each rank's gradient of the whole leaf is the same), then
    reduce-scatters over the data group (each data rank's rows give a
    different gradient, and the loss is the global batch's, so they sum):
    the gradient of the rank's part. ``all_gather_ad``, which takes the own
    slice on every axis, would drop the other data ranks' gradients.

    A ``KeepModel`` spec gathers over the data group only: the result is
    the rank's model slice of the leaf. A ``SumModel`` spec gathers the
    whole leaf and sums its gradient over the model group: a reduce-scatter
    over ``model`` where the leaf is split there, else (after the data
    reduce-scatter) a sum of the part's gradient (``to_model_region``)."""
    cuts = _fsdp_cuts(spec, mesh)
    if (isinstance(spec, SumModel) and mesh.model_size > 1
            and not any(c[1] is mesh.model_group for c in cuts)):
        shard = to_model_region(shard, mesh.model_group)
    return _FsdpGather.apply(shard, cuts) if cuts else shard


def fsdp_gather_tree(parts, specs, mesh):
    """``fsdp_gather_ad`` on every leaf of a tree of parts, ``specs`` the
    sanitized spec of each leaf."""
    from repro_torch.models.common import tree_map2

    return tree_map2(lambda x, sp: fsdp_gather_ad(x, sp, mesh), parts, specs)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g.contiguous(), ctx.group), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        return _sum_f32(y.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_model_region(x: torch.Tensor, group) -> torch.Tensor:
    """Into the model region: ``x`` as it is (alike on every rank of the
    model group), its gradient summed over the group in f32. It goes
    before every column-parallel product, whose rank's gradient of ``x`` is
    partial, so what lies upstream (the residual stream, the norms) gets
    the whole gradient on every rank."""
    return _ToModel.apply(x, group)


def from_model_region(y: torch.Tensor, group) -> torch.Tensor:
    """Out of the model region: the sum over the model group of every
    rank's partial ``y`` (a row-parallel product, a vocabulary-parallel
    term), taken in f32 and returned in ``y``'s dtype; its gradient passes
    as it is to every rank's partial."""
    return _FromModel.apply(y, group)


def all_to_all_ad(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``all_to_all_tiled`` with a gradient: the inverse all-to-all (split
    and concat axes swapped)."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def take_chunk_ad(x: torch.Tensor, group, dim: int, n: int) -> torch.Tensor:
    """Rank ``i``'s chunk ``[i*n, (i+1)*n)`` along ``dim`` of an ``x`` that
    every rank of the group holds alike. Its gradient is the all-gather of
    every rank's chunk gradient: each rank then holds the whole gradient
    of ``x``."""
    return _TakeChunk.apply(x, group, dim, n)


def all_gather_ad(y: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``all_gather_tiled`` with a gradient: the rank's own slice of the
    upstream gradient, which every rank holds whole (the result is alike
    on every rank, and so is what consumes it)."""
    return _AllGather.apply(y, group, dim)


# -- the int8 error-feedback all-reduce (the reference's) ----------------------


def _blocks(flat: torch.Tensor, block: int) -> torch.Tensor:
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Per-block symmetric int8 quantization: returns (q (nb, block) int8,
    scales (nb, 1)), the reference's arithmetic in ``x``'s dtype."""
    blocks = _blocks(x.reshape(-1), block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape)).to(dtype)


def _compressed_flat(y: torch.Tensor, group, block: int):
    """The compressed all-reduce of one flat f32 ``y`` whose length is a
    multiple of ``block``: (the summed value, the new residual)."""
    blocks = y.reshape(-1, block)
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    shared = _all_reduce(amax, group, dist.ReduceOp.MAX)  # 1/block of the payload
    scale = torch.clamp(shared / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    sent = (q.float() * scale).reshape(-1)
    summed = _all_reduce(q.to(torch.int32), group, dist.ReduceOp.SUM)
    return (summed.float() * scale).reshape(-1), y - sent


def compressed_psum(x: torch.Tensor, group, residual: torch.Tensor, block: int = 256):
    """The int8 error-feedback all-reduce of ``x`` over ``group`` (the
    reference's ``compressed_psum``): a shared per-block scale (the MAX
    all-reduce of each rank's block amax) makes the int8 payloads
    summable; they are summed as int32; the residual carries this rank's
    quantization error into the next call. Returns (the summed value in
    f32, the new residual in f32), both of ``x``'s shape. Under gloo a
    CUDA ``x`` stages through host memory."""
    y = (x + residual).float()
    n = y.numel()
    out, res = _compressed_flat(_blocks(y.reshape(-1), block).reshape(-1), group, block)
    return out[:n].reshape(y.shape), res[:n].reshape(y.shape)


def make_compressed_grad_allreduce(mesh, axis_name: str = "pod", block: int = 256):
    """Returns ``f(grads, residuals) -> (summed, new_residuals)``: each leaf
    of a tree all-reduced over the mesh axis ``axis_name`` with int8 error
    feedback (``compressed_psum``), as the reference's. The leaves go in
    one bucket: each leaf padded to whole blocks on its own (no block spans
    two leaves, so every number is the per-leaf call's), one MAX and one
    int32 all-reduce a call."""
    from repro_torch.models.common import tree_leaves, tree_map

    group = mesh.groups[axis_name]

    def run(grads, residuals):
        ys = [(g + r).float() for g, r in zip(tree_leaves(grads), tree_leaves(residuals))]
        flat = torch.cat([_blocks(y.reshape(-1), block).reshape(-1) for y in ys])
        out, res = _compressed_flat(flat, group, block)
        outs, news, lo = [], [], 0
        for y in ys:
            n = y.numel()
            outs.append(out[lo:lo + n].reshape(y.shape))
            news.append(res[lo:lo + n].reshape(y.shape))
            lo += n + (-n) % block
        it_o, it_r = iter(outs), iter(news)
        return (tree_map(lambda _: next(it_o), grads), tree_map(lambda _: next(it_r), grads))

    return run


def ring_shift(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Send ``tensors`` to the next rank of the group's ring and return
    those of the previous one (``jax.lax.ppermute`` with ``i -> i + 1 mod
    S``). Every rank sends tensors of the same shapes and dtypes; they
    travel packed as one byte buffer, one send and one receive a call.
    Under gloo CUDA tensors stage through host memory."""
    S = dist.get_world_size(group)
    if S == 1:
        return [t.clone() for t in tensors]
    dev = tensors[0].device
    staged = _staged(tensors[0], group)
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    # each tensor starts 8-byte aligned, so its bytes view back as its dtype
    size = [-(-f.numel() // 8) * 8 for f in flat]
    buf = torch.cat([torch.nn.functional.pad(f, (0, n - f.numel())) for f, n in zip(flat, size)])
    if staged:
        buf = buf.cpu()
    recv = torch.empty_like(buf)
    me = dist.get_group_rank(group, dist.get_rank())
    nxt = dist.get_global_rank(group, (me + 1) % S)
    prv = dist.get_global_rank(group, (me - 1) % S)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, nxt, group),
                                   dist.P2POp(dist.irecv, recv, prv, group)])
    _count("collective-permute", _nbytes(recv), group)
    for r in reqs:
        r.wait()
    recv = recv.to(dev) if staged else recv
    out, lo = [], 0
    for t, f, n in zip(tensors, flat, size):
        out.append(recv[lo:lo + f.numel()].view(t.dtype).reshape(t.shape))
        lo += n
    return out
