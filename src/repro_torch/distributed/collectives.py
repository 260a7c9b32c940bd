"""The collectives of multi-rank serving (the port's counterparts of the
``jax.lax`` collectives the JAX package's serving paths call inside
``shard_map``): the tiled all-gather of the tensor-parallel combine
(``tp_gather``, ``jax.lax.all_gather(tiled=True)``), the tiled all-to-all
of expert parallelism (``all_to_all_tiled``, ``jax.lax.all_to_all``), a
sum over a group (``sum_over``, ``jax.lax.psum``) and the pipeline ring
(``ring_shift``, ``jax.lax.ppermute`` to the next rank).

Backends: with 'nccl' each collective runs on the card's tensors. With
'gloo' (ranks that share one card, or ranks on the CPU) a CUDA tensor is
copied to the host, the collective runs there, and the result is copied
back: gloo takes only some collectives on CUDA tensors, so every one here
stages through host memory on purpose, and only under gloo. The copy back
waits for the collective, so a window that calls these cannot be captured
as a CUDA graph under gloo.

The gradient collectives of training (int8 compression with its residual)
are not here.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


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
    return out.to(y.device) if staged else out


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
    return out.to(x.device) if staged else out


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` (``jax.lax.psum``), on ``t``'s device.
    Under gloo a CUDA ``t`` stages through host memory."""
    staged = _staged(t, group)
    x = (t.cpu() if staged else t).clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(t.device) if staged else x


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
    for r in reqs:
        r.wait()
    recv = recv.to(dev) if staged else recv
    out, lo = [], 0
    for t, f, n in zip(tensors, flat, size):
        out.append(recv[lo:lo + f.numel()].view(t.dtype).reshape(t.shape))
        lo += n
    return out
