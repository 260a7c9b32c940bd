"""Chunked, atomic checkpointing with async writes (the port's counterpart
of the JAX package's ``checkpoint/manager.py``), in the SAME on-disk
format, so either package restores the other's checkpoints:
  * each leaf its own ``leaf_XXXXX.npy``, numbered in the flatten order
    (dict keys sorted, list items as ``#i``); ``manifest.json`` holds
    ``{"step", "leaves": {path: file}}``;
  * atomic: written to ``step_XXXXXXXX.tmp/``, fsynced, renamed;
  * async: ``save_async`` snapshots to host memory, then writes on a worker
    thread; ``wait`` joins it;
  * keep-N retention and resume discovery.

A bf16 leaf is written as the reference writes one: its raw two-byte
words under descr ``'<V2'`` (numpy has no bf16; ``np.load`` returns
such a leaf as ``V2``). On restore a ``V2`` leaf is read back as
``torch.bfloat16`` through its bits.

Meshes (the reference's checkpoints are mesh-agnostic: whole leaves as
host numpy). ``save(state, step, mesh=, sharding_tree=)`` writes from the
ranks of a mesh step, where a leaf marked ``Shard(axis, index, n)`` holds
only part ``index`` of ``n`` along ``axis`` on this rank (or, with tuples,
the part each of several axes cuts: an FSDP leaf split over data and
model): rank 0 writes each split leaf's header, sized for the whole leaf;
then each part is written in place into that file (``np.memmap``) by one
of the ranks that hold it (``replica`` 0), and the whole leaves (alike on
every rank) are spread over the ranks, leaf ``i`` on rank ``i mod
world``; rank 0 renames the directory after a barrier. The files are the
ones the whole tree would give, byte for byte.
``restore(step, device, sharding_tree=)`` reads only the rank's part of
each split leaf (``np.load(mmap_mode="r")``), so no rank holds a whole
split leaf; ``bytes_read`` counts what the last restore read.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.bridge import from_numpy_params
from repro_torch.models.common import tree_map

_BF16_DESCR = "<V2"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    root: Any = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for i, p in enumerate(parts):
            if i == len(parts) - 1:
                node[p] = val
            else:
                node = node.setdefault(p, {})
    return _restore_lists(root)


def _restore_lists(node):
    if isinstance(node, dict):
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
            return [_restore_lists(v) for _, v in items]
        return {k: _restore_lists(v) for k, v in node.items()}
    return node


def _host(x):
    """A leaf -> a host numpy array that no later in-place update touches;
    bf16 as its raw words (V2)."""
    if not torch.is_tensor(x):
        return np.array(x)
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _descr(dtype):
    # the reference's header for a bf16 leaf
    return _BF16_DESCR if dtype == np.dtype("V2") else np.lib.format.dtype_to_descr(dtype)


def _np_dtype(x):
    """The numpy dtype ``_host`` gives a leaf, without copying it."""
    if not torch.is_tensor(x):
        return np.asarray(x).dtype
    if x.dtype == torch.bfloat16:
        return np.dtype("V2")
    return torch.empty((), dtype=x.dtype).numpy().dtype


def _save_leaf(path, a):
    if a.dtype == np.dtype("V2"):
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": a.shape})
            f.write(np.ascontiguousarray(a).tobytes())
        return
    np.save(path, a, allow_pickle=False)


@dataclasses.dataclass(frozen=True)
class Shard:
    """A leaf a rank holds in part: part ``index`` of ``n`` equal parts
    along ``axis`` (the expert axis of a mesh step's expert leaves), or,
    with tuples of axes, indices and counts, the part that each of those
    axes cuts (an FSDP leaf split over data and model). ``replica`` is
    this rank's place among the ranks that hold the same part; replica 0
    writes it."""

    axis: Any
    index: Any
    n: Any
    replica: int = 0

    def cuts(self) -> list:
        """``[(axis, index, n)]``, one an axis the part is cut along."""
        if isinstance(self.axis, (tuple, list)):
            return list(zip(self.axis, self.index, self.n))
        return [(self.axis, self.index, self.n)]

    def whole_shape(self, part_shape) -> tuple:
        shape = list(part_shape)
        for ax, _, n in self.cuts():
            shape[ax] *= n
        return tuple(shape)

    def index_of(self, whole_shape) -> tuple:
        """The numpy index of this part in the whole leaf."""
        idx = [slice(None)] * len(whole_shape)
        for ax, i, n in self.cuts():
            ax %= len(whole_shape)
            k = whole_shape[ax] // n
            idx[ax] = slice(i * k, (i + 1) * k)
        return tuple(idx)


def _alloc_leaf(path, shape, dtype):
    """A leaf file with its header and room for the whole leaf."""
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _descr(dtype), "fortran_order": False, "shape": tuple(shape)})
        f.truncate(f.tell() + int(np.prod(shape)) * dtype.itemsize)


def _data_offset(path) -> int:
    with open(path, "rb") as f:
        np.lib.format.read_magic(f)
        np.lib.format.read_array_header_1_0(f)
        return f.tell()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------------

    def save(self, state, step: int, *, mesh=None, sharding_tree=None):
        """Write ``state`` as step ``step``. From a mesh step every rank calls
        it with its own state, ``mesh`` and ``sharding_tree`` (module
        docstring)."""
        if mesh is None:
            if sharding_tree is not None:
                raise ValueError("save(sharding_tree=) writes parts from the ranks of a mesh: "
                                 "pass mesh=")
            self._write(tree_map(_host, state), step)
            return
        self._write_mesh(state, step, mesh, sharding_tree)

    def _write_mesh(self, state, step, mesh, sharding_tree):
        """Each leaf reaches the host only on the rank that writes it."""
        import torch.distributed as dist

        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        flat = _flatten(state)
        shards = _flatten(sharding_tree) if sharding_tree is not None else {}
        files = {key: f"leaf_{i:05d}.npy" for i, key in enumerate(flat)}
        if mesh.rank == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for key, a in flat.items():
                sh = shards.get(key)
                if sh is not None:
                    _alloc_leaf(os.path.join(tmp, files[key]), sh.whole_shape(a.shape),
                                _np_dtype(a))
        dist.barrier()
        world = dist.get_world_size()
        for i, (key, a) in enumerate(flat.items()):
            sh = shards.get(key)
            path = os.path.join(tmp, files[key])
            if sh is None:
                if i % world == mesh.rank:
                    _save_leaf(path, _host(a))
            elif sh.replica == 0:  # one writer a part
                whole = sh.whole_shape(a.shape)
                a = _host(a)
                mm = np.memmap(path, dtype=a.dtype, mode="r+", offset=_data_offset(path),
                               shape=whole)
                mm[sh.index_of(whole)] = a
                mm.flush()
                del mm
        dist.barrier()
        if mesh.rank == 0:
            self._finish(tmp, name, step, files)
        dist.barrier()

    def save_async(self, state, step: int):
        """Snapshot to host memory synchronously, write on a worker thread."""
        host = tree_map(_host, state)
        self.wait()
        self._thread = threading.Thread(target=self._write, args=(host, step), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, host_state, step: int):
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for i, (key, val) in enumerate(_flatten(host_state).items()):
            fn = f"leaf_{i:05d}.npy"
            _save_leaf(os.path.join(tmp, fn), np.asarray(val))
            manifest[key] = fn
        self._finish(tmp, name, step, manifest)

    def _finish(self, tmp, name, step, manifest):
        """The manifest, fsync, the atomic rename, retention."""
        final = os.path.join(self.dir, name)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        dfd = os.open(tmp, os.O_RDONLY)
        os.fsync(dfd)
        os.close(dfd)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device="cuda", sharding_tree=None):
        """Load a checkpoint (the latest by default) as a tree of tensors on
        ``device``; None when there is none. ``sharding_tree`` (the state's
        structure, a ``Shard`` or None a leaf) restores onto a layout: a
        ``Shard`` leaf is read as that part only, whatever layout wrote the
        checkpoint. ``bytes_read`` is what this call read of the leaves."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        shards = _flatten(sharding_tree) if sharding_tree is not None else {}
        flat, self.bytes_read = {}, 0
        for key, fn in manifest["leaves"].items():
            sh = shards.get(key)
            if sh is None:
                a = np.load(os.path.join(path, fn), allow_pickle=False)
            else:
                whole = np.load(os.path.join(path, fn), mmap_mode="r", allow_pickle=False)
                a = np.ascontiguousarray(whole[sh.index_of(whole.shape)])
                del whole
            flat[key] = a
            self.bytes_read += a.nbytes
        return from_numpy_params(_unflatten(flat), device)
