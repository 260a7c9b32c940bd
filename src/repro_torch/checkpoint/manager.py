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
"""
from __future__ import annotations

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


def _save_leaf(path, a):
    if a.dtype == np.dtype("V2"):  # the reference's header for a bf16 leaf
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": a.shape})
            f.write(np.ascontiguousarray(a).tobytes())
        return
    np.save(path, a, allow_pickle=False)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------------

    def save(self, state, step: int):
        self._write(tree_map(_host, state), step)

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
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for i, (key, val) in enumerate(_flatten(host_state).items()):
            fn = f"leaf_{i:05d}.npy"
            _save_leaf(os.path.join(tmp, fn), np.asarray(val))
            manifest[key] = fn
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

    def restore(self, step: Optional[int] = None, device="cuda"):
        """Load a checkpoint (the latest by default) as a tree of tensors on
        ``device``; None when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {key: np.load(os.path.join(path, fn), allow_pickle=False)
                for key, fn in manifest["leaves"].items()}
        return from_numpy_params(_unflatten(flat), device)
