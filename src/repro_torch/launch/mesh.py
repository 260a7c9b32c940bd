"""Ranks, process groups and meshes over ``torch.distributed`` (the port's
counterpart of the JAX package's ``launch/mesh.py``).

JAX drives every device of a mesh from one process; here every rank is a
process that runs the same program on its own shard (SPMD). A rank joins
the job with ``init_dist`` (the backend is always named by the caller:
'nccl' for one card a rank, 'gloo' for ranks that share a card or run on
the CPU), then builds its view of a mesh: ``make_mesh(shape, axes)`` for
any row-major mesh over named axes (training: ``("data", "model")`` or
``("pod", "data", "model")``; ``make_test_mesh``,
``make_production_mesh``), or ``make_serving_mesh`` for the serving
layouts, ``("data", "model")`` (tensor-parallel decode) or ``("stage",)``
(the exit-gated pipeline window). A view holds the rank's coordinates,
the process group of each axis and its device. ``spawn`` starts the
ranks of one job as processes (the ``spawn`` start method), returns what
each rank's function returns, and raises when any rank raises or dies.

Ranks lie on the mesh row-major: rank ``d * tp + m`` holds data row ``d``
and model column ``m``; its model group is the ``tp`` ranks of its row,
its data group the ``dp`` ranks of its column.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import os
import pickle
import queue as _queue
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# how long ``spawn`` waits for its ranks before it stops them and raises
SPAWN_TIMEOUT_S = 1800.0


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device of ``rank``: ``cuda:(rank % device_count)`` (``cuda:0``
    for every rank on one card), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' to run the ranks on the CPU)")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _check_backend(backend: str, world: int, device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: name one of {BACKENDS}")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA devices; ranks on the CPU take 'gloo'")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > n:
            raise ValueError(
                f"backend 'nccl' with {world} ranks on {n} card(s): NCCL refuses two ranks "
                "on one device; ranks that share a card take backend='gloo'")


def init_dist(rank: int, world: int, *, backend: str, init_method: str,
              device="cuda") -> torch.device:
    """Join the job as ``rank`` of ``world`` through ``init_method`` (a
    ``file://`` store path or ``tcp://host:port``). ``backend`` is required:
    nothing picks one, and nothing switches after a failure. Returns the
    rank's device (and makes it current on a card)."""
    _check_backend(backend, world, device)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, **kw)
    return dev


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """One rank's view of the serving mesh. ``groups`` maps each axis name
    to the process group of the ranks this rank shares it with; ``coords``
    maps it to this rank's index along it."""

    tp: int
    dp: int
    pp: int
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Any]
    device: torch.device
    backend: str

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    @property
    def data_rank(self) -> int:
        return self.coords.get("data", 0)

    @property
    def stage(self) -> int:
        return self.coords.get("stage", 0)

    @functools.cached_property
    def tp_ctx(self):
        """The ``TpCtx`` of this rank's decode: the tiled gather over its
        model group, and its data group when rows shard over ``data``;
        built once a mesh (a sharded step is host-bound)."""
        from repro_torch.distributed import tp_gather
        from repro_torch.models.transformer import TpCtx

        g = self.groups["model"]
        return TpCtx(self.tp, functools.partial(tp_gather, group=g),
                     self.groups["data"] if self.dp > 1 else None, g, self.model_rank)


DATA_AXES = ("pod", "data")  # the axes a batch splits over, in this order


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """One rank's view of a row-major mesh over named axes (``make_mesh``).
    ``shape`` maps each axis to its size, in mesh order; ``coords`` maps it
    to this rank's index along it; ``groups`` maps it to the process group
    of the ranks that differ from this one only along it, and ``"batch"``
    to the group over the combined data axes (``DATA_AXES`` present),
    whose ranks lie in row-major (pod, data) order."""

    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Any]
    device: torch.device
    backend: str

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh lacks."""
        return self.shape.get(axis, 1)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in DATA_AXES if a in self.shape)

    @property
    def data_size(self) -> int:
        return math.prod(self.size(a) for a in self.data_axes)

    @property
    def data_rank(self) -> int:
        """This rank's index over the combined data axes, row-major."""
        r = 0
        for a in self.data_axes:
            r = r * self.shape[a] + self.coords[a]
        return r

    @property
    def data_group(self):
        return self.groups["batch"]

    @property
    def model_size(self) -> int:
        return self.size("model")

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    @property
    def model_group(self):
        return self.groups.get("model")

    def serving(self) -> "ServingMesh":
        """The ``ServingMesh`` of this layout for ``prefill_sharded`` and
        ``decode_sharded``: tensor-parallel over ``model``, rows over the
        combined data axes."""
        if "model" not in self.shape or set(self.shape) - set(DATA_AXES) - {"model"}:
            raise ValueError(f"mesh axes {self.axis_names}: a serving view needs 'model' "
                             f"and data axes {DATA_AXES} only")
        return ServingMesh(self.model_size, self.data_size, 1, self.rank,
                           {"data": self.data_rank, "model": self.model_rank},
                           {"model": self.groups["model"], "data": self.groups["batch"]},
                           self.device, self.backend)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda") -> RankMesh:
    """This rank's view of a row-major mesh of ``shape`` over named
    ``axes`` (the reference's ``make_mesh``): its coordinates, one process
    group per axis, and one over the combined data axes (``"batch"``).
    Every rank of the job calls it with the same arguments
    (``dist.new_group`` is collective); the job must have exactly
    ``prod(shape)`` ranks. The rank's device is ``rank_device(rank,
    device)``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call init_dist in every rank first")
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} must pair one to one")
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the job has {world}")
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    coords = {a: (rank // st) % n for a, n, st in zip(axes, shape, strides)}

    def groups_along(dims):
        """Every rank creates every group in one order; returns this rank's."""
        others = [i for i in range(len(axes)) if i not in dims]
        mine = None
        for fixed in itertools.product(*(range(shape[i]) for i in others)):
            base = sum(c * strides[i] for c, i in zip(fixed, others))
            members = [base + sum(c * strides[i] for c, i in zip(cs, dims))
                       for cs in itertools.product(*(range(shape[i]) for i in dims))]
            g = dist.new_group(members)
            if rank in members:
                mine = g
        return mine

    groups = {a: groups_along([i]) for i, a in enumerate(axes)}
    data_dims = [axes.index(a) for a in DATA_AXES if a in axes]
    groups["batch"] = groups_along(data_dims) if len(data_dims) > 1 else (
        groups[axes[data_dims[0]]] if data_dims else None)
    return RankMesh(dict(zip(axes, shape)), rank, coords, groups, rank_device(rank, device),
                    dist.get_backend())


def mesh_axes(mesh, *, fsdp: bool = True):
    """The ``MeshAxes`` of a mesh (a ``RankMesh``, or a dict of axis sizes):
    data over ``("pod", "data")`` when it has a ``pod`` axis, ``model`` or
    None without one; ``fsdp`` shards params over data too (training)."""
    from repro_torch.models.layers import MeshAxes

    names = tuple(mesh) if isinstance(mesh, dict) else mesh.axis_names
    data = ("pod", "data") if "pod" in names else ("data",)
    return MeshAxes(data=data, model="model" if "model" in names else None, fsdp=fsdp)


def make_test_mesh(data: int = 1, model: int = 1, *, device="cuda") -> RankMesh:
    """The reference's test mesh: ``(data, model)``."""
    return make_mesh((data, model), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> RankMesh:
    """The reference's production layouts, for the dry run: ``(data 16,
    model 16)``, or with ``multi_pod`` ``(pod 2, data 16, model 16)``."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device=device)
    return make_mesh((16, 16), ("data", "model"), device=device)


def make_serving_mesh(tp: int = 1, dp: int = 1, pp: int = 1, *, device="cuda") -> ServingMesh:
    """This rank's view of a ``(data, model)`` mesh of ``dp x tp`` ranks
    (``ShardedDecodeRunner``, ``decode_sharded``) or of a ``(stage,)`` mesh
    of ``pp`` ranks (``pipeline_decode_window``); the two are alternative
    layouts, not one mesh. Every rank of the job calls it with the same
    shape (``dist.new_group`` is collective). The rank's device is
    ``rank_device(rank, device)``."""
    if pp == 1:
        return make_mesh((dp, tp), ("data", "model"), device=device).serving()
    if tp > 1 or dp > 1:
        raise ValueError("pp is a (stage,) mesh; combine with tp/dp by nesting runners, "
                         "not one mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh: call init_dist in every rank first")
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != pp:
        raise ValueError(f"mesh ({pp},) needs {pp} ranks, the job has {world}")
    return ServingMesh(1, 1, pp, rank, {"stage": rank}, {"stage": dist.group.WORLD},
                       rank_device(rank, device), dist.get_backend())


def _rank_main(fn, rank, world, backend, init_method, device, args_path, results):
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        init_dist(rank, world, backend=backend, init_method=init_method, device=device)
        # plain pickle: tensors travel as bytes, not as shared memory that
        # this process's exit would take away before the parent reads it
        results.put((rank, True, pickle.dumps(fn(rank, world, *args))))
    except BaseException:  # the parent re-raises it with the rank's traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str, *, args: Sequence = (), device="cuda",
          store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the
    ``spawn`` start method), each joined to one job through a ``file://``
    store under ``store_dir`` (a fresh temporary directory by default), so
    concurrent jobs never collide on a port. ``fn`` and ``args`` must
    pickle (``args`` travel through a file there); ``fn`` builds its own
    mesh (``make_serving_mesh``). Returns each
    rank's result in rank order. If a rank raises or dies, or the ranks
    outlast ``SPAWN_TIMEOUT_S``, the other ranks
    are stopped and this raises with that rank's traceback: no rank's
    failure is swallowed. Every process is ended before it returns."""
    _check_backend(backend, world, device)
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        # the ranks read their arguments from a file: a pipe would hold each
        # start until the rank before it had unpickled them, so the ranks
        # would start one after another
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(tuple(args), f)
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, init_method, device, args_path,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        failure = None
        waited = 0.0
        try:
            while len(got) < world and failure is None:
                try:
                    rank, ok, out = results.get(timeout=0.5)
                except _queue.Empty:
                    waited += 0.5
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        failure = f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}"
                    elif waited > SPAWN_TIMEOUT_S:
                        failure = f"the ranks did not finish within {SPAWN_TIMEOUT_S:.0f} s"
                    continue
                if ok:
                    got[rank] = pickle.loads(out)
                else:
                    failure = f"rank {rank} raised:\n{out}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failure is not None:
            raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, world={world}, "
                               f"backend={backend!r}): {failure}")
        return [got[r] for r in range(world)]
