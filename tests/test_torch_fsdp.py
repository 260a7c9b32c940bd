"""The port's FSDP train state against the JAX package: the partition specs
of every schema leaf (``pspecs``, ``cache_pspecs``, ``sanitize_specs``,
``mesh_axes``) for all 14 configs at full width, computed on the schemas
alone (no tensor is allocated); and the FSDP mesh step, whose ranks hold
their part of every leaf of the params, gradients and AdamW moments, on
four gloo ranks spawned on the CPU (``launch.mesh.spawn``) against the
reference's ``fsdp=True`` step on its (data 2, model 2) mesh of four XLA
host devices.

The reference's step runs in ONE subprocess (as ``test_torch_train_dist.py``
runs its own), started before the ranks and read after; its params come
from ``init(PRNGKey(0))``, which the parent bridges to the ranks. The
ranks' bodies live in ``torch_fsdp_ranks.py`` (no JAX there).

Tolerances: specs equal; losses, grad norms and every leaf after two steps
within 1e-4; the unit collectives and the checkpoints exact."""
import filecmp
import functools
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.checkpoint import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.configs import ARCH_IDS, PAPER_IDS, get_tiny  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch.mesh import mesh_axes as ref_mesh_axes  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.common import PRODUCTION_AXES as REF_PRODUCTION_AXES  # noqa: E402
from repro.models.common import abstract_from_schema  # noqa: E402
from repro.models.common import sanitize_specs as ref_sanitize  # noqa: E402
from repro.models.layers import MeshAxes as RefMeshAxes  # noqa: E402

import torch_fsdp_ranks as R  # noqa: E402  # repro: allow[tier1-deps] — the rank bodies beside this file (torch + the port)
from repro_torch.checkpoint.manager import CheckpointManager, Shard  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.configs import get_config  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.launch.mesh import RankMesh, mesh_axes, spawn  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    PRODUCTION_AXES,
    entry_axes,
    part_shape,
    sanitize_specs,
    spec_parts,
    tree_leaves,
)
from repro_torch.models.layers import MeshAxes  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.training.train_loop import layout_specs, state_sharding  # noqa: E402  # repro: allow[tier1-deps] — the port under test

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CONFIGS = ARCH_IDS + PAPER_IDS  # all 14
# the meshes the specs are sanitized on: axis name -> size, in mesh order
LAYOUTS = {"production": {"data": PRODUCTION_AXES["data"], "model": PRODUCTION_AXES["model"]},
           "multi-pod": {"pod": 2, "data": 16, "model": 16},
           "test-2x2": {"data": 2, "model": 2}}
CASES = {"qwen2-1.5b": {"arch": "qwen2-1.5b", "over": {}},
         "qwen3-moe-30b-a3b": {"arch": "qwen3-moe-30b-a3b", "over": {"capacity_factor": 8.0}}}


# -- the specs ---------------------------------------------------------------------


def _flat(tree, prefix=""):
    """A port spec tree -> {leaf path: spec tuple} (dicts and lists are
    nodes, tuples leaves)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _ref_flat(tree):
    """A reference spec tree -> {leaf path: tuple(PartitionSpec)}."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(v)
            for path, v in leaves}


def _ref_mesh(layout):
    """What the reference's ``sanitize_specs`` and ``mesh_axes`` read of a
    mesh: its axis names and device grid's shape."""
    return types.SimpleNamespace(axis_names=tuple(layout),
                                 devices=np.empty(tuple(layout.values()), dtype=np.int8))


@functools.lru_cache(maxsize=None)
def _models(arch):
    return ref_build(ref_get_config(arch)), build_model(get_config(arch))


def _axes(layout, fsdp):
    if layout is None:
        return RefMeshAxes(fsdp=fsdp), MeshAxes(fsdp=fsdp)
    return ref_mesh_axes(_ref_mesh(layout), fsdp=fsdp), mesh_axes(layout, fsdp=fsdp)


def _both(ref_specs, specs, ref_schema, schema, layout):
    """(reference, port) spec trees as flat dicts, sanitized on ``layout``
    (resolved only with None)."""
    if layout is not None:
        ref_specs = ref_sanitize(ref_specs, abstract_from_schema(ref_schema), _ref_mesh(layout))
        specs = sanitize_specs(specs, schema, layout)
    return _ref_flat(ref_specs), _flat(specs)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("layout", [None] + list(LAYOUTS))
@pytest.mark.parametrize("arch", CONFIGS)
def test_pspecs_match_reference(arch, layout, fsdp):
    """Every param leaf's spec, path for path, at full width: as resolved
    on ``MeshAxes``, and as sanitized on the production mesh (data 32,
    model 16: ``PRODUCTION_AXES``), the multi-pod mesh (pod 2, data 16,
    model 16; data over ``("pod", "data")``) and the test mesh (2, 2)."""
    lay = LAYOUTS.get(layout)
    ref, port = _models(arch)
    ra, pa = _axes(lay, fsdp)
    want, got = _both(ref.pspecs(ra), port.pspecs(pa), ref.schema(), port.schema(), lay)
    assert got == want
    assert PRODUCTION_AXES == REF_PRODUCTION_AXES


LM_CONFIGS = [a for a in CONFIGS if get_config(a).family == "lm"]


@pytest.mark.parametrize("shard_batch", [True, False])
@pytest.mark.parametrize("arch", LM_CONFIGS)
def test_cache_pspecs_match_reference(arch, shard_batch):
    """Every contiguous cache leaf's spec at (B 8, S 1024), and every paged
    pool leaf's (64 blocks of 16), for ``fsdp`` True and False, resolved
    and sanitized on each mesh."""
    ref, port = _models(arch)
    for fsdp in (True, False):
        for lay in [None] + list(LAYOUTS.values()):
            ra, pa = _axes(lay, fsdp)
            want, got = _both(ref.cache_pspecs(8, 1024, ra, shard_batch),
                              port.cache_pspecs(8, 1024, pa, shard_batch),
                              ref.cache_schema(8, 1024, shard_batch),
                              port.cache_schema(8, 1024, shard_batch), lay)
            assert got == want, (fsdp, lay)
    from repro.models.common import specs_from_schema as ref_specs_from_schema
    from repro.models.layers import resolve_schema as ref_resolve
    from repro_torch.models.common import specs_from_schema  # repro: allow[tier1-deps] — the port under test
    from repro_torch.models.layers import resolve_schema  # repro: allow[tier1-deps] — the port under test

    ra, pa = _axes(None, False)
    assert (_flat(specs_from_schema(resolve_schema(port.paged_cache_schema(64, 16), pa)))
            == _ref_flat(ref_specs_from_schema(ref_resolve(ref.paged_cache_schema(64, 16), ra))))


@pytest.mark.parametrize("layout", [{"data": 2, "model": 2}, {"pod": 2, "data": 16, "model": 16},
                                    {"data": 4}])
def test_mesh_axes_match_reference(layout):
    """``mesh_axes`` of a (data, model) mesh, a (pod, data, model) mesh and
    a mesh without ``model``, on a ``RankMesh`` as on a dict of sizes."""
    rank = RankMesh(layout, 0, {a: 0 for a in layout}, {}, torch.device("cpu"), "gloo")
    for fsdp in (True, False):
        want = ref_mesh_axes(_ref_mesh(layout), fsdp=fsdp)
        for mesh in (layout, rank):
            got = mesh_axes(mesh, fsdp=fsdp)
            assert (got.data, got.model, got.fsdp, got.d) == (want.data, want.model, want.fsdp,
                                                               want.d)
            assert got.wspec("data", "model", None) == tuple(want.wspec("data", "model", None))
            assert got.aspec("data", "model") == tuple(want.aspec("data", "model"))


# -- the FSDP step against the reference -------------------------------------------

REF_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_tiny
from repro.launch.mesh import make_mesh, mesh_axes
from repro.models import build_model
from repro.models.common import abstract_from_schema, sanitize_specs
from repro.training.optim import AdamWConfig, adamw_init
from repro.training.train_loop import TrainConfig, make_train_step

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = make_mesh((2, 2), ("data", "model"))
axes = mesh_axes(mesh, fsdp=True)
rep = NamedSharding(mesh, P())
for name, over in %s:
    model = build_model(get_tiny(name).replace(**over))
    specs = sanitize_specs(model.pspecs(axes), abstract_from_schema(model.schema()), mesh)
    ns = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                      is_leaf=lambda x: isinstance(x, P))
    params = jax.device_put(model.init(jax.random.PRNGKey(0)), ns)
    tc = TrainConfig(steps=%d, lr=%r, warmup=1, moe_impl="ep", remat=True)
    opt = AdamWConfig(lr=tc.lr, weight_decay=tc.weight_decay, clip_norm=%r)
    step_fn, _ = make_train_step(model, tc, axes=axes, mesh=mesh, opt_cfg=opt)
    o = adamw_init(params, opt)
    state = {"params": params, "opt": {"step": o["step"], "mu": jax.device_put(o["mu"], ns),
                                       "nu": jax.device_put(o["nu"], ns)},
             "step": jnp.zeros((), jnp.int32)}
    bsh = NamedSharding(mesh, P("data", None))
    jstep = jax.jit(step_fn, in_shardings=(
        {"params": ns, "opt": {"step": rep, "mu": ns, "nu": ns}, "step": rep},
        {"tokens": bsh, "labels": bsh}))
    for i, a in enumerate(jax.tree.leaves(params)):
        out[f"{name}_shape_{i}"] = np.asarray(a.addressable_shards[0].data.shape)
    for s in range(tc.steps):
        batch = {k: jnp.asarray(inp[f"{name}_{k}"][s]) for k in ("tokens", "labels")}
        state, m = jstep(state, batch)
        out[f"{name}_loss_{s}"], out[f"{name}_gn_{s}"] = m["loss"], m["grad_norm"]
    for i, a in enumerate(jax.tree.leaves(state["params"])):
        out[f"{name}_p_{i}"] = a
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _batches(name, rng, B=8, S=16):
    """Two steps' global batches, labels padded unevenly across the data
    shards."""
    cfg = get_tiny(name)
    toks = rng.integers(0, cfg.vocab_size, (R.STEPS, B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=2)
    labels[:, 0, 2:] = -1  # data rank 0 keeps far fewer labels
    labels[:, 5, :7] = -1
    return toks, labels


def _standin(layout, coords):
    """A rank's view of a mesh with no process group: what the sharding
    reads (sizes, coordinates, axis names)."""
    return RankMesh(dict(layout), 0, dict(coords), {}, torch.device("cpu"), "gloo")


@functools.lru_cache(maxsize=None)
def runs():
    """The reference's outputs and the four ranks' results."""
    tmp = tempfile.mkdtemp(prefix="fsdp_")
    rng = np.random.default_rng(1)
    inp, cases = {}, {}
    for name, c in CASES.items():
        toks, labels = _batches(c["arch"], rng)
        inp[f"{name}_tokens"], inp[f"{name}_labels"] = toks, labels
        model = ref_build(get_tiny(c["arch"]).replace(**c["over"]))
        params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
        cases[name] = dict(c, params=params, batches=[{"tokens": t, "labels": lab}
                                                      for t, lab in zip(toks, labels)])
    np.savez(os.path.join(tmp, "in.npz"), **inp)
    code = REF_CODE % (repr([(c["arch"], c["over"]) for c in CASES.values()]), R.STEPS, R.LR,
                       R.CLIP)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), os.path.join(tmp, "in.npz"),
         os.path.join(tmp, "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ckpt = os.path.join(tmp, "ckpt")
        four = spawn(R.job, 4, "gloo", device="cpu", args=(cases, ckpt))
        stdout, stderr = ref_proc.communicate(timeout=600)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr[-3000:]}"
    return {"ref": dict(np.load(os.path.join(tmp, "ref.npz"))), "four": four, "cases": cases,
            "ckpt": ckpt, "tmp": tmp}


@pytest.fixture(scope="module", autouse=True)
def _remove_runs_dir():
    yield
    if runs.cache_info().currsize:
        shutil.rmtree(runs()["tmp"], ignore_errors=True)


MESH = {"data": 2, "model": 2}


def _stitch(name):
    """The whole state from the four ranks' parts (``state_sharding`` of
    each rank's coordinates): its leaves as numpy, in flatten order."""
    run = runs()
    model = R.model_of(CASES[name])
    parts, shards = [], []
    for r in run["four"]:
        d, m = r["coords"]
        sh = state_sharding(model, _standin(MESH, {"data": d, "model": m}), mesh_axes(MESH))
        parts.append(tree_leaves(r[name]["state"]))
        shards.append(jax.tree.leaves(sh, is_leaf=lambda x: x is None or isinstance(x, Shard)))
    out = []
    for i, first in enumerate(parts[0]):
        if shards[0][i] is None:
            out.append(first)
            continue
        whole = np.empty(shards[0][i].whole_shape(first.shape), first.dtype)
        for p, s in zip(parts, shards):
            whole[s[i].index_of(whole.shape)] = p[i]
        out.append(whole)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_step_matches_reference(name):
    """Two AdamW steps (clipping active) on tiny ``name`` at (data 2, model
    2): every rank's losses and grad norms, and every leaf put together
    from the ranks' parts, within 1e-4 of the reference's ``fsdp=True``
    step on its (2, 2) mesh."""
    run = runs()
    ref = run["ref"]
    for r in run["four"]:
        for s, log in enumerate(r[name]["logs"]):
            np.testing.assert_allclose(log["loss"], ref[f"{name}_loss_{s}"], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(log["grad_norm"], ref[f"{name}_gn_{s}"], rtol=1e-4,
                                       atol=1e-4)
            assert ref[f"{name}_gn_{s}"] > R.CLIP
    state = jax.tree.unflatten(jax.tree.structure(run["four"][0][name]["state"]), _stitch(name))
    got = jax.tree.leaves(state["params"])
    assert len(got) == len(tree_leaves(run["cases"][name]["params"]))
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, ref[f"{name}_p_{i}"], rtol=1e-4, atol=1e-4, err_msg=str(i))


@pytest.mark.parametrize("name", list(CASES))
def test_rank_parts_have_reference_shard_shapes(name):
    """Each rank's part of each param leaf has the shape of the reference's
    ``addressable_shards``. Only the f32 norms and the MoE router stay
    whole, and a rank holds about a quarter of the other leaves' bytes
    (qwen2's biases split over ``model`` only)."""
    run = runs()
    ref = run["ref"]
    model = R.model_of(CASES[name])
    schema = tree_leaves(model.schema())
    for r in run["four"]:
        shapes = r[name]["shapes"]
        assert len(shapes) == len(schema)
        for i, s in enumerate(shapes):
            assert s == tuple(ref[f"{name}_shape_{i}"]), i
    paths = list(_paths(model.schema(), model.schema()))
    shapes = run["four"][0][name]["shapes"]
    whole = [p for (p, (i, _)), s in zip(paths, shapes) if tuple(s) == i.shape]
    assert whole and all(p[-1] in ("w", "qnorm", "knorm", "norm_w", "router") for p in whole)
    total = sum(math_prod(i.shape) * i.dtype.itemsize for i in schema)
    kept = sum(math_prod(i.shape) * i.dtype.itemsize for (_, (i, _)), s in zip(paths, shapes)
               if tuple(s) == i.shape)
    mine = sum(math_prod(s) * i.dtype.itemsize for i, s in zip(schema, shapes))
    assert abs(mine - kept - (total - kept) / 4) < 0.005 * total


def math_prod(shape):
    out = 1
    for n in shape:
        out *= n
    return out


def _paths(schema, specs, path=()):
    """(leaf path, (ParamInfo, spec)) for every leaf of a schema."""
    if isinstance(schema, dict):
        for k in sorted(schema):
            yield from _paths(schema[k], specs[k], path + (k,))
    elif isinstance(schema, list):
        for i, (a, b) in enumerate(zip(schema, specs)):
            yield from _paths(a, b, path + (i,))
    else:
        yield path, (schema, specs)


def _reckon(model):
    """(all-gather bytes, reduce-scatter bytes) of one FSDP step at (2, 2)
    with remat, by hand from the sanitized specs. Each use of a leaf
    gathers it over data (the result twice its part), and reduce-scatters
    its gradient over data once (the result its part). A leaf split over
    model stays the rank's slice there: the step splits its compute over
    model, and every sublayer of these tiny models splits at (2, 2) (4
    heads, 2 kv heads, the hidden units, the vocabulary; a MoE slot's
    experts over model), so no leaf is gathered over model. A layer's
    leaves and the ramp heads are gathered twice (forward, and again in
    the remat backward), the tied embedding three times (the lookup; the
    head, forward and remat) and used twice."""
    mesh = _standin(MESH, {"data": 0, "model": 0})
    ag = rs = 0
    for path, (info, sp) in _paths(model.schema(), layout_specs(model, mesh, mesh_axes(MESH))):
        cuts = [(entry_axes(sp[d]), n) for d, _, n in spec_parts(sp, mesh)]
        cuts = [c for c in cuts if c[0] != ("model",)]
        part = math_prod(part_shape(info.shape, sp, mesh)) * info.dtype.itemsize
        one, g = 0, part
        for _, n in sorted(cuts, key=lambda c: c[0] == ("model",)):
            g *= n
            one += g
        tied = path == ("tok", "embed") and model.cfg.tie_embeddings
        gathers, uses = (3, 2) if tied else (2, 1)
        ag += gathers * one
        if any(c[0] == ("data",) for c in cuts):  # a model-only cut sums nothing
            rs += uses * part
    return ag, rs


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_step_collectives_match_the_specs(name):
    """Each step's reduce-scatter bytes (``count_collectives``) equal the
    bytes reckoned from the sanitized specs, on every rank; for the dense
    model the all-gather bytes too (the MoE model's expert-parallel
    dispatch all-gathers as well)."""
    ag, rs = _reckon(R.model_of(CASES[name]))
    for r in runs()["four"]:
        for c in r[name]["counts"]:
            assert c["reduce-scatter"][1] == rs
            if name == "qwen2-1.5b":
                assert c["all-gather"][1] == ag


# -- the collectives ------------------------------------------------------------------


def test_reduce_scatter_tiled_is_sum_then_chunk():
    """On gloo (an all-to-all of the chunks, summed in rank order) each
    rank's result is its data group's sum, cut along dim 1, the chunk at
    its data index."""
    four = runs()["four"]
    for r in four:
        d, m = r["coords"]
        total = sum(x["units"]["rs_in"] for x in four if x["coords"][1] == m)
        np.testing.assert_array_equal(r["units"]["rs_out"], np.split(total, 2, axis=1)[d])


def test_fsdp_gather_backward_sums_over_data_only():
    """``fsdp_gather_ad`` gives the whole leaf; its gradient is the rank's
    part of the upstream gradients summed over the data group (they differ
    by data rank, and are alike in a model group). ``all_gather_ad``,
    which takes the own slice on both axes, drops the other data rank's
    gradient."""
    four = runs()["four"]
    whole = torch.randn(4, 6, generator=torch.Generator().manual_seed(7)).numpy()
    ups = {x["coords"][0]: x["units"]["up"] for x in four}
    summed = ups[0] + ups[1]
    for r in four:
        d, m = r["coords"]
        np.testing.assert_array_equal(r["units"]["gathered"], whole)
        want = summed[2 * d:2 * d + 2, 3 * m:3 * m + 3]
        np.testing.assert_allclose(r["units"]["fsdp"], want, rtol=1e-6, atol=1e-6)
        assert not np.allclose(r["units"]["all_gather_ad"], want, rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(r["units"]["all_gather_ad"],
                                      ups[d][2 * d:2 * d + 2, 3 * m:3 * m + 3])


# -- checkpoints -------------------------------------------------------------------------


@pytest.mark.parametrize("axis,index,n,part,whole,idx", [
    ((1, 2), (0, 1), (2, 2), (3, 4, 5), (3, 8, 10), (slice(None), slice(0, 4), slice(5, 10))),
    ((-2, -1), (1, 0), (2, 4), (4, 4), (8, 16), (slice(4, 8), slice(0, 4))),
    ((0,), (3,), (4,), (2, 6), (8, 6), (slice(6, 8), slice(None))),
    (-3, 1, 2, (2, 3, 4), (4, 3, 4), (slice(2, 4), slice(None), slice(None))),
])
def test_shard_over_several_axes(axis, index, n, part, whole, idx):
    """``Shard.whole_shape`` and ``index_of`` of a part cut along two dims
    (an FSDP leaf split over data and model), one dim, and the expert axis
    of the experts-only (``fsdp=False``) layout."""
    sh = Shard(axis, index, n)
    assert sh.whole_shape(part) == whole
    assert sh.index_of(whole) == idx
    assert np.empty(whole)[sh.index_of(whole)].shape == part


def test_fsdp_checkpoint_restores_anywhere(tmp_path):
    """qwen2's state after two FSDP steps, saved from the four ranks of (2,
    2), is byte for byte the checkpoint a whole save of the put-together
    state writes (the reference's format, which the reference restores);
    it restores onto one rank whole and onto each rank of (data 1, model
    4), which reads only its part of each split leaf, bit for bit."""
    run = runs()
    name = "qwen2-1.5b"
    whole = _stitch(name)
    model = R.model_of(CASES[name])
    mgr = CheckpointManager(run["ckpt"])
    treedef = jax.tree.structure(run["four"][0][name]["state"])
    state = jax.tree.unflatten(treedef, whole)
    CheckpointManager(str(tmp_path)).save(from_numpy_params(state, "cpu"), R.STEPS)
    step_dir = f"step_{R.STEPS:08d}"
    names = sorted(os.listdir(os.path.join(run["ckpt"], step_dir)))
    assert names == sorted(os.listdir(tmp_path / step_dir))
    for f in names:
        assert filecmp.cmp(os.path.join(run["ckpt"], step_dir, f), tmp_path / step_dir / f,
                           shallow=False), f
    one = jax.tree.leaves(jax.tree.map(np.asarray, mgr.restore(R.STEPS, "cpu")))
    ref = jax.tree.leaves(jax.tree.map(np.asarray, RefCheckpointManager(run["ckpt"]).restore(R.STEPS)))
    assert len(one) == len(ref) == len(whole)
    for a, b, w in zip(one, ref, whole):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, w)
    total = sum(w.nbytes for w in whole)
    layout = {"data": 1, "model": 4}
    for mi in range(4):
        sh = state_sharding(model, _standin(layout, {"data": 0, "model": mi}), mesh_axes(layout))
        got = jax.tree.leaves(jax.tree.map(np.asarray, mgr.restore(R.STEPS, "cpu",
                                                                   sharding_tree=sh)))
        sl = jax.tree.leaves(sh, is_leaf=lambda x: x is None or isinstance(x, Shard))
        assert any(s is not None for s in sl)
        read = 0
        for a, w, s in zip(got, whole, sl):
            want = w if s is None else w[s.index_of(w.shape)]
            np.testing.assert_array_equal(a, want)
            read += want.nbytes
        assert mgr.bytes_read == read < total


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b",
                                  "mamba2-2.7b", "seamless-m4t-large-v2"])
def test_init_parts_are_slices_of_the_whole_draw(arch):
    """``init_state(mesh=)``'s parts (``ParamInfo.initialize`` keeping the
    part each of a leaf's cut dims gives, one or two) equal the rank's
    slices of the whole ``init``, bit for bit, on every rank of (2, 2) and
    of (data 1, model 4); the moments are zero and shaped alike."""
    from repro_torch.models.common import take_part  # repro: allow[tier1-deps] — the port under test
    from repro_torch.training import init_state  # repro: allow[tier1-deps] — the port under test
    from repro_torch.training.optim import AdamWConfig  # repro: allow[tier1-deps] — the port under test

    model = build_model(get_tiny(arch))
    whole = model.init(3, device="cpu")
    for layout in (MESH, {"data": 1, "model": 4}):
        for d in range(layout["data"]):
            for m in range(layout["model"]):
                mesh = _standin(layout, {"data": d, "model": m})
                state = init_state(model, 3, AdamWConfig(), "cpu", mesh=mesh)
                specs = layout_specs(model, mesh, mesh_axes(layout))
                got = tree_leaves(state["params"])
                want = [take_part(w, sp, mesh) for w, (_, (_, sp)) in
                        zip(tree_leaves(whole), _paths(model.schema(), specs))]
                assert any(g.shape != w.shape for g, w in zip(got, tree_leaves(whole)))
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
                for mu in tree_leaves(state["opt"]["mu"]):
                    assert not mu.any()
