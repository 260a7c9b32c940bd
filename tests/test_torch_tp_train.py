"""The FSDP train step's compute split over ``model`` against the JAX
package: each rank of a model group gathers a model-split leaf over its
data axes only and computes its heads, hidden units and vocabulary
columns (``transformer.fsdp_use``, ``layers.ModelSplit``), on gloo ranks
spawned on the CPU (``launch.mesh.spawn``), held against the reference's
``fsdp=True`` step (GSPMD's split of the same specs) on its meshes of four
XLA host devices.

The reference runs in ONE subprocess (as ``test_torch_fsdp.py`` runs its
own), started before the ranks and read after: two AdamW steps of tiny
DeepSeek-V2-Lite (MLA, shared experts) and Gemma3 (qk-norm, local
windows) at (data 2, model 2), the loss and gradients of tiny
SeamlessM4T (encoder, decoder self- and cross-attention) there, and two
steps of tiny qwen2 at (data 1, model 4), where its 2 kv heads do not
split over 4 ranks. Its params come from ``init(PRNGKey(0))``, which the
parent bridges to the ranks. The ranks' bodies live in
``torch_tp_train_ranks.py`` (no JAX there): one job of four ranks, one of
two.

Tolerances: losses, grad norms, gradients and every leaf after two steps
within 1e-4; the unit collectives exact or within 1e-6; a rank's product
FLOPs at (data 1, model 2) at most 0.6 of the single rank's."""
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

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_tiny  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import torch_tp_train_ranks as R  # noqa: E402  # repro: allow[tier1-deps] — the rank bodies beside this file (torch + the port)
from repro_torch.checkpoint.manager import Shard  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.launch.mesh import RankMesh, mesh_axes, spawn  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import transformer as T  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import entry_axes, part_shape, spec_parts, tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.training.train_loop import layout_specs, state_sharding  # noqa: E402  # repro: allow[tier1-deps] — the port under test

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MOE = {"capacity_factor": 8.0}  # nothing drops, so the rank's dispatch is the reference's
TRAIN22 = {"deepseek-v2-lite-16b": {"arch": "deepseek-v2-lite-16b", "over": MOE},
           "gemma3-4b": {"arch": "gemma3-4b", "over": {}}}
GRADS22 = {"seamless-m4t-large-v2": {"arch": "seamless-m4t-large-v2", "over": {}}}
TRAIN14 = {"qwen2-1.5b@1x4": {"arch": "qwen2-1.5b", "over": {}}}
MESHES = {"train22": (2, 2), "grads22": (2, 2), "train14": (1, 4)}
M_FRAMES = 12  # the enc-dec's encoder frames

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
rep_of = lambda mesh: NamedSharding(mesh, P())


def setup(arch, over, shape):
    mesh = make_mesh(shape, ("data", "model"))
    axes = mesh_axes(mesh, fsdp=True)
    model = build_model(get_tiny(arch).replace(**over))
    specs = sanitize_specs(model.pspecs(axes), abstract_from_schema(model.schema()), mesh)
    ns = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                      is_leaf=lambda x: isinstance(x, P))
    return mesh, axes, model, ns, jax.device_put(model.init(jax.random.PRNGKey(0)), ns)


for name, arch, over, shape in %s:
    mesh, axes, model, ns, params = setup(arch, over, shape)
    rep = rep_of(mesh)
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
    for s in range(tc.steps):
        batch = {k: jnp.asarray(inp[f"{name}_{k}"][s]) for k in ("tokens", "labels")}
        state, m = jstep(state, batch)
        out[f"{name}_loss_{s}"], out[f"{name}_gn_{s}"] = m["loss"], m["grad_norm"]
    for i, a in enumerate(jax.tree.leaves(state["params"])):
        out[f"{name}_p_{i}"] = a

for name, arch, over, shape in %s:
    mesh, axes, model, ns, params = setup(arch, over, shape)
    batch = {k: jnp.asarray(inp[f"{name}_{k}"]) for k in ("frames", "tokens", "labels")}
    bsh = {k: NamedSharding(mesh, P("data")) for k in batch}
    f = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b, axes=axes, mesh=mesh)[0]),
                in_shardings=(ns, bsh))
    loss, g = f(params, batch)
    leaves = jax.tree.leaves(g)
    out[f"{name}_loss"] = loss
    out[f"{name}_gn"] = jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32))) for x in leaves))
    for i, a in enumerate(leaves):
        out[f"{name}_g_{i}"] = a
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _batches(arch, rng, B=8, S=16):
    """Two steps' global batches, labels padded unevenly across the data
    shards."""
    cfg = get_tiny(arch)
    toks = rng.integers(0, cfg.vocab_size, (R.STEPS, B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=2)
    labels[:, 0, 2:] = -1  # data rank 0 keeps far fewer labels
    labels[:, 5, :7] = -1
    return toks, labels


def _case(c, rng):
    model = ref_build(get_tiny(c["arch"]).replace(**c["over"]))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    toks, labels = _batches(c["arch"], rng)
    return dict(c, params=params, batches=[{"tokens": t, "labels": lab}
                                           for t, lab in zip(toks, labels)])


@functools.lru_cache(maxsize=None)
def runs():
    """The reference's outputs and the two jobs' results."""
    tmp = tempfile.mkdtemp(prefix="tp_train_")
    rng = np.random.default_rng(2)
    inp, cases = {}, {"train22": {}, "grads22": {}, "train14": {}}
    for group, table in (("train22", TRAIN22), ("train14", TRAIN14)):
        for name, c in table.items():
            cases[group][name] = case = _case(c, rng)
            for k in ("tokens", "labels"):
                inp[f"{name}_{k}"] = np.stack([b[k] for b in case["batches"]])
    for name, c in GRADS22.items():
        case = _case(c, rng)
        cfg = get_tiny(c["arch"])
        batch = dict(case["batches"][0], frames=rng.standard_normal(
            (8, M_FRAMES, cfg.d_frontend)).astype(np.float32))
        cases["grads22"][name] = dict(case, batch=batch)
        inp.update({f"{name}_{k}": v for k, v in batch.items()})
    np.savez(os.path.join(tmp, "in.npz"), **inp)
    code = REF_CODE % (_ref_rows("train22", "train14"), R.STEPS, R.LR, R.CLIP,
                       _ref_rows("grads22"))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), os.path.join(tmp, "in.npz"),
         os.path.join(tmp, "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        four = spawn(R.job_four, 4, "gloo", device="cpu", args=(cases,))
        two = spawn(R.job_two, 2, "gloo", device="cpu", args=(
            {"flops": cases["train14"]["qwen2-1.5b@1x4"], "qnorm": cases["train22"]["gemma3-4b"]},))
        stdout, stderr = ref_proc.communicate(timeout=600)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr[-3000:]}"
    return {"ref": dict(np.load(os.path.join(tmp, "ref.npz"))), "four": four, "two": two,
            "cases": cases, "tmp": tmp}


def _ref_rows(*groups):
    """The reference's (name, arch, overrides, mesh shape) of each case of
    ``groups``."""
    tables = {"train22": TRAIN22, "grads22": GRADS22, "train14": TRAIN14}
    return repr([(n, c["arch"], c["over"], MESHES[g]) for g in groups
                 for n, c in tables[g].items()])


@pytest.fixture(scope="module", autouse=True)
def _remove_runs_dir():
    yield
    if runs.cache_info().currsize:
        shutil.rmtree(runs()["tmp"], ignore_errors=True)


def _standin(layout, coords):
    """A rank's view of a mesh with no process group: what the sharding
    reads (sizes, coordinates, axis names)."""
    return RankMesh(dict(layout), 0, dict(coords), {}, torch.device("cpu"), "gloo")


def _stitch(model, layout, parts_by_coords):
    """The whole leaves of the params (or of their gradients) from each
    rank's parts, ``{(data, model) coordinates: [part, ...]}`` in flatten
    order, by ``state_sharding``."""
    items = list(parts_by_coords.items())
    shards = []
    for (d, m), _ in items:
        sh = state_sharding(model, _standin(layout, {"data": d, "model": m}), mesh_axes(layout))
        shards.append(jax.tree.leaves(sh["params"], is_leaf=lambda x: x is None
                                      or isinstance(x, Shard)))
    out = []
    for i, first in enumerate(items[0][1]):
        if shards[0][i] is None:
            out.append(first)
            continue
        whole = np.empty(shards[0][i].whole_shape(first.shape), first.dtype)
        for (_, parts), sh in zip(items, shards):
            whole[sh[i].index_of(whole.shape)] = parts[i]
        out.append(whole)
    return out


def _layout(group):
    d, m = MESHES[group]
    return {"data": d, "model": m}


def _coords(group):
    return "coords14" if group == "train14" else "coords22"


TRAIN_CASES = [("train22", n) for n in TRAIN22] + [("train14", n) for n in TRAIN14]


@pytest.mark.parametrize("group,name", TRAIN_CASES)
def test_split_step_matches_reference(group, name):
    """Two AdamW steps (clipping active, remat on) of the split FSDP step:
    every rank's losses and grad norms, and every leaf put together from
    the ranks' parts, within 1e-4 of the reference's ``fsdp=True`` step on
    the same mesh: tiny DeepSeek-V2-Lite and Gemma3 at (data 2, model 2),
    tiny qwen2 at (data 1, model 4), whose ``wk``/``wv`` are gathered whole
    (2 kv heads over 4 ranks) and summed over the model group."""
    run = runs()
    ref = run["ref"]
    for r in run["four"]:
        for s, log in enumerate(r[name]["logs"]):
            np.testing.assert_allclose(log["loss"], ref[f"{name}_loss_{s}"], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(log["grad_norm"], ref[f"{name}_gn_{s}"], rtol=1e-4,
                                       atol=1e-4)
            assert ref[f"{name}_gn_{s}"] > R.CLIP
    model = R.model_of(run["cases"][group][name])
    got = _stitch(model, _layout(group), {r[_coords(group)]: r[name]["params"]
                                          for r in run["four"]})
    assert len(got) == len(tree_leaves(model.schema()))
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, ref[f"{name}_p_{i}"], rtol=1e-4, atol=1e-4, err_msg=str(i))


@pytest.mark.parametrize("name", list(GRADS22))
def test_split_encdec_loss_and_gradients_match_reference(name):
    """Tiny SeamlessM4T's ``loss(mesh=, fsdp=)`` at (data 2, model 2): the
    encoder's self-attention and FFN, the decoder's self- and
    cross-attention, FFN, heads and ramp heads on the rank's slices. Every
    rank's loss and global grad norm, and every gradient put together from
    the ranks' parts (summed over the data group), within 1e-4 of the
    reference's ``jax.value_and_grad`` on its (2, 2) mesh."""
    run = runs()
    ref = run["ref"]
    for r in run["four"]:
        np.testing.assert_allclose(r[name]["loss"], ref[f"{name}_loss"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r[name]["grad_norm"], ref[f"{name}_gn"], rtol=1e-4,
                                   atol=1e-4)
    model = R.model_of(run["cases"]["grads22"][name])
    got = _stitch(model, _layout("grads22"), {r["coords22"]: r[name]["grads"]
                                              for r in run["four"]})
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, ref[f"{name}_g_{i}"], rtol=1e-4, atol=1e-4, err_msg=str(i))


def _units_of(results):
    return [r["units"] for r in results]


@pytest.mark.parametrize("job", ["two", "four"])
def test_conjugate_pair(job):
    """On the model group of two and of four ranks: ``to_model_region`` is
    the identity forward and sums the ranks' gradients backward;
    ``from_model_region`` sums the ranks' inputs forward and passes the
    gradient as it is."""
    us = _units_of(runs()[job])
    xs, ups = sum(u["x"] for u in us), sum(u["up"] for u in us)
    for u in us:
        np.testing.assert_array_equal(u["to_y"], u["x"])
        np.testing.assert_allclose(u["to_grad"], ups, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(u["from_y"], xs, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(u["from_grad"], u["up"])


@pytest.mark.parametrize("job", ["two", "four"])
def test_vocab_parallel_nll_and_lookup(job):
    """The vocabulary-parallel ``_nll_sum`` over each rank's columns (a
    label in every rank's range, -1 labels, the padded columns on the last
    rank holding the largest logits) against the whole-logit one: value on
    every rank and each rank's columns of the gradient within 1e-6. The
    vocabulary-parallel lookup equals ``embed[tokens]`` exactly."""
    us = _units_of(runs()[job])
    m = len(us)
    logits = torch.randn(2, 6, R.VP, generator=torch.Generator().manual_seed(5))
    logits[..., R.V:] += 8.0
    logits.requires_grad_(True)
    tot, cnt = T._nll_sum(types.SimpleNamespace(vocab_size=R.V), logits, torch.tensor(R.LABELS))
    tot.backward()
    grad = logits.grad.numpy()
    n = R.VP // m
    owners = {min(lab // n, m - 1) for row in R.LABELS for lab in row if lab >= 0}
    assert owners == set(range(m))
    for i, u in enumerate(us):
        assert u["count"] == int(cnt)
        np.testing.assert_allclose(u["nll"], float(tot.detach()), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(u["nll_grad"], grad[..., i * n:(i + 1) * n], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(u["lookup"], u["lookup_want"])
    assert not grad[..., R.V:].any()


def test_qk_norm_gradient_is_summed_over_model():
    """Tiny Gemma3's qk-norm weights act on a rank's heads at (data 1,
    model 2): with their gradient summed over the model group each rank's
    equals the single rank's within 1e-6; the planted fault (the sum left
    out) reads beyond 1e-3."""
    for r in runs()["two"]:
        q = r["qnorm"]
        worst = 0.0
        for s, g, p in zip(q["single"], q["split"], q["planted"]):
            np.testing.assert_allclose(g, s, rtol=1e-5, atol=1e-6)
            worst = max(worst, float(np.abs(p - s).max()))
        assert worst > 1e-3


def test_split_step_product_flops():
    """A rank's product FLOPs (``FlopCounterMode``: forward, remat and
    backward) of tiny qwen2's split step at (data 1, model 2) are at most
    0.6 of the single rank's step on the same rows."""
    two = runs()["two"]
    single = two[0]["flops"]["single"]
    for r in two:
        assert r["flops"]["rank"] <= 0.6 * single, (r["flops"]["rank"], single)


def _model_group(result_by_kind_group, kind, ranks):
    return result_by_kind_group.get((kind, ranks), [0, 0.0])


def test_split_step_model_sums_match_the_layers():
    """One split step of tiny qwen2 at (data 1, model 2) without remat: the
    model group's all-reduces (``count_collectives``) are those the layers
    imply, each an f32 sum of the rank's rows counted twice (a ring sends
    each byte twice): a layer's row-parallel attention and FFN products
    forward and their inputs' gradients backward, the embedding's lookup,
    the LM head's input gradient and at each ramp site its features'
    gradient; the vocabulary-parallel cross-entropy's max, exponentials'
    sum and label logit of each row and position, at the LM head and each
    site; and the norm's two scalars. Nothing is all-gathered (data 1)."""
    case = runs()["cases"]["train14"]["qwen2-1.5b@1x4"]
    model = R.model_of(case)
    cfg = model.cfg
    B, S = case["batches"][0]["tokens"].shape
    npos = min(16, S)
    act = lambda n: 2 * 4 * B * n * cfg.d_model  # noqa: E731 — f32, twice
    small = lambda n: 2 * 4 * B * n  # noqa: E731
    sites = len(model.sites)
    calls = 4 * cfg.n_layers + 1 + 1 + sites + 3 * (1 + sites) + 2
    nbytes = ((4 * cfg.n_layers + 2) * act(S) + sites * act(npos) + 3 * small(S)
              + 3 * sites * small(npos) + 2 * 8)
    for r in runs()["two"]:
        c = r["sums"]
        assert c["kinds"]["all-gather"] == [0, 0.0]
        assert _model_group(c["by_kind_group"], "all-reduce", (0, 1)) == [calls, nbytes]


def _reckon_14(model):
    """(all-gather bytes, reduce-scatter bytes) of one split step of tiny
    qwen2 at (data 1, model 4) with remat, by hand from the sanitized
    specs. Data 1 gathers nothing over data; the leaves split over model
    that split with their sublayer (the query heads, the FFN's hidden
    units, the vocabulary) stay the rank's slice. ``wk``/``wv``/``bk``/
    ``bv`` (2 kv heads over 4 ranks) are gathered whole over model, twice
    a step (forward, remat), and their gradient reduce-scattered over
    model once (the sum each rank's partial gradient needs)."""
    layout = {"data": 1, "model": 4}
    mesh = _standin(layout, {"data": 0, "model": 0})
    ag = rs = 0
    specs = layout_specs(model, mesh, mesh_axes(layout))
    for path, (info, sp) in _paths(model.schema(), specs):
        if path[-1] not in ("wk", "wv", "bk", "bv"):
            continue
        assert [entry_axes(sp[d]) for d, _, _ in spec_parts(sp, mesh)] == [("model",)]
        part = int(np.prod(part_shape(info.shape, sp, mesh))) * info.dtype.itemsize
        ag += 2 * 4 * part
        rs += part
    return ag, rs


def _paths(schema, specs, path=()):
    if isinstance(schema, dict):
        for k in sorted(schema):
            yield from _paths(schema[k], specs[k], path + (k,))
    elif isinstance(schema, list):
        for i, (a, b) in enumerate(zip(schema, specs)):
            yield from _paths(a, b, path + (i,))
    else:
        yield path, (schema, specs)


def test_split_step_gathers_over_data_only():
    """Each step's all-gathered and reduce-scattered bytes of tiny qwen2 at
    (data 1, model 4) equal the specs' reckoning (``_reckon_14``): only the
    kv projections, whose heads do not split, are gathered, over model."""
    name = "qwen2-1.5b@1x4"
    ag, rs = _reckon_14(R.model_of(runs()["cases"]["train14"][name]))
    assert ag and rs
    for r in runs()["four"]:
        for c in r[name]["counts"]:
            assert c["kinds"]["all-gather"][1] == ag
            assert c["kinds"]["reduce-scatter"][1] == rs
