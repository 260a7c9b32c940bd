"""The port's multi-rank training against the JAX package, on gloo ranks
spawned on the CPU (``launch.mesh.spawn``, a ``file://`` store in a
temporary directory): the int8 error-feedback all-reduce,
``pipeline_apply``, the mesh-level expert-parallel loss with its
gradients (capacity 8, nothing drops; the config's 1.25, assignments
drop), the small-batch prefill, the data- and expert-parallel train step,
the elastic checkpoint restore, and ``dryrun --mesh multi``.

The reference's multi-device outputs come from ONE subprocess with four
XLA host devices (as ``test_distributed.py`` runs its own), computed once
for the module and passed back as an ``.npz``; its single-device train
steps run here in process. The ranks' bodies live in
``torch_train_dist_ranks.py`` (no JAX there); two jobs carry every case,
four ranks and two. The reference subprocess runs while the ranks do.

Tolerances: the compressed all-reduce's sums and residuals within 1e-6
(its int8 codes exact: ``quantize_int8`` against the reference's);
pipeline outputs within 1e-5; losses within 1e-5 and gradients within
1e-4; the train steps' losses, grad norms and params within 1e-4;
checkpoint leaves exact; replicated gradients equal bit for bit across a
model group."""
import functools
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.checkpoint import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.distributed import dequantize_int8 as ref_dequantize  # noqa: E402
from repro.distributed import quantize_int8 as ref_quantize  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.training.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.training.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.training.train_loop import TrainConfig as RefTrainConfig  # noqa: E402
from repro.training.train_loop import make_train_step as ref_make_train_step  # noqa: E402

import torch_train_dist_ranks as R  # noqa: E402  # repro: allow[tier1-deps] — the rank bodies beside this file (torch + the port)
from repro_torch.checkpoint.manager import CheckpointManager, Shard  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.distributed import dequantize_int8, quantize_int8  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.launch import dryrun as DR  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.launch.mesh import RankMesh, mesh_axes, spawn  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.layers import MeshAxes  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.training.train_loop import layout_specs, state_sharding  # noqa: E402  # repro: allow[tier1-deps] — the port under test

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EP_AXES = MeshAxes(fsdp=False)  # dense leaves whole, experts over model


def _ranks(model: int, rank: int):
    """Rank ``rank``'s coordinates on (data 1, model ``model``), no groups."""
    return RankMesh({"data": 1, "model": model}, rank, {"data": 0, "model": rank}, {},
                    torch.device("cpu"), "gloo")
CFS = (8.0, 1.25)  # capacity factors of the EP-loss cases: nothing drops; the config's own

REF_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_tiny
from repro.distributed import compressed_psum, make_compressed_grad_allreduce, pipeline_apply
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.models.layers import MeshAxes

inp = dict(np.load(sys.argv[1]))
out = {}
pd = make_mesh((2, 2), ("pod", "data"))
g = {"b": jnp.asarray(inp["cb"]), "w": jnp.asarray(inp["cw"])}
f = make_compressed_grad_allreduce(pd, "pod")
o1, r1 = f(g, jax.tree.map(jnp.zeros_like, g))
o2, r2 = f(g, r1)
for k in g:
    out[f"c_o1_{k}"], out[f"c_r1_{k}"] = o1[k], r1[k]
    out[f"c_o2_{k}"], out[f"c_r2_{k}"] = o2[k], r2[k]
def per_pod(x, r):
    o, nr = compressed_psum(x[0], "pod", r[0])
    return o[None], nr[None]
fp = jax.jit(shard_map(per_pod, mesh=pd, in_specs=(P("pod"), P("pod")),
                       out_specs=(P("pod"), P("pod")), check_vma=False))
gp = jnp.asarray(inp["gp"])
out["c_po1"], out["c_pr1"] = fp(gp, jnp.zeros_like(gp))
out["c_po2"], out["c_pr2"] = fp(gp, out["c_pr1"])

W, x = jnp.asarray(inp["W"]), jnp.asarray(inp["x"])
for S in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:S]), ("stage",))
    out[f"pipe_{S}"] = pipeline_apply(mesh, "stage", lambda p, h: jnp.tanh(h @ p), W[:S], x)

mesh = make_mesh((2, 2), ("data", "model"))
axes = MeshAxes(data=("data",), model="model", fsdp=False)
batch = {"tokens": jnp.asarray(inp["tokens"]), "labels": jnp.asarray(inp["labels"])}
names = ["blocks/0/ffn/router", "blocks/0/ffn/w_gate", "blocks/0/mixer/wq", "ramps/head"]
for cf in (8.0, 1.25):
    m = build_model(get_tiny("qwen3-moe-30b-a3b").replace(capacity_factor=cf))
    params = m.init(jax.random.PRNGKey(0))
    fn = jax.jit(jax.value_and_grad(
        lambda p: m.loss(p, batch, axes=axes, mesh=mesh, moe_impl="ep"), has_aux=True))
    (loss, metrics), gr = fn(params)
    out[f"ep_{cf}_loss"] = loss
    for k, v in metrics.items():
        out[f"ep_{cf}_{k}"] = v
    for name in names:
        node = gr
        for key in name.split("/"):
            node = node[int(key)] if key.isdigit() else node[key]
        out[f"ep_{cf}_g_{name}"] = node

m = build_model(get_tiny("qwen3-moe-30b-a3b").replace(capacity_factor=8.0))
params = m.init(jax.random.PRNGKey(0))
_, outs = m.prefill(params, jnp.asarray(inp["small"]), active_sites=jnp.asarray([0], jnp.int32),
                    with_cache=False, moe_impl="ep", axes=axes, mesh=mesh)
for part, st in outs.items():
    for k, v in st.items():
        out[f"small_{part}_{k}"] = v
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def ref_params(name, seed=0, **over):
    return _np(ref_build(get_tiny(name).replace(**over)).init(jax.random.PRNGKey(seed)))


def _inputs():
    rng = np.random.default_rng(0)
    V = get_tiny(R.MOE).vocab_size
    tokens = rng.integers(0, V, (4, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, 3:14] = -1  # uneven padding: data rank 0 keeps far fewer labels
    labels[1, :5] = -1
    labels[3, 15] = -1
    return {"cb": rng.standard_normal(5).astype(np.float32),
            "cw": rng.standard_normal((33, 17)).astype(np.float32),
            "gp": rng.standard_normal((2, 40, 9)).astype(np.float32),
            "W": (0.3 * rng.standard_normal((4, 16, 16))).astype(np.float32),
            "x": rng.standard_normal((6, 3, 16)).astype(np.float32),
            "tokens": tokens, "labels": labels,
            "small": rng.integers(0, V, (2, 3)).astype(np.int32),
            "small1": rng.integers(0, V, (1, 3)).astype(np.int32)}


def _train_batches(name, rng, B=8, S=16):
    cfg = get_tiny(name)
    toks = rng.integers(0, cfg.vocab_size, (3, B, S)).astype(np.int32)
    if cfg.family == "lm":
        labels = np.roll(toks, -1, axis=2)
        labels[:, 0, 2:] = -1  # one row of each step's first microbatch mostly padding
        labels[:, 5, :7] = -1
        return [{"tokens": t, "labels": lab} for t, lab in zip(toks, labels)]
    labels = rng.integers(0, cfg.n_classes, (3, B)).astype(np.int32)
    return [{"tokens": t, "labels": lab} for t, lab in zip(toks, labels)]


TRAIN = {R.MOE: dict(arch=R.MOE, over={"capacity_factor": 8.0}, clip=0.05,
                     tcfg=dict(steps=3, lr=1e-2, warmup=1, grad_accum=2, moe_impl="ep")),
         f"{R.MOE}-ramps_only": dict(arch=R.MOE, over={"capacity_factor": 8.0}, clip=0.05,
                                     tcfg=dict(steps=3, lr=1e-2, warmup=1, moe_impl="ep",
                                               train_mode="ramps_only")),
         "bert-base": dict(arch="bert-base", over={}, clip=0.05,
                           tcfg=dict(steps=3, lr=1e-2, warmup=1))}


def _ref_train(name, case):
    """The reference's single-device ``make_train_step`` on the global
    batches."""
    model = ref_build(get_tiny(case["arch"]).replace(**case["over"]))
    tc = RefTrainConfig(**case["tcfg"])
    opt = RefAdamWConfig(lr=tc.lr, weight_decay=tc.weight_decay, clip_norm=case["clip"])
    step_fn, _ = ref_make_train_step(model, tc, opt_cfg=opt)
    params = jax.tree.map(jnp.asarray, case["params"])
    state = {"params": params, "opt": ref_adamw_init(params, opt),
             "step": jnp.zeros((), jnp.int32)}
    logs = []
    jstep = jax.jit(step_fn)
    for b in case["batches"]:
        state, out = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        logs.append({k: float(v) for k, v in out.items()})
    return {"logs": logs, "params": _np(state["params"])}


@functools.lru_cache(maxsize=None)
def runs():
    """The reference's outputs and both jobs' rank results."""
    inp = _inputs()
    tmp = tempfile.mkdtemp(prefix="train_dist_")
    np.savez(os.path.join(tmp, "in.npz"), **inp)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_CODE), os.path.join(tmp, "in.npz"),
         os.path.join(tmp, "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        moe_p = ref_params(R.MOE)
        rng = np.random.default_rng(1)
        train = {name: dict(c, params=ref_params(c["arch"]), batches=_train_batches(c["arch"], rng))
                 for name, c in TRAIN.items()}
        cases = {"compressed": {k: inp[k] for k in ("cb", "cw", "gp")},
                 "pipe": {"W": inp["W"], "x": inp["x"]},
                 "ep": {"params": moe_p, "tokens": inp["tokens"], "labels": inp["labels"],
                        "cfs": CFS},
                 "small": {"params": moe_p, "tokens": {k: inp[k] for k in ("small", "small1")}},
                 "train": train}
        four = spawn(R.job_four, 4, "gloo", device="cpu", args=(cases,))
        ckpt_dir = os.path.join(tmp, "ckpt")
        ck = {"params": moe_p, "dir": ckpt_dir,
              "batch": {"tokens": inp["tokens"], "labels": inp["labels"]}}
        two = spawn(R.job_ckpt, 2, "gloo", device="cpu", args=(ck,))
        ref_train = {name: _ref_train(name, c) for name, c in train.items()}
        stdout, stderr = ref_proc.communicate(timeout=600)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr[-3000:]}"
    ref = dict(np.load(os.path.join(tmp, "ref.npz")))
    # 3 tokens do not split over the data axis; the reference's mesh prefill
    # refuses a batch of 1 on it (its batch constraint), so this case is
    # held against its single-device dense dispatch (capacity 8: nothing
    # drops)
    m = ref_build(get_tiny(R.MOE).replace(capacity_factor=8.0))
    _, outs = m.prefill(jax.tree.map(jnp.asarray, moe_p), jnp.asarray(inp["small1"]),
                        active_sites=jnp.asarray([0], jnp.int32), with_cache=False,
                        moe_impl="dense")
    ref.update({f"small1_{part}_{k}": np.asarray(v) for part, st in outs.items()
                for k, v in st.items()})
    return {"inp": inp, "ref": ref, "four": four, "two": two, "ref_train": ref_train,
            "ckpt_dir": ckpt_dir, "tmp": tmp}


@pytest.fixture(scope="module", autouse=True)
def _remove_runs_dir():
    """Removes ``runs()``'s directory, its checkpoint included, once the
    module's tests are done."""
    yield
    if runs.cache_info().currsize:
        shutil.rmtree(runs()["tmp"], ignore_errors=True)


# -- the int8 error-feedback all-reduce -------------------------------------------


@pytest.mark.parametrize("shape", [(33, 17), (5,), (256,), (3, 300)])
def test_quantize_int8_matches_reference(shape):
    """``q`` and the scales equal the reference's exactly, and so does the
    round trip."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32) * 3
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = ref_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(dequantize_int8(q, s, shape, torch.float32).numpy(),
                                  np.asarray(ref_dequantize(rq, rs, shape, jnp.float32)))


@pytest.mark.parametrize("call", [1, 2])
def test_compressed_grad_allreduce_matches_reference(call):
    """``make_compressed_grad_allreduce`` over ``pod`` of a (pod 2, data 2)
    mesh, on leaves alike on every rank (the reference test's) and on
    leaves that differ by pod (``compressed_psum`` under a map over
    ``P("pod")``): the sums and residuals of a first call and of a second
    that feeds the first's residual back, on every rank."""
    run = runs()
    ref = run["ref"]
    for res in run["four"]:
        c = res["compressed"]
        for k in ("b", "w"):
            np.testing.assert_allclose(c[f"o{call}"][k], ref[f"c_o{call}_{k}"], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(c[f"r{call}"][k], ref[f"c_r{call}_{k}"], rtol=1e-6,
                                       atol=1e-6)
    for rank, res in enumerate(run["four"]):
        pod = rank // 2
        c = res["compressed"]
        np.testing.assert_allclose(c[f"po{call}"], ref[f"c_po{call}"][pod], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(c[f"pr{call}"], ref[f"c_pr{call}"][pod], rtol=1e-6,
                                   atol=1e-6)


def test_error_feedback_carries_the_residual():
    """Two calls with feedback sum closer to twice the exact sum than two
    calls without it, and the residual is the quantization error."""
    run = runs()
    inp, c = run["inp"], run["four"][0]["compressed"]
    exact = 2 * inp["cw"]  # two pods, alike
    with_fb = c["o1"]["w"] + c["o2"]["w"]
    without = 2 * c["o1"]["w"]
    assert np.abs(with_fb - 2 * exact).max() < np.abs(without - 2 * exact).max()
    assert np.abs(c["r1"]["w"]).sum() > 0


# -- pipeline_apply --------------------------------------------------------------


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_apply_matches_reference(S):
    """The GPipe forward over S stages against the reference's
    ``pipeline_apply`` (the ``tanh(h @ W)`` stages of its test) and the plain
    loop, on every rank (at S 2 both data rows of a (2, 2) mesh)."""
    run = runs()
    ref, inp = run["ref"], run["inp"]
    plain = inp["x"]
    for i in range(S):
        plain = np.tanh(plain @ inp["W"][i])
    for res in run["four"]:
        np.testing.assert_allclose(res["pipe"][S], ref[f"pipe_{S}"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["pipe"][S], plain, rtol=1e-5, atol=1e-5)


# -- the mesh-level expert-parallel loss -------------------------------------------


@pytest.mark.parametrize("cf", CFS)
def test_ep_loss_matches_reference_on_mesh(cf):
    """``LM.loss(mesh=)`` at (data 2, model 2), labels padded unevenly across
    the data shards, against the reference's loss on its (2, 2) mesh: the
    loss and its terms within 1e-5 on every rank; the gradients (summed
    over the data group) of the router, wq and the ramp head within 1e-4,
    an expert leaf's rank slice against the reference's."""
    run = runs()
    ref = run["ref"]
    for rank, res in enumerate(run["four"]):
        loss, metrics, grads, _ = res["ep"][cf]
        np.testing.assert_allclose(loss, ref[f"ep_{cf}_loss"], rtol=1e-5, atol=1e-5)
        for k, v in metrics.items():
            np.testing.assert_allclose(v, ref[f"ep_{cf}_{k}"], rtol=1e-5, atol=1e-5, err_msg=k)
        mi = res["coords"][1]
        for (path, split), name in zip(R.GRAD_LEAVES, grads):
            want = ref[f"ep_{cf}_g_{name}"]
            if split:
                n = want.shape[-3] // 2
                want = want[..., mi * n:(mi + 1) * n, :, :]
            np.testing.assert_allclose(grads[name], want, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("cf", CFS)
def test_ep_replicated_gradients_equal_across_model_group(cf):
    """The replicated leaves' gradients are bit for bit alike on both ranks
    of each model group."""
    four = runs()["four"]
    for d in range(2):
        a, b = (r["ep"][cf][2] for r in four[2 * d:2 * d + 2])
        for (path, split), name in zip(R.GRAD_LEAVES, a):
            if not split:
                np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_ep_at_the_configs_capacity_drops_assignments():
    """At capacity 8 no rank drops an assignment; at the config's 1.25 some
    rank does (and the loss test above holds the port's drops to the
    reference's: its loss and gradients within tolerance)."""
    four = runs()["four"]
    assert all(r["ep"][8.0][3]["dropped"] == 0 for r in four)
    assert sum(r["ep"][1.25][3]["dropped"] for r in four) > 0
    assert all(r["ep"][cf][3]["assignments"] > 0 for r in four for cf in CFS)


@pytest.mark.parametrize("key", ["small", "small1"])
def test_small_batch_prefill_matches_reference(key):
    """The prefill on a mesh at (data 2, model 2): 6 tokens against the
    reference's on its mesh (its ``test_moe_ep_small_batch_decode`` case: 3
    tokens a data rank, fewer than a model group's granularity of chunks);
    3 tokens, which do not split over the data axis and stay whole on
    every data rank, against its single-device dense dispatch. Final and
    ramp stats within 1e-5, labels exact."""
    run = runs()
    ref = run["ref"]
    for res in run["four"]:
        for part, st in res["small"][key].items():
            for k, v in st.items():
                want = ref[f"{key}_{part}_{k}"].reshape(v.shape)
                if k in ("label", "exit"):
                    np.testing.assert_array_equal(v, want, err_msg=f"{part}.{k}")
                else:
                    np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-5,
                                               err_msg=f"{part}.{k}")


# -- the data- and expert-parallel train step -------------------------------------


@pytest.mark.parametrize("name", list(TRAIN))
def test_mesh_train_step_matches_single_device_reference(name):
    """``make_train_step(mesh=)`` at (data 2, model 2), 3 steps (the MoE
    model with grad_accum 2 and unevenly padded labels, and in
    'ramps_only' mode; BERT-base), clipping active (clip 0.05), against the
    reference's single-device step on the global batch: losses, grad norms
    and params within 1e-4 on every rank (an expert leaf as the rank's
    slice)."""
    run = runs()
    want = run["ref_train"][name]
    specs = None
    if TRAIN[name]["arch"] == R.MOE:
        specs = build_model(get_tiny(R.MOE)).ep_param_specs()
    for res in run["four"]:
        got = res["train"][name]
        for g, w in zip(got["logs"], want["logs"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4, atol=1e-4)
            assert w["grad_norm"] > TRAIN[name]["clip"]
        mi = res["coords"][1]
        gl = jax.tree.leaves(got["params"])
        wl = jax.tree.leaves(want["params"])
        sl = (jax.tree.leaves(specs, is_leaf=lambda x: x is None) if specs is not None
              else [None] * len(wl))
        assert len(gl) == len(wl) == len(sl)
        for a, b, ax in zip(gl, wl, sl):
            if ax is not None:
                n = b.shape[ax] // 2
                b = np.take(b, range(mi * n, (mi + 1) * n), axis=b.ndim + ax)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    for d in range(2):  # replicated leaves stay alike across each model group
        a, b = (jax.tree.leaves(r["train"][name]["params"]) for r in run["four"][2 * d:2 * d + 2])
        for x, y, ax in zip(a, b, sl):
            if ax is None:
                np.testing.assert_array_equal(x, y)


# -- the elastic checkpoint restore ----------------------------------------------


def _stitch(two):
    """The whole state from the two (data 1, model 2) ranks' saved states."""
    specs = state_sharding(R.moe_model(8.0), _ranks(2, 0), EP_AXES)
    sl = jax.tree.leaves(specs, is_leaf=lambda x: x is None or isinstance(x, Shard))
    parts = [jax.tree.leaves(r["saved"]) for r in two]
    out = []
    for i, sh in enumerate(sl):
        if sh is None:
            out.append(parts[0][i])
            continue
        (axis, _, _), = sh.cuts()  # an expert leaf: one cut, over model
        out.append(np.concatenate([p[i] for p in parts], axis=axis))
    return out, sl


def test_checkpoint_saved_on_a_mesh_restores_anywhere():
    """The state saved from (data 1, model 2) restores at (data 2, model 1)
    (whole on each rank), onto one rank, and into the reference's
    ``CheckpointManager``, each leaf equal to the two ranks' parts put
    together."""
    run = runs()
    whole, _ = _stitch(run["two"])
    one = jax.tree.leaves(to_numpy(CheckpointManager(run["ckpt_dir"]).restore(1, "cpu")))
    ref = jax.tree.leaves(_np(RefCheckpointManager(run["ckpt_dir"]).restore(1)))
    for r in run["two"]:
        got = jax.tree.leaves(r["restored"])
        assert len(got) == len(whole) == len(one) == len(ref)
        for a, b, c, w in zip(got, one, ref, whole):
            np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(b, w)
            np.testing.assert_array_equal(c, w)


def test_reference_checkpoint_restores_onto_rank_slices(tmp_path):
    """A checkpoint the reference saved restores onto each rank's slices of
    a (data 1, model 4) layout reading only its part of each expert leaf."""
    model = ref_build(get_tiny(R.MOE).replace(n_experts=8))
    params = model.init(jax.random.PRNGKey(3))
    opt = RefAdamWConfig()
    state = {"params": params, "opt": ref_adamw_init(params, opt),
             "step": jnp.asarray(4, jnp.int32)}
    RefCheckpointManager(str(tmp_path)).save(state, 4)
    whole = jax.tree.leaves(_np(state))
    port = build_model(get_tiny(R.MOE).replace(n_experts=8))
    mgr = CheckpointManager(str(tmp_path))
    total = sum(x.nbytes for x in whole)
    for mi in range(4):
        specs = state_sharding(port, _ranks(4, mi), EP_AXES)
        got = jax.tree.leaves(to_numpy(mgr.restore(4, "cpu", sharding_tree=specs)))
        sl = jax.tree.leaves(specs, is_leaf=lambda x: x is None or isinstance(x, Shard))
        expect = 0
        for a, w, sh in zip(got, whole, sl):
            if sh is not None:
                w = w[sh.index_of(w.shape)]
            np.testing.assert_array_equal(a, w)
            expect += w.nbytes
        assert mgr.bytes_read == expect < total


# -- dryrun --mesh multi ------------------------------------------------------------


def test_dryrun_multi_counts_collectives():
    """Rank 0 of the (pod 2, data 16, model 16) layout, one MoE layer of
    qwen3-moe at tiny width (16 experts), a train_4k step without remat:
    every kind the step calls is counted, and the all-to-all bytes equal
    the hand reckoning: 2 all-to-alls forward and their 2 inverses
    backward, each the rank's (E, C, d) slot buffer in f32."""
    over = dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=48,
                vocab_size=512, n_experts=16, top_k=2, moe_d_ff=48, dtype="float32",
                train_remat=False)
    rec = DR.run_cell_multi("qwen3-moe-30b-a3b", "train_4k", write=False, overrides=over)
    assert rec["ok"] and rec["status"] == "ok", rec.get("traceback")
    c = rec["collectives"]
    for kind in ("all-gather", "all-to-all", "all-reduce"):
        assert c[kind]["calls"] > 0 and c[kind]["bytes"] > 0, kind
    cfg = DR.get_config("qwen3-moe-30b-a3b").replace(**over)
    T = 256 // 32 * 4096  # the rank's tokens
    Tl = -(-T // 16)
    C = max(1, int(cfg.capacity_factor * Tl * cfg.top_k / cfg.n_experts))
    assert c["all-to-all"]["calls"] == 4
    assert c["all-to-all"]["bytes"] == 4 * cfg.n_experts * C * cfg.d_model * 4
    # rank 0's model group (ranks 0-15) and data groups span 8-card hosts:
    # every byte is priced at the network's rate
    assert rec["collective_bytes_by_link"] == {"nvlink": 0.0,
                                               "network": rec["collective_bytes"]}
    assert rec["t_collective_s"] == pytest.approx(rec["collective_bytes"]
                                                  / DR.LINK_BW["network"])
    assert DR.link_of(range(8, 16)) == "nvlink" and DR.link_of((7, 8)) == "network"
    # the train cell's FSDP layout: every leaf split by its sanitized spec
    model = build_model(cfg)
    specs = layout_specs(model, DR.MULTI_LAYOUT, mesh_axes(DR.MULTI_LAYOUT))
    assert rec["resident"]["params"] == DR._rank_bytes(model.schema(), specs, DR.MULTI_LAYOUT)
