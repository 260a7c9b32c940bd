"""The port's checkpoints against the JAX package's, on the CPU.

Both packages write one ``leaf_XXXXX.npy`` a leaf in flatten order, a
``manifest.json`` and ``#i`` list keys, so either restores the other's:
the leaf files of one state are byte-identical across the packages, a bf16
leaf included (its raw words under descr '<V2'). Keep-N, async writes,
atomicity and resume are the reference's own cases. Tolerances: restored
leaves exact; a resumed run equal to one that never stopped: exact within
the port, and 1e-6 against the reference's continuation of the same
checkpoint (two frameworks' sums in other orders).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.training as RT  # noqa: E402
from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.data import TokenPipeline  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import repro_torch.training as TT  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.checkpoint import CheckpointManager  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402  # repro: allow[tier1-deps] — the port under test

BF16_BITS = np.array([[0x3F80, 0xC000, 0x0001], [0x7F7F, 0x8000, 0x3E80]], np.uint16)


def _states():
    """One state in both packages: f32, int32 steps, a list and a bf16 leaf
    (the same bits)."""
    w = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    ref = {"params": {"w": jnp.asarray(w), "blocks": [jnp.ones(3), jnp.zeros((2, 2))],
                      "emb": jnp.asarray(BF16_BITS.view(jnp.bfloat16))},
           "opt": {"step": jnp.int32(7)}, "step": jnp.int32(7)}
    port = {"params": {"w": torch.from_numpy(w), "blocks": [torch.ones(3), torch.zeros(2, 2)],
                       "emb": torch.from_numpy(BF16_BITS.view(np.int16)).view(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}
    return ref, port


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_checkpoints_interchange_byte_for_byte(tmp_path):
    ref, port = _states()
    RefManager(str(tmp_path / "ref")).save(ref, step=7)
    CheckpointManager(str(tmp_path / "port")).save(port, step=7)
    assert _files(tmp_path / "ref" / "step_00000007") == _files(tmp_path / "port" / "step_00000007")
    # the port restores the reference's: the bf16 leaf's bits, the lists, the steps
    got = CheckpointManager(str(tmp_path / "ref")).restore(device="cpu")
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert np.array_equal(got["params"]["emb"].view(torch.int16).numpy().view(np.uint16),
                          BF16_BITS)
    assert isinstance(got["params"]["blocks"], list) and int(got["step"]) == 7
    assert got["step"].dtype == torch.int32 and got["step"].dim() == 0
    np.testing.assert_array_equal(got["params"]["w"].numpy(), np.asarray(ref["params"]["w"]))
    # the reference restores the port's: a bf16 leaf comes back as raw V2 words
    back = RefManager(str(tmp_path / "port")).restore()
    assert back["params"]["emb"].dtype == np.dtype("V2")
    assert np.array_equal(back["params"]["emb"].view(np.uint16), BF16_BITS)
    np.testing.assert_array_equal(np.asarray(back["params"]["blocks"][1]), np.zeros((2, 2)))


def test_checkpoint_keep_n_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": torch.tensor(0)}
    for s in (1, 2, 3, 4):
        mgr.save_async({**state, "step": torch.tensor(s, dtype=torch.int32)}, step=s)
        state["params"]["w"].add_(1.0)  # after the snapshot: not in the checkpoint
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    r = mgr.restore(4, device="cpu")
    np.testing.assert_array_equal(r["params"]["w"].numpy(), np.arange(6.0).reshape(2, 3) + 3)
    assert int(r["step"]) == 4


def test_checkpoint_atomicity(tmp_path):
    """A leftover .tmp dir from a crashed writer is never picked up."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    os.makedirs(tmp_path / "ck" / "step_00000007.tmp")
    assert mgr.latest_step() is None and mgr.restore(device="cpu") is None
    mgr.save({"x": torch.ones(3)}, step=9)
    assert mgr.latest_step() == 9


def _run(step_fn, state, batches, lo, hi):
    for s in range(lo, hi):
        state, _ = step_fn(state, batches(s))
    return state


def test_resume_equals_a_run_that_never_stopped(tmp_path):
    tm = build_model(port_tiny("qwen2-1.5b"))
    step_fn, oc = TT.make_train_step(tm, TT.TrainConfig(steps=10, lr=1e-3))
    pipe = TokenPipeline(tm.cfg.vocab_size, 16, 4, seed=0)
    straight = _run(step_fn, TT.init_state(tm, 0, oc, device="cpu"), pipe.batch_at, 0, 10)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    half = _run(step_fn, TT.init_state(tm, 0, oc, device="cpu"), pipe.batch_at, 0, 5)
    mgr.save(half, step=5)
    restored = mgr.restore(device="cpu")
    assert int(restored["step"]) == 5
    resumed = _run(step_fn, restored, pipe.batch_at, 5, 10)
    for a, b in zip(tree_leaves(straight), tree_leaves(resumed)):
        assert torch.equal(a, b)


def test_port_continues_the_reference_checkpoint(tmp_path):
    """The reference trains 3 steps and checkpoints; the port restores the
    whole state (params, moments, steps) and trains 2 more; the reference
    continues from its own state: the same params and moments."""
    rm = ref_build(get_tiny("qwen2-1.5b"))
    tm = build_model(port_tiny("qwen2-1.5b"))
    pipe = TokenPipeline(rm.cfg.vocab_size, 16, 4, seed=2)
    rstep, roc = RT.make_train_step(rm, RT.TrainConfig(steps=5, lr=1e-3, warmup=2))
    jstep = jax.jit(rstep)
    rstate = RT.init_state(rm, jax.random.PRNGKey(0), roc)
    for s in range(3):
        rstate, _ = jstep(rstate, {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()})
    RefManager(str(tmp_path / "ck")).save(rstate, step=3)
    for s in range(3, 5):
        rstate, _ = jstep(rstate, {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()})
    tstep, _ = TT.make_train_step(tm, TT.TrainConfig(steps=5, lr=1e-3, warmup=2))
    tstate = CheckpointManager(str(tmp_path / "ck")).restore(device="cpu")
    assert int(tstate["step"]) == int(tstate["opt"]["step"]) == 3
    tstate = _run(tstep, tstate, pipe.batch_at, 3, 5)
    ref = jax.tree.map(np.asarray, rstate)
    for a, b in zip(tree_leaves(to_numpy(tstate)), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # and the state bridge carries the same tree without a checkpoint
    bridged = from_numpy_params(ref, "cpu")
    assert [t.shape for t in tree_leaves(bridged)] == [t.shape for t in tree_leaves(tstate)]


def test_train_launcher_resumes_as_never_stopped(tmp_path):
    """``launch/train.py``: a run stopped after its step-3 checkpoint and
    resumed with ``--resume`` ends where an uninterrupted run ends; the
    same launcher resumes a checkpoint the reference's launcher wrote."""
    from repro.launch.train import main as ref_main
    from repro_torch.launch.train import main  # repro: allow[tier1-deps] — the port under test

    args = ["--arch", "tiny:qwen2-1.5b", "--device", "cpu", "--steps", "6", "--batch", "4",
            "--seq", "16", "--lr", "1e-3"]
    ck = str(tmp_path / "ck")
    hist = []
    full = main(args + ["--ckpt-dir", ck, "--ckpt-every", "3"], history=hist)
    assert [h["step"] for h in hist] == list(range(6)) and all(h["ms"] > 0 for h in hist)
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [3, 6]
    shutil.rmtree(os.path.join(ck, "step_00000006"))  # "crashed" after step 3's checkpoint
    resumed = main(args + ["--ckpt-dir", ck, "--resume"])
    for a, b in zip(tree_leaves(full), tree_leaves(resumed)):
        assert torch.equal(a, b)
    # the reference launcher's checkpoint, resumed by the port's launcher
    rck = str(tmp_path / "rck")
    ref_main(["--arch", "tiny:qwen2-1.5b", "--steps", "3", "--batch", "4", "--seq", "16",
              "--ckpt-dir", rck])
    state = main(args + ["--ckpt-dir", rck, "--resume"])
    assert int(state["step"]) == 6 and all(bool(torch.isfinite(t).all())
                                            for t in tree_leaves(state["params"]))
