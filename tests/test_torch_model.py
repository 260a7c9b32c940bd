"""The port's LM against the JAX package's LM on tiny configs with the same
(bridged) weights: fp32, tolerance 1e-4 per whole model, discrete outputs
(labels, exit sites, n_done, greedy tokens) exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_tiny  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen2-1.5b", "gpt2-medium"]
# (reference decode_attn, pallas_head) <-> (port decode_attn, pallas_head):
# the port's 'kernel' runs the plain versions on CPU tensors, the
# reference's pallas head runs in interpret mode
MODES = {
    "dense": (("dense", "off"), ("dense", "off")),
    "kernels": (("ref", "interpret"), ("kernel", "kernel")),
}


def _pair(arch, mode, seed=0):
    (rda, rph), (tda, tph) = MODES[mode]
    rm = ref_build(get_tiny(arch).replace(decode_attn=rda, pallas_head=rph))
    tm = build_model(port_tiny(arch).replace(decode_attn=tda, pallas_head=tph))
    # perturb every leaf so zero-initialized biases and norms take part
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        rm.init(jax.random.PRNGKey(seed)))
    return rm, jax.tree.map(jnp.asarray, p), tm, from_numpy_params(p, "cpu")


def _check_stats(t, r, keys=("label", "maxprob", "entropy")):
    for k in keys:
        a, b = t[k].numpy(), np.asarray(r[k]).reshape(t[k].shape)
        if k in ("label", "exit"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **TOL)


def _check_cache(tc, rc):
    for a, b in zip(jax.tree.leaves(to_numpy(tc)), jax.tree.leaves(rc)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def _prefill(rm, rp, tm, tp, B=3, P=6, C=24, seed=0):
    toks = np.random.default_rng(seed).integers(0, rm.cfg.vocab_size, (B, P))
    act = list(range(len(rm.sites)))
    rc, ro = rm.prefill(rp, jnp.asarray(toks, jnp.int32), cache_len=C,
                        active_sites=jnp.asarray(act, jnp.int32))
    tc, to = tm.prefill(tp, torch.from_numpy(toks), cache_len=C, active_sites=act)
    return act, (rc, ro), (tc, to)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_then_decode_records_and_cache(arch, mode):
    rm, rp, tm, tp = _pair(arch, mode)
    act, (rc, ro), (tc, to) = _prefill(rm, rp, tm, tp)
    assert tuple(tm.sites) == tuple(rm.sites)
    _check_stats(to["final"], ro["final"])
    _check_stats(to["ramps"], ro["ramps"])
    _check_cache(tc, rc)
    # one decode step, every row at its own position, with exit thresholds
    pos = np.array([6, 9, 7])
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    thr = np.full(len(act), 0.999, np.float32)
    rc, ro = rm.decode(rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
                       active_sites=jnp.asarray(act, jnp.int32),
                       exit_thresholds=jnp.asarray(thr))
    tc, to = tm.decode(tp, tc, torch.from_numpy(tok.copy()).long(), torch.from_numpy(pos),
                       active_sites=act, exit_thresholds=torch.from_numpy(thr))
    _check_stats(to["final"], ro["final"])
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy", "exit"))
    _check_cache(tc, rc)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("thr_kind", ["mid", "all_exit"])
def test_decode_multi_window(arch, mode, thr_kind):
    """Records, first-firing exit sites and n_done of a sync window, and the
    cache after it: steps past the window's end must leave it unchanged."""
    rm, rp, tm, tp = _pair(arch, mode, seed=1)
    act, (rc, ro), (tc, to) = _prefill(rm, rp, tm, tp, seed=1)
    K = len(act)
    if thr_kind == "all_exit":
        thr = np.ones(K, np.float32)  # every ramp fires at once: n_done == 1
    else:
        # halfway between two rows' uncertainties: some rows exit, some not
        u = np.sort(1.0 - np.asarray(ro["ramps"]["maxprob"])[0])
        thr = np.full(K, 0.5 * (u[0] + u[1]), np.float32)
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    pos = np.array([6, 6, 6])
    valid = np.array([True, True, False])  # a padding row never holds a window open
    n, n_max = 3, 4
    rc, (rl, rmp, fl, ex, nd) = rm.decode_multi(
        rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32), n, n_max=n_max,
        active_sites=jnp.asarray(act, jnp.int32), thresholds=jnp.asarray(thr),
        row_valid=jnp.asarray(valid))
    tc, (tl, tmp, tfl, tex, tnd) = tm.decode_multi(
        tp, tc, torch.from_numpy(tok).long(), torch.from_numpy(pos), n, n_max=n_max,
        active_sites=act, thresholds=torch.from_numpy(thr), row_valid=torch.from_numpy(valid))
    nd = int(nd)
    assert int(tnd) == nd
    if thr_kind == "all_exit":
        assert nd == 1
    np.testing.assert_array_equal(tl.numpy()[:nd], np.asarray(rl)[:nd])
    np.testing.assert_allclose(tmp.numpy()[:nd], np.asarray(rmp)[:nd], **TOL)
    np.testing.assert_array_equal(tfl.numpy()[:nd], np.asarray(fl)[:nd])
    np.testing.assert_array_equal(tex.numpy()[:nd], np.asarray(ex)[:nd])
    _check_cache(tc, rc)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_trajectory_16_steps(arch, mode):
    rm, rp, tm, tp = _pair(arch, mode, seed=2)
    act, (rc, ro), (tc, to) = _prefill(rm, rp, tm, tp, seed=2)
    r_tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    t_tok = to["final"]["label"].reshape(-1, 1).long()
    r_seq, t_seq = [], []
    r_decode = jax.jit(rm.decode)  # one trace for the 16 steps
    for i in range(16):
        pos = np.full(3, 6 + i)
        rc, ro = r_decode(rp, rc, jnp.asarray(r_tok, jnp.int32), jnp.asarray(pos, jnp.int32))
        tc, to = tm.decode(tp, tc, t_tok, torch.from_numpy(pos))
        r_tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
        t_tok = to["final"]["label"].reshape(-1, 1).long()
        r_seq.append(r_tok[:, 0])
        t_seq.append(t_tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(t_seq), np.stack(r_seq))
