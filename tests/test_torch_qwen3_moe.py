"""The port's attention + MoE slot (Qwen3-MoE-30B-A3B) against the JAX
package's, on tiny Qwen3-MoE: 3 layers of attention with qk-norm and a
routed MoE FFN, no shared expert. Two variants: the TINY config (4 experts,
top-2, 4 heads on 2 of 16, H·hd = d) and a wide one at the full config's
head layout and routing: 8 heads on 1 KV head (GQA group 8) of width 32,
so H·hd = 256 != d = 64, and 128 experts with top-8.

Schemas and page kinds; the bridge; prefill and decode records, sync
windows and caches on contiguous rows and on the paged pool (serving runs
the dense dispatch, the reference's ``moe_impl='dense'``); ``LM.loss`` and
its gradients under the capacity-dropping 'ep' dispatch and 'dense';
paired ``DecodeRunner`` schedules through the prefix cache (hits,
copy-on-write, eviction), swap and a pool that runs dry; the launcher.

Tolerance rule: one op within 1e-5 (fp32); whole-model records, losses and
caches within 1e-4; labels, greedy tokens, exit bits and sites, ``n_done``,
allocator state and ``kv_stats()`` exact. Pools are compared outside block
0, the trash block FREE padding rows write into."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.serving as RS  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.common import is_info  # noqa: E402

import repro_torch.serving as TS  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test

ARCH = "qwen3-moe-30b-a3b"
REC_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model records, losses and caches
BS = 4
# the full config's head layout and routing at tiny width
VARIANTS = {"tiny": {}, "wide": dict(n_heads=8, n_kv_heads=1, head_dim=32, n_experts=128,
                                     top_k=8)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol=REC_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _ref(variant, **kw):
    return ref_build(get_tiny(ARCH).replace(**VARIANTS[variant], **kw))


def _port(variant, **kw):
    kw = {"pallas_head": "kernel", **VARIANTS[variant], **kw}
    return build_model(port_tiny(ARCH).replace(**kw), prefill_attn="kernel")


@functools.lru_cache(maxsize=None)
def _weights(variant, seed=0):
    """The reference's init, every leaf perturbed so zero-initialized norms
    take part (numpy tree)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                        .astype(np.float32), _ref(variant).init(jax.random.PRNGKey(seed)))


def _shapes(tree, jax_tree=False):
    leaves = jax.tree.leaves(tree, is_leaf=is_info) if jax_tree else tree_leaves(tree)
    return [tuple(i.shape) for i in leaves]


def _check_stats(t, r, keys):
    for k in keys:
        a, b = t[k].numpy(), np.asarray(r[k]).reshape(t[k].shape)
        if k in ("label", "exit"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **REC_TOL)


# -- schemas and the bridge ------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_schemas_cache_schemas_and_kinds_equal_reference(variant):
    """Params (router, experts, qk-norm), contiguous caches and paged pools
    leaf for leaf; every page a 'tokens' page, no xkv columns, and prefix
    sharing sound (every layer full attention), as in the reference."""
    rm, tm = _ref(variant), _port(variant)
    assert [(s.mixer, s.ffn) for s in tm.plan.layer_specs()] == [("attn", "moe")] * 3
    assert _shapes(tm.schema()) == _shapes(rm.schema(), True)
    assert _shapes(tm.cache_schema(3, 9)) == _shapes(rm.cache_schema(3, 9), True)
    assert _shapes(tm.paged_cache_schema(5, BS)) == _shapes(rm.paged_cache_schema(5, BS), True)
    assert tm.paged_cache_kinds(5, BS) == rm.paged_cache_kinds(5, BS) == ["tokens"] * 2
    assert tm.paged_xkv_blocks(BS) == rm.paged_xkv_blocks(BS) == 0
    assert tm.paged_sharing_ok and rm.paged_sharing_ok
    assert tm.sites == rm.sites


def test_bridge_keeps_every_leaf_path():
    p = _weights("wide")
    ref = jax.tree_util.tree_flatten_with_path(p)[0]
    port = from_numpy_params(p, "cpu")
    for path, x in ref:
        node = port
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), x)
    names = {jax.tree_util.keystr(pth) for pth, _ in ref}
    assert {"router", "qnorm", "knorm", "lm_head"} <= {n.split("'")[-2] for n in names}
    assert not any("shared" in n for n in names)
    assert port["blocks"][0]["ffn"]["w_gate"].shape == (3, 128, 64, 48)


# -- the LM ----------------------------------------------------------------------------


def _pages(cache, table):
    """A contiguous cache (token t at row t) laid out as pool pages under
    ``table`` (block 0 the trash block)."""
    def leaf(x):
        x = np.asarray(x)
        L, B, S = x.shape[:3]
        nb = table.shape[1]
        virt = np.zeros((L, B, nb * BS) + x.shape[3:], x.dtype)
        virt[:, :, :S] = x
        pool = np.zeros((L, 1 + B * nb, BS) + x.shape[3:], x.dtype)
        pool[:, table.reshape(-1)] = virt.reshape((L, B * nb, BS) + x.shape[3:])
        return pool

    return jax.tree.map(leaf, cache)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_lm_prefill_decode_and_window_agree(layout, variant):
    """Prefill records (final + every ramp) and caches, one decode step with
    exit bits, a sync window of up to 4 steps, then 4 greedy steps with
    equal tokens, on the dense dispatch; 'paged' runs both packages on the
    same pages under a shuffled table."""
    paged = layout == "paged"
    rm = _ref(variant, decode_attn="paged" if paged else "ref")
    tm = _port(variant, decode_attn="paged-kernel" if paged else "kernel")
    p = _weights(variant)
    rp, tp = jax.tree.map(jnp.asarray, p), from_numpy_params(p, "cpu")
    B, P, cl = 3, 10, 24
    toks = np.random.default_rng(7).integers(0, 512, (B, P))
    act = list(range(len(rm.sites)))
    rc, ro = rm.prefill(rp, jnp.asarray(toks, jnp.int32), cache_len=cl, moe_impl="dense",
                        active_sites=jnp.asarray(act, jnp.int32))
    tc, to = tm.prefill(tp, _t(toks), cache_len=cl, active_sites=act)
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy"))
    for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):
        _close(a, b)
    rkw, tkw = {"moe_impl": "dense"}, {}
    if paged:
        table = (np.random.default_rng(1).permutation(B * (cl // BS)) + 1) \
            .reshape(B, cl // BS).astype(np.int32)
        rc = jax.tree.map(jnp.asarray, _pages(rc, table))
        tc = from_numpy_params(_pages(to_numpy(tc), table), "cpu")
        rkw["block_tables"], tkw["block_tables"] = jnp.asarray(table), _t(table)
    pos = np.full(B, P)
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    thr = np.full(len(act), 0.999, np.float32)
    rc, ro = rm.decode(rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
                       active_sites=jnp.asarray(act, jnp.int32), exit_thresholds=jnp.asarray(thr),
                       **rkw)
    tc, to = tm.decode(tp, tc, _t(tok).long(), _t(pos), active_sites=act,
                       exit_thresholds=_t(thr), **tkw)
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy", "exit"))
    u = np.sort(1.0 - np.asarray(ro["ramps"]["maxprob"]).reshape(-1))
    thr = np.full(len(act), 0.5 * (u[1] + u[2]), np.float32)  # some rows exit, some stay
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    rc, (rl, rmp, fl, ex, nd) = rm.decode_multi(
        rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos + 1, jnp.int32), 4, n_max=4,
        active_sites=jnp.asarray(act, jnp.int32), thresholds=jnp.asarray(thr), **rkw)
    tc, (tl, tmp, tfl, tex, tnd) = tm.decode_multi(
        tp, tc, _t(tok).long(), _t(pos + 1), 4, n_max=4, active_sites=act, thresholds=_t(thr),
        **tkw)
    nd = int(nd)
    assert int(tnd) == nd
    np.testing.assert_array_equal(tl.numpy()[:nd], np.asarray(rl)[:nd])
    _close(tmp.numpy()[:nd], np.asarray(rmp)[:nd])
    np.testing.assert_array_equal(tfl.numpy()[:nd], np.asarray(fl)[:nd])
    np.testing.assert_array_equal(tex.numpy()[:nd], np.asarray(ex)[:nd])
    r_tok, t_tok = np.asarray(fl)[nd - 1].reshape(-1, 1), tfl[nd - 1].reshape(-1, 1).long()
    for i in range(4):
        q = pos + 1 + nd + i
        rc, ro = rm.decode(rp, rc, jnp.asarray(r_tok, jnp.int32), jnp.asarray(q, jnp.int32),
                           **rkw)
        tc, to = tm.decode(tp, tc, t_tok, _t(q), **tkw)
        r_tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
        t_tok = to["final"]["label"].reshape(-1, 1).long()
        np.testing.assert_array_equal(t_tok.numpy(), r_tok)
    for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):
        _close(a, b)


@pytest.mark.parametrize("variant,moe_impl", [("tiny", "ep"), ("tiny", "dense"), ("wide", "ep")])
def test_lm_loss_and_grads_match_reference(variant, moe_impl):
    """``LM.loss`` with padding labels under the capacity-dropping 'ep'
    dispatch (the default, overflows dropped) and 'dense': the loss, its
    metrics (the MoE aux loss included) and every leaf's gradient against
    ``jax.value_and_grad`` of the reference's."""
    rm, tm = _ref(variant), _port(variant)
    p = _weights(variant, seed=1)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labels[0, 3] = labels[1, -1] = -1

    def f(params):
        return rm.loss(params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
                       moe_impl=moe_impl)

    (rl, rmet), rg = jax.value_and_grad(f, has_aux=True)(jax.tree.map(jnp.asarray, p))
    tp = from_numpy_params(p, "cpu")
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    tl, tmet = tm.loss(tp, {"tokens": _t(toks), "labels": _t(labels)}, moe_impl=moe_impl)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(rl), rtol=1e-5)
    assert float(rmet["moe_aux"]) > 0
    for k in rmet:
        np.testing.assert_allclose(float(tmet[k].detach()), float(rmet[k]), rtol=1e-5,
                                   atol=1e-6)
    rleaves = jax.tree.leaves(rg)
    assert len(rleaves) == len(tg)
    for i, (a, b) in enumerate(zip(rleaves, tg)):
        b = np.zeros(np.shape(a), np.float32) if b is None else b.numpy()
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5, err_msg=f"leaf {i}")


# -- paired runner schedules ------------------------------------------------------------


def _runner_state(r):
    out = {"pos": r._pos.tolist(), "tok": r._tok.tolist(), "live": sorted(r._live),
           "pf": dict(r._pf_progress)}
    if r._alloc is not None:
        al = r._alloc
        out["alloc"] = (al.table.tolist(), al.owned.tolist(), al.refcount.tolist(),
                        al.n_free, al.peak_blocks, al.pins)
        out["kv"] = r.kv_stats()
    return out


class _Both:
    """Apply one call to a reference runner and the port's: the same result
    (records within 1e-4), the same outcome (PoolExhausted on both or
    neither) and the same host and allocator state."""

    def __init__(self, ref, port):
        self.ref, self.port, self.seen = ref, port, set()

    def __call__(self, name, *args, port_args=None):
        outs = []
        for r, a, exc in ((self.ref, args, RS.PoolExhausted),
                          (self.port, port_args or args, TS.PoolExhausted)):
            try:
                outs.append(("ok", getattr(r, name)(*a)))
            except exc:
                outs.append(("exhausted", None))
        (kr, rr), (kt, rt) = outs
        assert kr == kt, (name, args, kr, kt)
        self.seen.add(name if kr == "ok" else f"{name}:exhausted")
        if kr == "ok" and isinstance(rr, tuple):
            for i, (a, b) in enumerate(zip(rt, rr)):
                if np.asarray(a).dtype.kind == "f":
                    _close(a, b)
                else:
                    np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{name} record {i}")
        elif kr == "ok" and name != "swap_out":
            assert rt == rr, (name, rt, rr)
        assert _runner_state(self.port) == _runner_state(self.ref), name
        return rr, rt


def _runners(prompts, paged, **kw):
    p = _weights("tiny")
    rm = _ref("tiny", decode_attn="paged" if paged else "ref")
    tm = _port("tiny", decode_attn="paged-kernel" if paged else "kernel")
    kw = {"max_new_tokens": 24, "max_slots": 3, "n_slots": 4, **kw}
    if paged:
        kw["kv_block_size"] = BS
    return (RS.DecodeRunner(rm, jax.tree.map(jnp.asarray, p), prompts, **kw),
            TS.DecodeRunner(tm, from_numpy_params(p, "cpu"), prompts, **kw))


def _check_pools(port, ref):
    for a, b in zip(tree_leaves(to_numpy(port._cache)), jax.tree.leaves(ref._cache)):
        _close(np.delete(a, 0, 1), np.delete(np.asarray(b), 0, 1))


def test_paged_runner_prefix_cache_matches_reference():
    """10-token prompts (a 2-token tail block): prompt 0 twice (a
    whole-prompt hit that costs no device work, then copy-on-write of the
    shared tail on both slots' first decode write) and a prompt sharing its
    first 8 tokens (a partial hit); windows (one ending early), a swap round
    trip, a pool that runs dry (PoolExhausted with an atomic unwind, the
    prefix cache evicted first), chunked prefill: host, allocator and
    prefix-cache state equal call for call, the pools equal outside
    block 0."""
    prompts = np.random.default_rng(3).integers(1, 512, (5, 10))
    prompts[2] = prompts[0]
    prompts[1, :8] = prompts[0, :8]
    ref, port = _runners(prompts, True, kv_blocks=14, prefix_cache=True)
    both = _Both(ref, port)
    act = [0, 1]
    thr = np.array([0.5, 0.9], np.float32)
    both("start", 0, 0)
    both("start", 1, 2)  # whole prompt cached
    both("step", [0, 1], act)  # both write into the shared tail: CoW
    both("start", 2, 1)  # its first 8 tokens cached
    both("step_multi", [0, 1, 2], act, 3, thr)
    both("step_multi", [0, 1, 2], act, 2, np.ones(2, np.float32))  # ends after one step
    h_ref, h_port = both("swap_out", 1)
    both("prefill_begin", 3, 3, 5)
    both("prefill_resume", 3, 5)
    both("step_multi", [0, 2, 3], act, 4, thr)
    both("start", 1, 4)  # the pool runs dry
    both("free", 0)
    both("swap_in", 1, h_ref, port_args=(1, h_port))
    _check_pools(port, ref)
    both("step_multi", [1, 2, 3], act, 4, thr)
    assert port.kv_stats()["prefix_hits"] >= 2 and port.kv_stats()["cow_copies"] >= 2
    assert {"start", "step", "step_multi", "swap_out", "swap_in", "free", "prefill_begin",
            "prefill_resume", "start:exhausted"} <= both.seen, both.seen
    _check_pools(port, ref)


def test_contiguous_runner_matches_reference():
    ref, port = _runners(np.random.default_rng(5).integers(1, 512, (3, 10)), False)
    both = _Both(ref, port)
    act = [0, 1]
    both("start", 0, 0)
    both("start", 1, 1)
    both("step_multi", [0, 1], act, 3, np.array([0.5, 0.9], np.float32))
    both("free", 0)
    both("start", 0, 2)
    both("step", [0, 1], act)
    both("step_multi", [0, 1], [], 2, np.zeros(0, np.float32))


# -- the launcher ------------------------------------------------------------------------


def test_serve_launcher_qwen3_moe_on_cpu_tiny():
    """The launcher end to end at tiny size: 6 requests on 3 prompts, each
    sent twice, on contiguous rows and on the pool with the prefix cache;
    equal greedy tokens, every request complete, prefix hits counted."""
    from repro_torch.launch.serve import serve_generative  # repro: allow[tier1-deps] — the port under test

    base = np.random.default_rng(8).integers(1, 512, (3, 14))
    prompts = np.concatenate([base, base])
    runs = {}
    for bs, kw in ((0, {}), (4, {"prefix_cache": True})):
        out, resp = serve_generative(ARCH, decode_tokens=5, steps_per_sync=3, tiny=True,
                                     device="cpu", verbose=False, kv_block_size=bs,
                                     prompts=prompts, **kw)
        assert len(resp) == 6 and all(len(r.tokens) == 5 and not r.dropped for r in resp)
        runs[bs] = (out, sorted((r.rid, r.final_tokens) for r in resp))
    assert runs[0][1] == runs[4][1]
    assert runs[4][0]["kv_cache"]["prefix_hits"] > 0
