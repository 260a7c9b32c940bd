"""The port's hybrid plan (Jamba-1.5-Large) against the JAX package's, on
tiny Jamba: 8 layers in two periods of 4 slots (mamba + dense FFN, mamba +
MoE, attention + dense FFN, mamba + MoE), no positional encoding (the
mamba layers carry order), one SSD group.

Schemas, cache schemas and page kinds (``state`` pages for the mamba
layers, ``tokens`` pages for the attention layer, one pool); prefill and
decode records, sync windows and caches on contiguous rows and on the
pool; ``LM.loss`` and its gradients under 'ep' and 'dense'; paired
``DecodeRunner`` schedules with swap of state and token pages and a pool
that runs dry; a refused prefix cache; the launcher.

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
from repro_torch.models.transformer import _cache_len  # noqa: E402  # repro: allow[tier1-deps] — the port under test

ARCH = "jamba-1.5-large-398b"
REC_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model records, losses and caches
BS = 4
ATTN = 2  # the attention slot of a period


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol=REC_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _ref(**kw):
    return ref_build(get_tiny(ARCH).replace(**kw))


def _port(**kw):
    kw = {"pallas_head": "kernel", **kw}
    return build_model(port_tiny(ARCH).replace(**kw), prefill_attn="kernel")


@functools.lru_cache(maxsize=None)
def _weights(seed=0):
    """The reference's init, every leaf perturbed so zero-initialized norms
    take part (numpy tree)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                        .astype(np.float32), _ref().init(jax.random.PRNGKey(seed)))


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


# -- schemas -----------------------------------------------------------------------------


def test_plan_schemas_cache_schemas_and_kinds_equal_reference():
    """The hybrid period as the reference builds it; params (no positional
    embedding), contiguous caches and paged pools leaf for leaf; 'state'
    pages for the mamba slots and 'tokens' pages for the attention slot in
    one pool; no prefix sharing; the decode mask from the attention rows."""
    rm, tm = _ref(), _port()
    assert [(s.mixer, s.ffn) for s in tm.plan.period] == \
        [(s.mixer, s.ffn) for s in rm.plan.period] == \
        [("mamba", "dense"), ("mamba", "moe"), ("attn", "dense"), ("mamba", "moe")]
    assert tm.plan.n_periods == 2 and tm.cfg.pos_type == "none"
    assert _shapes(tm.schema()) == _shapes(rm.schema(), True)
    assert "pos_embed" not in tm.schema()["tok"]
    for S in (9, 40):
        assert _shapes(tm.cache_schema(3, S)) == _shapes(rm.cache_schema(3, S), True)
        assert _cache_len(tm.init_cache(2, S, device="cpu")) == S
    assert _shapes(tm.paged_cache_schema(5, BS)) == _shapes(rm.paged_cache_schema(5, BS), True)
    kinds = tm.paged_cache_kinds(5, BS)
    assert kinds == rm.paged_cache_kinds(5, BS)
    assert kinds == ["state"] * 4 + ["tokens"] * 2 + ["state"] * 2
    assert tm.paged_xkv_blocks(BS) == 0
    assert tm.paged_sharing_ok is False and rm.paged_sharing_ok is False


# -- the LM ----------------------------------------------------------------------------


def _pages(cache, table):
    """A contiguous cache laid out as pool pages under ``table``: the
    attention slot's token rows by position, each mamba slot's state at
    its row's first table entry."""
    def tokens(x):
        x = np.asarray(x)
        n, B, S = x.shape[:3]
        nb = table.shape[1]
        virt = np.zeros((n, B, nb * BS) + x.shape[3:], x.dtype)
        virt[:, :, :S] = x
        pool = np.zeros((n, 1 + B * nb, BS) + x.shape[3:], x.dtype)
        pool[:, table.reshape(-1)] = virt.reshape((n, B * nb, BS) + x.shape[3:])
        return pool

    def state(x):
        x = np.asarray(x)
        pool = np.zeros((x.shape[0], 1 + table.size) + x.shape[2:], x.dtype)
        pool[:, table[:, 0]] = x
        return pool

    return {"blocks": [jax.tree.map(tokens if s == ATTN else state, blk)
                       for s, blk in enumerate(cache["blocks"])]}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_lm_prefill_decode_and_window_agree(layout):
    """Prefill records (final + every ramp) and caches, one decode step with
    exit bits, a sync window of up to 4 steps, then 4 greedy steps with
    equal tokens; 'paged' runs both packages on the same pages (token and
    state pages in one pool) under a shuffled table."""
    paged = layout == "paged"
    rm = _ref(decode_attn="paged" if paged else "ref")
    tm = _port(decode_attn="paged-kernel" if paged else "kernel")
    p = _weights()
    rp, tp = jax.tree.map(jnp.asarray, p), from_numpy_params(p, "cpu")
    B, P, cl = 3, 10, 24
    toks = np.random.default_rng(7).integers(0, 512, (B, P))
    act = list(range(len(rm.sites)))
    ract = jnp.asarray(act, jnp.int32)
    rc, ro = rm.prefill(rp, jnp.asarray(toks, jnp.int32), cache_len=cl, moe_impl="dense",
                        active_sites=ract)
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
                       active_sites=ract, exit_thresholds=jnp.asarray(thr), **rkw)
    tc, to = tm.decode(tp, tc, _t(tok).long(), _t(pos), active_sites=act,
                       exit_thresholds=_t(thr), **tkw)
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy", "exit"))
    u = np.sort(1.0 - np.asarray(ro["ramps"]["maxprob"]).reshape(-1))
    thr = np.full(len(act), 0.5 * (u[1] + u[2]), np.float32)  # some rows exit, some stay
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    rc, (rl, rmp, fl, ex, nd) = rm.decode_multi(
        rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos + 1, jnp.int32), 4, n_max=4,
        active_sites=ract, thresholds=jnp.asarray(thr), **rkw)
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


@pytest.mark.parametrize("moe_impl", ["ep", "dense"])
def test_lm_loss_and_grads_match_reference(moe_impl):
    """``LM.loss`` with padding labels: the loss, its metrics (the MoE aux
    loss of the two MoE slots a period) and every leaf's gradient against
    ``jax.value_and_grad`` of the reference's."""
    rm, tm = _ref(), _port()
    p = _weights(seed=1)
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
    p = _weights()
    rm = _ref(decode_attn="paged" if paged else "ref")
    tm = _port(decode_attn="paged-kernel" if paged else "kernel")
    kw = {"max_new_tokens": 14, "max_slots": 3, "n_slots": 4, **kw}
    if paged:
        kw["kv_block_size"] = BS
    return (RS.DecodeRunner(rm, jax.tree.map(jnp.asarray, p), prompts, **kw),
            TS.DecodeRunner(tm, from_numpy_params(p, "cpu"), prompts, **kw))


def _check_pools(port, ref):
    for a, b in zip(tree_leaves(to_numpy(port._cache)), jax.tree.leaves(ref._cache)):
        _close(np.delete(a, 0, 1), np.delete(np.asarray(b), 0, 1))


def test_paged_runner_matches_reference():
    """10-token prompts on an 8-block pool: admits, steps, windows (one
    ending early), a swap round trip (state pages ride at the first owned
    block), chunked prefill, an admission that runs the pool dry: host and
    allocator state equal call for call, the pools equal outside block 0."""
    ref, port = _runners(np.random.default_rng(3).integers(1, 512, (5, 10)), True,
                         kv_blocks=8)
    both = _Both(ref, port)
    act = [0, 4]
    thr = np.array([0.5, 0.9], np.float32)
    both("start", 0, 0)
    both("start", 1, 1)
    both("step", [0, 1], act)
    both("step_multi", [0, 1], act, 3, thr)
    both("step_multi", [0, 1], act, 2, np.ones(2, np.float32))  # ends after one step
    h_ref, h_port = both("swap_out", 1)
    both("prefill_begin", 2, 2, 5)
    both("prefill_resume", 2, 5)
    both("step_multi", [0, 2], act, 4, thr)
    both("start", 3, 3)  # the pool runs dry
    both("free", 0)
    both("swap_in", 1, h_ref, port_args=(1, h_port))
    _check_pools(port, ref)
    both("step_multi", [1, 2], act, 4, thr)
    assert {"start", "step", "step_multi", "swap_out", "swap_in", "free", "prefill_begin",
            "prefill_resume", "start:exhausted"} <= both.seen, both.seen
    _check_pools(port, ref)


def test_contiguous_runner_matches_reference():
    ref, port = _runners(np.random.default_rng(5).integers(1, 512, (3, 10)), False)
    both = _Both(ref, port)
    both("start", 0, 0)
    both("start", 1, 1)
    both("step_multi", [0, 1], [0, 4], 3, np.array([0.5, 0.9], np.float32))
    both("free", 0)
    both("start", 0, 2)
    both("step", [0, 1], [3])


def test_prefix_cache_refused_for_jamba():
    """State pages are per slot: both runners refuse a prefix cache with the
    same ValueError."""
    prompts = np.zeros((2, 8), np.int64)
    with pytest.raises(ValueError) as e_ref:
        RS.DecodeRunner(_ref(decode_attn="paged"), {"tok": {"embed": jnp.zeros(1)}}, prompts,
                        prefix_cache=True)
    with pytest.raises(ValueError) as e_port:
        TS.DecodeRunner(_port(decode_attn="paged-kernel"), {"tok": {"embed": torch.zeros(1)}},
                        prompts, prefix_cache=True)
    assert str(e_port.value) == str(e_ref.value)


# -- the launcher ------------------------------------------------------------------------


def test_serve_launcher_jamba_on_cpu_tiny():
    """The launcher end to end at tiny size: 4 requests on contiguous rows,
    on the pool, and on a 12-block pool with swap preemption: equal greedy
    tokens, every request complete, the swaps balanced; a prefix cache
    refused."""
    from repro_torch.launch.serve import serve_generative  # repro: allow[tier1-deps] — the port under test

    runs = []
    for kw in ({}, {"kv_block_size": 4}, {"kv_block_size": 4, "kv_blocks": 12,
                                          "preempt": "swap"}):
        out, resp = serve_generative(ARCH, 4, decode_tokens=5, prompt_len=20, steps_per_sync=3,
                                     tiny=True, device="cpu", verbose=False, **kw)
        assert len(resp) == 4 and all(len(r.tokens) == 5 and not r.dropped for r in resp)
        runs.append(sorted((r.rid, r.final_tokens) for r in resp))
    assert runs[0] == runs[1] == runs[2]
    kv = out["kv_cache"]
    assert kv["swap_outs"] > 0 and kv["swap_ins"] == kv["swap_outs"] and kv["live_blocks"] == 0
    with pytest.raises(ValueError):
        serve_generative(ARCH, 2, decode_tokens=2, prompt_len=8, tiny=True, device="cpu",
                         verbose=False, kv_block_size=4, prefix_cache=True)
