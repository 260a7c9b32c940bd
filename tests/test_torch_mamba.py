"""The port's Mamba2 path against the JAX package's on tiny Mamba2-2.7B:
``mamba_schema``, ``ssd_decode_step``, ``_conv_step`` and ``mamba_apply``
(prefill and decode), the LM (prefill records, a 16-step greedy trajectory
and sync windows that end early, on contiguous state rows and on state
pages), and paired ``DecodeRunner`` schedules on both layouts with chunked
prefill, swap out/in of state pages and a pool that runs dry.

Tolerance rule: one op within 1e-5 (fp32); whole-model records and states
within 1e-4; labels, greedy tokens, exit sites, ``n_done``, allocator state
and ``kv_stats()`` exact. Pools are compared outside block 0, the trash
block FREE padding rows write into."""
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
from repro.models import layers as RL  # noqa: E402
from repro.models import mamba as RM  # noqa: E402
from repro.models.common import is_info  # noqa: E402

import repro_torch.serving as TS  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import mamba as TM  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.transformer import _cache_len  # noqa: E402  # repro: allow[tier1-deps] — the port under test

ARCH = "mamba2-2.7b"
TOL = dict(rtol=1e-5, atol=1e-5)  # one op
REC_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model records, states and pools
P_LEN, MAX_NEW, BS = 14, 10, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(a, b, tol=REC_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# -- the block's pieces -----------------------------------------------------------------


def _mamba_params(seed):
    """Random mamba params of the tiny config: the reference's init, moved
    off its zeros and ones."""
    cfg = get_tiny(ARCH)
    rng = np.random.default_rng(seed)
    sch = RM.mamba_schema(cfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), 8)
    return {k: np.asarray(i.initialize(kk)) + 0.1 * _rand(rng, i.shape)
            for kk, (k, i) in zip(keys, sorted(sch.items()))}


def test_mamba_schema_equals_reference():
    for L in (None, 3):
        ref = RM.mamba_schema(get_tiny(ARCH), L=L)
        port = TM.mamba_schema(port_tiny(ARCH), L=L)
        assert sorted(ref) == sorted(port)
        for k in ref:
            assert tuple(ref[k].shape) == tuple(port[k].shape), k
            assert np.dtype(ref[k].dtype).name == str(port[k].dtype)[6:], k
            assert ref[k].init == port[k].init, k
        # the port's one state schema is the reference's contiguous rows and
        # its pool of state pages (the two differ in sharding specs only)
        for fn_r, n in ((RM.mamba_cache_schema, 5), (RM.mamba_paged_cache_schema, 7)):
            r, t = fn_r(get_tiny(ARCH), n, L=L), TM.mamba_cache_schema(port_tiny(ARCH), n, L=L)
            assert {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in r.items()} == \
                {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in t.items()}


@pytest.mark.parametrize("kind", ["ssm_a", "dt_bias"])
def test_ssm_inits_draw_the_reference_ranges(kind):
    """A_log in [log 1, log 16); dt_bias = softplus^-1 of dt in [1e-3, 1e-1]."""
    g = torch.Generator().manual_seed(0)
    x = TM.ParamInfo((4096,), torch.float32, kind).initialize(g, "cpu").numpy()
    if kind == "ssm_a":
        assert x.min() >= 0 and x.max() < np.log(16) and x.max() > np.log(15)
    else:
        dt = np.log1p(np.exp(x))
        assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(1)
    b, h, p, n, g = 3, 4, 8, 6, 2
    args = (_rand(rng, (b, h, p, n)), _rand(rng, (b, h, p)),
            np.abs(_rand(rng, (b, h))) * 0.1, -np.abs(_rand(rng, (h,))) - 0.5,
            _rand(rng, (b, g, n)), _rand(rng, (b, g, n)))
    y_r, s_r = RM.ssd_decode_step(*(jnp.asarray(a) for a in args))
    y_t, s_t = TM.ssd_decode_step(*(_t(a) for a in args))
    _close(y_t.numpy(), y_r, TOL)
    _close(s_t.numpy(), s_r, TOL)


def test_conv_step_matches_reference():
    rng = np.random.default_rng(2)
    args = (_rand(rng, (3, 3, 10)), _rand(rng, (3, 10)), _rand(rng, (4, 10)), _rand(rng, (10,)))
    o_r, s_r = RM._conv_step(*(jnp.asarray(a) for a in args))
    o_t, s_t = TM._conv_step(*(_t(a) for a in args))
    _close(o_t.numpy(), o_r, TOL)
    _close(s_t.numpy(), s_r, TOL)


@pytest.mark.parametrize("S", [6, 16])  # one chunk of 6 (6 % 4 != 0); 16 = 4 chunks of 4
@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_mamba_apply_prefill_then_decode(S, impl):
    """Prefill with and without a cache, then two decode steps from the
    state the prefill returned; ``chunk=4`` makes S = 16 a scan of 4 chunks
    (the reference's chunking, by chunk where it divides S)."""
    cfg, tcfg = get_tiny(ARCH), port_tiny(ARCH)
    p = _mamba_params(3)
    rp, tp = jax.tree.map(jnp.asarray, p), from_numpy_params(p, "cpu")
    rng = np.random.default_rng(S)
    B = 2
    x = _rand(rng, (B, S, cfg.d_model))
    ro, _ = RM.mamba_apply(cfg, rp, jnp.asarray(x), axes=RL.TEST_AXES, chunk=4)
    to, tc = TM.mamba_apply(tcfg, tp, _t(x), chunk=4, ssd_impl=impl)
    assert tc is None
    _close(to.numpy(), ro, TOL)
    zero = {k: jnp.zeros(i.shape, i.dtype)
            for k, i in RM.mamba_cache_schema(cfg, B).items()}
    ro, rc = RM.mamba_apply(cfg, rp, jnp.asarray(x), axes=RL.TEST_AXES, cache=zero, chunk=4)
    to, tc = TM.mamba_apply(tcfg, tp, _t(x), cache={k: _t(v) for k, v in zero.items()},
                            chunk=4, ssd_impl=impl)
    _close(to.numpy(), ro, TOL)
    for k in ("conv", "ssm"):
        _close(tc[k].numpy(), rc[k], TOL)
    for _ in range(2):
        x1 = _rand(rng, (B, 1, cfg.d_model))
        ro, rc = RM.mamba_apply(cfg, rp, jnp.asarray(x1), axes=RL.TEST_AXES, cache=rc)
        to, tc = TM.mamba_apply(tcfg, tp, _t(x1), cache=tc)
        _close(to.numpy(), ro, TOL)
        for k in ("conv", "ssm"):
            _close(tc[k].numpy(), rc[k], TOL)


# -- the LM ---------------------------------------------------------------------------


def _lm_pair(seed=0, ref_attn="dense", port_attn="dense", pallas_head="kernel"):
    rm = ref_build(get_tiny(ARCH).replace(decode_attn=ref_attn))
    tm = build_model(port_tiny(ARCH).replace(decode_attn=port_attn, pallas_head=pallas_head))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda x: np.asarray(x) + 0.05 * _rand(rng, x.shape),
                     rm.init(jax.random.PRNGKey(seed)))
    return rm, jax.tree.map(jnp.asarray, p), tm, from_numpy_params(p, "cpu")


def test_lm_schema_sites_and_cache_schemas_equal_reference():
    rm, rp, tm, tp = _lm_pair()
    assert tuple(tm.sites) == tuple(rm.sites)
    ref = jax.tree.leaves(rm.schema(), is_leaf=is_info)
    port = tree_leaves(tm.schema())
    assert [tuple(i.shape) for i in ref] == [tuple(i.shape) for i in port]
    for r, t in ((rm.cache_schema(3, 9), tm.cache_schema(3, 9)),
                 (rm.paged_cache_schema(5, BS), tm.paged_cache_schema(5, BS))):
        assert [tuple(i.shape) for i in jax.tree.leaves(r, is_leaf=is_info)] == \
            [tuple(i.shape) for i in tree_leaves(t)]
    assert tm.paged_sharing_ok is False and rm.paged_sharing_ok is False
    assert tm.paged_cache_kinds(3, BS) == ["state", "state"]


def test_cache_len_reads_any_attention_leaf():
    """The repaired ``_cache_len``: a mamba-only cache has no sequence
    (None, and ``decode`` builds no mask); attention and MLA caches give
    their S from stacked or prefix leaves."""
    rm, rp, tm, tp = _lm_pair()
    assert _cache_len(tm.init_cache(2, 9, device="cpu")) is None
    for arch, S in (("qwen2-1.5b", 11), ("deepseek-v2-lite-16b", 7)):
        m = build_model(port_tiny(arch))
        assert _cache_len(m.init_cache(2, S, device="cpu")) == S
        assert _cache_len({"prefix": m.init_cache(2, S, device="cpu")["blocks"],
                           "blocks": [{}]}) == S


def _check_stats(t, r, keys):
    for k in keys:
        a, b = t[k].numpy(), np.asarray(r[k]).reshape(t[k].shape)
        if k in ("label", "exit"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **REC_TOL)


def _check_cache(tc, rc):
    for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):
        _close(a, b)


def _prefill(rm, rp, tm, tp, B=3, P=6, seed=0):
    toks = np.random.default_rng(seed).integers(0, rm.cfg.vocab_size, (B, P))
    act = list(range(len(rm.sites)))
    rc, ro = rm.prefill(rp, jnp.asarray(toks, jnp.int32), cache_len=P + 20,
                        active_sites=jnp.asarray(act, jnp.int32))
    tc, to = tm.prefill(tp, _t(toks), cache_len=P + 20, active_sites=act)
    return act, (rc, ro), (tc, to)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("P", [6, 70])  # one chunk of 6; a chunk of 64 and a ragged 6
def test_lm_prefill_decode_and_16_step_trajectory(P, paged):
    """Prefill records (final + every ramp) and state, then, on contiguous
    state rows or on state pages (each row's state at its first table
    entry), one decode step with exit bits and 16 greedy steps with equal
    tokens."""
    rm, rp, tm, tp = _lm_pair(ref_attn="paged" if paged else "dense",
                              port_attn="paged-kernel" if paged else "kernel")
    act, (rc, ro), (tc, to) = _prefill(rm, rp, tm, tp, P=P)
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy"))
    _check_cache(tc, rc)
    tabs = {}
    if paged:
        table = (np.random.default_rng(P).permutation(3 * 4) + 1).reshape(3, 4).astype(np.int32)
        pages = _to_pages(rc, table)
        rc, tc = jax.tree.map(jnp.asarray, pages), from_numpy_params(pages, "cpu")
        tabs = {"block_tables": table}
    r_tabs = {k: jnp.asarray(v) for k, v in tabs.items()}
    t_tabs = {k: _t(v) for k, v in tabs.items()}
    pos = np.array([P, P + 3, P + 1])
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    thr = np.full(len(act), 0.999, np.float32)
    rc, ro = rm.decode(rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
                       active_sites=jnp.asarray(act, jnp.int32),
                       exit_thresholds=jnp.asarray(thr), **r_tabs)
    tc, to = tm.decode(tp, tc, _t(tok).long(), _t(pos), active_sites=act,
                       exit_thresholds=_t(thr), **t_tabs)
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy", "exit"))
    _check_cache(tc, rc)
    r_decode = jax.jit(rm.decode)
    r_tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    t_tok = to["final"]["label"].reshape(-1, 1).long()
    r_seq, t_seq = [], []
    for i in range(16):
        p = jnp.asarray(pos + 1 + i, jnp.int32)
        rc, ro = r_decode(rp, rc, jnp.asarray(r_tok, jnp.int32), p, **r_tabs)
        tc, to = tm.decode(tp, tc, t_tok, _t(pos + 1 + i), **t_tabs)
        r_tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
        t_tok = to["final"]["label"].reshape(-1, 1).long()
        r_seq.append(r_tok[:, 0])
        t_seq.append(t_tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(t_seq), np.stack(r_seq))
    _check_cache(tc, rc)


def _to_pages(cache, table):
    """Contiguous state rows (.., B, ...) -> state pages (.., 1 + B*nb, ...)
    with row b's state at its first table entry ``table[b, 0]``."""
    def leaf(x):
        x = np.asarray(x)
        pool = np.zeros((x.shape[0], 1 + table.size) + x.shape[2:], x.dtype)
        pool[:, table[:, 0]] = x
        return pool

    return jax.tree.map(leaf, cache)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("thr_kind", ["mid", "all_exit"])
def test_lm_window_ends_early_and_leaves_state(paged, thr_kind):
    """A sync window of up to 4 steps (with every threshold 1, every row
    exits at step 1): records equal to ``n_done``, and the state after the
    window equals the reference's, whose while_loop stops at ``n_done``: the port's steps past it run with the write gate off,
    which must cover conv and ssm (a state update is not an attention
    write). Then 8 greedy steps with equal tokens."""
    rm, rp, tm, tp = _lm_pair(seed=1, ref_attn="paged" if paged else "dense",
                              port_attn="paged-kernel" if paged else "kernel")
    B, nb = 3, 4
    act, (rc, ro), (tc0, _) = _prefill(rm, rp, tm, tp, B=B, seed=1)
    table = None
    if paged:
        table = (np.random.default_rng(5).permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)
        pages = _to_pages(rc, table)
        rc, tc = jax.tree.map(jnp.asarray, pages), from_numpy_params(pages, "cpu")
    else:
        tc = tc0
    K = len(act)
    if thr_kind == "all_exit":
        thr = np.ones(K, np.float32)
    else:
        u = np.sort(1.0 - np.asarray(ro["ramps"]["maxprob"])[0])
        thr = np.full(K, 0.5 * (u[0] + u[1]), np.float32)
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    pos = np.full(B, 6)
    tabs = {} if table is None else {"block_tables": table}
    rc, (rl, rmp, fl, ex, nd) = rm.decode_multi(
        rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32), 4, n_max=4,
        active_sites=jnp.asarray(act, jnp.int32), thresholds=jnp.asarray(thr),
        **{k: jnp.asarray(v) for k, v in tabs.items()})
    tc, (tl, tmp, tfl, tex, tnd) = tm.decode_multi(
        tp, tc, _t(tok).long(), _t(pos), 4, n_max=4, active_sites=act, thresholds=_t(thr),
        **{k: _t(v) for k, v in tabs.items()})
    nd = int(nd)
    assert int(tnd) == nd and (nd == 1) == (thr_kind == "all_exit")
    np.testing.assert_array_equal(tl.numpy()[:nd], np.asarray(rl)[:nd])
    _close(tmp.numpy()[:nd], np.asarray(rmp)[:nd])
    np.testing.assert_array_equal(tfl.numpy()[:nd], np.asarray(fl)[:nd])
    np.testing.assert_array_equal(tex.numpy()[:nd], np.asarray(ex)[:nd])
    _check_cache(tc, rc)
    r_decode = jax.jit(rm.decode)
    r_tok = np.asarray(fl)[nd - 1].reshape(-1, 1)
    t_tok = tfl[nd - 1].reshape(-1, 1).long()
    r_seq, t_seq = [], []
    for i in range(8):
        p = pos + nd + i
        rc, ro = r_decode(rp, rc, jnp.asarray(r_tok, jnp.int32), jnp.asarray(p, jnp.int32),
                          **{k: jnp.asarray(v) for k, v in tabs.items()})
        tc, to = tm.decode(tp, tc, t_tok, _t(p), **{k: _t(v) for k, v in tabs.items()})
        r_tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
        t_tok = to["final"]["label"].reshape(-1, 1).long()
        r_seq.append(r_tok[:, 0])
        t_seq.append(t_tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(t_seq), np.stack(r_seq))
    _check_cache(tc, rc)


def test_gate_off_leaves_state_bit_for_bit():
    """A decode step with the write gate off changes neither conv nor ssm,
    on either layout, while a step with it on does."""
    _, _, tm, tp = _lm_pair()
    B = 2
    rows = tm.init_cache(B, 4, device="cpu")
    pages = tm.init_paged_cache(1 + B, BS, device="cpu")
    for leaf in tree_leaves(rows) + tree_leaves(pages):
        leaf.normal_(generator=torch.Generator().manual_seed(leaf.numel()))
    table = torch.tensor([[2], [1]], dtype=torch.int32)
    tok, pos = torch.tensor([[3], [7]]), torch.tensor([4, 5])
    for cache, tabs in ((rows, {}), (pages, {"block_tables": table})):
        before = [t.clone() for t in tree_leaves(cache)]
        tm.decode(tp, cache, tok, pos, write_gate=torch.tensor(False), **tabs)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache), before))
        tm.decode(tp, cache, tok, pos, write_gate=torch.tensor(True), **tabs)
        assert not any(torch.equal(a, b) for a, b in zip(tree_leaves(cache), before))


# -- paired runner schedules ----------------------------------------------------------


def _runner_pair(paged, prompts, seed=0, **kw):
    rm = ref_build(get_tiny(ARCH).replace(decode_attn="paged" if paged else "dense"))
    tm = build_model(port_tiny(ARCH).replace(
        decode_attn="paged-kernel" if paged else "kernel", pallas_head="kernel"))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda x: np.asarray(x) + 0.05 * _rand(rng, x.shape),
                     rm.init(jax.random.PRNGKey(seed)))
    kw = {"max_new_tokens": MAX_NEW, "max_slots": 2, "n_slots": 4, **kw}
    if paged:
        kw["kv_block_size"] = BS
    return (RS.DecodeRunner(rm, jax.tree.map(jnp.asarray, p), prompts, **kw),
            TS.DecodeRunner(tm, from_numpy_params(p, "cpu"), prompts, **kw))


def _runner_state(r):
    out = {"pos": r._pos.tolist(), "tok": r._tok.tolist(), "live": sorted(r._live),
           "pf": dict(r._pf_progress), "kv": r.kv_stats()}
    if r._alloc is not None:
        al = r._alloc
        out["alloc"] = (al.table.tolist(), al.owned.tolist(), al.refcount.tolist(),
                        al.n_free, al.peak_blocks, al.pins)
    return out


class _Both:
    """Apply one call to the reference and the port runner, then hold the
    results to the tolerance rule and the states to exact equality."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port
        self.seen = set()

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


def _prompts(n, seed):
    return np.random.default_rng(seed).integers(1, 512, (n, P_LEN))


def _check_pools(port, ref):
    for a, b in zip(tree_leaves(to_numpy(port._cache)), jax.tree.leaves(ref._cache)):
        _close(np.delete(a, 0, 1), np.delete(np.asarray(b), 0, 1))  # the pool axis is 1


def test_paged_runner_schedule_agrees():
    """State pages: admits (the prefill's state scattered into the slot's
    first block), steps, windows (one ending early), chunked prefill, a
    swap round trip, PoolExhausted with an atomic unwind and frees on a pool
    too small for every stream; the pools agree outside block 0 after the
    swap and at the end."""
    prompts = _prompts(6, 3)
    ref, port = _runner_pair(True, prompts, kv_blocks=11)
    both = _Both(ref, port)
    act = [0, 1]
    thr = np.array([0.5, 0.9], np.float32)
    both("start", 0, 0)
    both("start", 1, 1)
    both("step", [0, 1], act)
    both("step_multi", [0, 1], act, 3, thr)
    both("step_multi", [0, 1], act, 2, np.ones(2, np.float32))  # ends after one step
    (h_ref, h_port) = both("swap_out", 1)
    both("prefill_begin", 2, 2, 6)
    both("prefill_resume", 2, 3)
    both("start", 3, 3)  # the pool runs dry mid-admission
    both("prefill_resume", 2, 8)
    both("step_multi", [0, 2], act, 4, thr)
    both("free", 0)
    both("swap_in", 0, h_ref, port_args=(0, h_port))
    _check_pools(port, ref)
    both("step_multi", [0, 2], act, 4, thr)  # needs more blocks than are free
    both("step", [0, 2], [])
    both("free", 2)
    both("start", 1, 4)
    both("step_multi", [0, 1], act, 3, thr)
    assert {"start", "step", "step_multi", "swap_out", "swap_in", "free", "prefill_begin",
            "prefill_resume", "start:exhausted", "step_multi:exhausted"} <= both.seen, both.seen
    _check_pools(port, ref)


def test_swap_round_trip_moves_the_state_page():
    """swap_out carries the slot's state page (position 0 of its owned ids)
    to the host; swap_in into another slot lands it at the new first table
    entry, and the stream decodes on as if never swapped."""
    prompts = _prompts(2, 8)
    _, port = _runner_pair(True, prompts, kv_blocks=16)
    _, twin = _runner_pair(True, prompts, kv_blocks=16)
    for r in (port, twin):
        r.start(0, 0)
        r.start(1, 1)
        r.step([0, 1], [0])

    def page(r, slot):
        blk = int(r._alloc.table[slot, 0])
        return [leaf[:, blk].clone() for leaf in tree_leaves(r._cache)]

    before = page(port, 1)
    h = port.swap_out(1)
    assert h["n_blocks"] == int(twin._alloc.owned[1]) and 1 not in port._live
    port.free(0)
    port.swap_in(0, h)  # slot 1's stream now lives in slot 0
    assert all(torch.equal(a, b) for a, b in zip(page(port, 0), before))
    assert int(port._alloc.table[0, 0]) != int(twin._alloc.table[1, 0])
    for _ in range(3):
        got = port.step([0], [0])
        want = twin.step([1], [0])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[0], want[0])


def test_contiguous_runner_schedule_agrees():
    """Contiguous state rows: admits, steps, windows and chunked prefill
    interleaved with decode steps; the states agree at the end."""
    prompts = _prompts(5, 6)
    ref, port = _runner_pair(False, prompts, seed=1)
    both = _Both(ref, port)
    both("start", 0, 0)
    assert both("prefill_begin", 1, 3, 5) == (None, None)
    both("step", [0], [0])
    both("prefill_resume", 1, 4)
    both("step_multi", [0], [0], 2, np.array([0.9], np.float32))
    both("prefill_resume", 1, 20)
    both("step", [0, 1], [0, 1])
    both("start", 2, 4)
    both("step_multi", [0, 1, 2], [0, 1], 3, np.array([0.5, 0.9], np.float32))
    both("free", 1)
    both("step_multi", [0, 2], [1], 2, np.ones(1, np.float32))
    for a, b in zip(tree_leaves(to_numpy(port._cache)), jax.tree.leaves(ref._cache)):
        _close(a, b)


def test_prefix_cache_refused_for_mamba():
    """State pages are not shared: both runners refuse a prefix cache with
    the same ValueError."""
    prompts = _prompts(2, 0)
    rm = ref_build(get_tiny(ARCH).replace(decode_attn="paged"))
    tm = build_model(port_tiny(ARCH).replace(decode_attn="paged-kernel"))
    with pytest.raises(ValueError) as e_ref:
        RS.DecodeRunner(rm, {"tok": {"embed": jnp.zeros(1)}}, prompts, prefix_cache=True)
    with pytest.raises(ValueError) as e_port:
        TS.DecodeRunner(tm, {"tok": {"embed": torch.zeros(1)}}, prompts, prefix_cache=True)
    assert str(e_port.value) == str(e_ref.value)


@functools.lru_cache(maxsize=None)
def _served(bs, **kw):
    from repro_torch.launch.serve import serve_generative  # repro: allow[tier1-deps] — the port under test

    out, resp = serve_generative(ARCH, 4, decode_tokens=5, prompt_len=8, steps_per_sync=3,
                                 tiny=True, device="cpu", verbose=False, kv_block_size=bs,
                                 **kw)
    return out, [r.final_tokens for r in resp], resp


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 3}, {"kv_blocks": 5, "preempt": "swap"}])
def test_serve_launcher_mamba_on_cpu_tiny(kw):
    """The launcher end to end at tiny size: state pages (also with chunked
    prefill, and with swap on a pool that runs dry) give the contiguous
    rows' greedy tokens, and every request completes."""
    out, toks, resp = _served(4, **kw)
    assert len(resp) == 4 and all(len(r.tokens) == 5 and not r.dropped for r in resp)
    assert out["config"] == "tiny-" + ARCH and out["kv_cache"]["paged"]
    assert toks == _served(0)[1]
    if "preempt" in kw:
        assert out["kv_cache"]["swap_outs"] > 0
        assert out["kv_cache"]["swap_ins"] == out["kv_cache"]["swap_outs"]
