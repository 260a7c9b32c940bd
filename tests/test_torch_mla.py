"""The port's MLA path against the JAX package's on tiny DeepSeek-V2-Lite:
the paged MLA plain version against the JAX ref and the Pallas kernel in
interpret mode, ``mla_apply`` on every branch, the LM (prefill records, a
16-step greedy trajectory and a sync window on both layouts) and paired
``DecodeRunner`` schedules with chunked prefill and swap on a dry pool.

Tolerance rule: one attention call within 1e-5 (fp32); whole-model records
and caches within 1e-4; labels, greedy tokens, exit sites, ``n_done``,
allocator state and ``kv_stats()`` exact. Pools are compared outside block
0, the trash block: a padding row whose stale pos lies past its table
writes there in the port, while the reference drops that write."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.serving as RS  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.kernels.decode_attention import paged_mla_decode_attention as pallas_mla  # noqa: E402
from repro.kernels.decode_attention import paged_mla_decode_attention_ref as jax_mla_ref  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.common import is_info  # noqa: E402

import repro_torch.serving as TS  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.decode_attention import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    attend_decode_paged_mla,
    paged_mla_decode_attention_ref,
)
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import layers as TL  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-5, atol=1e-5)  # one attention call
REC_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model records, caches and pools
P_LEN, MAX_NEW, BS = 14, 10, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- the plain version of the paged MLA kernel -------------------------------------


def _mla_case(B, H, r, dr, bs, nb, seed):
    """A shuffled table over a pool whose block 0 is trash; row 1 owns one
    block and points the rest at block 0 (unallocated entries); pos covers a
    partial last block, a block's first slot and the table's last slot."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    table = (rng.permutation(P - 1) + 1).reshape(B, nb).astype(np.int32)
    table[1, 1:] = 0
    pos = np.array([nb * bs - 2, bs - 1, bs, nb * bs - 1][:B], np.int32)
    return (_rand(rng, (B, H, r)), _rand(rng, (B, H, dr)), _rand(rng, (P, bs, r)),
            _rand(rng, (P, bs, dr)), table, pos, 1.0 / np.sqrt(r + dr))


# (B, H, r, dr, bs, nb): 5 does not divide the tables' 15 or 20 slots into
# 32-key tiles, 16 puts a row's whole history in one block
MLA_SHAPES = [(3, 4, 32, 8, 4, 3), (4, 4, 32, 8, 5, 4), (2, 2, 16, 8, 16, 2), (4, 8, 64, 16, 5, 3)]


@pytest.mark.parametrize("shape", MLA_SHAPES)
def test_paged_mla_ref_matches_jax_ref(shape):
    ql, qp, cp, kp, table, pos, scale = _mla_case(*shape, seed=sum(shape))
    ref = jax_mla_ref(*(jnp.asarray(a) for a in (ql, qp, cp, kp, table, pos)), scale=scale)
    out = paged_mla_decode_attention_ref(_t(ql), _t(qp), _t(cp), _t(kp), _t(table),
                                         _t(pos.astype(np.int64)), scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    same = attend_decode_paged_mla(_t(ql), _t(qp), _t(cp), _t(kp), _t(table), _t(pos),
                                   scale=scale)  # CPU -> the plain version
    np.testing.assert_array_equal(same.numpy(), out.numpy())


@pytest.mark.parametrize("shape", MLA_SHAPES[:2])
def test_paged_mla_ref_matches_pallas_interpret(shape):
    ql, qp, cp, kp, table, pos, scale = _mla_case(*shape, seed=7)
    got = pallas_mla(*(jnp.asarray(a) for a in (ql, qp, cp, kp, table, pos)), scale=scale,
                     interpret=True)
    out = paged_mla_decode_attention_ref(_t(ql), _t(qp), _t(cp), _t(kp), _t(table), _t(pos),
                                         scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(got), **TOL)


def test_no_paged_mla_kernel_for_other_devices():
    q = torch.zeros(2, 4, 32, device="meta")
    pool = torch.zeros(3, 4, 32, device="meta")
    with pytest.raises(ValueError):
        attend_decode_paged_mla(q, q[..., :8], pool, pool[..., :8],
                                torch.zeros(2, 2, dtype=torch.int32), 3, scale=0.1)


# -- mla_apply on every branch --------------------------------------------------------


def _mla_params(seed):
    """Random MLA params of the tiny config (kv_norm away from zero)."""
    rng = np.random.default_rng(seed)
    sch = RL.mla_schema(get_tiny(ARCH))
    return jax.tree.map(lambda i: 0.3 * _rand(rng, i.shape), sch, is_leaf=is_info)


def test_mla_schema_equals_reference():
    ref = RL.mla_schema(get_tiny(ARCH), L=2)
    port = TL.mla_schema(port_tiny(ARCH), L=2)
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert tuple(ref[k].shape) == tuple(port[k].shape), k
        assert np.dtype(ref[k].dtype).name == str(port[k].dtype)[6:], k


@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_apply_contiguous_prefill_then_decode(absorbed):
    """Prefill writes the latents at 0 under a causal mask, then one decode
    token per row at its own position writes and attends to the cache."""
    cfg, tcfg = get_tiny(ARCH), port_tiny(ARCH)
    p = _mla_params(1)
    rp, tp = jax.tree.map(jnp.asarray, p), from_numpy_params(p, "cpu")
    rng = np.random.default_rng(2)
    B, S, C = 3, 5, 12
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    x = _rand(rng, (B, S, cfg.d_model))
    rc = {"c": jnp.zeros((B, C, r)), "k_pe": jnp.zeros((B, C, dr))}
    tc = {"c": torch.zeros(B, C, r), "k_pe": torch.zeros(B, C, dr)}
    ro, rc = RL.mla_apply(cfg, rp, jnp.asarray(x), positions=jnp.arange(S)[None],
                          mask=RL.causal_mask(S, C, 0), axes=RL.TEST_AXES, cache=rc,
                          cache_index=0, absorbed=absorbed)
    to, tc = TL.mla_apply(tcfg, tp, _t(x), positions=torch.arange(S)[None],
                          mask=TL.causal_mask(S, C, 0), cache=tc, cache_index=0,
                          absorbed=absorbed)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), **TOL)
    for k in ("c", "k_pe"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]), **TOL)
    pos = np.array([5, 8, 6])
    x1 = _rand(rng, (B, 1, cfg.d_model))
    mask = (np.arange(C)[None, :] <= pos[:, None])[:, None, None, :]
    ro, rc = RL.mla_apply(cfg, rp, jnp.asarray(x1), positions=jnp.asarray(pos)[:, None],
                          mask=jnp.asarray(mask), axes=RL.TEST_AXES, cache=rc,
                          cache_index=jnp.asarray(pos, jnp.int32), absorbed=absorbed)
    to, tc = TL.mla_apply(tcfg, tp, _t(x1), positions=_t(pos)[:, None], mask=_t(mask),
                          cache=tc, cache_index=_t(pos), absorbed=absorbed)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), **TOL)
    for k in ("c", "k_pe"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]), **TOL)


LIVE = [0, 1, 3]  # the FREE padding row's outputs are garbage in both packages


@pytest.mark.parametrize("ref_impl,port_impl,absorbed", [
    ("paged", "paged", True), ("paged", "paged", False),
    ("paged-interpret", "paged-kernel", True),  # the Pallas kernel vs the port's route
])
def test_mla_apply_paged(ref_impl, port_impl, absorbed):
    """Single-token decode on a latent pool: rows 0 and 1 live, row 2 a FREE
    padding row (table of zeros, a stale pos past its table), row 3 a
    duplicate of row 0."""
    cfg, tcfg = get_tiny(ARCH), port_tiny(ARCH)
    p = _mla_params(3)
    rng = np.random.default_rng(4)
    nb, P = 4, 9
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    table = (rng.permutation(P - 1) + 1).reshape(2, nb).astype(np.int32)
    table = np.concatenate([table, np.zeros((1, nb), np.int32), table[:1]])
    pos = np.array([9, 14, nb * BS + 3, 9], np.int32)
    x = _rand(rng, (4, 1, cfg.d_model))
    pools = {"c": _rand(rng, (P, BS, r)), "k_pe": _rand(rng, (P, BS, dr))}
    ro, rc = RL.mla_apply(cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                          positions=jnp.asarray(pos)[:, None], mask=None, axes=RL.TEST_AXES,
                          cache=jax.tree.map(jnp.asarray, pools), cache_index=jnp.asarray(pos),
                          absorbed=absorbed, decode_impl=ref_impl,
                          block_table=jnp.asarray(table))
    tc = from_numpy_params(pools, "cpu")
    to, tc = TL.mla_apply(tcfg, from_numpy_params(p, "cpu"), _t(x), positions=_t(pos)[:, None],
                          mask=None, cache=tc, cache_index=_t(pos), absorbed=absorbed,
                          decode_impl=port_impl, block_table=_t(table))
    np.testing.assert_allclose(to.numpy()[LIVE], np.asarray(ro)[LIVE], **TOL)
    for k in ("c", "k_pe"):
        np.testing.assert_allclose(tc[k].numpy()[1:], np.asarray(rc[k])[1:], **TOL)
    with pytest.raises(ValueError):  # a block table needs a paged decode_impl
        TL.mla_apply(tcfg, from_numpy_params(p, "cpu"), _t(x), positions=_t(pos)[:, None],
                     mask=None, cache=tc, cache_index=_t(pos), decode_impl="dense",
                     block_table=_t(table))


# -- the LM ---------------------------------------------------------------------------


def _lm_pair(absorbed, seed=0, ref_attn="dense", port_attn="dense", pallas_head="off"):
    rm = ref_build(get_tiny(ARCH).replace(mla_absorbed=absorbed, decode_attn=ref_attn))
    tm = build_model(port_tiny(ARCH).replace(mla_absorbed=absorbed, decode_attn=port_attn,
                                             pallas_head=pallas_head))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda x: np.asarray(x) + 0.05 * _rand(rng, x.shape),
                     rm.init(jax.random.PRNGKey(seed)))
    return rm, jax.tree.map(jnp.asarray, p), tm, from_numpy_params(p, "cpu")


def test_lm_schema_and_sites_equal_reference():
    rm, rp, tm, tp = _lm_pair(True)
    assert tuple(tm.sites) == tuple(rm.sites)
    ref = jax.tree_util.tree_flatten_with_path(rm.schema(), is_leaf=is_info)[0]
    port = tree_leaves(tm.schema())
    assert [tuple(i.shape) for _, i in ref] == [tuple(i.shape) for i in port]
    assert "prefix" in tm.schema() and len(tm.schema()["prefix"]) == 1
    for B, S in ((2, 7),):
        rs = jax.tree.leaves(rm.cache_schema(B, S), is_leaf=is_info)
        ts = tree_leaves(tm.cache_schema(B, S))
        assert [tuple(i.shape) for i in rs] == [tuple(i.shape) for i in ts]
        rs = jax.tree.leaves(rm.paged_cache_schema(5, BS), is_leaf=is_info)
        ts = tree_leaves(tm.paged_cache_schema(5, BS))
        assert [tuple(i.shape) for i in rs] == [tuple(i.shape) for i in ts]
    assert tm.paged_sharing_ok is False and rm.paged_sharing_ok is False
    assert tm.paged_cache_kinds(3, BS) == ["tokens"] * 4


def _check_stats(t, r, keys, rows=slice(None)):
    for k in keys:
        a, b = t[k].numpy()[..., rows], np.asarray(r[k]).reshape(t[k].shape)[..., rows]
        if k in ("label", "exit"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **REC_TOL)


def _prefill(rm, rp, tm, tp, B=3, P=6, C=24, seed=0):
    toks = np.random.default_rng(seed).integers(0, rm.cfg.vocab_size, (B, P))
    act = list(range(len(rm.sites)))
    rc, ro = rm.prefill(rp, jnp.asarray(toks, jnp.int32), cache_len=C, moe_impl="dense",
                        active_sites=jnp.asarray(act, jnp.int32))
    tc, to = tm.prefill(tp, _t(toks), cache_len=C, active_sites=act)
    return act, (rc, ro), (tc, to)


def _check_cache(tc, rc):
    for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):
        np.testing.assert_allclose(a, np.asarray(b), **REC_TOL)


@pytest.mark.parametrize("absorbed", [True, False])
def test_lm_prefill_decode_and_16_step_trajectory(absorbed):
    """Contiguous cache: prefill records (final + every ramp) and cache, one
    decode step with exit bits, then 16 greedy steps with equal tokens."""
    rm, rp, tm, tp = _lm_pair(absorbed, pallas_head="kernel")
    act, (rc, ro), (tc, to) = _prefill(rm, rp, tm, tp)
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy"))
    _check_cache(tc, rc)
    pos = np.array([6, 9, 7])
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    thr = np.full(len(act), 0.999, np.float32)
    rc, ro = rm.decode(rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
                       active_sites=jnp.asarray(act, jnp.int32), moe_impl="dense",
                       exit_thresholds=jnp.asarray(thr))
    tc, to = tm.decode(tp, tc, _t(tok).long(), _t(pos), active_sites=act,
                       exit_thresholds=_t(thr))
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy", "exit"))
    _check_cache(tc, rc)
    r_decode = jax.jit(functools.partial(rm.decode, moe_impl="dense"))
    r_tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    t_tok = to["final"]["label"].reshape(-1, 1).long()
    r_seq, t_seq = [], []
    for i in range(16):
        p = jnp.asarray(pos + 1 + i, jnp.int32)
        rc, ro = r_decode(rp, rc, jnp.asarray(r_tok, jnp.int32), p)
        tc, to = tm.decode(tp, tc, t_tok, _t(pos + 1 + i))
        r_tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
        t_tok = to["final"]["label"].reshape(-1, 1).long()
        r_seq.append(r_tok[:, 0])
        t_seq.append(t_tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(t_seq), np.stack(r_seq))


def _to_pool(cache, table, nb):
    """A contiguous (.., B, nb*bs, w) cache -> (.., 1 + B*nb, bs, w) pools laid
    out by ``table`` (block 0 zero)."""
    def leaf(x):
        x = np.asarray(x)
        lead, (B, S, w) = x.shape[:-3], x.shape[-3:]
        pool = np.zeros(lead + (1 + B * nb, BS, w), x.dtype)
        blocks = x.reshape(lead + (B * nb, BS, w))
        pool[..., table.reshape(-1), :, :] = blocks
        return pool

    return jax.tree.map(leaf, cache)


@pytest.mark.parametrize("thr_kind", ["mid", "all_exit"])
def test_lm_paged_window_and_trajectory(thr_kind):
    """The pool: a sync window (records to n_done; past n_done the gated
    c/k_pe writes leave the pool unchanged), then 12 greedy steps through
    the port's kernel route against the reference's jnp oracle."""
    rm, rp, tm, tp = _lm_pair(True, seed=1, ref_attn="paged", port_attn="paged-kernel",
                              pallas_head="kernel")
    B, nb = 3, 6
    act, (rc, ro), _ = _prefill(rm, rp, tm, tp, C=nb * BS, seed=1)
    perm = np.random.default_rng(5).permutation(B * nb) + 1
    table = perm.reshape(B, nb).astype(np.int32)
    pools = _to_pool(rc, table, nb)
    rc, tc = jax.tree.map(jnp.asarray, pools), from_numpy_params(pools, "cpu")
    K = len(act)
    if thr_kind == "all_exit":
        thr = np.ones(K, np.float32)
    else:
        u = np.sort(1.0 - np.asarray(ro["ramps"]["maxprob"])[0])
        thr = np.full(K, 0.5 * (u[0] + u[1]), np.float32)
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    pos = np.full(B, 6)
    n, n_max = 3, 4
    rc, (rl, rmp, fl, ex, nd) = rm.decode_multi(
        rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32), n, n_max=n_max,
        active_sites=jnp.asarray(act, jnp.int32), thresholds=jnp.asarray(thr),
        block_tables=jnp.asarray(table), moe_impl="dense")
    tc, (tl, tmp, tfl, tex, tnd) = tm.decode_multi(
        tp, tc, _t(tok).long(), _t(pos), n, n_max=n_max, active_sites=act,
        thresholds=_t(thr), block_tables=_t(table))
    nd = int(nd)
    assert int(tnd) == nd and (nd == 1) == (thr_kind == "all_exit")
    np.testing.assert_array_equal(tl.numpy()[:nd], np.asarray(rl)[:nd])
    np.testing.assert_allclose(tmp.numpy()[:nd], np.asarray(rmp)[:nd], **REC_TOL)
    np.testing.assert_array_equal(tfl.numpy()[:nd], np.asarray(fl)[:nd])
    np.testing.assert_array_equal(tex.numpy()[:nd], np.asarray(ex)[:nd])
    _check_cache(tc, rc)
    r_decode = jax.jit(functools.partial(rm.decode, moe_impl="dense"))
    r_tok = np.asarray(fl)[nd - 1].reshape(-1, 1)
    t_tok = tfl[nd - 1].reshape(-1, 1).long()
    r_seq, t_seq = [], []
    for i in range(12):
        p = pos + nd + i
        rc, ro = r_decode(rp, rc, jnp.asarray(r_tok, jnp.int32), jnp.asarray(p, jnp.int32),
                          block_tables=jnp.asarray(table))
        tc, to = tm.decode(tp, tc, t_tok, _t(p), block_tables=_t(table))
        r_tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
        t_tok = to["final"]["label"].reshape(-1, 1).long()
        r_seq.append(r_tok[:, 0])
        t_seq.append(t_tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(t_seq), np.stack(r_seq))
    _check_cache(tc, rc)


# -- paired runner schedules ----------------------------------------------------------


def _runner_pair(paged, prompts, seed=0, **kw):
    rm = ref_build(get_tiny(ARCH).replace(mla_absorbed=True,
                                          decode_attn="paged" if paged else "dense"))
    tm = build_model(port_tiny(ARCH).replace(
        mla_absorbed=True, decode_attn="paged-kernel" if paged else "kernel",
        pallas_head="kernel"))
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
                    np.testing.assert_allclose(a, b, **REC_TOL)
                else:
                    np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{name} record {i}")
        elif kr == "ok" and name != "swap_out":
            assert rt == rr, (name, rt, rr)
        assert _runner_state(self.port) == _runner_state(self.ref), name
        return rr, rt


def _prompts(n, seed):
    return np.random.default_rng(seed).integers(1, 512, (n, P_LEN))


def test_paged_runner_schedule_agrees():
    """Admits, steps, sync windows (one ending early), chunked prefill, a
    swap round trip, PoolExhausted with an atomic unwind and frees on a
    latent pool too small for every stream; the pools agree outside block
    0 at the end."""
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
    both("step_multi", [0, 2], act, 4, thr)  # needs more blocks than are free
    both("step", [0, 2], [])
    both("free", 2)
    both("start", 1, 4)
    both("step_multi", [0, 1], act, 3, thr)
    assert {"start", "step", "step_multi", "swap_out", "swap_in", "free", "prefill_begin",
            "prefill_resume", "start:exhausted", "step_multi:exhausted"} <= both.seen, both.seen
    for a, b in zip(tree_leaves(to_numpy(port._cache)), jax.tree.leaves(ref._cache)):
        ax = 1 if a.ndim == 4 else 0  # the pool axis: period leaves (L, P, bs, w)
        np.testing.assert_allclose(np.delete(a, 0, ax), np.delete(np.asarray(b), 0, ax),
                                   **REC_TOL)


def test_contiguous_runner_schedule_agrees():
    """The contiguous latent cache: admits, steps, windows and chunked
    prefill interleaved with decode steps; the caches agree at the end."""
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
        np.testing.assert_allclose(a, np.asarray(b), **REC_TOL)


def test_prefix_cache_refused_for_mla():
    """Latent pages are not shared: both runners refuse a prefix cache with
    the same ValueError."""
    prompts = _prompts(2, 0)
    rm = ref_build(get_tiny(ARCH).replace(decode_attn="paged"))
    tm = build_model(port_tiny(ARCH).replace(decode_attn="paged-kernel"))
    with pytest.raises(ValueError) as e_ref:
        RS.DecodeRunner(rm, {"tok": {"embed": jnp.zeros(1)}}, prompts, prefix_cache=True)
    with pytest.raises(ValueError) as e_port:
        TS.DecodeRunner(tm, {"tok": {"embed": torch.zeros(1)}}, prompts, prefix_cache=True)
    assert str(e_port.value) == str(e_ref.value)
    assert "unsound" in str(e_port.value)


def test_serve_launcher_deepseek_on_cpu_tiny():
    """The launcher end to end at tiny size, on the pool and on contiguous
    rows: every request completes, and the two layouts give the same
    greedy tokens (both run the absorbed math)."""
    from repro_torch.launch.serve import serve_generative  # repro: allow[tier1-deps] — the port under test

    toks = {}
    for bs in (4, 0):
        out, resp = serve_generative(ARCH, 4, decode_tokens=5, prompt_len=8, steps_per_sync=3,
                                     tiny=True, device="cpu", verbose=False, kv_block_size=bs)
        assert len(resp) == 4 and all(len(r.tokens) == 5 and not r.dropped for r in resp)
        assert out["config"] == "tiny-" + ARCH and out["kv_cache"]["paged"] == bool(bs)
        toks[bs] = [r.final_tokens for r in resp]
    assert toks[4] == toks[0]


@pytest.mark.parametrize("n_sm,B,keys", [(132, 8, 160), (132, 32, 4096), (132, 6, 240),
                                         (132, 200, 4096), (132, 1, 8), (16, 3, 1000)])
def test_paged_mla_key_ranges_tile_the_table(n_sm, B, keys):
    """The CUDA wrapper's key split: whole 32-key tiles, every range but the
    last full, the last not empty, and no more ranges than MLA_WAVES waves
    of the bf16 kernel's CTAs an SM need."""
    from repro_torch.kernels.decode_attention.kernel import (  # repro: allow[tier1-deps] — the port under test
        MLA_CTAS_PER_SM,
        MLA_TILE,
        MLA_WAVES,
        mla_splits,
    )

    splits = mla_splits(n_sm, B, keys)
    tiles = -(-keys // MLA_TILE)
    per = -(-tiles // splits)  # the kernel's range, in tiles
    assert 1 <= splits <= tiles and (splits - 1) * per < tiles <= splits * per
    assert splits == 1 or B * (splits - 1) < MLA_WAVES * n_sm * MLA_CTAS_PER_SM[torch.bfloat16]
