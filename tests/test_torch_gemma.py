"""The port's Gemma3-4B path against the JAX package's on tiny Gemma3-4B
(window 16, 2 local : 1 global): 6 layers (two periods, no suffix) and 8
layers (two periods and a 2-layer local suffix, ``ramp_sites`` crossing
into it). Schemas, cache schemas and page kinds; the bridge leaf by leaf;
prefill and decode records, sync windows and caches on the three cache
layouts (full contiguous rows, ``windowed_cache`` rings of W rows, ring
pages on the block pool) with prompts shorter (12) and longer (24) than
the window; paired ``DecodeRunner`` schedules (windows, chunked prefill,
swap, a pool that runs dry, a refused prefix cache); ``LM.loss`` and its
gradients; the plain attention versions at head width 256; the launcher
end to end.

Where the reference is the oracle for the paged pool: for prompts longer
than W, the reference's own paged run is not. Its paged prefill
(``repro.serving.runner.DecodeRunner._prefill_fn_paged``) scatters token t
of a local layer's full-length prefill cache to virtual row t, while its
paged ring decode reads virtual row ``t % W`` (``repro.models.layers.
attn_apply``'s paged ring branch), so past the window the rows it reads
hold other tokens: its paged records part from its contiguous ones. Its
contiguous full-cache and ring runs agree with each
other, and the port's paged run is held against them; for prompts of at
most W tokens the reference's paged runner is the oracle as well.

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
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.decode_attention.ref import paged_decode_attention_ref as jax_paged_ref  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_flash_ref  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.common import is_info  # noqa: E402

import repro_torch.serving as TS  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.configs import get_config, get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.decode_attention import decode_attention_ref, paged_decode_attention_ref  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import layers as TL  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.transformer import _cache_len  # noqa: E402  # repro: allow[tier1-deps] — the port under test

ARCH = "gemma3-4b"
TOL = dict(rtol=1e-5, atol=1e-5)  # one op
REC_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model records, losses and caches
W, BS, MAX_NEW = 16, 4, 8
DEPTHS = [6, 8]  # 8: a 2-layer local suffix after the two periods


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol=REC_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@functools.lru_cache(maxsize=None)
def _weights(L, seed=0):
    """The reference's init of tiny gemma at depth L, every leaf perturbed
    so zero-initialized norms take part (numpy tree)."""
    rm = ref_build(get_tiny(ARCH).replace(n_layers=L))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                        .astype(np.float32), rm.init(jax.random.PRNGKey(seed)))


def _ref(L, **kw):
    return ref_build(get_tiny(ARCH).replace(n_layers=L, **kw))


def _port(L, **kw):
    kw = {"pallas_head": "kernel", **kw}
    return build_model(port_tiny(ARCH).replace(n_layers=L, **kw), prefill_attn="kernel")


def _leaf_shapes(tree, jax_tree=False):
    leaves = jax.tree.leaves(tree, is_leaf=is_info) if jax_tree else tree_leaves(tree)
    return [tuple(i.shape) for i in leaves]


# -- configs, schemas and the bridge ---------------------------------------------------


def test_plan_suffix_and_sites_equal_reference():
    for L in DEPTHS:
        rm, tm = _ref(L), _port(L)
        assert [(s.mixer, s.is_local) for s in tm.plan.layer_specs()] == \
            [(s.mixer, s.is_local) for s in rm.plan.layer_specs()]
        assert (len(tm.plan.suffix), tm.plan.n_periods) == (L - 6, 2)
        assert tuple(tm.sites) == tuple(rm.sites)
    assert max(_port(8).sites) >= 6  # a ramp site inside the suffix


@pytest.mark.parametrize("L", DEPTHS)
@pytest.mark.parametrize("windowed", [False, True])
def test_schemas_cache_schemas_and_kinds_equal_reference(L, windowed):
    """Params, contiguous caches (a local slot's rows cut to min(W, S) with
    ``windowed_cache``) and paged pools leaf for leaf; local slots' pages
    are 'ring', the global slot's 'tokens'; no prefix sharing."""
    rm, tm = _ref(L, windowed_cache=windowed), _port(L, windowed_cache=windowed)
    assert _leaf_shapes(tm.schema()) == _leaf_shapes(rm.schema(), True)
    for S in (9, 40):
        assert _leaf_shapes(tm.cache_schema(3, S)) == _leaf_shapes(rm.cache_schema(3, S), True)
        assert _cache_len(tm.init_cache(2, S, device="cpu")) == S  # the longest leaf
    assert _leaf_shapes(tm.paged_cache_schema(5, BS)) == \
        _leaf_shapes(rm.paged_cache_schema(5, BS), True)
    kinds = tm.paged_cache_kinds(5, BS)
    assert len(kinds) == len(rm.paged_cache_kinds(5, BS))
    local = [s.is_local for s in tm.plan.period] + [True] * len(tm.plan.suffix)
    assert kinds == [k for loc in local for k in ("ring" if loc else "tokens",) * 2]
    assert tm.paged_sharing_ok is False and rm.paged_sharing_ok is False


@pytest.mark.parametrize("L", DEPTHS)
def test_bridge_keeps_every_leaf_path(L):
    """A reference pytree bridged to the port: the same paths (the suffix
    list, qnorm/knorm, the tied head's absence) and the same values."""
    p = _weights(L)
    ref = jax.tree_util.tree_flatten_with_path(p)[0]
    port = from_numpy_params(p, "cpu")

    def at(tree, path):
        for k in path:
            tree = tree[getattr(k, "key", getattr(k, "idx", None))]
        return tree

    for path, x in ref:
        np.testing.assert_array_equal(at(port, path).numpy(), x)
    assert len(ref) == len(tree_leaves(port)) == len(tree_leaves(_port(L).schema()))
    names = {jax.tree_util.keystr(pth) for pth, _ in ref}
    assert any("qnorm" in n for n in names) and any("knorm" in n for n in names)
    assert any(n.startswith("['suffix']") for n in names) == (L == 8)
    assert not any("lm_head" in n for n in names)


def test_port_builds_full_width_gemma_from_schemas():
    """``LM(get_config('gemma3-4b'))`` builds (nothing allocated) with the
    reference's plan: 5 periods of 5 local + 1 global and a 4-layer local
    suffix, the reference's leaf shapes."""
    cfg = get_config(ARCH)
    tm = build_model(cfg)
    rm = ref_build(ref_config(ARCH))
    assert (tm.plan.n_periods, len(tm.plan.period), len(tm.plan.suffix)) == (5, 6, 4)
    assert sum(s.is_local for s in tm.plan.layer_specs()) == 29
    assert _leaf_shapes(tm.schema()) == _leaf_shapes(rm.schema(), True)
    assert tm.sites == rm.sites


# -- the layers ------------------------------------------------------------------------


def test_window_mask_equals_reference():
    for Sq, Sk, off, w in ((5, 5, 0, 2), (7, 12, 3, 4), (1, 9, 8, 16)):
        np.testing.assert_array_equal(TL.window_mask(Sq, Sk, off, w).numpy(),
                                      np.asarray(RL.window_mask(Sq, Sk, off, w)))


def _attn_pair(seed=0):
    cfg = get_tiny(ARCH)
    sch = RL.gqa_schema(cfg)
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(sch))
    p = {k: np.asarray(i.initialize(kk)) + 0.1 * rng.standard_normal(i.shape).astype(np.float32)
         for kk, (k, i) in zip(keys, sorted(sch.items()))}
    return cfg, port_tiny(ARCH), jax.tree.map(jnp.asarray, p), from_numpy_params(p, "cpu")


@pytest.mark.parametrize("layout", ["full", "ring", "paged"])
@pytest.mark.parametrize("S", [12, 24])
def test_attn_apply_local_layer_prefill_then_decode(layout, S):
    """One local layer (qk-norm, RoPE base 1e4): a prefill of S tokens, then
    three decode steps at per-row positions, against the reference's branch
    of the same layout (paged: against its contiguous ring, see the module
    docstring)."""
    cfg, tcfg, rp, tp = _attn_pair()
    B, cl = 2, S + 6
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ring = layout != "full"
    rows = min(W, cl) if ring else cl
    rkw = dict(ring_window=W) if ring else dict(local_window=W)
    tkw = dict(rkw)
    zero = {k: np.zeros((B, rows, cfg.n_kv_heads, cfg.hd), np.float32) for k in ("k", "v")}
    mask = RL.window_mask(S, S, 0, W)
    ro, rc = RL.attn_apply(cfg, rp, jnp.asarray(x), positions=jnp.arange(S)[None], mask=mask,
                           axes=RL.TEST_AXES, cache=jax.tree.map(jnp.asarray, zero),
                           cache_index=0, rope_theta=1e4, **rkw)
    tc = {k: _t(v) for k, v in zero.items()}
    to, _ = TL.attn_apply(tcfg, tp, _t(x), positions=torch.arange(S)[None],
                          mask=TL.window_mask(S, S, 0, W), cache=tc, cache_index=0,
                          rope_theta=1e4, **tkw)
    _close(to.numpy(), ro, TOL)
    for k in ("k", "v"):
        _close(tc[k].numpy(), rc[k][:, :rows], TOL)
    table = None
    if layout == "paged":  # the ring's W rows as 4-row pages under a shuffled table
        nb = -(-cl // BS)
        table = (np.random.default_rng(1).permutation(B * nb) + 1).reshape(B, nb)
        pool = {k: np.zeros((1 + B * nb, BS, cfg.n_kv_heads, cfg.hd), np.float32)
                for k in ("k", "v")}
        for k in ("k", "v"):
            virt = np.zeros((B, nb * BS, cfg.n_kv_heads, cfg.hd), np.float32)
            virt[:, :rows] = tc[k].numpy()
            pool[k][table.reshape(-1)] = virt.reshape(B * nb, BS, cfg.n_kv_heads, cfg.hd)
        tc = {k: _t(v) for k, v in pool.items()}
    pos = np.array([S, S + 2])
    for i in range(3):
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        p = pos + i
        ci = p % W if ring else p
        ro, rc = RL.attn_apply(cfg, rp, jnp.asarray(x1), positions=jnp.asarray(p)[:, None],
                               mask=None, axes=RL.TEST_AXES, cache=rc,
                               cache_index=jnp.asarray(ci), rope_theta=1e4, **rkw)
        if layout == "paged":
            to, tc = TL.attn_apply(tcfg, tp, _t(x1), positions=_t(p)[:, None], mask=None,
                                   cache=tc, cache_index=_t(p), rope_theta=1e4,
                                   decode_impl="paged", block_table=_t(table), **tkw)
        else:
            to, tc = TL.attn_apply(tcfg, tp, _t(x1), positions=_t(p)[:, None], mask=None,
                                   cache=tc, cache_index=_t(ci), rope_theta=1e4, **tkw)
        _close(to.numpy(), ro, TOL)


@pytest.mark.parametrize("window", [None, 5, 40])
def test_flash_plain_version_hd256_equals_reference(window):
    """The flash plain version at head width 256 with GQA (8 heads on 4),
    causal, with a window inside and one wider than the prompt."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 8, 30, 256)).astype(np.float32)
    k = rng.standard_normal((1, 4, 30, 256)).astype(np.float32)
    v = rng.standard_normal((1, 4, 30, 256)).astype(np.float32)
    ref = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                        window=window)
    got = attention_ref(_t(q), _t(k), _t(v), causal=True, window=window)
    _close(got.numpy(), ref, TOL)


def test_decode_plain_versions_hd256_equal_reference():
    """The flash-decode plain versions at head width 256, contiguous and
    paged (a shuffled table of 4-slot blocks), per-row pos."""
    rng = np.random.default_rng(4)
    B, H, KH, S, hd = 3, 8, 4, 24, 256
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, KH, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, KH, S, hd)).astype(np.float32)
    pos = np.array([0, 11, 23], np.int32)
    _close(decode_attention_ref(_t(q), _t(k), _t(v), _t(pos)).numpy(),
           jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)), TOL)
    nb = S // BS
    table = (rng.permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)
    pool_k = rng.standard_normal((1 + B * nb, BS, KH, hd)).astype(np.float32)
    pool_v = rng.standard_normal((1 + B * nb, BS, KH, hd)).astype(np.float32)
    _close(paged_decode_attention_ref(_t(q), _t(pool_k), _t(pool_v), _t(table), _t(pos)).numpy(),
           jax_paged_ref(jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
                         jnp.asarray(table), jnp.asarray(pos)), TOL)


# -- the LM ----------------------------------------------------------------------------


def _check_stats(t, r, keys):
    for k in keys:
        a, b = t[k].numpy(), np.asarray(r[k]).reshape(t[k].shape)
        if k in ("label", "exit"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **REC_TOL)


def _ring_pages(cache, table, P, kinds):
    """A contiguous prefill cache (full rows, token t at row t) laid out as
    pool pages under ``table``: token leaves by position, ring leaves with
    the newest token t = j (mod W) at virtual row j."""
    def leaf(x, kind):
        x = np.asarray(x)
        ax = x.ndim - 4  # the batch axis: 1 stacked, 0 suffix
        B, S = x.shape[ax], x.shape[ax + 1]
        nb = table.shape[1]
        virt = np.zeros(x.shape[:ax + 1] + (nb * BS,) + x.shape[ax + 2:], x.dtype)
        if kind == "ring":
            j = np.arange(min(W, P))
            src = (P - 1) - ((P - 1 - j) % W)
            virt[(slice(None),) * (ax + 1) + (j,)] = np.take(x, src, axis=ax + 1)
        else:
            virt[(slice(None),) * (ax + 1) + (slice(0, S),)] = x
        blocks = virt.reshape(x.shape[:ax] + (B * nb, BS) + x.shape[ax + 2:])
        pool = np.zeros(x.shape[:ax] + (1 + B * nb, BS) + x.shape[ax + 2:], x.dtype)
        pool[(slice(None),) * ax + (table.reshape(-1),)] = blocks
        return pool

    kinds = iter(kinds)
    return jax.tree.map(lambda x: leaf(x, next(kinds)), cache)


@pytest.mark.parametrize("L", DEPTHS)
@pytest.mark.parametrize("P", [12, 24])
@pytest.mark.parametrize("layout", ["full", "ring", "paged"])
def test_lm_prefill_decode_and_window_agree(layout, P, L):
    """Prefill records (final + every ramp) and caches, one decode step with
    exit bits, a sync window of up to 4 steps, then 6 greedy steps with
    equal tokens. The reference runs its contiguous layout (full rows, or
    rings for 'ring' and 'paged'); the port its own, the paged one on ring
    pages under a shuffled table."""
    ring = layout != "full"
    rm = _ref(L, windowed_cache=ring, decode_attn="ref")
    tm = _port(L, windowed_cache=layout == "ring",
               decode_attn="paged-kernel" if layout == "paged" else "kernel")
    p = _weights(L)
    rp, tp = jax.tree.map(jnp.asarray, p), from_numpy_params(p, "cpu")
    B, cl = 3, P + 16
    toks = np.random.default_rng(P).integers(0, 512, (B, P))
    act = list(range(len(rm.sites)))
    rc, ro = rm.prefill(rp, jnp.asarray(toks, jnp.int32), cache_len=cl,
                        active_sites=jnp.asarray(act, jnp.int32))
    tc, to = tm.prefill(tp, _t(toks), cache_len=cl, active_sites=act)
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy"))
    tabs = {}
    if layout == "paged":
        table = (np.random.default_rng(L).permutation(B * (cl // BS)) + 1) \
            .reshape(B, cl // BS).astype(np.int32)
        tc = from_numpy_params(_ring_pages(to_numpy(tc), table, P,
                                           tm.paged_cache_kinds(1, BS)), "cpu")
        tabs = {"block_tables": _t(table)}
    else:
        for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):
            _close(a, b)
    pos = np.array([P, P, P])
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    thr = np.full(len(act), 0.999, np.float32)
    rc, ro = rm.decode(rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
                       active_sites=jnp.asarray(act, jnp.int32), exit_thresholds=jnp.asarray(thr))
    tc, to = tm.decode(tp, tc, _t(tok).long(), _t(pos), active_sites=act,
                       exit_thresholds=_t(thr), **tabs)
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy", "exit"))
    u = np.sort(1.0 - np.asarray(ro["ramps"]["maxprob"]).reshape(-1))
    thr = np.full(len(act), 0.5 * (u[1] + u[2]), np.float32)  # some rows exit, some stay
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    rc, (rl, rmp, fl, ex, nd) = rm.decode_multi(
        rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos + 1, jnp.int32), 4, n_max=4,
        active_sites=jnp.asarray(act, jnp.int32), thresholds=jnp.asarray(thr))
    tc, (tl, tmp, tfl, tex, tnd) = tm.decode_multi(
        tp, tc, _t(tok).long(), _t(pos + 1), 4, n_max=4, active_sites=act, thresholds=_t(thr),
        **tabs)
    nd = int(nd)
    assert int(tnd) == nd
    np.testing.assert_array_equal(tl.numpy()[:nd], np.asarray(rl)[:nd])
    _close(tmp.numpy()[:nd], np.asarray(rmp)[:nd])
    np.testing.assert_array_equal(tfl.numpy()[:nd], np.asarray(fl)[:nd])
    np.testing.assert_array_equal(tex.numpy()[:nd], np.asarray(ex)[:nd])
    r_decode = jax.jit(rm.decode)
    r_tok = np.asarray(fl)[nd - 1].reshape(-1, 1)
    t_tok = tfl[nd - 1].reshape(-1, 1).long()
    r_seq, t_seq = [], []
    for i in range(6):
        q = pos + 1 + nd + i
        rc, ro = r_decode(rp, rc, jnp.asarray(r_tok, jnp.int32), jnp.asarray(q, jnp.int32))
        tc, to = tm.decode(tp, tc, t_tok, _t(q), **tabs)
        r_tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
        t_tok = to["final"]["label"].reshape(-1, 1).long()
        r_seq.append(r_tok[:, 0])
        t_seq.append(t_tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(t_seq), np.stack(r_seq))
    if layout != "paged":
        for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):
            _close(a, b)


@pytest.mark.parametrize("L", DEPTHS)
@pytest.mark.parametrize("mode", ["full", "ramps_only"])
def test_lm_loss_and_grads_match_reference(L, mode):
    """``LM.loss`` on 24 tokens (past the 16-token window) with padding
    labels: the loss, its metrics and every leaf's gradient against
    ``jax.value_and_grad`` of the reference's."""
    rm, tm = _ref(L), _port(L)
    p = _weights(L, seed=1)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 24)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 24)).astype(np.int32)
    labels[0, 3] = labels[1, -1] = -1

    def f(params):
        return rm.loss(params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
                       train_mode=mode)

    (rl, rmet), rg = jax.value_and_grad(f, has_aux=True)(jax.tree.map(jnp.asarray, p))
    tp = from_numpy_params(p, "cpu")
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    tl, tmet = tm.loss(tp, {"tokens": _t(toks), "labels": _t(labels)}, train_mode=mode)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(rl), rtol=1e-5)
    for k in rmet:
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]), rtol=1e-5, atol=1e-6)
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
    """Apply one call to a reference runner and the port's, then hold the
    results to the tolerance rule; with ``same_layout`` the host states
    (allocator included) must be equal too."""

    def __init__(self, ref, port, same_layout):
        self.ref, self.port, self.same = ref, port, same_layout
        self.seen = set()

    def __call__(self, name, *args, port_args=None, port_only=False):
        pairs = ((self.port, port_args or args, TS.PoolExhausted),) if port_only else \
            ((self.ref, args, RS.PoolExhausted), (self.port, port_args or args, TS.PoolExhausted))
        outs = []
        for r, a, exc in pairs:
            try:
                outs.append(("ok", getattr(r, name)(*a)))
            except exc:
                outs.append(("exhausted", None))
        self.seen.add(name if outs[-1][0] == "ok" else f"{name}:exhausted")
        if port_only:
            return outs[0][1]
        (kr, rr), (kt, rt) = outs
        assert kr == kt, (name, args, kr, kt)
        if kr == "ok" and isinstance(rr, tuple):
            for i, (a, b) in enumerate(zip(rt, rr)):
                if np.asarray(a).dtype.kind == "f":
                    _close(a, b)
                else:
                    np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{name} record {i}")
        elif kr == "ok" and name != "swap_out":
            assert rt == rr, (name, rt, rr)
        if self.same:
            assert _runner_state(self.port) == _runner_state(self.ref), name
        else:
            for k in ("pos", "tok", "pf"):  # a port-only swap leaves a slot not live
                assert _runner_state(self.port)[k] == _runner_state(self.ref)[k], (name, k)
        return rr, rt


def _runners(L, prompts, ref_paged, port_paged, *, windowed=False, **kw):
    p = _weights(L)
    rm = _ref(L, windowed_cache=windowed, decode_attn="paged" if ref_paged else "ref")
    tm = _port(L, windowed_cache=windowed,
               decode_attn="paged-kernel" if port_paged else "kernel")
    kw = {"max_new_tokens": 32, "max_slots": 3, "n_slots": 4, **kw}
    rkw, tkw = dict(kw), dict(kw)
    if ref_paged:
        rkw["kv_block_size"] = BS
    if port_paged:
        tkw["kv_block_size"] = BS
    else:
        tkw.pop("kv_blocks", None)
    if not ref_paged:
        rkw.pop("kv_blocks", None)
    return (RS.DecodeRunner(rm, jax.tree.map(jnp.asarray, p), prompts, **rkw),
            TS.DecodeRunner(tm, from_numpy_params(p, "cpu"), prompts, **tkw))


def _prompts(n, P, seed):
    return np.random.default_rng(seed).integers(1, 512, (n, P))


def _check_pools(port, ref):
    for a, b in zip(tree_leaves(to_numpy(port._cache)), jax.tree.leaves(ref._cache)):
        ax = a.ndim - 4  # the pool axis: 1 stacked, 0 suffix
        _close(np.delete(a, 0, ax), np.delete(np.asarray(b), 0, ax))


@pytest.mark.parametrize("L", DEPTHS)
def test_paged_runner_matches_reference_paged_runner_within_the_window(L):
    """12-token prompts (<= W, where the reference's paged runner is right):
    the port's ring pages against the reference's, call for call: admits,
    steps, windows (one ending early), chunked prefill, a swap round trip,
    PoolExhausted with an atomic unwind on a pool too small for every
    stream; host and allocator state equal, the pools equal outside
    block 0."""
    ref, port = _runners(L, _prompts(6, 12, 3), True, True, kv_blocks=11)
    both = _Both(ref, port, same_layout=True)
    act = [0, 1]
    thr = np.array([0.5, 0.9], np.float32)
    both("start", 0, 0)
    both("start", 1, 1)
    both("step", [0, 1], act)
    both("step_multi", [0, 1], act, 3, thr)
    both("step_multi", [0, 1], act, 2, np.ones(2, np.float32))  # ends after one step
    h_ref, h_port = both("swap_out", 1)
    both("prefill_begin", 2, 2, 5)
    both("prefill_resume", 2, 3)
    both("prefill_resume", 2, 8)
    both("step_multi", [0, 2], act, 4, thr)
    both("start", 3, 3)  # the pool runs dry mid-admission
    both("free", 0)
    both("swap_in", 0, h_ref, port_args=(0, h_port))
    _check_pools(port, ref)
    both("step_multi", [0, 2], act, 4, thr)
    both("free", 2)
    both("start", 1, 4)
    both("step_multi", [0, 1], act, 3, thr)
    assert {"start", "step", "step_multi", "swap_out", "swap_in", "free", "prefill_begin",
            "prefill_resume", "start:exhausted"} <= both.seen, both.seen
    _check_pools(port, ref)


@pytest.mark.parametrize("L", DEPTHS)
@pytest.mark.parametrize("windowed", [False, True])
def test_paged_runner_past_the_window_matches_reference_contiguous(L, windowed):
    """24-token prompts (> W): the port's ring pages against the reference's
    contiguous runner (full rows, or rings with ``windowed_cache``) at equal
    batch shapes, call for call: admits, steps, windows, a chunked prefill
    whose first chunk (5 tokens) ends inside the window and whose resumed
    tokens wrap the ring, and a swap round trip of the port's slot (the
    reference's slot waits unstepped meanwhile)."""
    ref, port = _runners(L, _prompts(5, 24, 4), False, True, windowed=windowed)
    both = _Both(ref, port, same_layout=False)
    act = [0, 2]
    thr = np.array([0.5, 0.9], np.float32)
    both("start", 0, 0)
    both("start", 1, 1)
    both("step_multi", [0, 1], act, 3, thr)
    both("prefill_begin", 2, 2, 5)
    both("step", [0, 1], act)
    both("prefill_resume", 2, 11)
    handle = both("swap_out", 1, port_only=True)
    both("prefill_resume", 2, 20)
    both("step_multi", [0, 2], act, 4, thr)
    both("swap_in", 1, handle, port_only=True)
    both("step_multi", [0, 1, 2], act, 4, thr)
    both("free", 0)
    both("start", 0, 3)
    both("step_multi", [0, 1, 2], [1], 2, np.array([0.9], np.float32))
    both("step", [0, 1, 2], [])


def test_chunked_prefill_and_swap_leave_the_one_shot_pages():
    """A 24-token prompt prefilled in one shot, in chunks (5 by scatter,
    then one token a call), and swapped out and back in: the pages every
    decode step reads are equal (the local layers' virtual rows 0..W-1,
    the global layer's rows 0..23), through each runner's table."""
    prompts = _prompts(1, 24, 6)
    _, one = _runners(8, prompts, False, True)
    _, chunked = _runners(8, prompts, False, True)
    one.start(0, 0)
    chunked.prefill_begin(0, 0, 5)
    chunked.prefill_resume(0, 24)
    h = chunked.swap_out(0)
    chunked.swap_in(1, h)
    kinds = one.model.paged_cache_kinds(1, BS)

    def live(r, slot):
        tab = torch.from_numpy(r._alloc.table[slot, :6].astype(np.int64))
        out = []
        for leaf, kind in zip(tree_leaves(r._cache), kinds):
            ax = leaf.dim() - 4
            virt = leaf.index_select(ax, tab).flatten(ax, ax + 1)
            out.append(virt.narrow(ax, 0, W if kind == "ring" else 24))
        return out

    for a, b in zip(live(one, 0), live(chunked, 1)):
        _close(a.numpy(), b.numpy(), TOL)
    assert one._tok[0] == chunked._tok[1] and one._pos[0] == chunked._pos[1] == 24


def test_prefix_cache_refused_for_gemma():
    """Ring pages are position-aliased mod W, not shareable: both runners
    refuse a prefix cache with the same ValueError."""
    prompts = _prompts(2, 12, 0)
    rm = _ref(6, decode_attn="paged")
    tm = _port(6, decode_attn="paged-kernel")
    with pytest.raises(ValueError) as e_ref:
        RS.DecodeRunner(rm, {"tok": {"embed": jnp.zeros(1)}}, prompts, prefix_cache=True)
    with pytest.raises(ValueError) as e_port:
        TS.DecodeRunner(tm, {"tok": {"embed": torch.zeros(1)}}, prompts, prefix_cache=True)
    assert str(e_port.value) == str(e_ref.value)


# -- the launcher ------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _served(bs, **kw):
    from repro_torch.launch.serve import serve_generative  # repro: allow[tier1-deps] — the port under test

    out, resp = serve_generative(ARCH, 4, decode_tokens=5, prompt_len=20, steps_per_sync=3,
                                 tiny=True, device="cpu", verbose=False, kv_block_size=bs,
                                 **kw)
    return out, [r.final_tokens for r in resp], resp


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 6}, {"kv_blocks": 12, "preempt": "swap"}])
def test_serve_launcher_gemma_on_cpu_tiny(kw):
    """The launcher end to end at tiny size with 20-token prompts (past the
    window): ring pages (also with chunked prefill, and with swap on a pool
    that runs dry) give the contiguous rows' greedy tokens, and every
    request completes; a prefix cache is refused."""
    out, toks, resp = _served(4, **kw)
    assert len(resp) == 4 and all(len(r.tokens) == 5 and not r.dropped for r in resp)
    assert out["config"] == "tiny-" + ARCH and out["kv_cache"]["paged"]
    assert toks == _served(0)[1]
    if "preempt" in kw:
        assert out["kv_cache"]["swap_outs"] > 0
        assert out["kv_cache"]["swap_ins"] == out["kv_cache"]["swap_outs"]
    from repro_torch.launch.serve import serve_generative  # repro: allow[tier1-deps] — the port under test

    with pytest.raises(ValueError):
        serve_generative(ARCH, 2, decode_tokens=2, prompt_len=8, tiny=True, device="cpu",
                         verbose=False, kv_block_size=4, prefix_cache=True)
