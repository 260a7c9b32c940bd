"""The port's cross-attention plan (Llama-3.2-Vision) against the JAX
package's, on tiny Llama-3.2-Vision at two periods (10 layers: each period
4 self-attention layers, then one that adds a tanh-gated cross-attention
over M = 16 image tokens of width 32). The gates, zero at init (a branch
that changes nothing), are set to 0.5 on both sides.

Schemas, cache schemas and page kinds (``xkv``); the cross layer; the LM
with image memory through ``prefill(image_embeds=)`` and without it (what
the serving runner runs: zero memory), then decode steps and sync windows
from the contiguous ``xkv`` rows and from pinned xkv pages in the trailing
table columns; ``LM.loss`` with ``image_embeds`` and its gradients; paired
``DecodeRunner`` schedules through pinned-page claims, swaps and an
unwind that releases the pins; a refused prefix cache; the launcher.

One deliberate difference (ROADMAP.md, Queue 3): the reference's
``prefill`` with a cache attends the zero ``xkv`` of ``init_cache`` and
ignores ``image_embeds``; the port's writes the memory's k/v into ``xkv``.
The repaired path is held against the reference's cacheless prefill (which
does read the memory) and against the reference's decode over a cache
whose ``xkv`` holds the memory's k/v, computed here in JAX.

Tolerance rule: one op within 1e-5 (fp32); whole-model records, losses and
caches within 1e-4; labels, greedy tokens, exit bits and sites, ``n_done``,
allocator state (pins included) and ``kv_stats()`` exact."""
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
from repro.models.common import is_info  # noqa: E402

import repro_torch.serving as TS  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import layers as TL  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.transformer import _cache_len  # noqa: E402  # repro: allow[tier1-deps] — the port under test

ARCH = "llama-3.2-vision-90b"
TOL = dict(rtol=1e-5, atol=1e-5)  # one op
REC_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model records, losses and caches
L, BS, M, GATE = 10, 4, 16, 0.5
X = 4  # the cross slot: the last of each period


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol=REC_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _ref(n_layers=L, **kw):
    return ref_build(get_tiny(ARCH).replace(n_layers=n_layers, **kw))


def _port(n_layers=L, **kw):
    kw = {"pallas_head": "kernel", **kw}
    return build_model(port_tiny(ARCH).replace(n_layers=n_layers, **kw), prefill_attn="kernel")


@functools.lru_cache(maxsize=None)
def _weights(seed=0, n_layers=L):
    """The reference's init, every leaf perturbed so zero-initialized norms
    take part, and every cross gate at 0.5 (numpy tree)."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                     .astype(np.float32), _ref(n_layers).init(jax.random.PRNGKey(seed)))
    p["blocks"][X]["xattn"]["gate"] = np.full_like(p["blocks"][X]["xattn"]["gate"], GATE)
    return p


def _image(B, seed=4):
    return np.random.default_rng(seed).standard_normal((B, M, 32)).astype(np.float32)


def _shapes(tree, jax_tree=False):
    leaves = jax.tree.leaves(tree, is_leaf=is_info) if jax_tree else tree_leaves(tree)
    return [tuple(i.shape) for i in leaves]


def _check_stats(t, r, keys, tol=REC_TOL):
    for k in keys:
        a, b = t[k].numpy(), np.asarray(r[k]).reshape(t[k].shape)
        if k in ("label", "exit"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **tol)


# -- schemas, kinds and the cross layer ------------------------------------------------


def test_schemas_cache_schemas_and_kinds_equal_reference():
    """Params (``frontend.proj``, the cross slot's ``lnx``/``xattn`` with
    its gate stacked over the periods), contiguous caches (``xkv`` rows
    (L, B, M, KH, hd)) and paged pools (``xkv`` pages) leaf for leaf; the
    xkv pages' kind, ``ceil(M / bs)`` trailing columns, no prefix sharing;
    the decode mask's length ignores the M image rows."""
    rm, tm = _ref(), _port()
    assert [s.cross for s in tm.plan.period] == [False] * 4 + [True]
    assert _shapes(tm.schema()) == _shapes(rm.schema(), True)
    assert tm.schema()["blocks"][X]["xattn"]["gate"].shape == (2,)
    for S in (9, 40):
        assert _shapes(tm.cache_schema(3, S)) == _shapes(rm.cache_schema(3, S), True)
        assert _cache_len(tm.init_cache(2, S, device="cpu")) == S
    assert _shapes(tm.paged_cache_schema(5, BS)) == _shapes(rm.paged_cache_schema(5, BS), True)
    kinds = tm.paged_cache_kinds(5, BS)
    assert kinds == rm.paged_cache_kinds(5, BS)
    assert kinds == ["tokens"] * 8 + ["tokens", "tokens", "xkv", "xkv"]
    for bs in (4, 5, 16):
        assert tm.paged_xkv_blocks(bs) == rm.paged_xkv_blocks(bs) == -(-M // bs)
    assert tm.paged_sharing_ok is False and rm.paged_sharing_ok is False


def test_cross_attn_apply_equals_reference():
    """One cross layer at gate 0.5: from image memory (its k/v projected)
    and from k/v as a cache holds them."""
    cfg, tcfg = get_tiny(ARCH), port_tiny(ARCH)
    sch = RL.cross_attn_schema(cfg)
    rng = np.random.default_rng(0)
    p = {k: 0.3 * rng.standard_normal(i.shape).astype(np.float32) for k, i in sch.items()}
    p["gate"] = np.float32(GATE)
    rp, tp = jax.tree.map(jnp.asarray, p), from_numpy_params(p, "cpu")
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, M, cfg.d_model)).astype(np.float32)
    ro, rkv = RL.cross_attn_apply(cfg, rp, jnp.asarray(x), memory=jnp.asarray(mem),
                                  axes=RL.TEST_AXES)
    to, tkv = TL.cross_attn_apply(tcfg, tp, _t(x), memory=_t(mem))
    _close(to.numpy(), ro, TOL)
    for k in ("k", "v"):
        _close(tkv[k].numpy(), rkv[k], TOL)
    kv = {k: rng.standard_normal(np.shape(rkv[k])).astype(np.float32) for k in ("k", "v")}
    ro, _ = RL.cross_attn_apply(cfg, rp, jnp.asarray(x), kv_cache=jax.tree.map(jnp.asarray, kv),
                                axes=RL.TEST_AXES)
    to, _ = TL.cross_attn_apply(tcfg, tp, _t(x), kv_cache={k: _t(v) for k, v in kv.items()})
    _close(to.numpy(), ro, TOL)


# -- the LM ----------------------------------------------------------------------------


def _memory_kv(p, img):
    """The reference's k/v of the image memory for every cross layer,
    stacked over the periods: (n_periods, B, M, KH, hd)."""
    cfg = get_tiny(ARCH)
    mem = jnp.asarray(img) @ jnp.asarray(p["frontend"]["proj"])
    xa = p["blocks"][X]["xattn"]
    B = img.shape[0]
    return {k: jnp.stack([(mem @ jnp.asarray(xa[w][l])).reshape(B, M, cfg.n_kv_heads, cfg.hd)
                          for l in range(L // 5)]) for k, w in (("k", "wk"), ("v", "wv"))}


def _pages(cache, table, xtable):
    """A contiguous cache laid out as pool pages: token leaves under
    ``table``, the cross slot's ``xkv`` leaves under ``xtable``."""
    def leaf(x, tab):
        x = np.asarray(x)
        n, B, S = x.shape[:3]
        nb = tab.shape[1]
        virt = np.zeros((n, B, nb * BS) + x.shape[3:], x.dtype)
        virt[:, :, :S] = x
        pool = np.zeros((n, P_BLOCKS, BS) + x.shape[3:], x.dtype)
        pool[:, tab.reshape(-1)] = virt.reshape((n, B * nb, BS) + x.shape[3:])
        return pool

    out = []
    for s, blk in enumerate(cache["blocks"]):
        d = {k: leaf(blk[k], table) for k in ("k", "v")}
        if s == X:
            d["xkv"] = {k: leaf(blk["xkv"][k], xtable) for k in ("k", "v")}
        out.append(d)
    return {"blocks": out}


P_BLOCKS = 1 + 3 * 6 + 3 * 4  # the trash block, 6 token and 4 xkv blocks a row


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("image", [True, False])
def test_lm_prefill_decode_and_window_agree(image, layout):
    """Prefill records and caches, then one decode step with exit bits, a
    sync window of up to 4 steps and 3 greedy steps with equal tokens, on
    contiguous rows or on pages (token pages, and the xkv pages in the
    trailing table columns, under shuffled tables: both packages on the
    same pages). With ``image`` the port's cached prefill reads the memory
    (held against the reference's cacheless prefill, and its ``xkv``
    against the memory's k/v); the reference then decodes over a cache
    whose ``xkv`` holds those k/v and whose token rows its decode steps
    wrote from the prompt, and its first decode step equals its own
    cacheless prefill of one more token. Without, both attend zeros."""
    paged = layout == "paged"
    rm = _ref(decode_attn="paged" if paged else "ref")
    tm = _port(decode_attn="paged-kernel" if paged else "kernel")
    p = _weights()
    rp, tp = jax.tree.map(jnp.asarray, p), from_numpy_params(p, "cpu")
    B, P, cl = 3, 10, 24
    toks = np.random.default_rng(7).integers(0, 512, (B, P + 1))
    act = list(range(len(rm.sites)))
    ract = jnp.asarray(act, jnp.int32)
    img = _image(B)
    tkw_img = {"image_embeds": _t(img)} if image else {}
    rc, ro = rm.prefill(rp, jnp.asarray(toks[:, :P], jnp.int32), cache_len=cl, active_sites=ract)
    tc, to = tm.prefill(tp, _t(toks[:, :P]), cache_len=cl, active_sites=act, **tkw_img)
    if image:
        _, ro = rm.prefill(rp, jnp.asarray(toks[:, :P], jnp.int32), active_sites=ract,
                           image_embeds=jnp.asarray(img), with_cache=False)
        _, to_free = tm.prefill(tp, _t(toks[:, :P]), active_sites=act, with_cache=False,
                                **tkw_img)
        _check_stats(to_free["final"], ro["final"], ("label", "maxprob", "entropy"))
        # the reference's cache of the prompt with the memory: its xkv set
        # to the memory's k/v, then the prompt fed one token a decode step
        rc = rm.init_cache(B, cl)
        rc["blocks"][X]["xkv"] = _memory_kv(p, img)
        step = jax.jit(functools.partial(rm.decode, moe_impl="dense"))
        for t in range(P):
            rc, _ = step(rp, rc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                         jnp.full((B,), t, jnp.int32))
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy"))
    for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):
        _close(a, b)
    rkw, tkw = {"moe_impl": "dense"}, {}
    if paged:
        perm = np.random.default_rng(1).permutation(P_BLOCKS - 1) + 1
        table, xtable = perm[:18].reshape(B, 6), perm[18:].reshape(B, 4)
        full = np.concatenate([table, xtable], axis=1).astype(np.int32)
        rc = jax.tree.map(jnp.asarray, _pages(rc, table, xtable))
        tc = from_numpy_params(_pages(to_numpy(tc), table, xtable), "cpu")
        rkw["block_tables"], tkw["block_tables"] = jnp.asarray(full), _t(full)
    pos = np.full(B, P)
    tok = toks[:, P:]
    thr = np.full(len(act), 0.999, np.float32)
    rc, ro = rm.decode(rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
                       active_sites=ract, exit_thresholds=jnp.asarray(thr), **rkw)
    tc, to = tm.decode(tp, tc, _t(tok).long(), _t(pos), active_sites=act,
                       exit_thresholds=_t(thr), **tkw)
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy", "exit"))
    if image:  # the decode step against the cacheless prefill of P + 1 tokens
        _, rf = rm.prefill(rp, jnp.asarray(toks, jnp.int32), active_sites=ract,
                           image_embeds=jnp.asarray(img), with_cache=False)
        _check_stats(to["final"], rf["final"], ("label", "maxprob", "entropy"))
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
    for i in range(3):
        q = pos + 1 + nd + i
        rc, ro = rm.decode(rp, rc, jnp.asarray(r_tok, jnp.int32), jnp.asarray(q, jnp.int32),
                           **rkw)
        tc, to = tm.decode(tp, tc, t_tok, _t(q), **tkw)
        r_tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
        t_tok = to["final"]["label"].reshape(-1, 1).long()
        np.testing.assert_array_equal(t_tok.numpy(), r_tok)
    for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):  # xkv never written
        _close(a, b)


def test_lm_loss_and_grads_with_image_match_reference():
    """``LM.loss`` with ``image_embeds`` and padding labels: the loss, its
    metrics and every leaf's gradient (the gates and ``frontend.proj``
    among them) against ``jax.value_and_grad`` of the reference's."""
    rm, tm = _ref(), _port()
    p = _weights(seed=1)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labels[0, 3] = labels[1, -1] = -1
    img = _image(2, seed=5)

    def f(params):
        return rm.loss(params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                                "image_embeds": jnp.asarray(img)})

    (rl, rmet), rg = jax.value_and_grad(f, has_aux=True)(jax.tree.map(jnp.asarray, p))
    tp = from_numpy_params(p, "cpu")
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    tl, tmet = tm.loss(tp, {"tokens": _t(toks), "labels": _t(labels), "image_embeds": _t(img)})
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(rl), rtol=1e-5)
    for k in rmet:
        np.testing.assert_allclose(float(tmet[k].detach()), float(rmet[k]), rtol=1e-5,
                                   atol=1e-6)
    rleaves = jax.tree.leaves(rg)
    assert len(rleaves) == len(tg)
    gate = next(i for i, t in enumerate(leaves) if t is tp["blocks"][X]["xattn"]["gate"])
    assert np.abs(np.asarray(rleaves[gate])).min() > 0  # the branch takes part
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
        out["xkv"] = r._xkv_tab.tolist()
        out["kv"] = r.kv_stats()
    return out


class _Both:
    """Apply one call to a reference runner and the port's: the same result
    (records within 1e-4), the same outcome (PoolExhausted on both or
    neither) and the same host and allocator state, pins included."""

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


def test_paged_runner_pinned_xkv_pages_match_reference():
    """10-token prompts, 3 token blocks and 4 pinned xkv pages an
    admission on a 20-block pool: admits, steps, windows (one ending
    early), a swap round trip that moves the xkv pages out and back, a
    chunked prefill (its pages claimed with its first chunk), an admission
    whose xkv claim runs the pool dry after its token blocks were taken
    (the unwind releases both), frees: host and allocator state (pins and
    each slot's xkv ids) equal call for call, the pools equal outside
    block 0, and the pins balance at the end."""
    ref, port = _runners(np.random.default_rng(3).integers(1, 512, (5, 10)), True,
                         kv_blocks=20)
    both = _Both(ref, port)
    act = [0, 3]
    thr = np.array([0.5, 0.9], np.float32)
    both("start", 0, 0)
    both("start", 1, 1)
    both("step", [0, 1], act)
    both("step_multi", [0, 1], act, 3, thr)
    both("step_multi", [0, 1], act, 2, np.ones(2, np.float32))  # ends after one step
    assert port._alloc.pins == 8
    h_ref, h_port = both("swap_out", 1)
    assert h_port["n_xkv"] == 4 and port._alloc.pins == 4
    both("prefill_begin", 2, 2, 5)
    both("prefill_resume", 2, 5)
    both("step_multi", [0, 2], act, 4, thr)
    both("start", 3, 3)  # its token blocks fit, its xkv pages do not
    both("free", 0)
    both("swap_in", 1, h_ref, port_args=(1, h_port))
    _check_pools(port, ref)
    both("step_multi", [1, 2], act, 4, thr)
    both("free", 1)
    both("free", 2)
    assert {"start", "step", "step_multi", "swap_out", "swap_in", "free", "prefill_begin",
            "prefill_resume", "start:exhausted"} <= both.seen, both.seen
    assert port._alloc.pins == 0 and port._alloc.n_free == 20 and not port._xkv_tab.any()


def test_contiguous_runner_matches_reference():
    ref, port = _runners(np.random.default_rng(5).integers(1, 512, (3, 10)), False)
    both = _Both(ref, port)
    both("start", 0, 0)
    both("start", 1, 1)
    both("step_multi", [0, 1], [0, 3], 3, np.array([0.5, 0.9], np.float32))
    both("free", 0)
    both("start", 0, 2)
    both("step", [0, 1], [2])


def test_prefix_cache_refused_for_cross_attention():
    """Pinned xkv pages are per slot: both runners refuse a prefix cache
    with the same ValueError."""
    prompts = np.zeros((2, 8), np.int64)
    with pytest.raises(ValueError) as e_ref:
        RS.DecodeRunner(_ref(decode_attn="paged"), {"tok": {"embed": jnp.zeros(1)}}, prompts,
                        prefix_cache=True)
    with pytest.raises(ValueError) as e_port:
        TS.DecodeRunner(_port(decode_attn="paged-kernel"), {"tok": {"embed": torch.zeros(1)}},
                        prompts, prefix_cache=True)
    assert str(e_port.value) == str(e_ref.value)


# -- the launcher ------------------------------------------------------------------------


def test_serve_launcher_cross_on_cpu_tiny():
    """The launcher end to end at tiny size: 4 requests on contiguous rows,
    on pinned xkv pages, and on a 12-block pool with swap preemption: equal
    greedy tokens, every request complete, the swaps balanced; a prefix
    cache refused."""
    from repro_torch.launch.serve import serve_generative  # repro: allow[tier1-deps] — the port under test

    runs = []
    for kw in ({}, {"kv_block_size": 4}, {"kv_block_size": 4, "kv_blocks": 12,
                                          "preempt": "swap"}):
        out, resp = serve_generative(ARCH, 4, decode_tokens=5, prompt_len=12, steps_per_sync=3,
                                     tiny=True, device="cpu", verbose=False, **kw)
        assert len(resp) == 4 and all(len(r.tokens) == 5 and not r.dropped for r in resp)
        runs.append(sorted((r.rid, r.final_tokens) for r in resp))
    assert runs[0] == runs[1] == runs[2]
    kv = out["kv_cache"]
    assert kv["swap_outs"] > 0 and kv["swap_ins"] == kv["swap_outs"] and kv["live_blocks"] == 0
    with pytest.raises(ValueError):
        serve_generative(ARCH, 2, decode_tokens=2, prompt_len=8, tiny=True, device="cpu",
                         verbose=False, kv_block_size=4, prefix_cache=True)
