"""The port's ``EncDecLM`` (SeamlessM4T-large-v2's backbone) against the JAX
package's, on the tiny config (2 encoder + 2 decoder layers, d 64, 4 heads
of 16) with M = 24 or 20 encoder frames (20 is not a multiple of the block
size 8, so the last pinned page is partly filled). Weights are the
reference's init, every leaf perturbed so zero-initialized norms take
part, and every cross gate at 0.7 (zero at init: a branch that changes
nothing), carried over by ``models/bridge.py``.

One deliberate difference (ROADMAP.md, Queue 3): the reference's
``prefill`` with a cache attends the zero ``xkv`` it starts from and
ignores the frames; the port's writes the memory's k/v into ``xkv``. The
port's cached prefill is held against the reference's cacheless prefill,
its ``xkv`` against the memory's k/v computed from the reference's
``encode``, and its decode against the reference's decode over a cache
whose ``xkv`` holds those k/v and whose token rows the reference's own
decode steps wrote from the prompt.

Tolerance rule: one op within 1e-5 (fp32); whole-model records, losses,
gradients and caches within 1e-4; labels, greedy tokens, exit bits and
sites and ``n_done`` exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_tiny  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.common import is_info  # noqa: E402

from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.encdec import ramp_positions  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.serving.runner import BlockAllocator  # noqa: E402  # repro: allow[tier1-deps] — the port under test

ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=1e-5, atol=1e-5)  # one op
REC_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model records, losses and caches
GATE, BS, B, P, CL = 0.7, 8, 3, 10, 24  # gate, block size, rows, prompt, cache_len
KW = {"decode_attn": "kernel", "pallas_head": "kernel"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol=REC_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _ref(M=24, **kw):
    return ref_build(get_tiny(ARCH).replace(n_image_tokens=M, **kw))


def _port(M=24, prefill_attn="kernel", **kw):
    return build_model(port_tiny(ARCH).replace(n_image_tokens=M, **{**KW, **kw}),
                       prefill_attn=prefill_attn)


@functools.lru_cache(maxsize=None)
def _weights(seed=0):
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                     .astype(np.float32), _ref().init(jax.random.PRNGKey(seed)))
    p["dec"]["xattn"]["gate"] = np.full_like(p["dec"]["xattn"]["gate"], GATE)
    return p


def _both(seed=0):
    p = _weights(seed)
    return jax.tree.map(jnp.asarray, p), from_numpy_params(p, "cpu")


def _frames(M, seed=4, n=B):
    return np.random.default_rng(seed).standard_normal((n, M, 64)).astype(np.float32)


def _tokens(seed=7, n=B, S=P + 1):
    return np.random.default_rng(seed).integers(0, 512, (n, S))


def _check_stats(t, r, keys, tol=REC_TOL):
    for k in keys:
        a, b = t[k].numpy(), np.asarray(r[k]).reshape(t[k].shape)
        if k in ("label", "exit"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **tol)


def _paths(tree, pre=""):
    """Leaf paths of the port's tree in flatten order, spelled as
    ``jax.tree_util.keystr`` spells the reference's."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k], f"{pre}['{k}']")]
    return [pre]


# -- schemas and page kinds -------------------------------------------------------------


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_schema_leaf_paths_and_shapes_equal_reference(which):
    """Leaf paths (``frontend_proj``, ``tok``, ``enc``/``dec`` with the
    leading layer axis, ``enc_norm``, ``final_norm``, ``ramps.{norm_w,
    head}``), shapes and dtypes; ramps on all 23 decoder sites at full
    width, not the decoder-only LM's 12."""
    from repro.configs import get_config

    from repro_torch.configs import get_config as port_config  # repro: allow[tier1-deps] — the port under test

    rcfg = get_tiny(ARCH) if which == "tiny" else get_config(ARCH)
    tcfg = port_tiny(ARCH) if which == "tiny" else port_config(ARCH)
    rm, tm = ref_build(rcfg), build_model(tcfg)
    ref = jax.tree_util.tree_flatten_with_path(rm.schema(), is_leaf=is_info)[0]
    sch = tm.schema()
    port = tree_leaves(sch)
    assert _paths(sch) == [jax.tree_util.keystr(k) for k, _ in ref]
    assert [tuple(i.shape) for i in port] == [tuple(i.shape) for _, i in ref]
    assert [str(i.dtype)[6:] for i in port] == [np.dtype(i.dtype).name for _, i in ref]
    assert tm.sites == rm.sites == tuple(range(tcfg.n_dec_layers - 1))
    assert sch["ramps"]["head"].shape[0] == (1 if which == "tiny" else 23)


@pytest.mark.parametrize("M", [24, 20])
def test_page_kinds_xkv_blocks_and_sharing_equal_reference(M):
    rm, tm = _ref(M), _port(M)
    sch = tm.paged_cache_schema(5, BS)
    rsch = rm.paged_cache_schema(5, BS)
    assert [tuple(i.shape) for i in tree_leaves(sch)] == [
        tuple(i.shape) for i in jax.tree.leaves(rsch, is_leaf=is_info)]
    assert tm.paged_cache_kinds(5, BS) == rm.paged_cache_kinds(5, BS) == [
        "tokens", "tokens", "xkv", "xkv"]
    for bs in (4, 5, 8, 16):
        assert tm.paged_xkv_blocks(bs) == rm.paged_xkv_blocks(bs) == -(-M // bs)
    assert tm.paged_sharing_ok is False and rm.paged_sharing_ok is False


def test_ramp_positions_equal_reference_linspace():
    """The loss's 16 ramp positions, formed in numpy, are the reference's
    ``jnp.linspace(...).astype(int32)`` for every sequence length up to 300."""
    for S in range(1, 301):
        npos = min(16, S)
        ref = np.asarray(jnp.linspace(max(S // npos - 1, 0), S - 1, npos).astype(jnp.int32))
        np.testing.assert_array_equal(ramp_positions(S, npos), ref, err_msg=f"S={S}")


# -- the encoder and the cached prefill --------------------------------------------------


@pytest.mark.parametrize("prefill_attn", ["sdpa", "kernel"])
def test_encode_equals_reference(prefill_attn):
    rp, tp = _both()
    rm, tm = _ref(), _port(prefill_attn=prefill_attn)
    fr = _frames(24)
    _close(tm.encode(tp, _t(fr)).numpy(), rm.encode(rp, jnp.asarray(fr)), TOL)


def _memory_kv(rm, rp, frames):
    """The memory's k/v for every decoder layer from the reference's
    ``encode``: (L, B, M, KH, hd)."""
    cfg = rm.cfg
    mem = rm.encode(rp, jnp.asarray(frames))
    n, M = frames.shape[:2]
    xa = rp["dec"]["xattn"]
    return {k: jnp.stack([(mem @ xa[w][l]).reshape(n, M, cfg.n_kv_heads, cfg.hd)
                          for l in range(cfg.n_dec_layers)]) for k, w in (("k", "wk"),
                                                                          ("v", "wv"))}


def _ref_cache(rm, rp, frames, toks, per_row=True):
    """The reference's cache of the prompt with the memory: zero caches
    whose ``xkv`` holds the memory's k/v, then the prompt fed one token a
    decode step (per-row or scalar pos)."""
    cfg = rm.cfg
    L, K, hd = cfg.n_dec_layers, cfg.n_kv_heads, cfg.hd
    n = toks.shape[0]
    z = jnp.zeros((L, n, CL, K, hd), jnp.float32)
    rc = {"k": z, "v": z, "xkv": _memory_kv(rm, rp, frames)}
    step = jax.jit(rm.decode)
    for t in range(toks.shape[1]):
        pos = jnp.full((n,), t, jnp.int32) if per_row else jnp.int32(t)
        rc, _ = step(rp, rc, jnp.asarray(toks[:, t:t + 1], jnp.int32), pos)
    return rc


@pytest.mark.parametrize("M", [24, 20])
def test_cached_prefill_equals_reference_cacheless_prefill(M):
    """Outputs of the port's cached prefill (final and every ramp) against
    the reference's cacheless prefill; its ``xkv`` against the memory's
    k/v; its token rows against those the reference's decode steps write
    over that ``xkv``; the reference's own cached prefill attends zeros:
    its output does not move with the frames."""
    rp, tp = _both()
    rm, tm = _ref(M), _port(M)
    fr, toks = _frames(M), _tokens()[:, :P]
    act = list(rm.sites)
    _, ro = rm.prefill(rp, jnp.asarray(fr), jnp.asarray(toks, jnp.int32),
                       active_sites=jnp.asarray(act), with_cache=False)
    tc, to = tm.prefill(tp, _t(fr), _t(toks), cache_len=CL, active_sites=act)
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy"))
    kv = _memory_kv(rm, rp, fr)
    for k in ("k", "v"):
        _close(tc["xkv"][k].numpy(), kv[k])
    rc = _ref_cache(rm, rp, fr, toks)
    for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):
        _close(a, b)
    # the reference caveat this port repairs: its cached prefill's output is
    # the same whatever the frames
    outs = [rm.prefill(rp, jnp.asarray(f), jnp.asarray(toks, jnp.int32), cache_len=CL)[1]
            for f in (fr, 2.0 * fr)]
    np.testing.assert_array_equal(np.asarray(outs[0]["final"]["maxprob"]),
                                  np.asarray(outs[1]["final"]["maxprob"]))


# -- decode on contiguous rows and on the pool ------------------------------------------


def _pool(tm, cache, rng):
    """Lay a prefill's contiguous cache out on a pool as the serving
    runner's paged prefill scatter does: token blocks and pinned xkv blocks
    claimed from a ``BlockAllocator`` in a shuffled order of rows, each
    table its token columns then its trailing xkv columns, the self k/v
    scattered into the token pages and ``xkv`` into the pinned pages.
    Returns (pool, tables (B, nb + nbx) int32)."""
    n, S = cache["k"].shape[1:3]
    nb, nbx = -(-S // BS), tm.paged_xkv_blocks(BS)
    al = BlockAllocator(n * (nb + nbx), nb, n)
    claims = [(b, "tokens") for b in range(n) for _ in range(nb)] + [(b, "xkv") for b in range(n)]
    xtab = {}
    for i in rng.permutation(len(claims)):
        b, kind = claims[i]
        if kind == "tokens":
            al.alloc(b, 1)
        else:
            xtab[b] = al.alloc_pinned(nbx)
    tables = np.concatenate([al.table[:n, :nb], np.asarray([xtab[b] for b in range(n)])], 1)
    pool = tm.init_paged_cache(1 + al.n_blocks, BS, device="cpu")

    def scatter(dst, src, ids):
        L, _, rows = src.shape[:3]
        pad = torch.zeros((L, n, ids.shape[1] * BS - rows) + src.shape[3:], dtype=src.dtype)
        pages = torch.cat([src, pad], 2).reshape((L, -1, BS) + src.shape[3:])
        dst.index_copy_(1, torch.from_numpy(ids.reshape(-1).astype(np.int64)), pages)

    for k in ("k", "v"):
        scatter(pool[k], cache[k], tables[:, :nb])
        scatter(pool["xkv"][k], cache["xkv"][k], tables[:, nb:])
    return pool, tables.astype(np.int32)


@pytest.mark.parametrize("layout", ["contiguous", "scalar_pos", "paged"])
@pytest.mark.parametrize("M", [24, 20])
def test_decode_steps_equal_reference(M, layout):
    """4 decode steps (the first with exit bits at thresholds that split
    the rows) from the prompt's cache: per-row or 0-d ``pos`` on contiguous
    rows, or on the pool (token pages and pinned pages under shuffled
    tables, both packages on the same pages; the reference through its
    plain paged attention); greedy tokens equal, records within 1e-4, the
    caches equal after, the pinned pages never written. The paged run's
    records also equal the port's contiguous run's."""
    paged = layout == "paged"
    rp, tp = _both()
    rm = _ref(M, decode_attn="paged" if paged else "dense")
    tm = _port(M, decode_attn="paged-kernel" if paged else "kernel")
    fr, toks = _frames(M), _tokens()
    act = list(rm.sites)
    tc, _ = tm.prefill(tp, _t(fr), _t(toks[:, :P]), cache_len=CL)
    rc = _ref_cache(rm, rp, fr, toks[:, :P], per_row=layout != "scalar_pos")
    cont = None
    rkw, tkw = {}, {}
    if paged:
        cont = _port(M), {k: v.clone() for k, v in tc.items() if k != "xkv"}
        cont[1]["xkv"] = {k: v.clone() for k, v in tc["xkv"].items()}
        tc, tables = _pool(tm, tc, np.random.default_rng(M))
        rc, rtables = _pool(tm, from_numpy_params(jax.tree.map(np.asarray, rc), "cpu"),
                            np.random.default_rng(M))
        np.testing.assert_array_equal(rtables, tables)
        rc = jax.tree.map(jnp.asarray, to_numpy(rc))
        xkv0 = {k: v.clone() for k, v in tc["xkv"].items()}
        rkw["block_tables"], tkw["block_tables"] = jnp.asarray(tables), _t(tables)
    tok = toks[:, P:]
    for t in range(4):
        q = P + t
        rpos = jnp.int32(q) if layout == "scalar_pos" else jnp.full((B,), q, jnp.int32)
        tpos = torch.tensor(q) if layout == "scalar_pos" else torch.full((B,), q)
        thr = None
        if t == 0:
            _, probe = rm.decode(rp, rc, jnp.asarray(tok, jnp.int32), rpos,
                                 active_sites=jnp.asarray(act), **rkw)
            u = np.sort(1.0 - np.asarray(probe["ramps"]["maxprob"]).reshape(-1))
            thr = np.full(len(act), 0.5 * (u[0] + u[1]), np.float32)  # splits the rows
        rc, ro = rm.decode(rp, rc, jnp.asarray(tok, jnp.int32), rpos,
                           active_sites=jnp.asarray(act),
                           exit_thresholds=None if thr is None else jnp.asarray(thr), **rkw)
        tc, to = tm.decode(tp, tc, _t(tok).long(), tpos, active_sites=act,
                           exit_thresholds=None if thr is None else _t(thr), **tkw)
        keys = ("label", "maxprob", "entropy") + (("exit",) if t == 0 else ())
        _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
        _check_stats(to["ramps"], ro["ramps"], keys)
        if t == 0:
            ex = to["ramps"]["exit"].numpy()
            assert ex.any() and not ex.all()
        if cont is not None:
            cm, cc = cont
            _, co = cm.decode(tp, cc, _t(tok).long(), tpos, active_sites=act)
            _check_stats(to["final"], co["final"], ("label", "maxprob", "entropy"))
            _check_stats(to["ramps"], co["ramps"], ("label", "maxprob", "entropy"))
        tok = to["final"]["label"].numpy().reshape(-1, 1)
        np.testing.assert_array_equal(tok, np.asarray(ro["final"]["label"]).reshape(-1, 1))
    for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):
        _close(a, b)
    if paged:  # the pinned pages hold what the scatter wrote
        for k in ("k", "v"):
            assert torch.equal(tc["xkv"][k], xkv0[k])


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_multi_equals_reference(layout):
    """A sync window of up to 4 steps with thresholds that let some rows
    exit and one bucket-padding row masked out by ``row_valid``: ``n_done``,
    labels, exit sites exact, maxprobs within 1e-4, caches after."""
    paged = layout == "paged"
    M = 20
    rp, tp = _both()
    rm = _ref(M, decode_attn="paged" if paged else "dense")
    tm = _port(M, decode_attn="paged-kernel" if paged else "kernel")
    fr, toks = _frames(M), _tokens()
    act = list(rm.sites)
    tc, _ = tm.prefill(tp, _t(fr), _t(toks[:, :P]), cache_len=CL)
    rc = _ref_cache(rm, rp, fr, toks[:, :P])
    rkw, tkw = {}, {}
    if paged:
        tc, tables = _pool(tm, tc, np.random.default_rng(1))
        rc, _ = _pool(tm, from_numpy_params(jax.tree.map(np.asarray, rc), "cpu"),
                      np.random.default_rng(1))
        rc = jax.tree.map(jnp.asarray, to_numpy(rc))
        rkw["block_tables"], tkw["block_tables"] = jnp.asarray(tables), _t(tables)
    tok, pos = toks[:, P:], np.full(B, P)
    _, probe = rm.decode(rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
                         active_sites=jnp.asarray(act), **rkw)
    u = np.sort(1.0 - np.asarray(probe["ramps"]["maxprob"]).reshape(-1))
    thr = np.full(len(act), 0.5 * (u[1] + u[2]), np.float32)
    valid = np.array([True, True, False])
    rc, (rl, rmp, fl, ex, nd) = rm.decode_multi(
        rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32), 4, n_max=4,
        active_sites=jnp.asarray(act), thresholds=jnp.asarray(thr),
        row_valid=jnp.asarray(valid), **rkw)
    tc, (tl, tmp, tfl, tex, tnd) = tm.decode_multi(
        tp, tc, _t(tok).long(), _t(pos), 4, n_max=4, active_sites=act, thresholds=_t(thr),
        row_valid=_t(valid), **tkw)
    nd = int(nd)
    assert int(tnd) == nd and 1 <= nd <= 4
    assert (np.asarray(ex)[:nd] >= 0).any()  # some rows exit
    np.testing.assert_array_equal(tl.numpy()[:nd], np.asarray(rl)[:nd])
    _close(tmp.numpy()[:nd], np.asarray(rmp)[:nd])
    np.testing.assert_array_equal(tfl.numpy()[:nd], np.asarray(fl)[:nd])
    np.testing.assert_array_equal(tex.numpy()[:nd], np.asarray(ex)[:nd])
    for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):
        _close(a, b)


# -- the loss ----------------------------------------------------------------------------


def test_loss_and_grads_equal_reference():
    """``loss`` with padding labels: the value, its metrics and every leaf's
    gradient (the gates and ``frontend_proj`` among them) against
    ``jax.value_and_grad`` of the reference's; the ramp heads' gradients
    reach no backbone leaf through the stopped pooled hidden."""
    rm, tm = _ref(), _port()
    p = _weights(seed=1)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labels[0, 3] = labels[1, -1] = -1
    fr = _frames(24, seed=5, n=2)

    def f(params):
        return rm.loss(params, {"frames": jnp.asarray(fr), "tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)})

    (rl, rmet), rg = jax.value_and_grad(f, has_aux=True)(jax.tree.map(jnp.asarray, p))
    tp = from_numpy_params(p, "cpu")
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    tl, tmet = tm.loss(tp, {"frames": _t(fr), "tokens": _t(toks), "labels": _t(labels)})
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(rl), rtol=1e-5)
    for k in rmet:
        np.testing.assert_allclose(float(tmet[k].detach()), float(rmet[k]), rtol=1e-5,
                                   atol=1e-6)
    rleaves = jax.tree.leaves(rg)
    assert len(rleaves) == len(tg) == len(leaves)
    for name in ("frontend_proj", "gate"):
        i = next(i for i, q in enumerate(_paths(tp)) if q.endswith(f"['{name}']"))
        assert np.abs(np.asarray(rleaves[i])).min() > 0  # the branch takes part
    for i, (a, b) in enumerate(zip(rleaves, tg)):
        b = np.zeros(np.shape(a), np.float32) if b is None else b.numpy()
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5, err_msg=f"leaf {i}")


# -- the kernel switches on the CPU ------------------------------------------------------


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_kernel_switches_match_plain_path(layout):
    """``prefill_attn='kernel'``, ``decode_attn`` 'kernel' / 'paged-kernel'
    and ``pallas_head='kernel'`` (their plain versions on CPU tensors)
    against the plain path (sdpa, the dense masked decode or the plain
    paged walk, the dense heads): a prefill and 3 decode steps with exit
    bits, records within 1e-5, labels and exits exact."""
    paged = layout == "paged"
    M = 20
    _, tp = _both()
    on = _port(M, decode_attn="paged-kernel" if paged else "kernel")
    off = _port(M, prefill_attn="sdpa", pallas_head="off",
                decode_attn="paged" if paged else "dense")
    fr, toks = _frames(M), _tokens()
    act = list(on.sites)
    c_on, o_on = on.prefill(tp, _t(fr), _t(toks[:, :P]), cache_len=CL, active_sites=act)
    c_off, o_off = off.prefill(tp, _t(fr), _t(toks[:, :P]), cache_len=CL, active_sites=act)
    for k in ("final", "ramps"):
        _check_stats(o_on[k], {q: v.numpy() for q, v in o_off[k].items()},
                     ("label", "maxprob", "entropy"), TOL)
    kw = {}
    if paged:
        c_on, tables = _pool(on, c_on, np.random.default_rng(3))
        c_off = {k: v.clone() for k, v in c_on.items() if k != "xkv"}
        c_off["xkv"] = {k: v.clone() for k, v in c_on["xkv"].items()}
        kw["block_tables"] = _t(tables)
    tok = _t(toks[:, P:]).long()
    thr = torch.full((len(act),), 0.99)
    for t in range(3):
        pos = torch.full((B,), P + t)
        _, a = on.decode(tp, c_on, tok, pos, active_sites=act, exit_thresholds=thr, **kw)
        _, b = off.decode(tp, c_off, tok, pos, active_sites=act, exit_thresholds=thr, **kw)
        for k in ("final", "ramps"):
            keys = ("label", "maxprob", "entropy") + (("exit",) if k == "ramps" else ())
            _check_stats(a[k], {q: v.numpy() for q, v in b[k].items()}, keys, TOL)
        tok = a["final"]["label"].reshape(-1, 1).long()
    for x, y in zip(tree_leaves(c_on), tree_leaves(c_off)):
        _close(x.numpy(), y.numpy(), TOL)


def test_build_model_builds_encdec_and_refuses_other_ramp_styles():
    from repro_torch.configs import get_config  # repro: allow[tier1-deps] — the port under test
    from repro_torch.models.encdec import EncDecLM  # repro: allow[tier1-deps] — the port under test

    model = build_model(get_config(ARCH))
    assert isinstance(model, EncDecLM) and len(model.sites) == 23
    with pytest.raises(NotImplementedError):
        build_model(port_tiny(ARCH).replace(ramp_style="mlp"))
    with pytest.raises(ValueError):
        _port(prefill_attn="flash")
