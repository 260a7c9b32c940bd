"""The port's kernel packages: plain versions against the JAX package's refs
and its Pallas kernels in interpret mode (fp32, 1e-5), and the dispatch
rules. The CUDA kernels themselves are tested on the card by
`test_torch_gpu.py`."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.decode_attention import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.ramp_head import (  # noqa: E402
    ramp_head_exit as pallas_exit,
    ramp_head_exit_ref as jax_exit_ref,
    ramp_head_stats as pallas_stats,
    ramp_head_stats_ref as jax_stats_ref,
    stats_to_confidence as jax_conf,
)
from repro_torch.kernels import build  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.kernels.decode_attention import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    attend_decode,
    decode_attention,
    decode_attention_ref,
)
from repro_torch.kernels.ramp_head import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    ramp_confidence,
    ramp_exit_decision,
    ramp_head_exit,
    ramp_head_exit_ref,
    ramp_head_stats,
    ramp_head_stats_ref,
    stats_to_confidence,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qkv(B, H, KH, S, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    # the cache in its (B, S, KH, hd) storage; the kernel API views it (B, KH, S, hd)
    k = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    return q, k, v


# -- decode attention ---------------------------------------------------------


@pytest.mark.parametrize("KH,pos", [(2, [0, 7, 19]), (4, [5, 5, 5]), (1, 11), (2, [25, 3, 0])])
def test_decode_ref_matches_jax_ref(KH, pos):
    q, k, v = _qkv(3, 4, KH, 20, 16, 0)
    kt, vt = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    ref = jax_decode_ref(jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(pos))
    pos_t = _t(np.asarray(pos, np.int64))
    # strided (B, KH, S, hd) views of the (B, S, KH, hd) storage, as the model passes them
    out = decode_attention_ref(_t(q), _t(k).transpose(1, 2), _t(v).transpose(1, 2), pos_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    out2 = attend_decode(_t(q), _t(k).transpose(1, 2), _t(v).transpose(1, 2), pos_t)
    np.testing.assert_array_equal(out2.numpy(), out.numpy())


def test_decode_ref_matches_pallas_interpret_ragged_tile():
    """Per-row pos, GQA (G=2), and S=20 not divisible by the 8-key tile."""
    q, k, v = _qkv(3, 4, 2, 20, 16, 1)
    pos = np.array([0, 9, 19], np.int32)
    kt, vt = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    got = pallas_decode(jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(pos),
                        block_s=8, interpret=True)
    out = decode_attention_ref(_t(q), _t(k).transpose(1, 2), _t(v).transpose(1, 2),
                               _t(pos.astype(np.int64)))
    np.testing.assert_allclose(out.numpy(), np.asarray(got), **TOL)


# -- ramp head ----------------------------------------------------------------


def _hw(B, d, V, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, d)).astype(np.float32),
            (0.3 * rng.standard_normal((d, V))).astype(np.float32))


@pytest.mark.parametrize("layout", ["d_by_V", "embed_T"])
def test_ramp_stats_ref_matches_jax_ref(layout):
    h, w = _hw(5, 32, 96, 2)
    ref = jax_stats_ref(jnp.asarray(h), jnp.asarray(w))
    # the tied head arrives as embed.T: a (d, V) view contiguous along d
    wt = _t(np.ascontiguousarray(w.T)).T if layout == "embed_T" else _t(w)
    got = ramp_head_stats_ref(_t(h), wt)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for g, r in zip(stats_to_confidence(*got), jax_conf(*ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("layout", ["d_by_V", "embed_T"])
def test_ramp_refs_match_pallas_interpret_with_v_limit(layout):
    h, w = _hw(4, 32, 256, 3)
    thr = np.array([0.2, 0.95, 0.999, 0.0], np.float32)
    kw = dict(block_b=4, block_v=64, interpret=True, v_limit=200)
    st = pallas_stats(jnp.asarray(h), jnp.asarray(w), **kw)
    ex = pallas_exit(jnp.asarray(h), jnp.asarray(w), jnp.asarray(thr), **kw)
    wt = _t(np.ascontiguousarray(w.T)).T if layout == "embed_T" else _t(w)
    got_s = ramp_head_stats_ref(_t(h), wt, 200)
    got_e = ramp_head_exit_ref(_t(h), wt, _t(thr), 200)
    for g, r in zip(got_s[:3], st[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    np.testing.assert_array_equal(got_s[3].numpy(), np.asarray(st[3]))
    assert int(got_s[3].max()) < 200  # masked pad columns never win
    for g, r in zip(got_e, ex):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert 0 < int(got_e[4].sum()) < 4  # both exit values occur


def test_exit_boundary_is_strict():
    """thr == unc must not exit; the next float up must (both packages)."""
    h, w = _hw(3, 16, 64, 4)
    _, s, _, _ = ramp_head_stats_ref(_t(h), _t(w))
    unc = (1.0 - 1.0 / s).numpy().astype(np.float32)
    up = np.nextafter(unc, np.float32(np.inf)).astype(np.float32)
    assert (ramp_head_exit_ref(_t(h), _t(w), _t(unc))[4] == 0).all()
    assert (ramp_head_exit_ref(_t(h), _t(w), _t(up))[4] == 1).all()
    _, js, _, _ = jax_stats_ref(jnp.asarray(h), jnp.asarray(w))
    junc = np.asarray(1.0 - 1.0 / js, np.float32)
    jup = np.nextafter(junc, np.float32(np.inf)).astype(np.float32)
    assert (np.asarray(jax_exit_ref(jnp.asarray(h), jnp.asarray(w), jnp.asarray(junc))[4]) == 0).all()
    assert (np.asarray(jax_exit_ref(jnp.asarray(h), jnp.asarray(w), jnp.asarray(jup))[4]) == 1).all()


def test_ops_records_on_cpu():
    h, w = _hw(3, 16, 64, 5)
    thr = _t(np.array([0.5, 0.99, 0.0], np.float32))
    conf = ramp_confidence(_t(h), _t(w), v_limit=60)
    dec = ramp_exit_decision(_t(h), _t(w), thr, v_limit=60)
    for k in ("label", "maxprob", "entropy", "lse"):
        np.testing.assert_array_equal(conf[k].numpy(), dec[k].numpy())
    lg = (_t(h) @ _t(w))[:, :60]
    np.testing.assert_array_equal(conf["label"].numpy(), lg.argmax(-1).numpy())
    np.testing.assert_allclose(conf["maxprob"].numpy(), torch.softmax(lg, -1).max(-1).values.numpy(),
                               **TOL)
    assert int(dec["exit"][2]) == 0  # a zero threshold never fires


# -- the bf16 kernel's key ranges -------------------------------------------------


@pytest.mark.parametrize("n_sm", [132, 1])
@pytest.mark.parametrize("B,KH", [(1, 1), (8, 2), (32, 2), (200, 2), (3, 16)])
@pytest.mark.parametrize("keys", [1, 17, 162, 1000, 4096, 65536])
def test_decode_splits_whole_tiles_fill_the_card(n_sm, B, KH, keys):
    """decode_splits is a pure function of static shapes: ranges of whole
    16-key tiles, none past the last tile, at least DECODE_RANGE_TILES tiles
    a range where there is more than one, and about DECODE_WAVES waves of
    CTAs (within the 0.8 that equal whole-tile ranges lose) wherever the
    tiles allow them."""
    from repro_torch.kernels.decode_attention.kernel import (  # repro: allow[tier1-deps] — the port under test
        DECODE_CTAS_PER_SM,
        DECODE_MAX_SPLITS,
        DECODE_RANGE_TILES,
        DECODE_TILE,
        DECODE_WAVES,
        decode_splits,
    )

    for hd, ctas in DECODE_CTAS_PER_SM.items():  # the CTAs an SM of each head width
        s = decode_splits(n_sm, B, KH, keys, hd)
        tiles = -(-keys // DECODE_TILE)
        per = -(-tiles // s)  # tiles a range; the kernel's chunk is per * DECODE_TILE keys
        assert 1 <= s <= min(tiles, DECODE_MAX_SPLITS) and (s - 1) * per < tiles
        assert s == 1 or per >= DECODE_RANGE_TILES
        target = DECODE_WAVES * n_sm * ctas
        allowed = min(target,
                      B * KH * max(1, min(tiles // DECODE_RANGE_TILES, DECODE_MAX_SPLITS)))
        assert B * KH * s >= 0.8 * allowed
        assert s == 1 or B * KH * (s - 1) < target  # no more ranges than the target needs
        assert decode_splits(n_sm, B, KH, keys, hd) == s
    assert decode_splits(n_sm, B, KH, keys) == decode_splits(n_sm, B, KH, keys, 128)


# -- the paged MLA kernel's key ranges --------------------------------------------


@pytest.mark.parametrize("n_sm", [132, 16])
@pytest.mark.parametrize("B", [1, 8, 32, 400])
@pytest.mark.parametrize("keys", [16, 160, 4096, 65536])
@pytest.mark.parametrize("ctas_per_sm", [1, 2])
def test_mla_splits_whole_tiles_fill_the_card(n_sm, B, keys, ctas_per_sm):
    """mla_splits is a pure function of static shapes: ranges of whole
    32-key tiles, none empty, at most MLA_MAX_SPLITS, and about MLA_WAVES
    waves of CTAs (within the half that equal whole-tile ranges can lose)
    wherever the tiles allow them, and at least one wave."""
    from repro_torch.kernels.decode_attention.kernel import (  # repro: allow[tier1-deps] — the port under test
        MLA_MAX_SPLITS,
        MLA_TILE,
        MLA_WAVES,
        mla_splits,
    )

    s = mla_splits(n_sm, B, keys, ctas_per_sm)
    tiles = -(-keys // MLA_TILE)
    per = -(-tiles // s)  # tiles a range; the kernel's chunk is per * MLA_TILE keys
    assert 1 <= s <= min(tiles, MLA_MAX_SPLITS) and (s - 1) * per < tiles <= s * per
    wave = n_sm * ctas_per_sm
    allowed = min(MLA_WAVES * wave, B * min(tiles, MLA_MAX_SPLITS))
    assert B * s >= 0.5 * allowed and B * s >= min(wave, allowed)
    assert s == 1 or B * (s - 1) < MLA_WAVES * wave  # no more ranges than the target needs
    assert mla_splits(n_sm, B, keys, ctas_per_sm) == s


# -- dispatch rules -------------------------------------------------------------


def other_device(t):
    """``t``, reporting a device the dispatchers have no path for (they know
    the CPU, CUDA and meta, where a kernel's contract runs)."""
    class Other(torch.Tensor):
        @property
        def device(self):
            return torch.device("xpu")

    return t.as_subclass(Other)


def test_no_kernel_for_other_devices_and_no_silent_fallback():
    q, k, v = (other_device(torch.zeros(2, 4, 64)), other_device(torch.zeros(2, 2, 8, 64)),
               other_device(torch.zeros(2, 2, 8, 64)))
    with pytest.raises(ValueError):
        attend_decode(q, k, v, 3)
    with pytest.raises(ValueError):
        ramp_confidence(other_device(torch.zeros(2, 8)), other_device(torch.zeros(8, 16)))
    # meta runs the kernel's contract and computes nothing
    assert attend_decode(*(t.to("meta") for t in (torch.zeros(2, 4, 64),
                                                  torch.zeros(2, 2, 8, 64),
                                                  torch.zeros(2, 2, 8, 64))), 3).is_meta
    # the kernel wrappers take CUDA tensors only
    with pytest.raises(ValueError):
        decode_attention(torch.zeros(2, 4, 64), torch.zeros(2, 2, 8, 64),
                         torch.zeros(2, 2, 8, 64), 3)
    with pytest.raises(ValueError):
        ramp_head_stats(torch.zeros(2, 8), torch.zeros(8, 16))


def test_cuda_request_without_card_raises():
    """Without a card the kernels refuse to load, and the serving entry
    point, which defaults to the card, refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernels load instead")
    from repro_torch.launch.serve import serve_generative  # repro: allow[tier1-deps] — the port under test

    for name in build.SOURCES:
        with pytest.raises(RuntimeError):
            build.load(name)
    with pytest.raises(RuntimeError):
        serve_generative("qwen2-1.5b", 1, tiny=True, verbose=False)
