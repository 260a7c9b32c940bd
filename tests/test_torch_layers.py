"""The port's layers against `repro.models.layers` on the same numpy inputs
(fp32, tolerance 1e-5 per op)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_tiny  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.models import layers as TL  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params  # noqa: E402  # repro: allow[tier1-deps] — the port under test

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen2-1.5b", "gpt2-medium"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


def _params(schema_fn, cfg, seed):
    from repro.models.common import init_from_schema

    p = init_from_schema(schema_fn(cfg), jax.random.PRNGKey(seed))
    # zero-init biases/norms would hide a mistake: perturb every leaf
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32), p)
    return p, from_numpy_params(p, "cpu")


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_norms(norm):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    if norm == "rms":
        _close(TL.rms_norm(_t(x), _t(w)), RL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    else:
        _close(TL.layer_norm(_t(x), _t(w), _t(b)),
               RL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_act_fn(act):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(TL.act_fn(act)(_t(x)), RL.act_fn(act)(jnp.asarray(x)))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    pos = np.array([[0, 3, 17, 40]], np.int32)
    x = rng.standard_normal((2, 4, 3, 16)).astype(np.float32)
    s_t, c_t = TL.rope_sincos(_t(pos), 16, theta)
    s_r, c_r = RL.rope_sincos(jnp.asarray(pos), 16, theta)
    _close(s_t, s_r)
    _close(c_t, c_r)
    _close(TL.apply_rope(_t(x), s_t, c_t), RL.apply_rope(jnp.asarray(x), s_r, c_r))


@pytest.mark.parametrize("arch", ARCHS)
def test_ffn(arch):
    cfg = get_tiny(arch)
    rp, tp = _params(lambda c: RL.ffn_schema(c, c.d_ff), cfg, 2)
    x = np.random.default_rng(2).standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    _close(TL.ffn_apply(port_tiny(arch), tp, _t(x)),
           RL.ffn_apply(cfg, rp, jnp.asarray(x), RL.TEST_AXES))


@pytest.mark.parametrize("K", [4, 2, 1])
def test_sdpa_gqa_with_mask(K):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, K, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, K, 8)).astype(np.float32)
    _close(TL.sdpa(_t(q), _t(k), _t(v), TL.causal_mask(3, 6, 2)),
           RL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), RL.causal_mask(3, 6, 2)))


def test_causal_mask():
    np.testing.assert_array_equal(TL.causal_mask(4, 7, 3).numpy(),
                                  np.asarray(RL.causal_mask(4, 7, 3)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["dense", "ref"])
def test_attn_prefill_then_per_row_decode(arch, impl):
    """Prefill writes the cache at 0, then one decode token per row at its
    own position; both outputs and the cache match."""
    cfg = get_tiny(arch)
    pcfg = port_tiny(arch)
    rp, tp = _params(RL.gqa_schema, cfg, 4)
    rng = np.random.default_rng(4)
    B, S, C, K, hd = 3, 5, 9, cfg.n_kv_heads, cfg.hd
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cache = {"k": np.zeros((B, C, K, hd), np.float32), "v": np.zeros((B, C, K, hd), np.float32)}
    pos = np.arange(S)[None, :]
    r_out, r_cache = RL.attn_apply(cfg, rp, jnp.asarray(x), positions=jnp.asarray(pos),
                                   mask=RL.causal_mask(S, C, 0), axes=RL.TEST_AXES,
                                   cache=jax.tree.map(jnp.asarray, cache), cache_index=0)
    t_cache = {k: _t(v.copy()) for k, v in cache.items()}
    t_out, t_cache = TL.attn_apply(pcfg, tp, _t(x), positions=_t(pos),
                                   mask=TL.causal_mask(S, C, 0), cache=t_cache, cache_index=0)
    _close(t_out, r_out)
    for k in ("k", "v"):
        _close(t_cache[k], r_cache[k])
    # decode: rows at staggered positions (a stale row would attend garbage)
    rows_pos = np.array([5, 7, 6], np.int32)
    xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    dmask = (np.arange(C)[None, :] <= rows_pos[:, None])[:, None, None, :]
    r_out, r_cache = RL.attn_apply(cfg, rp, jnp.asarray(xd), positions=jnp.asarray(rows_pos[:, None]),
                                   mask=jnp.asarray(dmask), axes=RL.TEST_AXES, cache=r_cache,
                                   cache_index=jnp.asarray(rows_pos), decode_impl=impl)
    t_out, t_cache = TL.attn_apply(pcfg, tp, _t(xd), positions=_t(rows_pos[:, None]).long(),
                                   mask=_t(dmask), cache=t_cache,
                                   cache_index=_t(rows_pos).long(), decode_impl=impl)
    _close(t_out, r_out)
    for k in ("k", "v"):
        _close(t_cache[k], r_cache[k])


def test_gated_cache_write_keeps_old_rows():
    cache = torch.zeros(2, 4, 1, 2)
    new = torch.ones(2, 1, 1, 2)
    TL._update_cache_rows(cache, new, torch.tensor([1, 3]), torch.tensor(False))
    assert cache.abs().sum() == 0
    TL._update_cache_rows(cache, new, torch.tensor([1, 3]), torch.tensor(True))
    assert cache[0, 1].sum() == 2 and cache[1, 3].sum() == 2 and cache.sum() == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_unembed(arch):
    cfg = get_tiny(arch)
    rp, tp = _params(RL.embed_schema, cfg, 5)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 6)).astype(np.int64)
    pos = np.arange(6)[None, :]
    h_r = RL.embed_apply(cfg, rp, jnp.asarray(toks), jnp.asarray(pos))
    h_t = TL.embed_apply(port_tiny(arch), tp, _t(toks), _t(pos))
    _close(h_t, h_r)
    _close(TL.unembed(port_tiny(arch), tp, h_t), RL.unembed(cfg, rp, h_r), dict(rtol=1e-5, atol=1e-6))
