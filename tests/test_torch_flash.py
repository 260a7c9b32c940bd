"""The port's prefill attention against the JAX package's, at tiny shapes:
the plain flash version (``repro_torch.kernels.flash_attention``) against
the Pallas ``flash_attention`` in interpret mode and ``attention_ref``
(causal, sliding window, GQA, Sq != Sk); ``attn_apply`` with
``prefill_attn='kernel'`` against the reference's ``sdpa`` prefill; and
tiny qwen2 / gpt2 prefills with ``prefill_attn='kernel'`` (the plain version
on the CPU) against ``'sdpa'`` and against the reference.

Tolerance rule: one attention call within 1e-5 (f32); whole-model records
and caches within 1e-4; labels exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_tiny  # noqa: E402
from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.common import is_info  # noqa: E402

from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.kernels.flash_attention import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    attention,
    attention_ref,
    flash_attention,
)
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import layers as TL  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test

TOL = dict(rtol=1e-5, atol=1e-5)  # one attention call
REC_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model records and caches


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(B, H, KH, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, Sq, hd), (B, KH, Sk, hd), (B, KH, Sk, hd)))


# (B, H, KH, Sq, Sk, hd, causal, window): GQA, Sq < Sk (a prefill into a
# longer cache), Sq > Sk, MHA with a window, a window alone
CASES = [(2, 4, 2, 8, 8, 16, True, None), (1, 6, 2, 8, 16, 8, True, None),
         (1, 4, 1, 16, 8, 8, True, None), (2, 2, 2, 16, 16, 8, True, 4),
         (1, 4, 2, 8, 16, 16, False, 5), (1, 2, 1, 8, 8, 16, False, None)]


@pytest.mark.parametrize("case", CASES)
def test_plain_flash_matches_reference_ref(case):
    B, H, KH, Sq, Sk, hd, causal, window = case
    q, k, v = _qkv(B, H, KH, Sq, Sk, hd, sum(case[:6]))
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                            window=window)
    out = attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    same = attention(_t(q), _t(k), _t(v), causal=causal, window=window)  # CPU: plain
    np.testing.assert_array_equal(same.numpy(), out.numpy())


@pytest.mark.parametrize("case", CASES[:4])
def test_plain_flash_matches_pallas_interpret(case):
    """The Pallas kernel in interpret mode (its tiles must divide Sq and Sk:
    tiles of 8 here) against the port's dispatcher on CPU tensors."""
    B, H, KH, Sq, Sk, hd, causal, window = case
    q, k, v = _qkv(B, H, KH, Sq, Sk, hd, 7)
    got = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                       window=window, block_q=8, block_k=8, interpret=True)
    out = attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(got), **TOL)


def test_kernel_wrapper_never_takes_cpu_tensors():
    from test_torch_kernels import other_device  # repro: allow[tier1-deps] — the shared stand-in for a device with no path

    q, k, v = (_t(a) for a in _qkv(1, 2, 1, 4, 4, 8, 0))
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
    with pytest.raises(ValueError):
        attention(other_device(q), other_device(k), other_device(v))
    assert attention(q.to("meta"), k.to("meta"), v.to("meta")).is_meta  # the contract
    before = flash_attention.launches
    attention(q, k, v)  # CPU: the plain version, no launch counted
    assert flash_attention.launches == before


# -- attn_apply and the LM's prefill ------------------------------------------------


ARCHS = ["qwen2-1.5b", "gpt2-medium"]


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    sch = RL.gqa_schema(cfg)
    return jax.tree.map(lambda i: 0.3 * rng.standard_normal(i.shape).astype(np.float32), sch,
                        is_leaf=is_info)


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_apply_prefill_kernel_matches_reference_sdpa(arch):
    """A prompt of 5 written at cache index 0 of a 12-slot cache: the
    flash route equals the reference's masked sdpa; a later chunk (cache
    index 5) stays on sdpa, so 'kernel' and 'sdpa' give the same bits
    there."""
    cfg, tcfg = get_tiny(arch), port_tiny(arch)
    p = _attn_params(cfg, 1)
    rng = np.random.default_rng(2)
    B, S, C = 2, 5, 12
    K, hd = cfg.n_kv_heads, cfg.hd
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    rc = {"k": jnp.zeros((B, C, K, hd)), "v": jnp.zeros((B, C, K, hd))}
    ro, rc = RL.attn_apply(cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           positions=jnp.arange(S)[None], mask=RL.causal_mask(S, C, 0),
                           axes=RL.TEST_AXES, cache=rc, cache_index=0)
    tp = from_numpy_params(p, "cpu")
    x2 = rng.standard_normal((B, 3, cfg.d_model)).astype(np.float32)
    outs = {}
    for impl in ("kernel", "sdpa"):
        tc = {"k": torch.zeros(B, C, K, hd), "v": torch.zeros(B, C, K, hd)}
        to, tc = TL.attn_apply(tcfg, tp, _t(x), positions=torch.arange(S)[None],
                               mask=TL.causal_mask(S, C, 0), cache=tc, cache_index=0,
                               prefill_attn=impl)
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), **TOL)
        for kk in ("k", "v"):
            np.testing.assert_allclose(tc[kk].numpy(), np.asarray(rc[kk]), **TOL)
        o2, _ = TL.attn_apply(tcfg, tp, _t(x2), positions=5 + torch.arange(3)[None],
                              mask=TL.causal_mask(3, C, 5), cache=tc, cache_index=5,
                              prefill_attn=impl)
        outs[impl] = o2
    np.testing.assert_array_equal(outs["kernel"].numpy(), outs["sdpa"].numpy())


def _lm_pair(arch, seed=0):
    rm = ref_build(get_tiny(arch))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                     .astype(np.float32), rm.init(jax.random.PRNGKey(seed)))
    return rm, jax.tree.map(jnp.asarray, p), from_numpy_params(p, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("with_cache", [True, False])
def test_lm_prefill_kernel_matches_sdpa_and_reference(arch, with_cache):
    """Tiny LM prefill (B 3, prompt 9, cache 20) with prefill_attn='kernel'
    against 'sdpa' and against the reference: records (final + every ramp)
    and the cache."""
    rm, rp, tp = _lm_pair(arch)
    tcfg = port_tiny(arch).replace(pallas_head="kernel")
    toks = np.random.default_rng(3).integers(0, rm.cfg.vocab_size, (3, 9))
    act = list(range(len(rm.sites)))
    rc, ro = rm.prefill(rp, jnp.asarray(toks, jnp.int32), cache_len=20,
                        active_sites=jnp.asarray(act, jnp.int32), with_cache=with_cache)
    runs = {impl: build_model(tcfg, prefill_attn=impl).prefill(
        tp, _t(toks), cache_len=20, active_sites=act, with_cache=with_cache)
        for impl in ("kernel", "sdpa")}
    for tc, to in runs.values():
        for part in ("final", "ramps"):
            for kk in ("label", "maxprob", "entropy"):
                a = to[part][kk].numpy()
                b = np.asarray(ro[part][kk]).reshape(a.shape)
                if kk == "label":
                    np.testing.assert_array_equal(a, b, err_msg=kk)
                else:
                    np.testing.assert_allclose(a, b, err_msg=kk, **REC_TOL)
        if with_cache:
            for a, b in zip(tree_leaves(to_numpy(tc)), jax.tree.leaves(rc)):
                np.testing.assert_allclose(a, np.asarray(b), **REC_TOL)
        else:
            assert tc is None and rc is None


def test_prefill_attn_is_checked():
    with pytest.raises(ValueError):
        build_model(port_tiny("qwen2-1.5b"), prefill_attn="flash")
