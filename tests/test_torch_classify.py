"""The port's classification workloads against the JAX package's at tiny
sizes, on bridged (perturbed) weights: the ResNet's SAME-padded
convolutions, GroupNorm and forward (f32, 1e-4), BERT's encoder through
sdpa and through the flash-attention kernel's plain version (1e-4), and
the ``ClassifierRunner`` / ``LMTokenRunner`` records (labels exact except
near-ties, uncertainty within 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.serving as RS  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.core.ramps import describe as ref_describe  # noqa: E402
from repro.data import make_image_stream, make_token_stream  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import resnet as ref_resnet  # noqa: E402

import repro_torch.serving as TS  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.core.ramps import describe  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import resnet as port_resnet  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params  # noqa: E402  # repro: allow[tier1-deps] — the port under test

TOL = dict(rtol=1e-4, atol=1e-4)
UNC_TOL = dict(rtol=0, atol=1e-5)
NEAR_TIE = 1e-4  # a top-2 logit gap under this may order the two labels either way


def _perturbed(rm, seed):
    """The reference's init, every leaf perturbed so zero-initialized biases
    and unit norms take part; (jax tree, numpy tree)."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        rm.init(jax.random.PRNGKey(seed)))
    return jax.tree.map(jnp.asarray, p), p


def _labels_agree(t, r, logits_r, what):
    """Labels equal, except where the reference's top-2 logits lie within
    NEAR_TIE (such a near-tie is named, never passed over silently).
    Returns the number of near-ties."""
    t, r = np.asarray(t), np.asarray(r)
    bad = np.argwhere(t != r)
    for idx in bad:
        top2 = np.sort(np.asarray(logits_r)[tuple(idx)])[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, f"{what}: label differs at {idx} off a near-tie"
        print(f"{what}: labels differ at {tuple(idx)}, a near-tie (gap {top2[1] - top2[0]:.2e})")
    return len(bad)


def _check_outs(to, ro, what):
    np.testing.assert_allclose(to["final_logits"].numpy(), np.asarray(ro["final_logits"]),
                               err_msg=what, **TOL)
    _labels_agree(to["final"]["label"], ro["final"]["label"], ro["final_logits"], what)
    for k in ("maxprob", "entropy"):
        np.testing.assert_allclose(to["final"][k].numpy(), np.asarray(ro["final"][k]),
                                   err_msg=f"{what} final {k}", **TOL)
    if "ramps" not in ro:
        assert "ramps" not in to
        return
    np.testing.assert_allclose(to["ramp_logits"].numpy(), np.asarray(ro["ramp_logits"]),
                               err_msg=what, **TOL)
    _labels_agree(to["ramps"]["label"], ro["ramps"]["label"], ro["ramp_logits"], what)
    for k in ("maxprob", "entropy"):
        np.testing.assert_allclose(to["ramps"][k].numpy(), np.asarray(ro["ramps"][k]),
                                   err_msg=f"{what} ramps {k}", **TOL)


# -- the ResNet's pieces --------------------------------------------------------


@pytest.mark.parametrize("size", [16, 15])  # even and odd: SAME pads (0, 1) vs (1, 1)
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_same_padding_conv_matches_reference(k, stride, size):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 7)).astype(np.float32)
    ref = np.asarray(ref_resnet.conv(jnp.asarray(x), jnp.asarray(w), stride))
    out = port_resnet.conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w), stride)
    assert out.shape[2:] == ref.shape[1:3]
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [16, 15])
def test_strided_identity_shortcut_is_the_reference_eye_conv(size):
    x = np.random.default_rng(size).standard_normal((2, size, size, 6)).astype(np.float32)
    ref = np.asarray(ref_resnet.conv(jnp.asarray(x), jnp.eye(6)[None, None], 2))
    out = port_resnet.shortcut(torch.from_numpy(x).permute(0, 3, 1, 2), {}, 2)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("C", [16, 12, 3])  # 8 groups; 12 -> 6 groups; 3 -> 3 groups
def test_group_norm_matches_reference(C):
    rng = np.random.default_rng(C)
    x = (3.0 + rng.standard_normal((2, 5, 5, C))).astype(np.float32)
    p = {"w": rng.standard_normal(C).astype(np.float32),
         "b": rng.standard_normal(C).astype(np.float32)}
    ref = np.asarray(ref_resnet.group_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p)))
    out = port_resnet.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)


# -- whole models -----------------------------------------------------------------

# TINY as published (one ramp site), and a deeper variant (two blocks a stage:
# identity shortcuts at stride 1, three sites) for an unsorted subset
RESNET_VARIANTS = {"all": ({}, "all"), "none": ({}, None),
                   "deep-subset": (dict(resnet_blocks=(2, 2), n_layers=4), [2, 0])}


@pytest.mark.parametrize("variant", list(RESNET_VARIANTS))
@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_forward_matches_reference(arch, size, variant):
    repl, act = RESNET_VARIANTS[variant]
    rm = ref_build(get_tiny(arch).replace(img_size=size, **repl))
    tm = build_model(port_tiny(arch).replace(img_size=size, **repl))
    assert tm.sites == rm.sites and tm.block_widths == rm.block_widths
    rp, p = _perturbed(rm, seed=size)
    act = list(rm.sites) if act == "all" else act
    x = np.random.default_rng(1).standard_normal((3, size, size, 3)).astype(np.float32)
    ro = rm.forward(rp, jnp.asarray(x), active_sites=act)
    to = tm.forward(from_numpy_params(p, "cpu"), torch.from_numpy(x), active_sites=act)
    _check_outs(to, ro, f"{arch} {size} {variant}")


@pytest.mark.parametrize("act", [None, [0, 1, 2], [2, 0]], ids=["none", "all", "unsorted"])
@pytest.mark.parametrize("prefill_attn", ["sdpa", "kernel"])
def test_encoder_forward_matches_reference(prefill_attn, act, monkeypatch):
    """BERT's encoder: the attention has no mask; 'kernel' runs the flash
    kernel's plain version on the CPU with causal=False, once a layer."""
    rm = ref_build(get_tiny("bert-base"))
    tm = build_model(port_tiny("bert-base"), prefill_attn=prefill_attn)
    rp, p = _perturbed(rm, seed=3)
    calls = []
    ref_attention = flash_ops.attention_ref

    def counting(q, k, v, *, causal=True, window=None):
        calls.append(causal)
        return ref_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(flash_ops, "attention_ref", counting)
    toks = np.random.default_rng(4).integers(0, rm.cfg.vocab_size, (3, 12))
    ro = rm.forward(rp, jnp.asarray(toks, jnp.int32), active_sites=act)
    to = tm.forward(from_numpy_params(p, "cpu"), torch.from_numpy(toks), active_sites=act)
    _check_outs(to, ro, f"bert {prefill_attn}")
    n_layers = rm.cfg.n_layers
    assert calls == ([False] * n_layers if prefill_attn == "kernel" else [])


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "bert-base", "qwen2-1.5b"])
def test_ramp_sites_match_reference(arch):
    rm, tm = ref_build(get_tiny(arch)), build_model(port_tiny(arch))
    assert tm.sites == rm.sites
    assert describe(tm) == ref_describe(rm)


# -- runners ----------------------------------------------------------------------


def _classifier_pair(arch, max_slots):
    rm = ref_build(get_tiny(arch))
    tm = build_model(port_tiny(arch), prefill_attn="kernel") if arch == "bert-base" \
        else build_model(port_tiny(arch))
    rp, p = _perturbed(rm, seed=5)
    if rm.cfg.family == "resnet":
        data = make_image_stream(40, img_size=rm.cfg.img_size, n_classes=rm.cfg.n_classes,
                                 seed=6).data
    else:
        data = make_token_stream(40, seq_len=12, vocab=rm.cfg.vocab_size,
                                 n_classes=rm.cfg.n_classes, seed=6).data
    return (rm, rp, RS.ClassifierRunner(rm, rp, data, max_slots=max_slots),
            TS.ClassifierRunner(tm, from_numpy_params(p, "cpu"), data, max_slots=max_slots))


def _lm_pair(arch, max_slots):
    rm = ref_build(get_tiny(arch))
    # the launcher's settings: the ramp-head and flash kernels (plain on CPU)
    tm = build_model(port_tiny(arch).replace(pallas_head="kernel"), prefill_attn="kernel")
    rp, p = _perturbed(rm, seed=7)
    data = np.random.default_rng(8).integers(1, rm.cfg.vocab_size, (40, 10)).astype(np.int32)
    return (rm, rp, RS.LMTokenRunner(rm, rp, data, max_slots=max_slots),
            TS.LMTokenRunner(tm, from_numpy_params(p, "cpu"), data, max_slots=max_slots))


def _ref_logits(rm, rp, runner, items, act):
    """The reference classifier's (ramp logits (K, B, C), final logits (B,
    C)) of the items, for naming a near-tie."""
    outs = rm.forward(rp, jnp.asarray(runner.data[items]), active_sites=act)
    return outs.get("ramp_logits"), outs["final_logits"]


def _lm_logits(runner, items, act):
    """An LM runner's f32 (ramp logits (K, B, V), final logits (B, V)) at the
    last position through the port's dense path, for naming a near-tie."""
    from repro_torch.models import layers as LY  # repro: allow[tier1-deps] — the port under test
    from repro_torch.models.transformer import _mask_pad_vocab  # repro: allow[tier1-deps] — the port under test

    m, p = runner.model, runner.params
    toks = torch.from_numpy(runner.data[items])
    S = toks.shape[1]
    pos = torch.arange(S)[None, :]
    h = LY.embed_apply(m.cfg, p["tok"], toks, pos)
    h, pooled = m._stack(p, h, positions=pos, mask=LY.causal_mask(S, S, 0), caches=None,
                         cache_index=0, pool_idx=slice(S - 1, S))
    hf = LY.apply_norm(m.cfg, p["final_norm"], h[:, -1:])
    final = _mask_pad_vocab(m.cfg, LY.unembed(m.cfg, p["tok"], hf)[:, 0].float())
    ramps = _mask_pad_vocab(m.cfg, m.ramp_outputs(p, pooled, sorted(act))[:, :, 0])
    return ramps.numpy(), final.numpy()


def _same_records(t, r, what, logits):
    (tl, tu, tf), (rl, ru, rf) = t, r
    assert tl.shape == np.shape(rl) and tu.shape == np.shape(ru) and tf.shape == np.shape(rf)
    assert tu.dtype == np.float32
    if (np.asarray(tl) != np.asarray(rl)).any() or (tf != np.asarray(rf)).any():
        ramp_logits, final_logits = logits()
        _labels_agree(tl, rl, ramp_logits, f"{what} ramps")
        _labels_agree(tf, rf, final_logits, f"{what} final")
    np.testing.assert_allclose(tu, np.asarray(ru), err_msg=what, **UNC_TOL)


@pytest.mark.parametrize("arch", ["resnet18", "bert-base"])
def test_classifier_runner_matches_reference(arch):
    """Records of unsorted and empty active sets, in buckets 1-8, the
    max_slots error, ``vanilla_labels`` and the variant counters."""
    max_slots = 1 if arch == "resnet18" else 2
    rm, rp, ref, port = _classifier_pair(arch, max_slots)
    n_sites = len(rm.sites)
    calls = [(np.array([5, 3, 9]), list(reversed(range(min(n_sites, max_slots))))),
             (np.array([0]), []), (np.arange(8), [n_sites - 1]), (np.array([7, 2, 4]), []),
             (np.array([5, 3, 9]), sorted(range(min(n_sites, max_slots))))]
    for items, act in calls:
        r, t = ref.infer(items, act), port.infer(items, act)
        _same_records(t, r, f"{arch} {items} {act}",
                      lambda: _ref_logits(rm, rp, ref, np.asarray(items), sorted(act)))
        assert (port.compiles, port.noramp_compiles) == (ref.compiles, ref.noramp_compiles)
    with pytest.raises(ValueError):
        port.infer(np.arange(4), list(range(max_slots + 1)))
    assert (port.compiles, port.noramp_compiles) == (ref.compiles, ref.noramp_compiles)
    assert port.vanilla_labels(0).shape == (0,) and port.vanilla_labels(0).dtype == np.int64
    full = port.vanilla_labels()
    np.testing.assert_array_equal(full, ref.vanilla_labels())
    np.testing.assert_array_equal(port.vanilla_labels(5), full[:5])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gpt2-medium"])
def test_lm_token_runner_matches_reference(arch):
    """Next-token records through the ramp-head and flash kernels' plain
    versions against the reference's dense path: unsorted and empty active
    sets, the max_slots error and ``vanilla_labels``."""
    rm, rp, ref, port = _lm_pair(arch, max_slots=3)
    n_sites = len(rm.sites)
    act = list(reversed(range(min(n_sites, 3))))
    for items, a in ((np.arange(6), act), (np.array([3, 1]), []), (np.array([9]), [0]),
                     (np.arange(6), sorted(act))):
        r, t = ref.infer(items, a), port.infer(items, a)
        _same_records(t, r, f"{arch} {items} {a}", lambda: _lm_logits(port, items, a))
    l_a, u_a, f_a = port.infer(np.arange(6), act)
    l_b, u_b, f_b = port.infer(np.arange(6), sorted(act))
    np.testing.assert_array_equal(l_a, l_b)
    np.testing.assert_array_equal(u_a, u_b)
    with pytest.raises(ValueError):
        port.infer(np.arange(4), [0, 1, 2, 3])
    assert port.vanilla_labels(0).shape == (0,) and port.vanilla_labels(0).dtype == np.int64
    np.testing.assert_array_equal(port.vanilla_labels(20), ref.vanilla_labels(20))
