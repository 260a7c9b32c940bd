"""The port's training path against the JAX package's, on the CPU at tiny
sizes, from bridged (perturbed) weights.

Tolerances:
- loss and every leaf's gradient (``jax.value_and_grad`` of the reference's
  ``loss``): rtol 1e-4, atol 1e-5 (whole fp32 tiny models; the two
  frameworks sum in other orders, ~1e-7 apart here);
- one optimizer update (AdamW, Adafactor) on the same trees: 1e-6; the
  cosine schedule: 1e-7;
- the first 5 losses and grad norms of ``train``: rtol 1e-4. Parameters
  after those 5 steps: every entry within 1e-3, and at most 10% of a
  model's entries beyond 1e-6. That is the Adam trap: Adam divides by
  sqrt(nu) + 1e-8, so an entry whose gradient is ~1e-8 (where the two
  frameworks' gradients differ by ~2e-8) can take its step with either
  sign, up to lr * lr_scale a step: 1e-3 x (0 + 1 + 2 + 3 + 4) / 20 =
  5e-4 over 5 steps, twice that apart. A key bias adds q . bk to every
  score of a query alike, which softmax cancels; a convolution feeding a
  GroupNorm of one channel a group has no gradient along what the norm
  removes. Measured: the LMs' entries within 1e-6 except their key biases
  (~2e-6); the ResNet in full training 7% of its entries beyond 1e-6, at
  most 8e-5, all in its convolutions and GroupNorms, while its gradients
  agree to 2e-8;
- ramp records of the 'mlp' and 'tied' styles (prefill, decode,
  decode_multi, the runner's windows; contiguous and paged) against the
  reference's dense head path (``pallas_head='off'``): maxprob and
  entropy 1e-4, labels, exit bits, exit sites and n_done exact;
- served responses on JAX-trained weights: identical (rid, label, exit
  site, release ms, dropped).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as RC  # noqa: E402
import repro.serving as RS  # noqa: E402
import repro.training as RT  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.data import TokenPipeline, make_image_stream, make_token_stream  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import repro_torch.core as TC  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
import repro_torch.serving as TS  # noqa: E402  # repro: allow[tier1-deps] — the port under test
import repro_torch.training as TT  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402  # repro: allow[tier1-deps] — the port under test

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
REC_TOL = dict(rtol=1e-4, atol=1e-4)


def _perturbed(rm, seed):
    """The reference's init, every leaf perturbed so zero-initialized biases
    and unit norms take part; (jax tree, numpy tree)."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        rm.init(jax.random.PRNGKey(seed)))
    return jax.tree.map(jnp.asarray, p), p


# (arch, cfg changes, the loss's keywords)
LM_CASES = [(a, {"ramp_style": s}, {}) for a in ("qwen2-1.5b", "gpt2-medium")
            for s in ("fc", "mlp", "tied")]
LM_CASES += [("deepseek-v2-lite-16b", {}, {"moe_impl": "dense"}),
             ("deepseek-v2-lite-16b", {}, {"moe_impl": "ep"}),
             ("mamba2-2.7b", {}, {})]


def _lm_batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    labels[0, 3] = labels[1, -1] = -1  # padding labels
    return {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}


def _cls_batch(arch, cfg, B=4, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.n_classes, B).astype(np.int32)
    if arch == "resnet18":
        x = rng.standard_normal((B, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
        return {"images": x, "labels": labels}
    return {"tokens": rng.integers(1, cfg.vocab_size, (B, 16)).astype(np.int32),
            "labels": labels}


def _grads_both(rm, rp, tm, tp, batch, rkw, tkw):
    def f(params):
        return rm.loss(params, {k: jnp.asarray(v) for k, v in batch.items()}, **rkw)

    (rl, rmet), rg = jax.value_and_grad(f, has_aux=True)(rp)
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    tl, tmet = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, **tkw)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    for x in leaves:
        x.requires_grad_(False)
    return (rl, rmet, rg), (tl, tmet, tg)


def _check_grads(ref, port, what):
    (rl, rmet, rg), (tl, tmet, tg) = ref, port
    np.testing.assert_allclose(float(tl.detach()), float(rl), rtol=1e-5, err_msg=what)
    assert set(tmet) == set(rmet)
    for k in rmet:
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what} {k}")
    rleaves = jax.tree.leaves(rg)
    assert len(rleaves) == len(tg)
    for i, (a, b) in enumerate(zip(rleaves, tg)):
        b = np.zeros(np.shape(a), np.float32) if b is None else b.numpy()
        np.testing.assert_allclose(b, np.asarray(a), err_msg=f"{what} leaf {i}", **GRAD_TOL)
    return rleaves


@pytest.mark.parametrize("mode", ["full", "ramps_only"])
@pytest.mark.parametrize("arch,changes,kw", LM_CASES)
def test_lm_loss_and_grads_match_reference(arch, changes, kw, mode):
    """Loss, its metrics and every leaf's gradient of ``LM.loss`` (padding
    labels, the padded vocab, the ramp positions, stop-grad ramp features);
    in 'ramps_only' only the ramps (and a 'tied' ramp's final head) get a
    non-zero gradient."""
    rm = ref_build(get_tiny(arch).replace(**changes))
    tm = build_model(port_tiny(arch).replace(**changes))
    rp, p = _perturbed(rm, 0)
    batch = _lm_batch(rm.cfg)
    ref, port = _grads_both(rm, rp, tm, from_numpy_params(p, "cpu"), batch,
                            {"train_mode": mode, **kw}, {"train_mode": mode, **kw})
    rg = _check_grads(ref, port, f"{arch} {changes} {kw} {mode}")
    if mode == "ramps_only":  # the backbone's gradient is zero in both
        flat = jax.tree_util.tree_flatten_with_path(ref[2])[0]
        for path, g in flat:
            keys = [getattr(k, "key", None) for k in path]
            tied_head = changes.get("ramp_style") == "tied" and keys[:1] == ["tok"] and \
                keys[1] in ("embed", "lm_head")
            if "ramps" not in keys and not tied_head:
                assert not np.asarray(g).any(), keys
    assert len(rg) == len(tree_leaves(tm.schema()))


def test_lm_loss_remat_changes_no_number():
    cfg = port_tiny("deepseek-v2-lite-16b")
    tm = build_model(cfg)
    rm = ref_build(get_tiny("deepseek-v2-lite-16b"))
    _, p = _perturbed(rm, 1)
    batch = _lm_batch(cfg, seed=1)
    outs = []
    for remat in (False, True):
        ref, port = _grads_both(rm, jax.tree.map(jnp.asarray, p), tm,
                                from_numpy_params(p, "cpu"), batch, {"moe_impl": "ep"},
                                {"moe_impl": "ep", "remat": remat})
        outs.append(port)
    (l0, _, g0), (l1, _, g1) = outs
    assert float(l0) == float(l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_lm_loss_reaches_no_kernel(monkeypatch):
    """The loss runs through sdpa, ssd_ref and the dense ramp outputs on a
    model built to serve through the kernels: no kernel dispatcher is
    called."""
    import repro_torch.kernels.flash_attention as FA  # repro: allow[tier1-deps] — the port under test
    import repro_torch.kernels.ramp_head as RH  # repro: allow[tier1-deps] — the port under test
    import repro_torch.kernels.ssd.ops as SO  # repro: allow[tier1-deps] — the port under test

    def boom(*a, **k):
        raise AssertionError("a kernel dispatcher ran inside the loss")

    for mod, name in ((FA, "attention"), (RH, "ramp_confidence"),
                      (RH, "ramp_exit_decision"), (SO, "ssd")):
        monkeypatch.setattr(mod, name, boom)
    for arch in ("qwen2-1.5b", "mamba2-2.7b"):
        cfg = port_tiny(arch).replace(pallas_head="kernel", decode_attn="kernel")
        tm = build_model(cfg, prefill_attn="kernel", ssd_impl="kernel")
        params = tm.init(0, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _lm_batch(cfg).items()}
        loss, _ = tm.loss(params, batch)
        assert torch.isfinite(loss)


@pytest.mark.parametrize("arch", ["resnet18", "bert-base"])
def test_classifier_loss_and_grads_match_reference(arch):
    """ResNet (no stop-grad) and BERT (the reference's no-op
    ``stop_gradient(0.0) +``: the ramp loss reaches the encoder)."""
    rm = ref_build(get_tiny(arch))
    kw = {"prefill_attn": "kernel"} if arch == "bert-base" else {}
    tm = build_model(port_tiny(arch), **kw)
    rp, p = _perturbed(rm, 2)
    batch = _cls_batch(arch, rm.cfg)
    ref, port = _grads_both(rm, rp, tm, from_numpy_params(p, "cpu"), batch, {}, {})
    rg = _check_grads(ref, port, arch)
    if arch == "bert-base":  # the encoder's gradient carries the ramp loss
        assert np.asarray(jax.tree.leaves(ref[2]["enc"])[0]).any()
    assert len(rg) == len(tree_leaves(tm.schema()))


def test_kernel_dispatchers_raise_under_autograd():
    from repro_torch.kernels.decode_attention import (  # repro: allow[tier1-deps] — the port under test
        attend_decode,
        attend_decode_paged,
        attend_decode_paged_mla,
    )
    from repro_torch.kernels.flash_attention import attention  # repro: allow[tier1-deps] — the port under test
    from repro_torch.kernels.ramp_head import ramp_confidence, ramp_exit_decision  # repro: allow[tier1-deps] — the port under test
    from repro_torch.kernels.ssd import ssd  # repro: allow[tier1-deps] — the port under test

    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    q, k, v = r(2, 4, 8), r(2, 2, 6, 8), r(2, 2, 6, 8)
    pos = torch.tensor([3, 5])
    pool, table = r(5, 4, 2, 8), torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    cpool, kpe = r(5, 4, 16), r(5, 4, 4)
    qf = r(1, 2, 6, 8)
    x, dt, A, Bm = r(1, 2, 8, 4), r(1, 2, 8).abs(), -r(2).abs(), r(1, 8, 3)
    h, w = r(3, 8), r(8, 32)
    calls = {
        "attend_decode": (lambda t: attend_decode(t, k, v, pos), q),
        "attend_decode_paged": (lambda t: attend_decode_paged(t, pool, pool, table, pos), q),
        "attend_decode_paged_mla": (
            lambda t: attend_decode_paged_mla(t, r(2, 4, 4), cpool, kpe, table, pos,
                                              scale=0.1), r(2, 4, 16)),
        "attention": (lambda t: attention(t, qf, qf), qf.clone()),
        "ssd": (lambda t: ssd(t, dt, A, Bm, Bm), x),
        "ramp_confidence": (lambda t: ramp_confidence(t, w), h),
        "ramp_exit_decision": (lambda t: ramp_exit_decision(t, w, torch.zeros(3)), h),
    }
    for name, (fn, arg) in calls.items():
        fn(arg)  # no grad asked: the plain version on CPU tensors
        with pytest.raises(RuntimeError, match="no backward"):
            fn(arg.clone().requires_grad_(True))
        with torch.no_grad():
            fn(arg.clone().requires_grad_(True))


# -- optimizers -----------------------------------------------------------------


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (6, 5), "b": [(7,), (3, 4, 5)], "ramps": {"head": (4, 6), "norm_w": (4,)}}

    def draw(shp, s=1.0):
        if isinstance(shp, dict):
            return {k: draw(v, s) for k, v in shp.items()}
        if isinstance(shp, list):
            return [draw(v, s) for v in shp]
        return (s * rng.standard_normal(shp)).astype(np.float32)

    return draw(shapes), [draw(shapes, 3.0) for _ in range(3)]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


@pytest.mark.parametrize("masked", [False, True])
def test_adamw_matches_reference(masked):
    params, grads = _opt_trees(0)
    cfg_r = RT.AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    cfg_t = TT.AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    rp = jax.tree.map(jnp.asarray, params)
    rs = RT.adamw_init(rp, cfg_r)
    tp = from_numpy_params(params, "cpu")
    ts = TT.adamw_init(tp, cfg_t)
    rmask = RT.ramp_mask(rp) if masked else None
    tmask = TT.ramp_mask(tp) if masked else None
    sched_r, sched_t = RT.cosine_schedule(1e-2, 1, 3), TT.cosine_schedule(1e-2, 1, 3)
    for s, g in enumerate(grads):
        rp, rs, rgn = RT.adamw_update(rp, jax.tree.map(jnp.asarray, g), rs, cfg_r,
                                      lr_scale=sched_r(s + 1), mask=rmask)
        tp, ts, tgn = TT.adamw_update(tp, from_numpy_params(g, "cpu"), ts, cfg_t,
                                      lr_scale=sched_t(s + 1), mask=tmask)
        np.testing.assert_allclose(float(tgn), float(rgn), rtol=1e-6)
    for name, a, b in (("params", tp, rp), ("mu", ts["mu"], rs["mu"]), ("nu", ts["nu"], rs["nu"])):
        for x, y in zip(jax.tree.leaves(to_numpy(a)), jax.tree.leaves(_np_tree(b))):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6, err_msg=name)
    assert int(ts["step"]) == int(rs["step"]) == 3
    if masked:  # frozen leaves keep their value and moments
        np.testing.assert_array_equal(to_numpy(tp)["a"], params["a"])
        assert not to_numpy(ts["mu"])["a"].any()


def test_adamw_tensor_mask_matches_reference():
    """An elementwise bool-tensor mask, as the reference's masks are."""
    params, grads = _opt_trees(1)
    cfg_r, cfg_t = RT.AdamWConfig(lr=1e-2), TT.AdamWConfig(lr=1e-2)
    rng = np.random.default_rng(5)
    mask = jax.tree.map(lambda x: rng.random(x.shape) < 0.5, params)
    rp = jax.tree.map(jnp.asarray, params)
    rs = RT.adamw_init(rp, cfg_r)
    tp = from_numpy_params(params, "cpu")
    ts = TT.adamw_init(tp, cfg_t)
    rp, rs, _ = RT.adamw_update(rp, jax.tree.map(jnp.asarray, grads[0]), rs, cfg_r,
                                mask=jax.tree.map(jnp.asarray, mask))
    tp, ts, _ = TT.adamw_update(tp, from_numpy_params(grads[0], "cpu"), ts, cfg_t,
                                mask=tree_map(torch.from_numpy, mask))
    for x, y in zip(jax.tree.leaves(to_numpy(tp)), jax.tree.leaves(_np_tree(rp))):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)


def test_adafactor_matches_reference():
    params, grads = _opt_trees(2)
    rp = jax.tree.map(jnp.asarray, params)
    rs = RT.adafactor_init(rp)
    tp = from_numpy_params(params, "cpu")
    ts = TT.adafactor_init(tp)
    for g in grads:
        rp, rs = RT.adafactor_update(rp, jax.tree.map(jnp.asarray, g), rs)
        tp, ts = TT.adafactor_update(tp, from_numpy_params(g, "cpu"), ts)
    for x, y in zip(jax.tree.leaves(to_numpy(tp)), jax.tree.leaves(_np_tree(rp))):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)
    for x, y in zip(jax.tree.leaves(to_numpy(ts["v"])), jax.tree.leaves(_np_tree(rs["v"]))):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-30)


def test_cosine_schedule_matches_reference():
    for warm, total in ((0, 10), (20, 8), (5, 100)):
        r, t = RT.cosine_schedule(3e-4, warm, total), TT.cosine_schedule(3e-4, warm, total)
        for s in (0, 1, 4, 7, 20, 50, 99, 150):
            np.testing.assert_allclose(float(t(s)), float(r(s)), rtol=1e-7, atol=1e-7)
            np.testing.assert_allclose(float(t(torch.tensor(s, dtype=torch.int32))),
                                       float(r(s)), rtol=1e-7, atol=1e-7)


def test_ramp_mask_structure():
    tm = build_model(port_tiny("qwen2-1.5b"))
    mask = TT.ramp_mask(tm.init(0, device="cpu"))
    assert all(m is True for m in tree_leaves(mask["ramps"]))
    assert not any(tree_leaves(mask["tok"])) and not any(tree_leaves(mask["blocks"]))


# -- the train loop --------------------------------------------------------------


def _ref_state(rm, p, opt_cfg):
    rp = jax.tree.map(jnp.asarray, p)
    return {"params": rp, "opt": RT.adamw_init(rp, opt_cfg), "step": jnp.zeros((), jnp.int32)}


def _port_state(p, opt_cfg):
    tp = from_numpy_params(p, "cpu")
    return {"params": tp, "opt": TT.adamw_init(tp, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32)}


TRAIN_CASES = [("qwen2-1.5b", "full", {}), ("qwen2-1.5b", "ramps_only", {}),
               ("gpt2-medium", "ramps_only", {"ramp_style": "tied"}),
               ("deepseek-v2-lite-16b", "full", {})]
TRAIN_CASES += [(a, m, {}) for a in ("resnet18", "bert-base") for m in ("full", "ramps_only")]


@pytest.mark.parametrize("arch,mode,changes", TRAIN_CASES)
def test_first_five_losses_match_reference(arch, mode, changes):
    rm = ref_build(get_tiny(arch).replace(**changes))
    tm = build_model(port_tiny(arch).replace(**changes))
    _, p = _perturbed(rm, 3)
    cfg = rm.cfg
    if cfg.family == "lm":
        pipe = TokenPipeline(cfg.vocab_size, 16, 4, seed=1)
        batches = pipe.batch_at
    else:
        data = (make_image_stream(64, img_size=cfg.img_size, n_classes=cfg.n_classes, seed=1)
                if arch == "resnet18" else
                make_token_stream(64, seq_len=16, vocab=cfg.vocab_size,
                                  n_classes=cfg.n_classes, seed=1))
        key = "images" if arch == "resnet18" else "tokens"

        def batches(s):
            idx = np.random.default_rng(s).integers(0, 64, 8)
            return {key: data.data[idx], "labels": data.labels[idx].astype(np.int32)}

    rcfg = RT.TrainConfig(steps=5, lr=1e-3, train_mode=mode, log_every=1)
    tcfg = TT.TrainConfig(steps=5, lr=1e-3, train_mode=mode, log_every=1)
    rstate, rlogs = RT.train(rm, batches, rcfg, state=_ref_state(rm, p, RT.AdamWConfig(lr=1e-3)),
                             verbose=False)
    tstate, tlogs = TT.train(tm, batches, tcfg, state=_port_state(p, TT.AdamWConfig(lr=1e-3)),
                             verbose=False, device="cpu")
    assert len(tlogs) == len(rlogs) == 5
    for a, b in zip(tlogs, rlogs):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    flat = jax.tree_util.tree_flatten_with_path(_np_tree(rstate["params"]))[0]
    off = total = 0
    for (path, y), x in zip(flat, jax.tree.leaves(to_numpy(tstate["params"]))):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-3, err_msg=jax.tree_util.keystr(path))
        off += int((np.abs(x - y) > 1e-6).sum())
        total += x.size
    assert off <= 0.1 * total, f"{off} of {total} entries differ by more than 1e-6"
    assert int(tstate["step"]) == 5


def test_ramps_only_leaves_backbone_bit_identical():
    tm = build_model(port_tiny("qwen2-1.5b"))
    tcfg = TT.TrainConfig(steps=5, lr=1e-2, train_mode="ramps_only")
    step_fn, opt_cfg = TT.make_train_step(tm, tcfg)
    state = TT.init_state(tm, 0, opt_cfg, device="cpu")
    before = tree_map(torch.clone, state["params"])
    pipe = TokenPipeline(tm.cfg.vocab_size, 24, 8, seed=0)
    for s in range(5):
        state, _ = step_fn(state, pipe.batch_at(s))
    after = state["params"]
    for key in ("tok", "blocks", "final_norm"):
        for a, b in zip(tree_leaves(before[key]), tree_leaves(after[key])):
            assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(before["ramps"]),
                                                    tree_leaves(after["ramps"])))
    for key in ("tok", "blocks"):  # frozen moments stay zero
        assert not any(m.any() for m in tree_leaves(state["opt"]["mu"][key]))


@pytest.mark.parametrize("mode", ["full", "ramps_only"])
def test_grad_accum_equals_full_batch(mode):
    """Two equal micro-batches averaged (no padding labels: the mean of the
    halves' means is the batch mean): the same step as the whole batch,
    and as the reference's grad_accum=2."""
    rm = ref_build(get_tiny("qwen2-1.5b"))
    tm = build_model(port_tiny("qwen2-1.5b"))
    _, p = _perturbed(rm, 4)
    batch = TokenPipeline(rm.cfg.vocab_size, 16, 8, seed=1).batch_at(0)
    out = {}
    for ga in (1, 2):  # two steps: the first has lr scale 0, the moments move
        step, oc = TT.make_train_step(tm, TT.TrainConfig(steps=2, lr=1e-3, grad_accum=ga,
                                                          train_mode=mode))
        state = _port_state(p, oc)
        for _ in range(2):
            state, _ = step(state, batch)
        out[ga] = to_numpy(state)
    rstep, roc = RT.make_train_step(rm, RT.TrainConfig(steps=2, lr=1e-3, grad_accum=2,
                                                        train_mode=mode))
    rstate, jstep = _ref_state(rm, p, roc), jax.jit(rstep)
    for _ in range(2):
        rstate, _ = jstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    rstate = _np_tree(rstate)
    for part in ("params", "opt"):
        flat = jax.tree_util.tree_flatten_with_path(rstate[part])[0]
        for a, b, (path, c) in zip(jax.tree.leaves(out[1][part]),
                                   jax.tree.leaves(out[2][part]), flat):
            name = part + jax.tree_util.keystr(path)
            # the key bias's zero gradient: the Adam trap (module docstring)
            tol = dict(rtol=0, atol=2e-5) if name == "params['blocks'][0]['mixer']['bk']" \
                else dict(rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(b, a, err_msg=name, **tol)
            np.testing.assert_allclose(b, c, err_msg=name, **tol)


# -- the 'mlp' and 'tied' ramp styles on the serving paths -------------------------


STYLES = [(a, s) for a in ("qwen2-1.5b", "gpt2-medium") for s in ("mlp", "tied")]


def _style_pair(arch, style, paged=False, seed=0):
    """Reference: dense head (``pallas_head='off'``, the path that applies
    the mlp residual); port: the ramp-head kernel's path (its plain version
    on CPU tensors)."""
    rm = ref_build(get_tiny(arch).replace(ramp_style=style, pallas_head="off",
                                          decode_attn="paged" if paged else "ref"))
    tm = build_model(port_tiny(arch).replace(
        ramp_style=style, pallas_head="kernel", decode_attn="paged-kernel" if paged else "kernel"))
    rp, p = _perturbed(rm, seed)
    return rm, rp, tm, from_numpy_params(p, "cpu")


def _same_stats(t, r, keys, what):
    for k in keys:
        a, b = t[k].numpy(), np.asarray(r[k]).reshape(t[k].shape)
        if k in ("label", "exit"):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a, b, err_msg=f"{what} {k}", **REC_TOL)


@pytest.mark.parametrize("arch,style", STYLES)
def test_ramp_style_schema_and_records(arch, style):
    """Schema leaves as the reference's ('tied': no head; 'mlp': w1, w2);
    prefill, one contiguous decode step and a decode_multi window against
    the reference's dense head path."""
    rm, rp, tm, tp = _style_pair(arch, style)
    assert sorted(tm.schema()["ramps"]) == sorted(rm.schema()["ramps"])
    rng = np.random.default_rng(1)
    B, P, C = 3, 6, 24
    toks = rng.integers(0, rm.cfg.vocab_size, (B, P))
    act = list(range(len(rm.sites)))
    rc, ro = rm.prefill(rp, jnp.asarray(toks, jnp.int32), cache_len=C,
                        active_sites=jnp.asarray(act, jnp.int32))
    tc, to = tm.prefill(tp, torch.from_numpy(toks), cache_len=C, active_sites=act)
    for part in ("final", "ramps"):
        _same_stats(to[part], ro[part], ("label", "maxprob", "entropy"), f"prefill {part}")
    pos = np.array([6, 9, 7])
    tok = np.asarray(ro["final"]["label"]).reshape(-1, 1)
    u = np.sort(1.0 - np.asarray(ro["ramps"]["maxprob"]).reshape(-1))
    thr = np.full(len(act), 0.5 * (u[0] + u[-1]), np.float32)
    rc2, ro2 = rm.decode(rp, rc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
                         active_sites=jnp.asarray(act, jnp.int32),
                         exit_thresholds=jnp.asarray(thr))
    tc2, to2 = tm.decode(tp, tc, torch.from_numpy(tok.copy()).long(), torch.from_numpy(pos),
                         active_sites=act, exit_thresholds=torch.from_numpy(thr))
    _same_stats(to2["final"], ro2["final"], ("label", "maxprob", "entropy"), "decode final")
    _same_stats(to2["ramps"], ro2["ramps"], ("label", "maxprob", "entropy", "exit"),
                "decode ramps")
    tok2 = np.asarray(ro2["final"]["label"]).reshape(-1, 1)
    valid = np.array([True, True, False])
    rc3, (rl, rmp, fl, ex, nd) = rm.decode_multi(
        rp, rc2, jnp.asarray(tok2, jnp.int32), jnp.asarray(pos + 1, jnp.int32), 3, n_max=4,
        active_sites=jnp.asarray(act, jnp.int32), thresholds=jnp.asarray(thr),
        row_valid=jnp.asarray(valid))
    tc3, (tl, tmp, tfl, tex, tnd) = tm.decode_multi(
        tp, tc2, torch.from_numpy(tok2.copy()).long(), torch.from_numpy(pos + 1), 3, n_max=4,
        active_sites=act, thresholds=torch.from_numpy(thr), row_valid=torch.from_numpy(valid))
    nd = int(nd)
    assert int(tnd) == nd >= 1
    np.testing.assert_array_equal(tl.numpy()[:nd], np.asarray(rl)[:nd])
    np.testing.assert_allclose(tmp.numpy()[:nd], np.asarray(rmp)[:nd], **REC_TOL)
    np.testing.assert_array_equal(tfl.numpy()[:nd], np.asarray(fl)[:nd])
    np.testing.assert_array_equal(tex.numpy()[:nd], np.asarray(ex)[:nd])


@pytest.mark.parametrize("arch,style", STYLES)
def test_ramp_style_paged_decode_multi(arch, style):
    """A window on the paged pool: records up to n_done, exit sites exact."""
    rm, rp, tm, tp = _style_pair(arch, style, paged=True, seed=2)
    rng = np.random.default_rng(2)
    bs, nb, P = 4, 6, 13
    table = (rng.permutation(P - 1) + 1)[: 2 * nb].reshape(2, nb).astype(np.int32)
    pos = np.array([9, 14], np.int32)
    tok = rng.integers(0, rm.cfg.vocab_size, (2, 1)).astype(np.int32)
    sch = rm.paged_cache_schema(P, bs)
    pool = jax.tree.map(lambda i: rng.standard_normal(i.shape).astype(np.float32), sch,
                        is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "dtype"))
    act = list(range(len(rm.sites)))
    thr = np.full(len(act), 0.998, np.float32)
    _, (rl, rmp, fl, ex, nd) = rm.decode_multi(
        rp, jax.tree.map(jnp.asarray, pool), jnp.asarray(tok), jnp.asarray(pos), 3, n_max=4,
        active_sites=jnp.asarray(act, jnp.int32), thresholds=jnp.asarray(thr),
        block_tables=jnp.asarray(table))
    _, (tl, tmp, tfl, tex, tnd) = tm.decode_multi(
        tp, from_numpy_params(pool, "cpu"), torch.from_numpy(tok).long(), torch.from_numpy(pos),
        3, n_max=4, active_sites=act, thresholds=torch.from_numpy(thr),
        block_tables=torch.from_numpy(table))
    nd = int(nd)
    assert int(tnd) == nd
    np.testing.assert_array_equal(tl.numpy()[:nd], np.asarray(rl)[:nd])
    np.testing.assert_allclose(tmp.numpy()[:nd], np.asarray(rmp)[:nd], **REC_TOL)
    np.testing.assert_array_equal(tfl.numpy()[:nd], np.asarray(fl)[:nd])
    np.testing.assert_array_equal(tex.numpy()[:nd], np.asarray(ex)[:nd])


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("style", ["mlp", "tied"])
def test_ramp_style_runner_windows_agree(style, paged):
    """The runner's start / step_multi / free on both layouts, call for call:
    records exact except the f32 maxprob (1e-4)."""
    rm, rp, tm, tp = _style_pair("qwen2-1.5b", style, paged=paged, seed=3)
    prompts = np.random.default_rng(3).integers(1, rm.cfg.vocab_size, (4, 8))
    kw = {"max_new_tokens": 10, "max_slots": 2, "n_slots": 4}
    if paged:
        kw["kv_block_size"] = 4
    ref = RS.DecodeRunner(rm, rp, prompts, **kw)
    port = TS.DecodeRunner(tm, tp, prompts, **kw)
    act, thr = [0, 1], np.array([0.6, 0.99], np.float32)
    for r in (ref, port):
        for slot in range(3):
            r.start(slot, slot)
    for _ in range(2):
        outs = [r.step_multi([0, 1, 2], act, 4, thr) for r in (ref, port)]
        for i, (a, b) in enumerate(zip(outs[1], outs[0])):
            if np.asarray(a).dtype.kind == "f":
                np.testing.assert_allclose(a, b, **REC_TOL)
            else:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"record {i}")
    for r in (ref, port):
        r.free(1)


# -- serving trained weights -------------------------------------------------------


@pytest.fixture(scope="module")
def trained_bert():
    """Tiny BERT trained 40 steps by the JAX package on the first 64 items of
    the token stream the port's ``serve()`` draws (the launcher's recipe,
    fewer steps), bridged."""
    rm = ref_build(get_tiny("bert-base"))
    n, boot = 160, 64
    C = rm.cfg.n_classes
    stream = make_token_stream(n, seq_len=32, vocab=rm.cfg.vocab_size, n_classes=max(C, 2),
                               mode="nlp", seed=2)

    def batches(s):
        idx = np.random.default_rng(s).integers(0, boot, 64)
        return {"tokens": stream.data[idx], "labels": stream.labels[idx]}

    state, _ = RT.train(rm, batches, RT.TrainConfig(steps=40, lr=1e-3), verbose=False)
    p = _np_tree(state["params"])
    return rm, state["params"], p, stream, boot


@pytest.mark.parametrize("workers", [1, 2])
def test_serving_jax_trained_weights_agrees(trained_bert, workers):
    """The port's ``serve(train=False)`` on JAX-trained, bridged weights and
    the JAX stack on the same profile (the port's H100 one, which
    ``serve()`` builds), stream and requests give identical responses; the
    trained ramps exit."""
    from repro_torch.launch.serve import serve  # repro: allow[tier1-deps] — the port under test

    rm, rp, p, stream, boot = trained_bert
    n = len(stream.data)
    prof = TC.build_profile(port_tiny("bert-base"), mode="decode", chips=1, sites=rm.sites)
    out, tresp = serve("bert-base", n, tiny=True, device="cpu", workers=workers, seed=2,
                       params=from_numpy_params(p, "cpu"), verbose=False, budget=0.5,
                       acc=0.5)
    exec1 = prof.vanilla_time(1)
    arrivals = RS.maf_trace(n, mean_qps=workers * 0.5 * 1000.0 / exec1, seed=2)
    reqs = RS.make_requests(arrivals, slo_ms=2 * exec1)
    ccfg = RC.ControllerConfig(max_slots=6, ramp_budget_frac=0.5, acc_constraint=0.5)
    ctls = [RC.ApparateController(len(rm.sites), prof, ccfg) for _ in range(workers)]
    pf = RS.PlatformConfig(policy="tfserve", max_batch_size=8, batch_timeout_ms=exec1)
    sim = RS.ClusterSimulator(prof, RS.ClusterConfig(n_workers=workers, dispatch="jsq",
                                                     platform=pf),
                              runner=RS.ClassifierRunner(rm, rp, stream.data, max_slots=6),
                              controllers=ctls)
    rresp = sim.run(reqs)
    key = [(r.rid, r.label, r.exit_site, r.release_ms, r.dropped) for r in rresp]
    assert [(r.rid, r.label, r.exit_site, r.release_ms, r.dropped) for r in tresp] == key
    assert out["controllers"] == [dict(c.stats) for c in ctls]
    if workers == 1:  # one controller sees every sample: it tunes and exits
        assert sum(r.exit_site >= 0 for r in tresp) >= 1


def test_serve_train_on_cpu_tiny(tmp_path):
    """``serve(train=True)``: the reference's recipe on the bootstrap split
    (first max(n // 10, 256) items), the rest served, checkpoints written;
    the loss falls."""
    from repro_torch.launch.serve import serve  # repro: allow[tier1-deps] — the port under test

    out, resp = serve("resnet18", 300, tiny=True, device="cpu", train=True, verbose=False,
                      ckpt_dir=str(tmp_path / "ck"))
    assert out["served"] == len(resp) == 300 - 256
    tr = out["train"]
    assert tr["bootstrap"] == 256 and tr["steps"] == 150 and len(tr["losses"]) == 150
    assert tr["losses"][-1] < tr["losses"][0]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000050", "step_00000100", "step_00000150"]
    assert 0.0 <= out["accuracy"] <= 1.0
    with pytest.raises(ValueError):
        serve("qwen2-1.5b", 300, tiny=True, device="cpu", train=True, verbose=False)
