"""The port's configs pair field for field with the JAX package's."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_tiny as ref_tiny  # noqa: E402
from repro_torch.configs import get_config, get_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch

ARCHS = ["qwen2-1.5b", "gpt2-medium", "deepseek-v2-lite-16b", "mamba2-2.7b", "resnet18",
         "resnet50", "bert-base"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["config", "tiny"])
def test_every_field_equals_reference(arch, which):
    port = (get_config if which == "config" else get_tiny)(arch)
    ref = (ref_config if which == "config" else ref_tiny)(arch)
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n
    assert _props(port) == _props(ref)


def _props(cfg):
    """The derived properties, or the error one raises (``hd`` divides by
    ``n_heads``, which is 0 in an attention-free config, in both packages)."""
    out = []
    for name in ("hd", "padded_vocab", "ssm_nheads"):
        try:
            out.append(getattr(cfg, name))
        except ZeroDivisionError as e:
            out.append(type(e))
    return out


def test_qwen2_full_width_shape():
    cfg = get_config("qwen2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (28, 1536, 12, 2, 128)
    assert (cfg.vocab_size, cfg.padded_vocab, cfg.dtype) == (151936, 153600, "bfloat16")


def test_deepseek_full_width_schema_equals_reference():
    """Full-width DeepSeek-V2-Lite from the schemas alone (nothing is
    allocated): the port's leaf shapes are the reference's, 15.71 B model
    parameters plus 12 untied ramp heads of 2048 x 102400."""
    import jax

    from repro.models import build_model as ref_build
    from repro.models.common import is_info
    from repro_torch.models import build_model  # repro: allow[tier1-deps] — the port under test
    from repro_torch.models.common import tree_leaves  # repro: allow[tier1-deps] — the port under test

    ref = jax.tree.leaves(ref_build(ref_config("deepseek-v2-lite-16b")).schema(), is_leaf=is_info)
    port = tree_leaves(build_model(get_config("deepseek-v2-lite-16b")).schema())
    assert [tuple(i.shape) for i in port] == [tuple(i.shape) for i in ref]
    n = sum(math.prod(i.shape) for i in port)
    ramps = 12 * 2048 * 102400 + 12 * 2048
    assert len(build_model(get_config("deepseek-v2-lite-16b")).sites) == 12
    assert round((n - ramps) / 1e9, 2) == 15.71


def test_mamba2_full_width_schema_equals_reference():
    """Full-width Mamba2-2.7B from the schemas alone: 64 layers of d 2560,
    d_inner 5120 (80 heads of 64), N 128, one group, d_conv 4; the vocab
    50280 padded to 51200 with an untied head; the leaf shapes and dtypes
    are the reference's (A_log, D, dt_bias and norm_w f32), 2.84 B model
    parameters plus 12 ramp heads of 2560 x 51200."""
    import jax

    from repro.models import build_model as ref_build
    from repro.models.common import is_info
    from repro_torch.models import build_model  # repro: allow[tier1-deps] — the port under test
    from repro_torch.models.common import tree_leaves  # repro: allow[tier1-deps] — the port under test

    cfg = get_config("mamba2-2.7b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim,
            cfg.ssm_nheads, cfg.ssm_ngroups, cfg.d_conv) == (64, 2560, 5120, 128, 64, 80, 1, 4)
    assert (cfg.vocab_size, cfg.padded_vocab, cfg.tie_embeddings) == (50280, 51200, False)
    ref = jax.tree_util.tree_flatten_with_path(
        ref_build(ref_config("mamba2-2.7b")).schema(), is_leaf=is_info)[0]
    model = build_model(cfg)
    port = tree_leaves(model.schema())
    assert [tuple(i.shape) for _, i in ref] == [tuple(i.shape) for i in port]
    assert [np.dtype(i.dtype).name for _, i in ref] == [str(i.dtype)[6:] for i in port]
    f32 = {jax.tree_util.keystr(path).split("'")[-2] for path, i in ref
           if np.dtype(i.dtype).name == "float32"}
    assert {"A_log", "D", "dt_bias", "norm_w"} <= f32
    n = sum(math.prod(i.shape) for i in port)
    ramps = 12 * 2560 * 51200 + 12 * 2560
    assert len(model.sites) == 12
    assert round((n - ramps) / 1e9, 2) == 2.84


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("gemma3-4b")  # not ported yet
