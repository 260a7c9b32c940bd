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
         "resnet50", "bert-base", "gemma3-4b", "qwen3-moe-30b-a3b", "llama-3.2-vision-90b",
         "jamba-1.5-large-398b", "qwen1.5-32b", "deepseek-67b", "seamless-m4t-large-v2"]


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


def test_gemma3_full_width_schema_equals_reference():
    """Full-width Gemma3-4B from the schemas alone: 34 layers of d 2560 (5
    periods of 5 local + 1 global, then 4 local), 8 query heads on 4 KV
    heads of 256, qk-norm, a tied 262144-token vocab; the reference's leaf
    shapes and dtypes, 3.88 B model parameters plus 12 ramp heads of
    2560 x 262144 (~23.9 GB in bf16 together)."""
    import jax

    from repro.models import build_model as ref_build
    from repro.models.common import is_info
    from repro_torch.models import build_model  # repro: allow[tier1-deps] — the port under test
    from repro_torch.models.common import tree_leaves  # repro: allow[tier1-deps] — the port under test

    cfg = get_config("gemma3-4b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window,
            cfg.local_global_pattern) == (34, 2560, 8, 4, 256, 1024, 5)
    assert (cfg.vocab_size, cfg.padded_vocab, cfg.tie_embeddings) == (262144, 262144, True)
    ref = jax.tree.leaves(ref_build(ref_config("gemma3-4b")).schema(), is_leaf=is_info)
    model = build_model(cfg)
    port = tree_leaves(model.schema())
    assert [tuple(i.shape) for i in ref] == [tuple(i.shape) for i in port]
    assert [np.dtype(i.dtype).name for i in ref] == [str(i.dtype)[6:] for i in port]
    n = sum(math.prod(i.shape) for i in port)
    ramps = 12 * 2560 * 262144 + 12 * 2560
    assert len(model.sites) == 12 and len(model.plan.suffix) == 4
    assert round((n - ramps) / 1e9, 2) == 3.88
    assert round(2 * n / 1e9, 1) == 23.9


FULL_WIDTH_GB = [  # (arch, layers kept, ramp sites, GB: embed + head, blocks, ramps, total)
    ("qwen3-moe-30b-a3b", 48, 12, (1.26, 59.85, 7.55, 68.65)),
    ("llama-3.2-vision-90b", 5, 4, (4.23, 8.86, 8.46, 21.56)),  # one period: 4 self + 1 cross
    ("jamba-1.5-large-398b", 8, 7, (2.15, 88.14, 7.52, 97.81)),  # one period
    ("qwen1.5-32b", 64, 12, (3.15, 67.28, 18.87, 89.30)),
    ("deepseek-67b", 95, 12, (3.36, 131.50, 20.13, 154.99)),
]


@pytest.mark.parametrize("arch,L,n_sites,gb", FULL_WIDTH_GB)
def test_new_configs_full_width_schema_equals_reference(arch, L, n_sites, gb):
    """The five configs at full width (Llama-3.2-Vision and Jamba cut to one
    period) from the schemas alone, nothing allocated: the reference's leaf
    shapes and dtypes, and the bytes of their parameters (GB of 1e9 B),
    which say what fits one 80 GB card: Qwen3-MoE whole (68.65 GB) and one
    period of Llama-3.2-Vision (21.56 GB), not one period of Jamba nor
    qwen1.5-32b or DeepSeek-67B whole."""
    import jax

    from repro.models import build_model as ref_build
    from repro.models.common import is_info
    from repro_torch.models import build_model  # repro: allow[tier1-deps] — the port under test
    from repro_torch.models.common import tree_leaves  # repro: allow[tier1-deps] — the port under test

    ref = jax.tree.leaves(ref_build(ref_config(arch).replace(n_layers=L)).schema(),
                          is_leaf=is_info)
    model = build_model(get_config(arch).replace(n_layers=L))
    sch = model.schema()
    port = tree_leaves(sch)
    assert [tuple(i.shape) for i in ref] == [tuple(i.shape) for i in port]
    assert [np.dtype(i.dtype).name for i in ref] == [str(i.dtype)[6:] for i in port]
    assert len(model.sites) == n_sites

    def gbytes(tree):
        return sum(math.prod(i.shape) * i.dtype.itemsize for i in tree_leaves(tree)) / 1e9

    assert [round(gbytes(sch[k]), 2) for k in ("tok", "blocks", "ramps")] == list(gb[:3])
    assert round(gbytes(sch), 2) == gb[3]


def test_seamless_full_width_bytes():
    """Full-width SeamlessM4T-large-v2 from the schema alone: 24 + 24 layers
    of d 1024, 16 heads of 64, d_ff 8192, the vocab 256206 padded to
    258048 with an untied head, ramps on all 23 decoder sites: 8.12 B
    parameters, 16.23 GB in bf16, 12.16 GB of it the ramp heads. It fits
    one 80 GB card whole."""
    from repro_torch.models import build_model  # repro: allow[tier1-deps] — the port under test
    from repro_torch.models.common import tree_leaves  # repro: allow[tier1-deps] — the port under test

    cfg = get_config("seamless-m4t-large-v2")
    assert (cfg.n_enc_layers, cfg.n_dec_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff,
            cfg.padded_vocab, cfg.n_image_tokens) == (24, 24, 1024, 16, 64, 8192, 258048, 1600)
    sch = build_model(cfg).schema()

    def gbytes(tree):
        return sum(math.prod(i.shape) * i.dtype.itemsize for i in tree_leaves(tree)) / 1e9

    n = sum(math.prod(i.shape) for i in tree_leaves(sch))
    assert round(n / 1e9, 2) == 8.12
    assert (round(gbytes(sch), 2), round(gbytes(sch["ramps"]), 2)) == (16.23, 12.16)


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("no-such-arch")  # every reference config is registered
