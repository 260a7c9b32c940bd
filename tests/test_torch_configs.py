"""The port's configs pair field for field with the JAX package's."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_tiny as ref_tiny  # noqa: E402
from repro_torch.configs import get_config, get_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch

ARCHS = ["qwen2-1.5b", "gpt2-medium"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["config", "tiny"])
def test_every_field_equals_reference(arch, which):
    port = (get_config if which == "config" else get_tiny)(arch)
    ref = (ref_config if which == "config" else ref_tiny)(arch)
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n
    assert (port.hd, port.padded_vocab, port.ssm_nheads) == (
        ref.hd, ref.padded_vocab, ref.ssm_nheads)


def test_qwen2_full_width_shape():
    cfg = get_config("qwen2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (28, 1536, 12, 2, 128)
    assert (cfg.vocab_size, cfg.padded_vocab, cfg.dtype) == (151936, 153600, "bfloat16")


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("resnet50")  # not ported yet
