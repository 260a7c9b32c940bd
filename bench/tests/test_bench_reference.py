"""The weights the benchmark draws are laid out and scaled as the program's
own, and the plain reference agrees with the port's plain path (the CPU
versions of its kernels) at a small size: the served tokens, the ramp
labels and max-probabilities of a whole CPU run."""
import math

import pytest
import torch

from bench import weights
from bench.shapes import ramp_sites

from .helpers import CELLS, serve, small_cell


def _port(name, tiny):
    from repro_torch.configs import get_config, get_tiny
    from repro_torch.models import build_model

    return build_model((get_tiny if tiny else get_config)(name))


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("name", ["qwen2-1.5b", "deepseek-v2-lite-16b"])
def test_init_rules_are_the_programs(name, tiny):
    model = _port(name, tiny)
    for path, info in weights._walk(model.schema()):
        want = info.init.replace("embed:", "normal:")
        assert weights.init_rule(path, model.cfg.n_layers) == want, path
    assert ramp_sites(model.cfg.n_layers) == tuple(model.sites)


def test_draw_is_seeded_aligned_and_redraws_in_place():
    model = _port("deepseek-v2-lite-16b", tiny=True)
    sch, L = model.schema(), model.cfg.n_layers
    a, bufs = weights.draw(sch, 2 ** 40 + 3, L, "cpu")
    b, _ = weights.draw(sch, 2 ** 40 + 3, L, "cpu")
    lay = weights.layout(sch)
    for path, shape, dtype in lay:
        x, y = weights.leaf(a, path), weights.leaf(b, path)
        assert x.shape == shape and x.dtype == dtype and torch.equal(x, y)
        # offsets from the buffer's base (the card's allocator aligns bases to 512 B)
        assert (x.data_ptr() - bufs[dtype].data_ptr()) % weights.ALIGN == 0
    wq = weights.leaf(a, ("blocks", "0", "mixer", "wq"))
    ptr, before = wq.data_ptr(), wq.clone()
    c, _ = weights.draw(sch, 5, L, "cpu", bufs)
    assert weights.leaf(c, ("blocks", "0", "mixer", "wq")).data_ptr() == ptr
    assert not torch.equal(wq, before)  # the same storage holds seed 5's values
    std = weights.leaf(c, ("blocks", "0", "mixer", "wo")).float().std().item()
    assert std == pytest.approx(0.02 / math.sqrt(2 * L), rel=0.2)
    assert not weights.leaf(c, ("final_norm", "w")).any()


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_ports_plain_path(cell):
    _, win, chk = serve(small_cell(cell))
    p = chk["program"]
    assert chk["counts"]["tokens"] >= 40 and chk["counts"]["ramp_records"] > 0
    assert p["final_gap"] < 1e-4 and p["ramp_gap"] < 1e-4
    assert p["ramp_maxprob_err"] < 1e-4  # f32 on both sides; the record carries 1 - p
