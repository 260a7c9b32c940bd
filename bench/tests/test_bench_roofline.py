"""The yardstick's byte and operation counts reproduce the bounds of
PERF.md's kernel table and the dry run's step floor, and its parameter
bytes are the program's schema's."""
import pytest

from bench import roofline as rl
from bench.shapes import arch

from .helpers import load_cell

QWEN = arch(load_cell("qwen2-1.5b.decode").config)
DEEPSEEK = arch(load_cell("deepseek-v2-lite-16b.decode").config)


def _ms(nbytes_flops):
    return 1e3 * rl.bound_s(*nbytes_flops)


def test_paged_decode_bound():
    # #5 at B 8, blocks of 16, 10 blocks a row, rows at pos 120..159 (the
    # table's row drew 1106 keys in all)
    pos = [120, 125, 130, 135, 140, 145, 150, 153]
    assert sum(p + 1 for p in pos) == 1106
    assert round(_ms(rl.decode_attn(QWEN, pos, bs=16)), 6) == 0.000353


def test_ramp_head_bound():
    # #2 on qwen2's tied head, 1536 x 151936, B 8
    assert round(_ms(rl.ramp_head(QWEN, 8)), 3) == 0.139


def test_paged_mla_bound():
    # #6 at B 8, H 16, r 512, 10 blocks a row (1145 keys in all)
    pos = [128, 135, 140, 143, 145, 148, 150, 148]
    assert sum(p + 1 for p in pos) == 1145
    assert round(_ms(rl.decode_attn(DEEPSEEK, pos, bs=16)), 6) == 0.000477


def test_flash_prefill_bound():
    # #4 at Sq = Sk = 4096, causal, qwen2's 12:2 heads: bound by operations
    assert round(_ms(rl.prefill_attn(QWEN, 1, 4096)), 4) == 0.0521


def test_step_floor_qwen2_b8():
    f = rl.step_floor(QWEN, B=8, pos=140, n_active=4)
    assert round(f["total"] / 1e9, 2) == 5.01
    assert round(f["ms"], 2) == 1.50
    assert round(f["layers"] / 1e9, 2) == 2.62 and round(f["ramps"] / 1e9, 2) == 1.89


@pytest.mark.parametrize("a,name", [(QWEN, "qwen2-1.5b"), (DEEPSEEK, "deepseek-v2-lite-16b")])
def test_param_bytes_are_the_schemas(a, name):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import param_bytes

    assert sum(rl.param_bytes(a).values()) == param_bytes(build_model(get_config(name)).schema())


def test_mfu_counts_routed_experts_only():
    # a DeepSeek decode token: 6 routed + 2 shared experts' products, not 64
    dense = dict(DEEPSEEK, top_k=DEEPSEEK["E"] - DEEPSEEK["n_shared"])
    assert rl.decode_flops(DEEPSEEK, [600], 0) < 0.25 * rl.decode_flops(dense, [600], 0)
    # and a share of the peak stays a share
    assert rl.mfu_share(989e12, 1.0) == pytest.approx(100.0)
