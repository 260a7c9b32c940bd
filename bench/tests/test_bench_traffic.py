"""The traffic generator: the same seed gives the same backlog, seeds give
other prompts and the same sizes in another order."""
import numpy as np
import pytest

from bench import traffic

from .helpers import CELLS, load_cell


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_backlog_other_seed_other(cell):
    mix = load_cell(cell).mix
    a = traffic.generate(mix, 151936, 2147483701)
    b = traffic.generate(mix, 151936, 2147483701)
    c = traffic.generate(mix, 151936, 2147483702)
    assert np.array_equal(a.prompts, b.prompts) and np.array_equal(a.n_tokens, b.n_tokens)
    assert not np.array_equal(a.prompts, c.prompts)
    assert not np.array_equal(a.n_tokens, c.n_tokens)
    assert a.prompts.shape == (traffic.BACKLOG, mix["prompt_len"])
    assert (a.arrival_ms == 0).all()


@pytest.mark.parametrize("cell", CELLS)
def test_every_block_holds_the_same_sizes(cell):
    mix = load_cell(cell).mix
    out, blk = mix["output"], traffic.BLOCK
    for seed in (0, 5, 2 ** 33 + 1):
        n = traffic.generate(mix, 1000, seed).n_tokens
        assert n.min() >= out["lo"] and n.max() <= out["hi"]
        base = np.sort(traffic.quantile_lengths(out, blk))
        for k in range(len(n) // blk):
            assert np.array_equal(np.sort(n[k * blk:(k + 1) * blk]), base)


def test_streams_differ_and_ids_avoid_zero():
    mix = load_cell(CELLS[0]).mix
    a = traffic.generate(mix, 50, 3, "backlog", 64)
    b = traffic.generate(mix, 50, 3, "warmup", 64)
    assert not np.array_equal(a.prompts, b.prompts)
    assert a.prompts.min() >= 1 and a.prompts.max() < 50


def test_loguniform_quantiles():
    x = traffic.quantile_lengths({"dist": "loguniform", "lo": 128, "hi": 1024}, 64)
    assert x[0] == 130 and x[-1] == 1008 and np.all(np.diff(x) >= 0)
    u = traffic.quantile_lengths({"dist": "uniform", "lo": 16, "hi": 64}, 49)
    assert np.array_equal(u, np.arange(16, 65))
