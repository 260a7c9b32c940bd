"""``correct`` comes out false when the timed path is broken underneath.
Each test drives a whole run on the CPU (the card's look skipped) at a
small size (width 512, the published depth, a 4096-token vocabulary), the
port in float32 against the float32 reference. There a sound run reads
round-off (under 1e-5) where the full size reads bfloat16's rounding, so
the faults are held to ``SMALL``, the cell's numbers with a limit of 1e-3
each, a hundred times the sound readings; a token altered where the runner
produces it is also held to the cell's own full-size limits. The float8
control, put in the program's place at that size, is not correct either.
"""
import pytest

from .helpers import CELLS, correct, serve, small_cell, widen

SMALL = 1e-3


def _small(cell):
    c = small_cell(cell)
    c.mix["check"] = {**c.mix["check"], "limits": {k: SMALL for k in c.mix["check"]["limits"]}}
    return c


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, monkeypatch):
    widen(monkeypatch, d=512)
    assert correct(serve(small_cell(cell))[2])
    assert correct(serve(_small(cell))[2])


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_caught(cell, monkeypatch):
    import repro_torch.models.layers as layers

    widen(monkeypatch, d=512)
    # every decode step leaves the cache as it found it
    monkeypatch.setattr(layers, "_update_pool", lambda *a, **k: None)
    assert not correct(serve(_small(cell))[2])


@pytest.mark.parametrize("cell", CELLS)
def test_altered_token_is_caught(cell, monkeypatch):
    from repro_torch.serving import DecodeRunner

    widen(monkeypatch, d=512)
    step_multi = DecodeRunner.step_multi

    def altered(self, *a, **k):
        labels, unc, finals, exits = step_multi(self, *a, **k)
        return labels, unc, (finals + 1) % self.model.cfg.vocab_size, exits

    monkeypatch.setattr(DecodeRunner, "step_multi", altered)
    assert not correct(serve(small_cell(cell))[2])
    assert not correct(serve(_small(cell))[2])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, monkeypatch):
    widen(monkeypatch, d=512)
    chk = serve(_small(cell), stand_ins=("fp8",))[2]
    lim = chk["limits"]
    assert not all(chk["fp8"][k] <= v for k, v in lim.items())
    assert any(chk["fp8"][k] > max(3 * chk["program"][k], v) for k, v in lim.items())
