"""The window's arithmetic on hand-made release stamps: which tokens count,
out_tok_s, tpot_p95_ms, and a window closed in the middle of a request."""
from types import SimpleNamespace

import numpy as np
import pytest

from bench import check, harness


def _step_out(finals, act=(), unc=0.25):
    finals = np.asarray(finals, np.int64)  # (nd, B)
    nd, B = finals.shape
    labels = np.full((nd, len(act), B), 5, np.int64)
    return labels, np.full((nd, len(act), B), unc, np.float32), finals, np.full((nd, B), -1)


def _window(monkeypatch):
    """Two slots; items of 3, 5 and 4 tokens; the window (10 s) closes while
    item 2 is in flight."""
    clock = iter([0.0, 1.0, 1.0, 2.0, 2.0, 4.0, 4.0, 4.1, 4.1, 5.0, 5.0, 9.0, 9.0, 9.2, 10.5, 11.0])
    monkeypatch.setattr(harness, "CLOCK", lambda: next(clock))
    rec = harness.Recorder(np.array([3, 5, 4]), prompt_len=4)
    rec.deadline = 10.0
    rec.started(0, 0, 11, rec.before())
    rec.started(1, 1, 21, rec.before())
    rec.stepped([0, 1], (3,), _step_out([[12, 22], [13, 23]], act=(3,)), "replay",
                rec.before())
    rec.freed(0, rec.before())
    rec.started(0, 2, 31, rec.before())
    rec.stepped([0, 1], (), _step_out([[32, 24], [33, 25]]), "replay", rec.before())
    rec.freed(1, rec.before())
    with pytest.raises(harness.WindowClosed):
        rec.before()
    done = [r for r in rec.reqs.values() if len(r["tokens"]) >= r["n"]]
    return rec, SimpleNamespace(calls=rec.calls, plain=rec.calls, t_open=0.0,
                                t_close=rec.t_close, done=done)


def test_tokens_and_requests(monkeypatch):
    rec, ctx = _window(monkeypatch)
    assert rec.t_close == 10.5 and rec.off
    assert rec.reqs[0]["tokens"] == [11, 12, 13]
    assert rec.reqs[1]["tokens"] == [21, 22, 23, 24, 25]
    assert rec.reqs[2]["tokens"] == [31, 32, 33]  # 3 of its 4: in flight at the close
    assert sorted(r["item"] for r in ctx.done) == [0, 1]
    assert [c["pos0"] for c in rec.calls if c["kind"] == "step"] == [[4, 4], [4, 6]]
    # after the close nothing more is recorded
    rec.started(1, 2, 99, 11.0)
    assert len(rec.calls) == 7


def test_out_tok_s(monkeypatch):
    _, ctx = _window(monkeypatch)
    assert harness.reader("out_tok_s")(ctx) == pytest.approx(11 / 10.5)


def test_tpot_p95_ms(monkeypatch):
    _, ctx = _window(monkeypatch)
    # item 0: (4.0 - 1.0) / 2 s; item 1: (9.0 - 2.0) / 4 s; item 2 never finished
    v = [1500.0, 1750.0]
    assert harness.reader("tpot_p95_ms")(ctx) == pytest.approx(1500.0 + 0.95 * 250.0)
    assert harness.percentile(v, 95) == pytest.approx(np.percentile(v, 95))


def test_host_time_readers(monkeypatch):
    _, ctx = _window(monkeypatch)
    assert harness.reader("window_ms")(ctx) == pytest.approx(1e3 * (2.0 + 4.0) / 2)
    assert harness.reader("prefill_ms")(ctx) == pytest.approx(1e3 * (1.0 + 1.0 + 0.9) / 3)
    # gaps between calls: 0 + 0 + 0 + 0 + 0 + 0 over two windows
    assert harness.reader("engine_host_ms")(ctx) == pytest.approx(0.0)


def test_ramp_records_by_site(monkeypatch):
    rec, _ = _window(monkeypatch)
    idx, lab, mp = check.site_records(rec.reqs[1], 3)
    assert idx.tolist() == [1, 2] and lab.tolist() == [5, 5]
    assert mp == pytest.approx([0.75, 0.75])
    assert check.site_records(rec.reqs[1], 4) is None


def test_sample_has_the_longest():
    done = [{"item": i, "tokens": [0] * n} for i, n in enumerate([5, 50, 7, 9, 11])]
    s = check.sample(done, seed=3, min_tokens=60)
    assert s[0]["item"] == 1 and sum(len(r["tokens"]) for r in s) >= 60
    assert [r["item"] for r in s] == [r["item"] for r in check.sample(done, 3, 60)]


def test_traced_stretch_maps_marks_to_calls():
    """A traced CPU run: the profiler's marks name the stretch's calls, in
    order and by kind (the card adds the device operations)."""
    from .helpers import SMALL_SETTINGS, small_cell

    s = harness.Session(small_cell("qwen2-1.5b.decode"), 11, device="cpu", tiny=True)
    s.settings.update(SMALL_SETTINGS, trace={"start_frac": 0.0, "settle": 0.0, "seconds": 0.3})
    s.setup(process_start=0.0)
    win = s.measure(600.0, trace=True)
    st = win.stretch
    assert st is not None and len(st.calls) >= 3
    assert [m[0] for m in st.marks] == [c["kind"] for c in st.calls]
    assert all(a[2] <= b[1] for a, b in zip(st.marks, st.marks[1:]))
    assert st.t0_ns == st.marks[0][1] and st.t1_ns == st.marks[-1][2] and st.dev == []
    ids = [c["id"] for c in st.calls]
    assert ids == list(range(ids[0], ids[0] + len(ids)))
