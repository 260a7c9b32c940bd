"""The program's spans against a traced stretch (``bench/spans.py``): on a
hand-made stretch, each idle ns goes to exactly one innermost span and a
kernel to the span that launched it; the four readers, and a prefill whose
account does not add up; a tiny traced session on the CPU whose spans feed
the host-clock readers and whose profiled stretch holds the spans' twins
inside the runner calls' marks; and a benchmark run that never turns the
program's tracer on."""
from types import SimpleNamespace

import numpy as np
import pytest

from bench import harness, spans
from repro_torch import trace

from .helpers import SMALL_SETTINGS, small_cell

# (name, start, end, id, parent, attrs) on the profiler's clock
SPANS = [("runner/prefill", 10, 60, 1, 0, {"item": 4}), ("prefill/alloc", 10, 15, 2, 1, {}),
         ("prefill/model", 15, 40, 3, 1, {}), ("model/moe", 20, 30, 4, 3, {"layer": 1}),
         ("prefill/read", 40, 58, 5, 1, {}), ("runner/window", 70, 90, 6, 0, {}),
         ("window/run", 72, 80, 7, 6, {}), ("model/moe", 73, 76, 8, 7, {"layer": 1})]
# (name, start, end, correlation id) and each launch's host time
OPS = [("k1", 0, 5, 1), ("k2", 22, 35, 2), ("k3", 41, 50, 3), ("k4", 74, 85, 4),
       ("k5", 86, 88, 5)]
LAUNCHES = {1: 0, 2: 21, 3: 29, 4: 74, 5: 78}


def _stretch():
    return SimpleNamespace(t0_ns=0, t1_ns=100, dev=[o[:3] for o in OPS], ops=OPS,
                           launches=LAUNCHES, spans=SPANS)


def test_each_idle_ns_goes_to_one_innermost_span():
    st = _stretch()
    by = spans.idle_by_span(st)
    # idle: [5, 22), [35, 41), [50, 74), [85, 86), [88, 100)
    assert sum(by.values()) == 17 + 6 + 24 + 1 + 12
    assert by == {0: 5 + 10 + 10, 2: 5, 3: 5 + 5, 4: 2, 5: 1 + 8, 1: 2, 6: 2 + 1 + 2, 7: 1,
                  8: 1}
    assert spans.idle_under(st, "prefill/read") == 9
    assert spans.idle_under(st, "model/moe") == 3
    assert spans.idle_under(st, "runner/prefill") == 2  # innermost only
    table = dict(spans.idle_table(st))
    assert table["runner/prefill > prefill/model > model/moe"] == 2
    assert table[spans.NO_SPAN] == 25 and sum(table.values()) == 60


def test_a_kernel_goes_to_the_span_that_launched_it():
    st = _stretch()
    # k3 runs while prefill/read is open, launched under model/moe
    assert spans.launched_under(st, "prefill/read") == 0
    assert spans.launched_under(st, "model/moe") == 13 + 9 + 11
    assert spans.launched_under(st, "model/moe", within="runner/prefill") == 13 + 9
    # under a span at any depth
    assert spans.launched_under(st, "prefill/model") == 13 + 9
    assert spans.launched_under(st, "runner/window") == 11 + 2
    st.launches = {2: 21}  # an operation with no launch read counts for none
    assert spans.launched_under(st, "model/moe") == 13


def test_stretch_readers():
    ctx = SimpleNamespace(stretch=_stretch())
    assert spans.prefill_account(ctx.stretch) == [
        {"ns": 50, "idle": 28, "launched": 22, "moe": 22, "outside": 0}]
    assert spans.prefill_idle_ms(ctx) == pytest.approx((5 + 5 + 2 + 5 + 1 + 8 + 2) / 1e6)
    assert spans.moe_prefill_ms(ctx) == pytest.approx(22 / 1e6)
    ctx.stretch.spans = [s for s in SPANS if s[0] != "runner/prefill"]
    assert spans.prefill_idle_ms(ctx) is None and spans.moe_prefill_ms(ctx) is None
    # a parent's stretch has no program spans: nothing read, nothing raised
    assert spans.prefill_idle_ms(SimpleNamespace(stretch=SimpleNamespace())) is None
    assert spans.moe_prefill_ms(SimpleNamespace(stretch=None)) is None


def test_a_prefill_whose_account_does_not_add_up_reads_no_idle():
    """Idle inside a prefill and the device time it launched cannot exceed
    its length: it ends in a blocking read, so all it launched ran inside
    it. A kernel it launched that runs after it (k5, launched under
    prefill/model, run in the window) means the device's timeline and the
    host's disagree: no idle is read, the launch-matched MoE time still is."""
    st = _stretch()
    st.launches = {**LAUNCHES, 5: 38}
    ctx = SimpleNamespace(stretch=st)
    (acc,) = spans.prefill_account(st)
    assert acc == {"ns": 50, "idle": 28, "launched": 24, "moe": 22, "outside": 2}
    assert not spans.consistent([acc]) and spans.prefill_idle_ms(ctx) is None
    assert spans.moe_prefill_ms(ctx) == pytest.approx(22 / 1e6)
    # the check is over the stretch's prefills together, within SLACK: a
    # kernel overlapping its neighbour (counted twice) is not a disagreement
    fits = dict(acc, outside=0, launched=acc["ns"] - acc["idle"])
    assert spans.consistent([dict(fits, launched=fits["launched"] + 1), fits] * 5)
    # a prefill cut by the stretch's edge is not counted, its idle neither
    st = _stretch()
    st.t0_ns = 20
    assert spans.prefill_account(st) == [] and spans.prefill_idle_ms(
        SimpleNamespace(stretch=st)) is None


def test_twins_nest_as_they_nest():
    twins = [(70, 90, "runner/window"), (10, 60, "runner/prefill"), (15, 40, "prefill/model"),
             (40, 58, "prefill/read"), (20, 30, "model/moe"), (72, 80, "window/run")]
    assert spans.nest(twins) == [
        ("runner/prefill", 10, 60, 1, 0), ("prefill/model", 15, 40, 2, 1),
        ("model/moe", 20, 30, 3, 2), ("prefill/read", 40, 58, 4, 1),
        ("runner/window", 70, 90, 5, 0), ("window/run", 72, 80, 6, 5)]


def _span(name, t0, t1):
    return trace.Record(0, 0, name, t0, t1, {})


def test_host_readers():
    ctx = SimpleNamespace(spans=[
        _span("runner/prefill", 0, 9_000_000), _span("prefill/read", 6_000_000, 9_000_000),
        _span("runner/prefill", 10_000_000, 20_000_000),
        _span("prefill/read", 19_000_000, 20_000_000),
        _span("runner/window", 21_000_000, 25_000_000),
        _span("controller/observe", 25_000_000, 27_000_000),
        _span("controller/observe", 27_000_000, 28_000_000),
        _span("runner/window", 30_000_000, 34_000_000),
        _span("controller/observe", 34_000_000, 37_000_000)])
    assert spans.prefill_wait_ms(ctx) == pytest.approx(2.0)
    assert spans.controller_ms(ctx) == pytest.approx(3.0)
    empty = SimpleNamespace(spans=[])
    assert spans.prefill_wait_ms(empty) is None and spans.controller_ms(empty) is None
    assert spans.controller_ms(SimpleNamespace()) is None


def _session(seed=13):
    s = harness.Session(small_cell("deepseek-v2-lite-16b.decode"), seed, device="cpu",
                        tiny=True)
    s.settings.update(SMALL_SETTINGS, trace={"start_frac": 0.0, "settle": 0.0, "seconds": 0.3})
    s.setup(process_start=0.0)
    return s


def test_a_traced_session_feeds_the_readers():
    s = _session()
    assert not trace.enabled()
    ctx = spans.window(s, 600.0, tracer=True, profile=False)
    assert not trace.enabled() and "observe" not in vars(s.ctl)
    names = [sp.name for sp in ctx.spans]
    starts = [c for c in ctx.calls if c["kind"] == "start"]
    steps = [c for c in ctx.calls if c["kind"] == "step"]
    assert names.count("runner/prefill") == len(starts) > 0
    assert names.count("runner/window") == len(steps) > 0
    assert names.count("controller/observe") == sum(c["n"] for c in steps)
    assert spans.prefill_wait_ms(ctx) > 0 and spans.controller_ms(ctx) > 0
    # a span and its runner call share the host clock: the call holds the span
    pf = [sp for sp in ctx.spans if sp.name == "runner/prefill"]
    for c, sp in zip(starts, pf):
        assert c["t0"] <= sp.t0 / 1e9 <= sp.t1 / 1e9 <= c["t1"]


def test_a_profiled_session_puts_the_spans_on_the_profilers_clock():
    s = _session(17)
    ctx = spans.window(s, 600.0, tracer=True, profile=True)
    st = ctx.stretch
    assert st is not None and st.spans and st.ops == []  # the CPU runs no device operation
    # the spans are the profiler's twins, on its clock: each prefill's and
    # window's mark holds exactly its own runner span
    inside = {"start": "runner/prefill", "step": "runner/window"}
    held = [m for m in st.marks if m[0] in inside]
    assert held
    for kind, a, b in held:
        assert sum(sp[0] == inside[kind] and a <= sp[1] <= sp[2] <= b for sp in st.spans) == 1
    # the stretch is all idle, each ns under one innermost span
    assert sum(spans.idle_by_span(st).values()) == st.t1_ns - st.t0_ns
    assert spans.consistent(spans.prefill_account(st))
    assert spans.prefill_idle_ms(ctx) > 0 and spans.moe_prefill_ms(ctx) is None
    # the host readers read the unprofiled part of the window only
    on, off = 1e9 * ctx.win.rec.tracer.on, 1e9 * ctx.win.rec.tracer.off
    assert len(ctx.spans) < len(ctx.recorded)
    assert all(sp.t1 < on or sp.t0 > off for sp in ctx.spans)


def test_the_benchmark_never_turns_the_tracer_on(monkeypatch):
    def refuse():
        raise AssertionError("the program's tracer turned on")

    monkeypatch.setattr(trace, "enable", refuse)
    s = _session(19)
    for traced in (False, True):
        win = s.measure(600.0, trace=traced)
        assert win.done and trace.take() == []


class _Event:
    """A profiler event as ``with_spans`` reads one."""

    def __init__(self, name, device, a, b, corr=0):
        self._n, self._d, self._a, self._b, self._c = name, device, a, b, corr

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def correlation_id(self):
        return self._c


def test_the_stretch_skips_the_spans_device_twins():
    """A span's ``record_function`` twin leaves an annotation on the
    device's timeline over what it launched (as the harness's marks do):
    the stretch skips it, so the idle gap under it stays idle."""
    rec = harness.Recorder(np.array([4]), prompt_len=4)
    rec.calls = [{"id": 0, "kind": "start", "t0": 0.0, "t1": 1.0}]
    tr = harness.Tracer(at=0.0, seconds=1.0, settle=0.0, cuda=False)
    tr.off, tr.ids = 1.0, [0]
    events = [_Event("bench.start#0", "CPU", 0, 100), _Event("bench.start#0", "CUDA", 0, 100),
              _Event("runner/prefill", "CPU", 5, 95), _Event("runner/prefill", "CUDA", 10, 90),
              _Event("cudaLaunchKernel", "CPU", 6, 7, corr=7),
              _Event("gemm", "CUDA", 10, 30, corr=7), _Event("cudaLaunchKernel", "CPU", 8, 9, 8),
              _Event("add", "CUDA", 60, 90, corr=8)]
    tr.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    win = SimpleNamespace(stretch=tr.stretch(rec), rec=SimpleNamespace(tracer=tr))
    st = spans.with_spans(win, {"runner/prefill"})
    assert st.dev == [("gemm", 10, 30), ("add", 60, 90)]
    assert [o[0] for o in st.ops] == ["gemm", "add"] and st.launches == {7: 6, 8: 8}
    assert st.spans == [("runner/prefill", 5, 95, 1, 0)]
    assert spans.idle_gaps(st) == [(0, 10), (30, 60), (90, 100)]
    assert spans.launched_under(st, "runner/prefill") == 50
    assert spans.prefill_account(st) == [
        {"ns": 90, "idle": 40, "launched": 50, "moe": 0, "outside": 0}]
