"""The port's tracer (``repro_torch.trace``): off, a served run records
nothing and never enters the profiler; on, the spans of a tiny DeepSeek
engine run (``DecodeRunner`` + ``ApparateController`` +
``GenerativeEngine``) nest as the runner, the model, the controller and
the engine make them, change no served token, exit or threshold, and map
onto the profiler's clock; ``instrument`` puts the methods back."""
import statistics
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.configs import get_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.core import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    ApparateController, ControllerConfig, build_profile)
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.serving import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    DecodeRunner, GenerativeConfig, GenerativeEngine, make_gen_requests)
from repro_torch.serving.graphs import WindowGraphs  # noqa: E402  # repro: allow[tier1-deps] — the port under test

N, P_LEN, TOKS = 7, 8, 9


@pytest.fixture(autouse=True)
def _fresh():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


@pytest.fixture(scope="module")
def model():
    cfg = get_tiny("deepseek-v2-lite-16b").replace(
        decode_attn="paged-kernel", pallas_head="kernel", mla_absorbed=True)
    m = build_model(cfg, prefill_attn="kernel")
    return m, m.init(3, device="cpu")


def _serve(model, traced: bool):
    """A tiny DeepSeek served with the tracer on (engine and controller
    instrumented) or off. Returns (responses, controller, spans)."""
    m, params = model
    cfg = m.cfg
    prompts = np.random.default_rng(5).integers(1, cfg.vocab_size, (N, P_LEN))
    prof = build_profile(cfg, mode="decode", chips=1, sites=m.sites, charge_kv=True)
    reqs = make_gen_requests(np.zeros(N), n_tokens=TOKS, prompt_len=P_LEN, slo_ms=1e12)
    runner = DecodeRunner(m, params, prompts, max_new_tokens=TOKS + 2, max_slots=2,
                          n_slots=4, kv_block_size=4)
    ctl = ApparateController(len(m.sites), prof, ControllerConfig(
        max_slots=2, ramp_budget_frac=0.6, adjust_every=12, min_samples_to_tune=8))
    # every active ramp exits its first tokens, whose labels disagree: the
    # monitor then tunes (random weights exit nothing under thresholds of 0)
    ctl.thresholds[:] = 1.0
    eng = GenerativeEngine(prof, GenerativeConfig(max_batch_size=4, steps_per_sync=3),
                           runner, ctl)
    if traced:
        trace.enable()
        trace.instrument_engine(eng)
    resp = eng.run(reqs)
    trace.disable()
    return resp, ctl, trace.take()


def test_off_records_nothing_and_never_enters_the_profiler(model, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "_profiling", lambda: True)  # as if a profiler ran
    resp, _, spans = _serve(model, traced=False)
    assert len(resp) == N and spans == []
    assert trace.span("x") is trace.span("y")  # the one shared null context


def _tree(spans):
    by_id = {s.id: s for s in spans}

    def parent(s):
        return by_id.get(s.parent)

    def ancestors(s):
        p = parent(s)
        while p is not None:
            yield p
            p = parent(p)

    return parent, ancestors


def test_on_spans_nest_as_the_layers_make_them(model):
    _, ctl, spans = _serve(model, traced=True)
    parent, ancestors = _tree(spans)
    names = {s.name for s in spans}
    assert {"engine/admit", "engine/step", "controller/observe", "controller/tune",
            "controller/adjust", "runner/prefill", "prefill/alloc", "prefill/model",
            "prefill/scatter", "prefill/read", "runner/window", "window/claim",
            "window/run", "window/read", "runner/free", "model/mla", "model/moe",
            "model/ffn", "model/heads"} <= names
    want_parent = {"prefill/alloc": "runner/prefill", "prefill/model": "runner/prefill",
                   "prefill/scatter": "runner/prefill", "prefill/read": "runner/prefill",
                   "runner/prefill": "engine/admit", "window/claim": "runner/window",
                   "window/run": "runner/window", "window/read": "runner/window",
                   "runner/window": "engine/step", "controller/observe": "engine/step",
                   "controller/tune": "controller/observe",
                   "controller/adjust": "controller/observe", "runner/free": "engine/step"}
    for s in spans:
        if s.name in want_parent:
            assert parent(s).name == want_parent[s.name], (s, parent(s))
        if s.name.startswith("model/"):
            up = {a.name for a in ancestors(s)}
            assert "prefill/model" in up or "window/run" in up, s
        assert s.t0 <= s.t1 and (parent(s) is None or parent(s).t0 <= s.t0 <= s.t1
                                 <= parent(s).t1)
    # a request's spans share its identifier: an admission's rid is its prefill's item
    for s in spans:
        if s.name == "runner/prefill":
            assert parent(s).attrs["rid"] == s.attrs["item"] and s.attrs["S"] == P_LEN
    # one model/moe a MoE layer a prefill, numbered by layer; the first layer is dense
    m = model[0]
    moe_layers = [i for i in range(m.cfg.n_layers) if i >= m.cfg.first_k_dense]
    prefills = [s for s in spans if s.name == "runner/prefill"]
    assert len(prefills) == N
    for pf in prefills:
        under = [s for s in spans if pf.id in {a.id for a in ancestors(s)}]
        assert sorted(s.attrs["layer"] for s in under if s.name == "model/moe") == moe_layers
        assert [s.attrs["layer"] for s in under if s.name == "model/ffn"] == [0]
        assert len([s for s in under if s.name == "model/mla"]) == m.cfg.n_layers
    # one controller/observe a replayed step, each of the window's rows
    windows = [s for s in spans if s.name == "runner/window"]
    observes = [s for s in spans if s.name == "controller/observe"]
    assert len(observes) == sum(w.attrs["nd"] for w in windows) > len(windows)
    assert all(w.attrs["kind"] == "eager" and w.attrs["nd"] <= w.attrs["n"] for w in windows)
    by_parent = {}
    for o in observes:
        by_parent.setdefault(o.parent, []).append(o.attrs["B"])
    for w in windows:
        assert by_parent[w.parent] == [w.attrs["B"]] * w.attrs["nd"]
    assert ctl.stats["tunes"] == sum(s.name == "controller/tune" for s in spans) > 0
    assert ctl.stats["adjusts"] <= sum(s.name == "controller/adjust" for s in spans)


def test_on_and_off_serve_the_same(model):
    (r0, c0, _), (r1, c1, spans) = _serve(model, traced=False), _serve(model, traced=True)
    assert spans
    assert [(r.rid, r.tokens, r.final_tokens, r.exit_sites) for r in r0] == \
        [(r.rid, r.tokens, r.final_tokens, r.exit_sites) for r in r1]
    np.testing.assert_array_equal(c0.thresholds, c1.thresholds)
    assert (c0.active, c0.stats["tunes"], c0.stats["adjusts"]) == \
        (c1.active, c1.stats["tunes"], c1.stats["adjusts"])
    assert [(h["kind"], h["sample"]) for h in c0.history] == \
        [(h["kind"], h["sample"]) for h in c1.history]


def test_to_profiler_ns_meets_the_record_function_twins():
    from torch.profiler import ProfilerActivity, profile  # repro: allow[tier1-deps] — the port under test

    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.anchor()
        for i in range(24):
            with trace.span(f"twin/{i}", i=i):
                time.sleep(0.0005)
    spans = [s for s in trace.take() if s.name.startswith("twin/")]
    ev = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events() if e.name().startswith("twin/")}
    assert len(ev) == len(spans) == 24
    starts = [abs(trace.to_profiler_ns(s.t0) - ev[s.name][0]) for s in spans]
    ends = [abs(ev[s.name][1] - trace.to_profiler_ns(s.t1)) for s in spans]
    # per span, the gap is the twin's own entry or exit (and a busy host's
    # preemption); in the middle it is the clocks' agreement
    assert statistics.median(starts) < 50_000 and statistics.median(ends) < 50_000


def test_instrument_puts_the_methods_back(model):
    class Thing:
        def work(self, x):
            return 2 * x

    t = Thing()
    trace.instrument(t, {"work": ("thing/work", lambda x: {"x": x})})
    assert "work" not in vars(t)  # tracing off: nothing wrapped
    trace.enable()
    trace.instrument(t, {"work": ("thing/work", lambda x: {"x": x})})
    trace.instrument(t, {"work": "thing/twice"})  # once only
    assert t.work(3) == 6
    (s,) = trace.take()
    assert (s.name, s.attrs) == ("thing/work", {"x": 3})
    m, params = model
    prof = build_profile(m.cfg, mode="decode", chips=1, sites=m.sites)
    ctl = ApparateController(len(m.sites), prof, ControllerConfig(max_slots=2))
    eng = GenerativeEngine(prof, GenerativeConfig(), DecodeRunner(
        m, params, np.ones((1, 4), np.int64), kv_block_size=4), ctl)
    trace.instrument_engine(eng)
    assert {"observe", "_tune", "_adjust"} <= set(vars(ctl)) and "_make_adapter" in vars(eng)
    trace.disable()
    assert "work" not in vars(t) and t.work.__func__ is Thing.work
    assert not {"observe", "_tune", "_adjust"} & set(vars(ctl))
    assert "_make_adapter" not in vars(eng)
    assert ctl.observe.__func__ is ApparateController.observe


def test_graphs_count_windows_by_key_and_kind():
    g = WindowGraphs("cpu", capture=False)
    host = {"x": np.arange(3, dtype=np.int64)}
    trace.enable()
    for key in ((4, 1), (4, 1), (8, 2)):
        assert g.run(key, host, lambda st: st["x"].sum()).item() == 3
    spans = trace.take()
    assert g.by_key == {(4, 1): {"run": 2}, (8, 2): {"run": 1}} and g.pool_bytes == 0
    assert (g.runs, g.eagers, g.captures, g.replays, g.last) == (3, 0, 0, 0, "run")
    assert [(s.name, s.attrs["key"]) for s in spans] == [
        ("graph/run", (4, 1)), ("graph/run", (4, 1)), ("graph/run", (8, 2))]


def test_counters_and_recording():
    trace.annotate(a=0)  # off: nothing to annotate, nothing raised
    with trace.recording() as got:
        with trace.span("outer", a=1):
            with trace.span("inner"):
                trace.annotate(b=2)
    assert not trace.enabled()
    assert [(s.name, s.attrs) for s in got] == [("inner", {"b": 2}), ("outer", {"a": 1})]
    assert got[0].parent == got[1].id and got[1].parent == 0
    assert trace.take() == []  # a recording left off takes what it made
    trace.enable()
    with trace.recording() as got:
        with trace.span("kept"):
            pass
    assert trace.enabled() and [s.name for s in got] == ["kept"]
    assert [s.name for s in trace.take()] == ["kept"]
    with pytest.raises(KeyError), trace.span("fails", a=1):
        raise KeyError("no such slot")
    (s,) = trace.take()
    assert s.attrs == {"a": 1, "raised": "KeyError"} and trace._stack() == []
