"""Sync windows through the port's window graphs (``serving/graphs.py``) on
the CPU, where each window runs its body uncaptured over the same static
input buffers a CUDA graph replays on a card.

For tiny qwen2-1.5b, gpt2-medium, deepseek-v2-lite-16b, mamba2-2.7b and
gemma3-4b (8 layers: a local suffix after the periods), on contiguous rows
and on the paged pool, one schedule goes through three
runners at equal batch shapes: the JAX package's ``DecodeRunner``, the
port's eager runner and the port's runner on uncaptured window graphs. The
two port runners must agree bit for bit (records, ``n_done``, host and
allocator state, every cache leaf); the port and the reference by the
tolerance rule (labels exact, floats within 1e-4, states exact). The
schedule covers bucket changes 8 -> 4 -> 2 -> 1, window lengths 1-4, a
threshold change within one key, an active-set change, a window that every
row exits after one step, row and pool growth (which drop the windows),
swap out and in, copy-on-write under the prefix cache (qwen2) and chunked
prefill. The windows built must be exactly the keys seen since the last
growth."""
import contextlib
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.serving as RS  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import repro_torch.serving as TS  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
import repro_torch.serving.graphs as G  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels import counted_wrappers  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test

REC_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model fp32 records and caches
P_LEN, MAX_NEW, BS = 6, 30, 4
ARCHS = ["qwen2-1.5b", "gpt2-medium", "deepseek-v2-lite-16b", "mamba2-2.7b", "gemma3-4b"]


def _bucket(n):
    b = 1
    while b < n:
        b *= 2
    return b


def _runners(arch, paged, prompts, seed=0, **kw):
    """(JAX runner, port eager runner, port runner on uncaptured graphs)
    over one set of weights."""
    ref_cfg, port_cfg = get_tiny(arch), port_tiny(arch)
    if ref_cfg.window:  # gemma3: 8 layers, so a local suffix's leaves ride in the graph too
        ref_cfg, port_cfg = (c.replace(n_layers=8) for c in (ref_cfg, port_cfg))
    attn = "paged" if paged else ("dense" if ref_cfg.mla or ref_cfg.ssm else "ref")
    if ref_cfg.mla:
        ref_cfg, port_cfg = (c.replace(mla_absorbed=True) for c in (ref_cfg, port_cfg))
    rm = ref_build(ref_cfg.replace(decode_attn=attn))
    tm = build_model(port_cfg.replace(decode_attn="paged-kernel" if paged else "kernel",
                                      pallas_head="kernel"))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        rm.init(jax.random.PRNGKey(seed)))
    kw = {"max_new_tokens": MAX_NEW, "max_slots": 2, "n_slots": 2, **kw}
    if paged:
        kw["kv_block_size"] = BS
    eager = TS.DecodeRunner(tm, from_numpy_params(p, "cpu"), prompts, **kw)
    graphed = TS.DecodeRunner(tm, from_numpy_params(p, "cpu"), prompts, **kw)
    assert eager.graphs is None and graphed.graphs is None  # None on the CPU: eager
    graphed.graphs = G.WindowGraphs(graphed.device, capture=False)
    return RS.DecodeRunner(rm, jax.tree.map(jnp.asarray, p), prompts, **kw), eager, graphed


def _state(r):
    out = {"pos": r._pos.tolist(), "tok": r._tok.tolist(), "live": sorted(r._live),
           "pf": dict(r._pf_progress), "kv": r.kv_stats()}
    if r._alloc is not None:
        al = r._alloc
        out["alloc"] = (al.table.tolist(), al.owned.tolist(), al.refcount.tolist(),
                        sorted(al._free), al.n_free, al.peak_blocks, al.pins)
    return out


class _Three:
    """One call to the reference, the eager port runner and the graphed
    port runner; after every ``step_multi`` the graphed runner's windows
    must be the keys seen since its cache last moved."""

    def __init__(self, ref, eager, graphed):
        self.ref, self.eager, self.graphed = ref, eager, graphed
        self.keys, self.cache_id, self.windows = set(), None, 0

    def _key(self, slots, n, act):
        r = self.graphed
        rows = min(_bucket(len(slots)), r._rows)
        n = min(n, max(1, min(r._cache_len - int(r._pos[s]) for s in slots)))
        return (rows, n, tuple(sorted(act)), r.paged)

    def __call__(self, name, *args, port_args=None, graphed_args=None):
        key = self._key(args[0], args[2], args[1]) if name == "step_multi" else None
        rr = getattr(self.ref, name)(*args)
        rt = getattr(self.eager, name)(*(port_args or args))
        rg = getattr(self.graphed, name)(*(graphed_args or port_args or args))
        if name == "step_multi":
            self.windows += 1
            for i, (a, g, b) in enumerate(zip(rt, rg, rr)):
                np.testing.assert_array_equal(g, a, err_msg=f"graphed vs eager record {i}")
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(a, np.asarray(b), **REC_TOL)
                else:
                    np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"record {i}")
        elif name != "swap_out":
            assert rt == rr == rg, (name, rt, rr, rg)
        assert _state(self.eager) == _state(self.ref), name
        assert _state(self.graphed) == _state(self.eager), name
        ids = tuple(id(leaf) for leaf in tree_leaves(self.graphed._cache))
        if ids != self.cache_id:  # grown: every window of the old cache is gone
            self.keys, self.cache_id = set(), ids
        if key is not None:
            self.keys.add(key)
            assert set(self.graphed.graphs.windows) == self.keys, name
        return rr, rt, rg

    def check_caches(self):
        """Every cache leaf: graphed == eager bit for bit, eager ~ reference
        (a pool outside its trash block 0, where the port writes what the
        reference drops)."""
        axes = self.eager._pool_axes if self.eager.paged else None
        leaves = zip(tree_leaves(self.graphed._cache), tree_leaves(self.eager._cache),
                     jax.tree.leaves(self.ref._cache))
        for i, (g, a, b) in enumerate(leaves):
            assert torch.equal(g, a), f"cache leaf {i}"
            a, b = to_numpy(a), np.asarray(b)
            if axes is not None:
                a, b = np.delete(a, 0, axes[i]), np.delete(b, 0, axes[i])
            np.testing.assert_allclose(a, b, err_msg=f"cache leaf {i}", **REC_TOL)


def _prompts(arch, n=10, seed=3):
    prompts = np.random.default_rng(seed).integers(1, 512, (n, P_LEN))
    if arch == "qwen2-1.5b":
        prompts[1] = prompts[0]  # a whole-prompt hit, its partial tail block shared
        prompts[2, :BS] = prompts[0, :BS]  # a partial hit
    return prompts


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_window_schedule_agrees(arch, paged):
    prefix = paged and arch == "qwen2-1.5b"
    ref, eager, graphed = _runners(arch, paged, _prompts(arch), prefix_cache=prefix)
    run = _Three(ref, eager, graphed)
    a, b = [0, 1], [1]
    thr, thr2 = np.array([0.5, 0.9], np.float32), np.array([0.3, 0.99], np.float32)
    run("start", 0, 0)
    run("start", 1, 1)
    run("step_multi", [0, 1], a, 1, thr)  # B 2; with the prefix cache both copy on write
    for s in (2, 3):  # rows 2 -> 4 (the paged pool grows with them)
        run("start", s, s)
    run("step_multi", [0, 1, 2, 3], a, 2, thr)
    for s in range(4, 8):  # rows 4 -> 8
        run("start", s, s)
    eight = list(range(8))
    run("step_multi", eight, a, 4, thr)
    run("step_multi", eight, a, 4, thr2)  # the same window, other thresholds
    run("step_multi", eight, b, 3, thr[1:])  # another active set
    _, rec, _ = run("step_multi", eight, a, 4, np.ones(2, np.float32))
    assert rec[2].shape[0] == 1  # every row exits at the first step
    for s in range(4, 8):
        run("free", s)
    run("step_multi", [0, 1, 2, 3], a, 2, thr)  # B 4 again, on the grown cache
    run("step_multi", [0, 1, 2, 3], a, 2, thr2)
    if paged:
        (h, he, hg) = run("swap_out", 3)
        run("step_multi", [0, 1, 2], a, 1, thr)  # the swapped slot's row pads the bucket
        run("swap_in", 3, h, port_args=(3, he), graphed_args=(3, hg))
    run("prefill_begin", 4, 8, 3)
    run("step_multi", [0, 1, 2, 3], a, 1, thr)  # beside a slot mid-prefill
    run("prefill_resume", 4, 3)
    run("step_multi", [0, 1, 2, 3, 4], a, 2, thr)  # B 5 in a bucket of 8
    for s in (2, 3, 4):
        run("free", s)
    run("step_multi", [0, 1], a, 2, thr)
    run("free", 1)
    run("step_multi", [0], a, 1, thr)
    run("step_multi", [0], [], 1, np.zeros(0, np.float32))
    run.check_caches()
    kv = graphed.kv_stats()
    if prefix:
        assert kv["prefix_hits"] >= 2 and kv["cow_copies"] >= 1, kv
    if paged:
        assert kv["swap_ins"] == 1, kv
    assert graphed.graphs.runs == run.windows
    assert graphed.decode_steps == eager.decode_steps > 0


def test_graphs_true_needs_a_card():
    tm = build_model(port_tiny("qwen2-1.5b").replace(decode_attn="kernel", pallas_head="kernel"))
    params = tm.init(0, device="cpu")
    prompts = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TS.DecodeRunner(tm, params, prompts, graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        G.WindowGraphs("cpu", capture=True)
    assert TS.DecodeRunner(tm, params, prompts, graphs=False).graphs is None


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: executes nothing;
    ``capturing`` is the graph a stand-in launch records its nodes into."""

    capturing = None

    def __init__(self, keep_graph=False):
        self.nodes, self.replays = [], 0

    def capture_begin(self, pool=None):
        _FakeGraph.capturing = self

    def capture_end(self):
        _FakeGraph.capturing = None

    def instantiate(self):
        pass

    def replay(self):
        self.replays += 1


class _FakeStream:
    cuda_stream = 0

    def wait_stream(self, other):
        pass


def _fake_nodes(graph):
    counts = {k: graph.nodes.count(k) for k, _ in G.NODE_KINDS}
    return counts, [], len(graph.nodes)


def _stand_in_graphs(monkeypatch):
    """A ``WindowGraphs`` that takes the capture path on the CPU over
    ``_FakeGraph``, every launch count at 0, and a stand-in launch:
    ``launch(wrapper, *node kinds)`` counts a launch and records its nodes
    into the graph being captured (``record=False``: a launch whose node
    the graph lost)."""
    fns = counted_wrappers()
    for f in fns.values():
        monkeypatch.setattr(f, "launches", 0)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    monkeypatch.setattr(G, "kernel_nodes", _fake_nodes)
    graphs = G.WindowGraphs("cpu", capture=False)
    graphs.capture, graphs._stream = True, _FakeStream()

    def launch(name, *kinds, record=True):
        fns[name].launches += 1
        if _FakeGraph.capturing is not None and record:
            _FakeGraph.capturing.nodes.extend(kinds)

    return graphs, fns, launch


def test_replays_count_the_kernels_they_run(monkeypatch):
    """A counted stand-in body (3 decode-attention launches and one exit
    head a window) through the capture bookkeeping: a key's first window
    runs eager, its second is captured (its counts put back, its nodes
    checked against them) and replayed, and each replay adds the counts,
    so N windows count what N eager windows do."""
    graphs, fns, launch = _stand_in_graphs(monkeypatch)
    ran = []

    def body(static):
        ran.append(static["x"].clone())
        for _ in range(3):
            launch("decode_attention", "decode_attention")
        launch("ramp_head_exit", "ramp_head", "ramp_merge")
        return (static["x"] * 2,)

    N = 5
    kinds = []
    for i in range(N):
        out = graphs.run("key", {"x": np.full(3, i, np.int64)}, body)
        kinds.append(graphs.last)
    assert kinds == ["eager", "capture"] + ["replay"] * (N - 2)
    assert (graphs.eagers, graphs.captures, graphs.replays) == (1, 1, N - 2)
    assert len(ran) == 2  # the eager run and the capture
    assert {k: f.launches for k, f in fns.items() if f.launches} == {
        "decode_attention": 3 * N, "ramp_head_exit": N}
    w = graphs.windows["key"]
    assert w.graph.replays == N - 1  # the capture window replays too
    assert {k: v for k, v in w.nodes.items() if v} == {
        "decode_attention": 3, "ramp_head": 1, "ramp_merge": 1}
    assert w.inputs["x"].tolist() == [N - 1] * 3  # the last inputs
    assert out is w.outputs


def test_capture_refuses_a_graph_that_lost_a_kernel(monkeypatch):
    """A capture whose graph holds one decode-attention node fewer than the
    launches it counted raises, and puts the counts back: nothing ran."""
    graphs, fns, launch = _stand_in_graphs(monkeypatch)

    def body(static):
        launch("decode_attention", "decode_attention")
        launch("decode_attention", "decode_attention", record=False)
        return (static["x"],)

    host = {"x": np.zeros(2, np.int64)}
    graphs.run("key", host, body)  # eager
    with pytest.raises(RuntimeError, match="kernel nodes"):
        graphs.run("key", host, body)
    assert fns["decode_attention"].launches == 2 and graphs.windows["key"].graph is None


@pytest.mark.parametrize("case", ["equal", "lost", "extra", "heads", "combine"])
def test_check_nodes(case):
    """Each wrapper's count against its kernel's nodes: #2 and #3 share
    one tile pass and merge; #6's combine comes at most once a walk."""
    deltas = {k: 0 for k in counted_wrappers()}
    deltas.update(paged_mla_decode_attention=4, ramp_head_stats=1, ramp_head_exit=4)
    nodes = {k: 0 for k, _ in G.NODE_KINDS}
    nodes.update(paged_mla_decode_attention=4, mla_combine=4, ramp_head=5, ramp_merge=5)
    if case == "lost":
        nodes["paged_mla_decode_attention"] = 3
    elif case == "extra":
        nodes["decode_attention"] = 1
    elif case == "heads":
        nodes["ramp_merge"] = 4
    elif case == "combine":
        nodes["mla_combine"] = 5
    if case == "equal":
        G.check_nodes(nodes, deltas)
    else:
        with pytest.raises(RuntimeError, match="kernel nodes"):
            G.check_nodes(nodes, deltas)


def test_runner_is_freed_without_the_cycle_collector():
    """A runner with window graphs holds no reference cycle: it goes when
    its last reference does, so no collection can free its graphs later,
    in the middle of another runner's capture."""
    tm = build_model(port_tiny("qwen2-1.5b").replace(decode_attn="kernel", pallas_head="kernel"))
    params = tm.init(0, device="cpu")
    r = TS.DecodeRunner(tm, params, np.ones((2, 4), np.int64), max_new_tokens=4, max_slots=2)
    r.graphs = G.WindowGraphs(r.device, capture=False)
    r.start(0, 0)
    r.step_multi([0], [0], 2, np.array([0.5], np.float32))
    assert r.graphs.windows
    gone = weakref.ref(r)
    gc.disable()
    try:
        del r
        assert gone() is None
    finally:
        gc.enable()


def test_capture_runs_with_the_cycle_collector_off(monkeypatch):
    """The collector is off exactly while a graph is captured, and back on
    after it, also after a capture that raises: a collection there could
    free a graph that a cycle kept (the serving engine keeps its runner in
    cycles), and a graph reset mid-capture breaks the capture."""
    graphs, fns, launch = _stand_in_graphs(monkeypatch)
    seen = []

    def body(static):
        seen.append((_FakeGraph.capturing is not None, gc.isenabled()))
        launch("decode_attention", "decode_attention", record=static["x"][0].item() == 0)
        return (static["x"],)

    assert gc.isenabled()
    for x in (0, 0, 0):
        graphs.run("key", {"x": np.full(1, x, np.int64)}, body)
    with pytest.raises(RuntimeError, match="kernel nodes"):  # a graph that lost its node
        graphs.run("lost", {"x": np.ones(1, np.int64)}, body)
        graphs.run("lost", {"x": np.ones(1, np.int64)}, body)
    assert seen == [(False, True), (True, False), (False, True), (True, False)]
    assert gc.isenabled()
