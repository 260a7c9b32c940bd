"""One CUDA graph per sync window: the port's counterpart of the JAX
runner's memoized jitted window programs (``_decode_multi_fn*`` in its
``serving/runner.py``), one compiled dispatch a window.

``WindowGraphs`` keeps one ``Window`` per key ``(B, n, active sites,
paged)``. A window holds static input buffers and, on a card, one
``torch.cuda.CUDAGraph``. ``run`` copies a window's inputs into the buffers
and hands them to a body that reads only those buffers, the params and the
cache leaves; the body is passed on every call and never kept, so a window
holds no Python object of its runner and a runner goes with its last
reference. Then:

- captured (a card): the first window of a key runs the body eager on the
  capture stream, which also sizes every workspace, cuBLAS handle and
  kernel attribute; the second captures it (a capture executes nothing)
  and replays the graph; every later one replays it, one launch for the
  whole window. A key seen once costs one eager window;
- uncaptured (the CPU tests): runs the body over the same buffers, so a
  body that closes over a per-call tensor gives a wrong record there too.

All graphs of one ``WindowGraphs`` share one memory pool and replay one at
a time on one stream. Each window keeps its static inputs and outputs, so
no later capture reuses their memory. The kernels' ``launches`` counts
stay counts of kernels that ran: a capture records each count's change and
puts it back, reads the graph's kernel nodes by name and raises unless
they equal those changes, and each replay adds the changes, so every count
a replay adds rests on nodes read from that graph. Nothing here falls back
to eager: a failed capture or replay raises. A capture runs with the
cyclic collector off: the serving engine (a verbatim copy of the JAX
package's) keeps its runner in reference cycles, and a collection inside
a capture could free that runner's graphs there.
"""
from __future__ import annotations

import ctypes
import gc
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.kernels import counted_wrappers

# the port's kernels by demangled name: each counted wrapper launches its
# first kind once a call (#2 and #3 launch the same tile pass and merge;
# #6 adds its combine where it splits the key axis)
NODE_KINDS = (("decode_attention", r"decode_(bf16|f32)_kernel<\d+, false>"),
              ("paged_decode_attention", r"decode_(bf16|f32)_kernel<\d+, true>"),
              ("paged_mla_decode_attention", r"mla_(bf16|f32)_kernel\("),
              ("mla_combine", r"mla_combine_kernel<"),
              ("ramp_head", r"(ramp_tiles_bf16|tiles_vmajor|tiles_dmajor)<"),
              ("ramp_merge", r"merge_tiles\("),
              ("flash_attention", r"flash_attention_(bf16|f32)\("),
              ("ssd_chunked", r"ssd_(bf16|f32)_kernel\("))


def _demangle(name: str) -> str:
    cxa = getattr(ctypes.CDLL("libstdc++.so.6"), "__cxa_demangle")
    cxa.restype = ctypes.c_void_p
    status = ctypes.c_int(-1)
    p = cxa(name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not p:
        return name
    out = ctypes.string_at(p).decode()
    ctypes.CDLL(None).free(ctypes.c_void_p(p))
    return out


def kernel_nodes(graph, with_edges: bool = False):
    """The kernel nodes of a captured graph (a ``CUDAGraph`` made with
    ``keep_graph=True``, read before or after ``instantiate``) through the
    driver API. Returns ({kind of NODE_KINDS: nodes}, [(from kind, to kind,
    edge type)] for the edges that touch such a node (``with_edges``; else
    []), the number of kernel nodes)."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"window graph: {what} returned CUresult {rc}")

    h = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(h, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(h, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind_of_func, kind, n_kernels = {}, {}, 0
    params = (ctypes.c_char * 256)()  # CUDA_KERNEL_NODE_PARAMS_v2: func comes first
    for nd in nodes:
        t = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(nd), ctypes.byref(t)), "cuGraphNodeGetType")
        if t.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        n_kernels += 1
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(nd), params),
              "cuGraphKernelNodeGetParams_v2")
        func = ctypes.c_void_p.from_buffer(params).value
        if func not in kind_of_func:
            name = ctypes.c_char_p()
            ok = func and cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)) == 0
            nm = _demangle(name.value.decode()) if ok else "?"
            kind_of_func[func] = next((k for k, pat in NODE_KINDS if re.search(pat, nm)), None)
        if kind_of_func[func] is not None:
            kind[nd] = kind_of_func[func]
    counts = {k: 0 for k, _ in NODE_KINDS}
    for k in kind.values():
        counts[k] += 1
    ne = ctypes.c_size_t(0)
    if with_edges:
        check(cu.cuGraphGetEdges_v2(h, None, None, None, ctypes.byref(ne)),
              "cuGraphGetEdges_v2")
    if ne.value == 0:
        return counts, [], n_kernels
    fr, to = (ctypes.c_void_p * ne.value)(), (ctypes.c_void_p * ne.value)()
    data = (ctypes.c_ubyte * (8 * ne.value))()  # CUgraphEdgeData: from_port, to_port, type
    check(cu.cuGraphGetEdges_v2(h, fr, to, data, ctypes.byref(ne)), "cuGraphGetEdges_v2")
    edges = [(kind.get(fr[i]), kind.get(to[i]), data[8 * i + 2]) for i in range(ne.value)
             if kind.get(fr[i]) or kind.get(to[i])]
    return counts, edges, n_kernels


def check_nodes(nodes: Dict[str, int], deltas: Dict[str, int]) -> None:
    """Raise unless a graph's kernel nodes (``kernel_nodes``' counts) are
    the launches its capture counted (``deltas``, by wrapper)."""
    heads = deltas["ramp_head_stats"] + deltas["ramp_head_exit"]
    want = {k: deltas[k] for k in ("decode_attention", "paged_decode_attention",
                                   "paged_mla_decode_attention", "flash_attention",
                                   "ssd_chunked")}
    want.update(ramp_head=heads, ramp_merge=heads)
    bad = {k: (nodes[k], v) for k, v in want.items() if nodes[k] != v}
    if nodes["mla_combine"] > nodes["paged_mla_decode_attention"]:
        bad["mla_combine"] = (nodes["mla_combine"], nodes["paged_mla_decode_attention"])
    if bad:
        raise RuntimeError("window graph: its kernel nodes disagree with the launches its "
                           f"capture counted ({{kind: (nodes, launches)}}: {bad})")


class Window:
    """One key's static buffers, graph, outputs and counter deltas."""

    def __init__(self, inputs: Dict[str, torch.Tensor]):
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.deltas: Dict[str, int] = {}  # launches a replay runs, by wrapper
        self.nodes: Dict[str, int] = {}  # the graph's kernel nodes, by kind
        self.seen = False  # a first window ran eager


class WindowGraphs:
    """The window cache of one runner (see the module docstring).
    ``by_key`` counts the windows by key and kind ("eager", "capture",
    "replay" or "run"), ``eagers``/``captures``/``replays``/``runs`` total
    them by kind and ``last`` names the last one's kind; ``pool_bytes`` is
    what the graphs' private pool has reserved, read after each capture.
    Each window is the span ``graph/<kind>`` (``repro_torch.trace``)."""

    def __init__(self, device, capture: bool):
        self.device = torch.device(device)
        self.capture = bool(capture)
        if self.capture and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        self.windows: Dict[tuple, Window] = {}
        self.last: Optional[str] = None
        self.by_key: Dict[tuple, Dict[str, int]] = {}
        self.pool_bytes = 0
        self._fns = counted_wrappers()
        self._stream = torch.cuda.Stream(self.device) if self.capture else None
        self._pool = torch.cuda.graph_pool_handle() if self.capture else None

    def clear(self) -> None:
        """Drop every window: the cache they were built over moved."""
        self.windows = {}

    def run(self, key, host: Dict[str, np.ndarray], body: Callable[[dict], tuple]) -> tuple:
        """The window of ``key`` on the inputs ``host`` (name -> array):
        ``body(static)`` runs it over the static buffers. Returns the body's
        outputs."""
        w = self.windows.get(key)
        if w is None:
            static = {k: torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                     device=self.device) for k, a in host.items()}
            w = self.windows[key] = Window(static)
        for k, a in host.items():
            src = torch.from_numpy(np.ascontiguousarray(a))
            if self.capture:
                src = src.pin_memory()
            w.inputs[k].copy_(src, non_blocking=self.capture)
        if not self.capture:
            self._count(key, "run")
            with trace.span("graph/run", key=key):
                return body(w.inputs)
        if w.graph is not None:
            self._count(key, "replay")
        elif w.seen:
            with trace.span("graph/capture", key=key):
                self._capture(w, body)
            self._count(key, "capture")
        else:  # first sight: eager on the capture stream, sizing what a capture needs
            w.seen = True
            self._count(key, "eager")
            with trace.span("graph/eager", key=key):
                return self._on_capture_stream(lambda: body(w.inputs))
        with trace.span("graph/replay", key=key):
            w.graph.replay()
        for name, f in self._fns.items():
            f.launches += w.deltas[name]
        return w.outputs

    def _count(self, key, kind: str) -> None:
        kinds = self.by_key.setdefault(key, {})
        kinds[kind], self.last = kinds.get(kind, 0) + 1, kind

    def _total(self, kind: str) -> int:
        return sum(kinds.get(kind, 0) for kinds in self.by_key.values())

    eagers = property(lambda self: self._total("eager"))
    captures = property(lambda self: self._total("capture"))
    replays = property(lambda self: self._total("replay"))
    runs = property(lambda self: self._total("run"))

    def _on_capture_stream(self, fn):
        cur, s = torch.cuda.current_stream(self.device), self._stream
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out = fn()
        cur.wait_stream(s)
        return out

    def _capture(self, w: Window, body) -> None:
        """Capture the key's window (its second); ``run`` replays it."""
        fns = self._fns
        before = {name: f.launches for name, f in fns.items()}
        g = torch.cuda.CUDAGraph(keep_graph=True)

        def capture():
            # no cyclic collection inside the capture: a graph it freed there
            # (another runner's, kept by a cycle such as its engine's) would
            # be reset mid-capture, a call the capture refuses
            gc_was_on = gc.isenabled()
            gc.disable()
            g.capture_begin(pool=self._pool)
            try:
                w.outputs = body(w.inputs)
            finally:
                g.capture_end()
                if gc_was_on:
                    gc.enable()
                w.deltas = {name: f.launches - before[name] for name, f in fns.items()}
                for name, f in fns.items():  # a capture executes nothing
                    f.launches = before[name]

        reserved = torch.cuda.memory_reserved(self.device)
        self._on_capture_stream(capture)
        w.nodes = kernel_nodes(g)[0]
        check_nodes(w.nodes, w.deltas)
        g.instantiate()
        w.graph = g
        # what the capture added to the reserve is the private pool's: nothing
        # else allocates on this thread while it runs
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
