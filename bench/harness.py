"""One run of one cell of the port's benchmark.

Everything a cell is comes from files that the harness finds by name:
``BENCHMARK.json`` names the cell's configuration and traffic, the
configuration's file (``configs/<config>.json``) holds the model's sizes
and which of them the program's own config has to hold (``port``), the
cell's file (``workloads/<cell>.json``) its traffic mix, slots and
correctness limits, the plain reference is its family's
(``reference/<model_type>.py``), and each metric is a reader of its own
(``metrics/<metric>.py``, a ``read(ctx)`` that returns a number or None).
What every cell shares is ``SETTINGS``.

A run (``Session``):

1. set-up: imports, the port's kernels built (before CUDA starts), the
   weights drawn on the device from the seed (``weights.py``), the
   program's ``DecodeRunner`` (paged pool, window graphs), its
   ``ApparateController`` and a warm-up engine run of the cell's mix from a
   stream of its own: a fixed number of windows, and on until the window
   graphs the mix reaches are captured;
2. the window: a fresh ``GenerativeEngine`` run over the cell's backlog on
   the same runner and controller. The runner is wrapped (``timed``): each
   ``start``, ``step_multi`` and ``free`` is timed on the host clock (each
   ends in a host read, so the time holds the device work) and what it
   returned is kept by request. The first runner call at or after
   ``--seconds`` closes the window. With ``--trace 1`` a
   ``torch.profiler`` trace covers a steady stretch inside it;
3. after the window: the peak memory read, the program's serving state
   freed, the sample of finished requests held against the plain
   reference (``check.py``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench import check, traffic, weights
from bench.shapes import arch as arch_of

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
CLOCK = time.perf_counter
# what every cell shares: the launcher's serving settings (``launch/serve.py``:
# windows of 4 steps, a paged pool of 16-token blocks, 4 ramp slots, a ramp
# budget of 0.6, an agreement of 0.99), the warm-up (``requests`` from its own
# stream; ``windows`` dispatched, then on until every window key is captured,
# at most ``max_s``) and the traced stretch (``seconds`` of whole calls from
# ``start_frac`` into the window, ``settle`` after the profiler starts)
SETTINGS = {
    "steps_per_sync": 4, "kv_block_size": 16,
    "controller": {"slots": 4, "budget": 0.6, "acc": 0.99},
    "backlog": traffic.BACKLOG, "block": traffic.BLOCK,
    "warmup": {"requests": 512, "windows": 48, "max_s": 120.0},
    "trace": {"start_frac": 0.3, "settle": 0.5, "seconds": 2.0},
}


class WindowClosed(Exception):
    """Raised from the runner wrapper at the first call past the window."""


class WarmupDone(Exception):
    """Raised from the runner wrapper once the warm-up has what it needs."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``name`` as its files give it."""
    man = read_json(root / "BENCHMARK.json")
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    mix = read_json(root / "bench" / "workloads" / f"{name}.json")
    if mix["traffic"] != entry["traffic"]:
        raise ValueError(f"{name}: the workload file's traffic {mix['traffic']!r} is not "
                         f"BENCHMARK.json's {entry['traffic']!r}")
    return SimpleNamespace(
        name=name, entry=entry, config=read_json(root / conf["file"]), mix=mix,
        end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in man["per_layer"] if _applies(m, name)], root=root)


def reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read`` of metric ``name`` (``metrics/<name>.py``)."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# -- the runner wrapper -------------------------------------------------------


class Recorder:
    """What the wrapped runner did, call by call and request by request.

    ``deadline`` closes the window; ``stop`` (a predicate on the recorder)
    ends a warm-up; ``tracer`` starts and stops a profiler at call
    boundaries. Each request record holds its served tokens, its ramp
    records a window at a time (``check.site_records`` reads them) and the
    host times of its first and last token."""

    def __init__(self, n_tokens: np.ndarray, prompt_len: int):
        self.n_tokens, self.S = n_tokens, prompt_len
        self.calls: List[dict] = []
        self.reqs: Dict[int, dict] = {}
        self.slot_item: Dict[int, int] = {}
        self.deadline: Optional[float] = None
        self.stop: Optional[Callable] = None
        self.tracer = None
        self.off = False  # after a close: calls pass unrecorded
        self.t_close = None
        self.next_id = 0  # the id the next call gets (its profiler mark names it)

    def before(self) -> float:
        now = CLOCK()
        if self.off:
            return now
        if self.deadline is not None and now >= self.deadline:
            self.t_close, self.off = now, True
            raise WindowClosed
        if self.stop is not None and self.stop(self, now):
            self.off = True
            raise WarmupDone
        if self.tracer is not None:
            self.tracer.before(now)
        return now

    def mark(self, kind: str) -> str:
        """The profiler mark of the next call."""
        return f"bench.{kind}#{self.next_id}"

    def _done(self, call: dict) -> None:
        call["id"] = self.next_id
        self.next_id += 1
        self.calls.append(call)
        if self.tracer is not None:
            self.tracer.after(call)

    def started(self, slot: int, item: int, tok: int, t0: float) -> None:
        t1 = CLOCK()
        if self.off:
            return
        self.slot_item[slot] = item
        self.reqs[item] = {"item": item, "n": int(self.n_tokens[item]), "tokens": [int(tok)],
                           "ramps": [], "t_first": t1, "t_last": t1}
        self._done({"kind": "start", "t0": t0, "t1": t1, "tokens": 1, "S": self.S})

    def stepped(self, slots, active, out, graph: str, t0: float) -> None:
        t1 = CLOCK()
        if self.off:
            return
        labels, unc, finals, _ = out
        nd = finals.shape[0]
        act = tuple(sorted(active))
        pos0 = []
        for j, slot in enumerate(slots):
            r = self.reqs[self.slot_item[slot]]
            pos0.append(self.S + len(r["tokens"]) - 1)
            if act:  # (first token index, sites, labels (nd, K), max-probabilities (nd, K))
                r["ramps"].append((len(r["tokens"]), act, labels[:, :, j],
                                   1.0 - unc[:, :, j].astype(np.float64)))
            r["tokens"].extend(finals[:, j].tolist())
            r["t_last"] = t1
        self._done({"kind": "step", "t0": t0, "t1": t1, "tokens": nd * len(slots),
                    "n": nd, "pos0": pos0, "act": act, "graph": graph})

    def freed(self, slot: int, t0: float) -> None:
        t1 = CLOCK()
        if self.off:
            return
        self.slot_item.pop(slot, None)
        self._done({"kind": "free", "t0": t0, "t1": t1, "tokens": 0})


def timed(runner_cls):
    """``runner_cls`` with each engine-facing call recorded in ``rec`` and
    marked for the profiler."""
    from torch.profiler import record_function

    class Timed(runner_cls):
        rec: Recorder = None

        def start(self, slot, item):
            t0 = self.rec.before()
            with record_function(self.rec.mark("start")):
                tok = super().start(slot, item)
            self.rec.started(slot, item, tok, t0)
            return tok

        def step_multi(self, slots, active, n_steps, thresholds):
            t0 = self.rec.before()
            with record_function(self.rec.mark("step")):
                out = super().step_multi(slots, active, n_steps, thresholds)
            graph = "eager" if self.graphs is None else self.graphs.last
            self.rec.stepped(list(slots), active, out, graph, t0)
            return out

        def free(self, slot):
            t0 = self.rec.before()
            with record_function(self.rec.mark("free")):
                super().free(slot)
            self.rec.freed(slot, t0)

    return Timed


def warm_profiler(device) -> None:
    """Start and stop the profiler once on a trivial device operation: its
    first start (CUPTI's set-up, seconds) then falls in set-up, not in the
    window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


class Tracer:
    """A ``torch.profiler`` trace of a stretch of whole runner calls. The
    profiler starts at the first call at or after ``at``; the stretch is the
    calls that start ``settle`` seconds later or after (the profiler's own
    start-up stays out of it) and end within ``seconds`` of the first; the
    profiler stops after the last of them."""

    def __init__(self, at: float, seconds: float, settle: float, cuda: bool = True):
        self.at, self.seconds, self.settle, self.cuda = at, seconds, settle, cuda
        self.prof = None
        self.on = self.off = self.begin = None  # host times: profiler on and off, stretch start
        self.ids = []  # the stretch's call ids

    def before(self, now: float) -> None:
        if self.prof is None and now >= self.at:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                torch.cuda.synchronize()
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.on = CLOCK()
            log(f"trace: the profiler took {self.on - now:.3f} s to start")
        elif self.prof is not None and self.off is None and self.begin is None \
                and now >= self.on + self.settle:
            self.begin = now

    def after(self, call: dict) -> None:
        if self.begin is None or self.off is not None or call["t0"] < self.begin:
            return
        self.ids.append(call["id"])
        if call["t1"] - self.begin >= self.seconds:
            self.close()

    def close(self) -> None:
        if self.prof is not None and self.off is None:
            t = CLOCK()
            if self.cuda:
                torch.cuda.synchronize()
            self.prof.stop()
            self.off = CLOCK()
            log(f"trace: the profiler took {self.off - t:.3f} s to stop")

    def stretch(self, rec: Recorder) -> Optional[SimpleNamespace]:
        """The stretch's calls, device operations and call marks (each call's
        ``record_function`` span, by call id), on the profiler's clock
        (ns)."""
        if self.off is None or not self.ids:
            return None
        want = set(self.ids)
        dev, marks = [], {}
        for e in self.prof.profiler.kineto_results.events():
            name, on_device = e.name(), str(e.device_type()).endswith("CUDA")
            if name.startswith("bench."):  # a call's mark (its device-side twin skipped)
                k, _, i = name[6:].partition("#")
                if not on_device and int(i) in want:
                    marks[int(i)] = (k, e.start_ns(), e.start_ns() + e.duration_ns())
            elif on_device:  # a kernel, a copy or a fill
                dev.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        calls = [c for c in rec.calls if c["id"] in want and c["id"] in marks]
        if len(calls) < len(want):
            log(f"trace: {len(want) - len(calls)} of the stretch's {len(want)} calls have no "
                "mark; the stretch is read from the others")
        if not calls:
            return None
        m = [marks[c["id"]] for c in calls]
        t0, t1 = m[0][1], m[-1][2]
        dev = sorted((d for d in dev if d[2] > t0 and d[1] < t1), key=lambda d: d[1])
        return SimpleNamespace(calls=calls, marks=m, dev=dev, t0_ns=t0, t1_ns=t1)


# -- the run ------------------------------------------------------------------


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def port_view(cfg, holds: dict) -> dict:
    """The port's config ``cfg`` under the configuration file's key names:
    ``holds`` maps each file key the port has to hold to its attribute."""
    return {key: getattr(cfg, attr) for key, attr in holds.items()}


class Session:
    """One cell served by the port; see the module docstring. ``tiny``
    serves the port's TINY variant of the configuration (the CPU tests)."""

    def __init__(self, cell: SimpleNamespace, seed: int, device: str = "cuda",
                 tiny: bool = False):
        self.cell, self.seed, self.tiny = cell, int(seed), tiny
        self.device = torch.device(device)
        self.mix = cell.mix
        self.settings = dict(SETTINGS)  # the CPU tests shrink it
        self.parts: Dict[str, float] = {}
        self.buffers = None

    # -- set-up -------------------------------------------------------------

    def setup(self, process_start: float, trace: bool = False) -> None:
        mix, st, t = self.mix, self.settings, CLOCK()
        if self.device.type == "cuda":
            from repro_torch.kernels import build as kbuild

            kbuild.build()  # before CUDA starts: the profiler sees kernels built so
            self.parts["kernels"] = CLOCK() - t
            t = CLOCK()
        from repro_torch.configs import get_config, get_tiny
        from repro_torch.core import ApparateController, ControllerConfig, build_profile
        from repro_torch.models import build_model
        from repro_torch.serving import DecodeRunner, GenerativeConfig

        # the port's config as the file's ``port`` block serves it (its decode
        # attention, head and MLA paths), held to the sizes the block names
        port = dict(self.cell.config["port"])
        holds = port.pop("holds")
        cfg = (get_tiny if self.tiny else get_config)(port.pop("config")).replace(**port)
        view = port_view(cfg, holds)
        if not self.tiny:
            bad = {k: (v, self.cell.config[k]) for k, v in view.items()
                   if self.cell.config[k] != v}
            if bad:
                raise ValueError(f"the port's {cfg.name} is not the configuration file's "
                                 f"(key: (port, file)): {bad}")
        self.arch = arch_of({**self.cell.config, **view} if self.tiny else self.cell.config)
        self.model = build_model(cfg, prefill_attn="kernel", ssd_impl="kernel")
        if tuple(self.model.sites) != self.arch["sites"]:
            raise ValueError(f"ramp sites: the port's {self.model.sites}, the file's "
                             f"{self.arch['sites']}")
        self.parts["imports"] = CLOCK() - t

        t = CLOCK()
        self._draw()
        self.parts["weights"] = CLOCK() - t

        t = CLOCK()
        self.prof = build_profile(cfg, mode="decode", chips=1, sites=self.model.sites,
                                  charge_kv=True)
        ctl_cfg = st["controller"]
        self.ctl = ApparateController(len(self.model.sites), self.prof, ControllerConfig(
            max_slots=ctl_cfg["slots"], ramp_budget_frac=ctl_cfg["budget"],
            acc_constraint=ctl_cfg["acc"]))
        self.gcfg = GenerativeConfig(max_batch_size=int(mix["slots"]),
                                     steps_per_sync=int(st["steps_per_sync"]))
        self._traffic()
        self.runner = timed(DecodeRunner)(
            self.model, self.params, self.prompts, max_new_tokens=int(mix["output"]["hi"]) + 2,
            max_slots=ctl_cfg["slots"], n_slots=int(mix["slots"]),
            kv_block_size=int(st["kv_block_size"]), kv_blocks=None, prefix_cache=False,
            graphs=None)
        self.warmup()
        self.parts["warmup"] = CLOCK() - t
        if trace and self.device.type == "cuda":
            t = CLOCK()
            warm_profiler(self.device)
            self.parts["profiler"] = CLOCK() - t
        self.setup_s = time.time() - process_start

    def _draw(self) -> None:
        self.params, self.buffers = weights.draw(self.model.schema(), self.seed,
                                                 self.arch["L"], self.device, self.buffers)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _traffic(self) -> None:
        mix, st, V = self.mix, self.settings, self.arch["V"]
        self.warm = traffic.generate(mix, V, self.seed, "warmup", st["warmup"]["requests"],
                                     st["block"])
        self.backlog = traffic.generate(mix, V, self.seed, "backlog", st["backlog"],
                                        st["block"])
        self.prompts = np.concatenate([self.warm.prompts, self.backlog.prompts])
        self.n_tokens = np.concatenate([self.warm.n_tokens, self.backlog.n_tokens])

    def reseed(self, seed: int) -> None:
        """Serve another seed's weights and traffic on the same runner: the
        weights are drawn again into the same storage, so the captured
        window graphs stay valid."""
        self.seed = int(seed)
        self._draw()
        self._traffic()
        self.runner.prompts = self.prompts

    def _requests(self, first_item: int, backlog: traffic.Backlog):
        """The engine's requests of ``backlog``, whose prompts are the
        runner's from ``first_item`` on (no SLO: nothing is admitted or shed
        by deadline)."""
        from repro_torch.serving import make_gen_requests

        n = len(backlog.n_tokens)
        return make_gen_requests(backlog.arrival_ms, n_tokens=backlog.n_tokens,
                                 prompt_len=int(self.mix["prompt_len"]), slo_ms=1e12,
                                 items=np.arange(first_item, first_item + n))

    def _serve(self, rec: Recorder, reqs) -> bool:
        """Run a fresh engine over ``reqs`` until the recorder stops it.
        Returns False if the backlog ran dry first."""
        from repro_torch.serving import GenerativeEngine

        self.runner.rec = rec
        eng = GenerativeEngine(self.prof, self.gcfg, self.runner, self.ctl)
        stopped = True
        try:
            eng.run(reqs)
            stopped = False
        except (WindowClosed, WarmupDone):
            pass
        rec.off = True
        for slot in list(rec.slot_item):
            self.runner.free(slot)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return stopped

    def warmup(self) -> None:
        """An engine run of the cell's mix from the warm-up stream: a fixed
        amount of work, ``windows`` windows dispatched, and on (at most
        ``max_s`` seconds) until every window key the mix can reach has
        been captured: each step count up to ``steps_per_sync`` with each
        active ramp set of the last ``windows`` / 2 windows (the
        controller's first set, gone after its first adjustment, is not
        looked for)."""
        w, st = self.settings["warmup"], self.settings
        t0 = CLOCK()
        graphs = self.runner.graphs

        def covered(rec, steps):
            if graphs is None:
                return True
            acts = {c["act"] for c in steps[-(w["windows"] // 2):]}
            keys = {(k[1], k[2]) for k, win in graphs.windows.items() if win.graph is not None}
            return all((n, a) in keys for a in acts
                       for n in range(1, int(st["steps_per_sync"]) + 1))

        def stop(rec, now):
            steps = [c for c in rec.calls if c["kind"] == "step"]
            return (len(steps) >= w["windows"] and covered(rec, steps)) or now - t0 >= w["max_s"]

        rec = Recorder(self.n_tokens, int(self.mix["prompt_len"]))
        rec.stop = stop
        if not self._serve(rec, self._requests(0, self.warm)):
            log("warm-up: its backlog ran dry before it stopped")
        kinds = [c["graph"] for c in rec.calls if c["kind"] == "step"]
        self.warm_kinds = {k: kinds.count(k) for k in sorted(set(kinds))}

    # -- the window -----------------------------------------------------------

    def measure(self, seconds: float, trace: bool = False) -> SimpleNamespace:
        """A fresh engine run over the backlog on the warmed runner, closed
        at the first runner call past ``seconds``."""
        rec = Recorder(self.n_tokens, int(self.mix["prompt_len"]))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        # what set-up left on the heap is kept out of the window's collections
        gc.collect()
        gc.freeze()
        t_open = CLOCK()
        rec.deadline = t_open + seconds
        if trace:
            tr = self.settings["trace"]
            rec.tracer = Tracer(t_open + tr["start_frac"] * seconds, tr["seconds"], tr["settle"],
                                cuda=self.device.type == "cuda")
        ran_out = not self._serve(rec, self._requests(len(self.warm.n_tokens), self.backlog))
        if ran_out:
            rec.t_close = CLOCK()
            log("window: the backlog ran dry before the window closed")
        gc.unfreeze()
        if rec.tracer is not None:
            rec.tracer.close()
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        stretch = rec.tracer.stretch(rec) if rec.tracer is not None else None
        done = [r for r in rec.reqs.values() if len(r["tokens"]) >= r["n"]]
        return SimpleNamespace(rec=rec, t_open=t_open, t_close=rec.t_close, peak_bytes=peak,
                               stretch=stretch, done=done, calls=rec.calls)

    def release(self) -> None:
        """Free the program's serving state (its cache pool, its graphs):
        the reference runs on what is left, the weights."""
        self.runner = self.ctl = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ------------------------------------------------------------

    def check(self, win: SimpleNamespace, stand_ins=()) -> dict:
        """The numbers of ``check.py`` over a sample of the window's finished
        requests (and of the ``stand_ins`` precisions), with the limits."""
        spec = self.mix["check"]
        reqs = check.sample(win.done, self.seed, int(spec["min_tokens"]))
        if not reqs:
            raise RuntimeError("the window finished no request to check")
        torch.backends.cuda.matmul.allow_tf32 = False  # the reference is float32
        torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            out = check.compare(self.arch, self.params, self.prompts, reqs, stand_ins)
        out["limits"] = dict(spec["limits"])
        return out


def compared(chk: dict) -> dict:
    """The numbers a cell compares (its limits' keys), each with its limit."""
    return {k: {"value": chk["program"][k], "limit": v} for k, v in chk["limits"].items()}


def context(session: Session, win: SimpleNamespace) -> SimpleNamespace:
    """What a metric reader reads. ``plain`` holds the window's calls made
    while no profiler ran (every call of an untraced run)."""
    from bench import roofline

    on_off = win.rec.tracer and (win.rec.tracer.on, win.rec.tracer.off or win.t_close)
    plain = [c for c in win.calls
             if not on_off or c["t1"] < on_off[0] or c["t0"] > on_off[1]]
    return SimpleNamespace(calls=win.calls, plain=plain, t_open=win.t_open, t_close=win.t_close,
                           done=win.done, stretch=win.stretch,
                           peak_bytes=win.peak_bytes, setup_s=session.setup_s,
                           arch=session.arch, mix=session.mix, settings=session.settings,
                           roofline=roofline)


def timings(calls: List[dict]) -> str:
    """Mean host ms of the calls by kind (windows by step count), of the
    engine's time between calls a window, and a digest of the calls' order
    (equal for equal work)."""
    import hashlib

    def mean(xs):
        return f"{1e3 * sum(xs) / len(xs):.3f} ms x {len(xs)}" if xs else "none"

    steps = [c for c in calls if c["kind"] == "step"]
    parts = [f"{n}-step windows {mean([c['t1'] - c['t0'] for c in steps if c['n'] == n])}"
             for n in sorted({c["n"] for c in steps})]
    parts.append(f"prefills {mean([c['t1'] - c['t0'] for c in calls if c['kind'] == 'start'])}")
    gaps = sum(b["t0"] - a["t1"] for a, b in zip(calls, calls[1:]))
    parts.append(f"engine {1e3 * gaps / max(len(steps), 1):.3f} ms a window")
    sig = hashlib.sha1(repr([(c["kind"], c.get("n"), c.get("act")) for c in calls[:400]])
                       .encode()).hexdigest()[:12]
    return ", ".join(parts) + f"; first 400 calls {sig}"


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks (numpy's
    default), as ``serving/metrics.py`` takes it."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if len(values) else \
        math.nan
