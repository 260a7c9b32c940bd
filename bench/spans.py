"""The program's spans (``repro_torch.trace``) read against a traced
stretch: the per-layer numbers only they can give, and a tool that reads
them on the card.

  python3 bench/spans.py --workload deepseek-v2-lite-16b.decode --seed 7 --seconds 51

After one set-up (as ``bench/run.py --trace 1`` makes it), windows of
``--seconds`` over the cell's backlog on the same runner and seed:

1. ``--pairs`` times, in turns: the tracer off, no profiler
   (``bench/run.py --trace 0``'s window), then on, no profiler: what the
   spans cost, read by the host-clock readers ``prefill_ms``,
   ``window_ms`` and ``engine_host_ms``;
2. the profiled windows ``--profiled`` names, in order, each with the
   tracer ``on`` or ``off``: the profiler over a stretch as ``--trace 1``
   takes it.

With the tracer on, the controller is instrumented (``trace.CONTROLLER``).
While a profiler runs, each span enters ``record_function``, so the
profiler records a twin of it on its own clock: the clock of the device's
operations and of the host launches that enqueued them (matched by
correlation id). A stretch's spans are those twins, nested as they nest
(``with_spans``); no clock is mapped onto another. The spans made while no
profiler ran stay on the host's clock for the host-clock readers
(``unprofiled``).

From the last profiled window with the tracer on: ``prefill_idle_ms``,
``moe_prefill_ms``, ``prefill_wait_ms`` and ``controller_ms`` (the readers
below, each ``read(ctx)`` as a metric's), the stretch's idle device time by
innermost program span, each prefill's account (``prefill_account``) and
the window graphs' counts by key. Standard error carries the tables; the
last line of standard output is one JSON object, also written to
``chiprun_out/spans-<workload>-<seed>.json``. No correctness check: that is
``bench/run.py``'s.

``bench/run.py`` does not read these spans: wiring them into its ``--trace
1`` run is an edit to the benchmark's files (``harness.py``, ``run.py``,
``tracing.py``), left to a benchmark change, which then retires this tool
and the harness's own call timers.
"""
from __future__ import annotations

import bisect
import statistics
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Iterable, List, Optional, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import harness, tracing  # noqa: E402

# a host event that enqueues device work (its correlation id is its device
# operations'): the runtime's and the driver's launches, copies and fills
LAUNCH = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
          "cuMemcpy", "cudaMemset", "cuMemset")
NO_SPAN = "(no program span)"
# the prefills' idle and the device time they launched may exceed their
# length by this share: kernels that overlap (programmatic launch) count
# twice, and an operation launched before a prefill may run in it
SLACK = 0.01


# -- the stretch, with the program's spans -------------------------------------


def nest(twins: Iterable[Tuple[int, int, str]]) -> List[tuple]:
    """Spans (start, end, name) as (name, start, end, id, parent), each
    one's parent the innermost that holds it (0: none). The twins come
    from one thread, so they nest."""
    out, stack = [], []  # stack: (id, end) of the spans still open
    for i, (a, b, name) in enumerate(sorted(twins, key=lambda t: (t[0], -t[1])), 1):
        while stack and stack[-1][1] <= a:
            stack.pop()
        out.append((name, a, b, i, stack[-1][0] if stack else 0))
        stack.append((i, b))
    return out


def with_spans(win, names) -> Optional[SimpleNamespace]:
    """The window's stretch (``harness.Tracer.stretch``) with ``spans``: the
    twins of the program's spans named in ``names``, nested (``nest``);
    ``ops``: each device operation as (name, start, end, correlation id);
    ``launches``: each launch's host ns by correlation id. A twin also
    leaves an annotation on the device's timeline over what it launched, as
    the harness's own marks do: ``dev`` and ``ops`` skip both, or the
    annotations would fill the idle gaps."""
    st = win.stretch
    if st is None:
        return None
    names = set(names)
    twins, ops, launches = [], [], {}
    for e in win.rec.tracer.prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            if b > st.t0_ns and a < st.t1_ns and name not in names \
                    and not name.startswith("bench."):
                ops.append((name, a, b, e.correlation_id()))
        elif name in names:
            twins.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name.startswith(LAUNCH):
            launches[e.correlation_id()] = e.start_ns()
    st.dev = [d for d in st.dev if d[0] not in names]
    st.ops, st.launches = sorted(ops, key=lambda o: o[1]), launches
    st.spans = nest(twins)
    return st


def _chains(spans) -> Dict[int, Tuple[tuple, ...]]:
    """Each span id's spans from itself up to its root."""
    by_id = {s[3]: s for s in spans}
    out = {}
    for s in spans:
        chain, p = [s], by_id.get(s[4])
        while p is not None:
            chain.append(p)
            p = by_id.get(p[4])
        out[s[3]] = tuple(chain)
    return out


def _ancestry(spans) -> Dict[int, Tuple[str, ...]]:
    """Each span id's names from itself up to its root."""
    return {i: tuple(s[0] for s in chain) for i, chain in _chains(spans).items()}


def innermost(spans) -> List[Tuple[int, int, Optional[tuple]]]:
    """The host's timeline as segments (start, end, the innermost open span
    or None). Spans nest, so the innermost is the last opened of those
    still open."""
    bounds = sorted([(s[1], 1, i) for i, s in enumerate(spans)]
                    + [(s[2], 0, i) for i, s in enumerate(spans)])
    segs, stack, t = [], [], None
    for at, opens, i in bounds:
        if t is not None and at > t:
            segs.append((t, at, spans[stack[-1]] if stack else None))
        t = at
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    return segs


def _launching(st) -> List[Tuple[tuple, Optional[tuple]]]:
    """Each device operation with the innermost span open at its launch
    (None: none, or no launch read)."""
    segs = innermost(st.spans)
    starts = [s[0] for s in segs]
    out = []
    for op in st.ops:
        t, sp = st.launches.get(op[3]), None
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < segs[i][1]:
                sp = segs[i][2]
        out.append((op, sp))
    return out


def launched_under(st, name: str, within: Optional[str] = None) -> int:
    """Device ns of the stretch's operations whose launch (matched by
    correlation id) lies inside a span ``name`` (inside a span ``within``,
    if given): a kernel counts for the span that enqueued it, not for the
    one open while it ran."""
    anc = _ancestry(st.spans)
    total = 0
    for (_, a, b, _), sp in _launching(st):
        if sp is None:
            continue
        up = anc[sp[3]]
        if name in up and (within is None or within in up[up.index(name) + 1:]):
            total += min(b, st.t1_ns) - max(a, st.t0_ns)
    return total


def idle_gaps(st) -> List[Tuple[int, int]]:
    """The stretch's idle device intervals: where no operation ran."""
    gaps, t = [], st.t0_ns
    for _, a, b in sorted(st.dev, key=lambda d: d[1]):
        if a > t:
            gaps.append((t, min(a, st.t1_ns)))
        t = max(t, b)
        if t >= st.t1_ns:
            return gaps
    if t < st.t1_ns:
        gaps.append((t, st.t1_ns))
    return gaps


def idle_by_span(st) -> Dict[int, int]:
    """Idle device ns by innermost program span id (0: none open). Each
    idle ns goes to exactly one."""
    segs, out = innermost(st.spans), {}
    starts = [s[0] for s in segs]
    for a, b in idle_gaps(st):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        covered = a
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                sid = segs[i][2][3] if segs[i][2] is not None else 0
                out[sid] = out.get(sid, 0) + hi - lo
                covered += hi - lo
            i += 1
        if b > covered:  # outside every span
            out[0] = out.get(0, 0) + b - covered
    return out


def idle_under(st, name: str) -> int:
    """Idle device ns while the innermost open program span is ``name``."""
    names = {s[3]: s[0] for s in st.spans}
    return sum(ns for sid, ns in idle_by_span(st).items() if names.get(sid) == name)


def idle_table(st) -> List[Tuple[str, int]]:
    """Idle device ns by the innermost span's path (``runner/prefill >
    prefill/read``), most first."""
    anc, out = _ancestry(st.spans), {}
    for sid, ns in idle_by_span(st).items():
        key = " > ".join(reversed(anc[sid])) if sid else NO_SPAN
        out[key] = out.get(key, 0) + ns
    return sorted(out.items(), key=lambda kv: -kv[1])


def prefill_account(st) -> List[Dict[str, int]]:
    """Each ``runner/prefill`` span the stretch holds whole: its ``ns``, the
    ``idle`` device ns inside it, the device ns of the operations launched
    under it (``launched``; ``moe``: under its ``model/moe`` spans) and the
    part of those that ran outside it (``outside``). A prefill ends in a
    blocking read of its first token, so all it launched ran inside it:
    ``idle`` + ``launched`` is at most ``ns`` and ``outside`` is 0, unless
    the device's timeline and the host's disagree."""
    chains = _chains(st.spans)
    acc = {s[3]: {"ns": s[2] - s[1], "idle": 0, "launched": 0, "moe": 0, "outside": 0,
                  "end": s[2]}
           for s in st.spans
           if s[0] == "runner/prefill" and s[1] >= st.t0_ns and s[2] <= st.t1_ns}
    if not acc:
        return []
    gaps = idle_gaps(st)
    for pid, p in acc.items():
        t0 = p["end"] - p["ns"]
        p["idle"] = sum(max(0, min(b, p["end"]) - max(a, t0)) for a, b in gaps)
    for (_, a, b, _), sp in _launching(st):
        chain = chains[sp[3]] if sp is not None else ()
        pid = next((s[3] for s in chain if s[3] in acc), None)
        if pid is None:
            continue
        p = acc[pid]
        p["launched"] += b - a
        p["moe"] += (b - a) if any(s[0] == "model/moe" for s in chain) else 0
        p["outside"] += b - a - max(0, min(b, p["end"]) - max(a, p["end"] - p["ns"]))
    return [{k: v for k, v in p.items() if k != "end"} for p in acc.values()]


def consistent(acc: List[Dict[str, int]]) -> bool:
    """Whether the prefills' idle and launched device time fit in their
    length (within ``SLACK``)."""
    return sum(p["idle"] + p["launched"] for p in acc) <= (1 + SLACK) * sum(p["ns"] for p in acc)


# -- the readers (each a metric's ``read(ctx)``) --------------------------------


def _account(ctx) -> List[Dict[str, int]]:
    st = ctx.stretch
    return prefill_account(st) if st is not None and getattr(st, "spans", None) else []


def prefill_idle_ms(ctx) -> Optional[float]:
    """Idle device ms inside the ``runner/prefill`` spans the stretch holds
    whole, over those prefills; nothing where their account does not add
    up (``consistent``). The profiler slows the host's launches, so this is
    the idle of a profiled prefill."""
    acc = _account(ctx)
    if not acc or not consistent(acc):
        return None
    return sum(p["idle"] for p in acc) / 1e6 / len(acc)


def moe_prefill_ms(ctx) -> Optional[float]:
    """Device ms of the kernels launched under ``model/moe`` inside the
    ``runner/prefill`` spans the stretch holds whole, over those prefills."""
    acc = _account(ctx)
    ns = sum(p["moe"] for p in acc)
    return ns / 1e6 / len(acc) if ns else None


def _plain(ctx, name: str) -> List:
    return [s for s in getattr(ctx, "spans", None) or () if s.name == name]


def prefill_wait_ms(ctx) -> Optional[float]:
    """Mean host ms of ``prefill/read`` in the unprofiled prefills: how long
    the host waits on the device for the first token (near 0: the prefill
    is host-bound)."""
    t = [s.t1 - s.t0 for s in _plain(ctx, "prefill/read")]
    return sum(t) / len(t) / 1e6 if t else None


def controller_ms(ctx) -> Optional[float]:
    """Host ms of ``controller/observe`` (with ``_tune`` and ``_adjust``
    inside it) in the unprofiled windows, over those windows."""
    windows = len(_plain(ctx, "runner/window"))
    t = sum(s.t1 - s.t0 for s in _plain(ctx, "controller/observe"))
    return t / 1e6 / windows if windows else None


READERS = {"prefill_idle_ms": prefill_idle_ms, "moe_prefill_ms": moe_prefill_ms,
           "prefill_wait_ms": prefill_wait_ms, "controller_ms": controller_ms}


# -- windows with the program's tracer -------------------------------------------


def unprofiled(win, spans) -> list:
    """The ``spans`` (on the host's clock, in ns) made while no profiler
    ran: every span of an unprofiled window."""
    tr = win.rec.tracer
    if tr is None or tr.on is None:
        return list(spans)
    on, off = 1e9 * tr.on, 1e9 * (tr.off or win.t_close)
    return [s for s in spans if s.t1 < on or s.t0 > off]


def window(session, seconds: float, tracer: bool, profile: bool) -> SimpleNamespace:
    """One window of ``session`` (``harness.Session.measure``), the
    program's tracer on (the controller instrumented) or off, profiled or
    not. Returns the metric readers' context, with ``recorded`` (every span
    made) and ``spans`` (those made while no profiler ran); a profiled
    stretch carries the spans' twins (``with_spans``)."""
    from repro_torch import trace

    if tracer:
        trace.enable()
        trace.instrument(session.ctl, trace.CONTROLLER)
    try:
        win = session.measure(seconds, trace=profile)
    finally:
        trace.disable()
    recorded = trace.take()
    with_spans(win, {s.name for s in recorded})
    ctx = harness.context(session, win)
    ctx.win, ctx.recorded, ctx.spans = win, recorded, unprofiled(win, recorded)
    return ctx


def host_readers(ctx) -> Dict[str, Optional[float]]:
    return {m: harness.reader(m)(ctx) for m in ("prefill_ms", "window_ms", "engine_host_ms")}


def graph_counts(graphs) -> Dict[str, object]:
    if graphs is None:
        return {}
    return {"pool_bytes": graphs.pool_bytes,
            "by_key": {str(k): v for k, v in sorted(graphs.by_key.items(), key=str)}}


def clock_gap_us(st, recorded) -> Optional[float]:
    """Median distance (us) from each prefill twin's start to the nearest
    prefill span's start mapped by ``trace.to_profiler_ns`` (the last
    ``anchor``): how far the host's clock, so mapped, sits from the
    profiler's."""
    from repro_torch import trace

    mapped = sorted(trace.to_profiler_ns(s.t0) for s in recorded if s.name == "runner/prefill")
    twins = [s[1] for s in st.spans if s[0] == "runner/prefill"]
    if not mapped or not twins:
        return None
    gaps = []
    for t in twins:
        i = bisect.bisect_left(mapped, t)
        gaps.append(min(abs(mapped[j] - t) for j in (i - 1, i) if 0 <= j < len(mapped)))
    return statistics.median(gaps) / 1e3


def _mean_ms(acc: List[Dict[str, int]], key: str) -> Optional[float]:
    return sum(p[key] for p in acc) / 1e6 / len(acc) if acc else None


def _table(rows: Iterable[Tuple[str, int]], total: int) -> str:
    return "\n".join(f"  {ns / 1e6:10.3f} ms {100 * ns / max(total, 1):6.2f}%  {k}"
                     for k, ns in rows)


def _profiled(s, seconds: float, tracer: bool) -> dict:
    """A profiled window (``--trace 1``'s), with the program's tracer on or
    off: the traced readers, and with the tracer on the four metrics, the
    idle by span and each prefill's account."""
    from repro_torch import trace

    ctx = window(s, seconds, tracer, profile=True)
    st = ctx.stretch
    out = {"tracer": "on" if tracer else "off",
           "traced": {**host_readers(ctx), **{m: harness.reader(m)(ctx) for m in (
               "step_device_ms", "device_idle_pct", "mfu_pct")}}}
    if st is None:
        return out
    idle = tracing.union_ns(idle_gaps(st), st.t0_ns, st.t1_ns)
    out["stretch"] = {"seconds": (st.t1_ns - st.t0_ns) / 1e9, "idle_s": idle / 1e9,
                      "calls": len(st.calls), "device_ops": len(st.dev),
                      "breakdown": tracing.breakdown(st)}
    harness.log(f"profiled window, tracer {out['tracer']}: {harness.timings(ctx.win.calls)}; "
                f"{out['traced']}; {len(st.dev)} device operations, {idle / 1e9:.4f} s idle "
                f"of {(st.t1_ns - st.t0_ns) / 1e9:.4f} s")
    if not tracer:
        return out
    trace.anchor()
    out["metrics"] = {k: f(ctx) for k, f in READERS.items()}
    acc = prefill_account(st)
    rows, anc = idle_table(st), _ancestry(st.spans)
    in_pf = {sid: ns for sid, ns in idle_by_span(st).items()
             if sid and "runner/prefill" in anc[sid]}
    named = sum(ns for sid, ns in in_pf.items() if anc[sid][0] != "runner/prefill")
    out["stretch"].update({
        "prefills": len(acc), "consistent": consistent(acc),
        "prefill_account_ms": [{k: v / 1e6 for k, v in p.items()} for p in acc],
        "clock_gap_us": clock_gap_us(st, ctx.recorded),
        # the profiler slows the host's launches: a prefill's length under it
        # against the unprofiled ones' less the device time it launched
        "profiled_prefill_ms": _mean_ms(acc, "ns"),
        "unprofiled_idle_estimate_ms": None if not acc or out["traced"]["prefill_ms"] is None
        else out["traced"]["prefill_ms"] - _mean_ms(acc, "launched"),
        "ops_with_launch": sum(1 for o in st.ops if o[3] in st.launches),
        "idle_in_prefill_s": sum(in_pf.values()) / 1e9,
        "idle_in_prefill_under_a_child_pct": 100 * named / max(sum(in_pf.values()), 1),
        "launched_under_s": {n: launched_under(st, n) / 1e9 for n in (
            "runner/prefill", "prefill/model", "prefill/scatter", "model/mla", "model/moe",
            "model/ffn", "model/heads", "runner/window", "graph/replay", "graph/eager",
            "graph/capture")},
        "idle_by_span": [[k, ns / 1e9] for k, ns in rows]})
    harness.log(f"trace: {len(st.ops)} device operations, "
                f"{out['stretch']['ops_with_launch']} matched to a launch; {len(st.spans)} "
                f"span twins; clock gap {out['stretch']['clock_gap_us']} us")
    harness.log("profiled prefills (ms): " + "; ".join(
        f"{p['ns']:.2f} = idle {p['idle']:.2f} + launched {p['launched']:.2f} (moe "
        f"{p['moe']:.2f}, outside {p['outside']:.3f})"
        for p in out["stretch"]["prefill_account_ms"]))
    harness.log(f"idle device time by innermost program span ({idle / 1e9:.4f} s idle of "
                f"{(st.t1_ns - st.t0_ns) / 1e9:.4f} s):\n" + _table(rows, idle))
    return out


def main(argv=None) -> int:
    import argparse
    import json

    from bench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pairs", type=int, default=1,
                    help="windows with the tracer off and on, in turns, before the profiled ones")
    ap.add_argument("--profiled", default="on",
                    help="the profiled windows, in order, each with the tracer 'on' or 'off'")
    a = ap.parse_args(argv)
    torch, log = harness.torch, harness.log
    if not torch.cuda.is_available():
        log("no result: no CUDA card")
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = harness.Session(harness.load_cell(a.workload), a.seed)
    s.setup(run.PROCESS_START, trace=True)
    log(f"card: {harness.card_line()}; set-up {s.parts}; setup_s {s.setup_s:.3f}")

    cost = {"off": [], "on": []}
    for _ in range(a.pairs):
        for label in ("off", "on"):
            ctx = window(s, a.seconds, label == "on", profile=False)
            cost[label].append({**host_readers(ctx), "out_tok_s": harness.reader("out_tok_s")(ctx),
                                "spans": len(ctx.recorded)})
            log(f"window, tracer {label}: {harness.timings(ctx.win.calls)}; {cost[label][-1]}")
    profiled = [_profiled(s, a.seconds, w == "on") for w in a.profiled.split(",")]
    metrics = next((p["metrics"] for p in reversed(profiled) if "metrics" in p), {})
    out = {"workload": a.workload, "seed": a.seed, "card": harness.card_line(), "cost": cost,
           "metrics": metrics, "profiled": profiled, "graphs": graph_counts(s.runner.graphs)}
    log("window graphs by key: " + json.dumps(out["graphs"]))
    log("metrics: " + json.dumps(metrics))
    dest = harness.ROOT / "chiprun_out" / f"spans-{a.workload}-{a.seed}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
