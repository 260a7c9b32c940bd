"""Reading a traced stretch: device-busy time, kernel time by name, idle
gaps by what the host was doing. The stretch comes from
``harness.Tracer.stretch``: the device operations ``dev`` as (name, start,
end) and the runner calls' marks ``marks`` as (kind, start, end), in ns on
the profiler's clock.
"""
from __future__ import annotations

import re
from typing import Iterable, List, Tuple

# the port's kernels by name (as ``serving/graphs.py`` names them), mangled
# or demangled
ATTENTION = re.compile(r"decode_(bf16|f32)_kernel|mla_(bf16|f32)_kernel|mla_combine_kernel"
                       r"|flash_attention_(bf16|f32)")
RAMP_HEAD = re.compile(r"ramp_tiles_bf16|tiles_vmajor|tiles_dmajor|merge_tiles")
HOST = {"start": "prefill call", "step": "window call", "free": "free call"}


def union_ns(spans: Iterable[Tuple[int, int]], lo: int, hi: int) -> int:
    """The length of the union of ``spans`` clipped to [lo, hi]."""
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def busy_ns(st) -> int:
    """Device-busy ns of the stretch: the union of every device operation."""
    return union_ns(((a, b) for _, a, b in st.dev), st.t0_ns, st.t1_ns)


def kernel_ns(st, pattern) -> int:
    """Summed ns of the stretch's device operations whose name matches."""
    return sum(min(b, st.t1_ns) - max(a, st.t0_ns) for n, a, b in st.dev
               if pattern.search(n) and b > st.t0_ns and a < st.t1_ns)


def in_calls_ns(st, kind: str) -> int:
    """Device-busy ns inside the stretch's calls of one kind."""
    return sum(union_ns(((a, b) for _, a, b in st.dev), m0, m1)
               for k, m0, m1 in st.marks if k == kind)


def breakdown(st, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing (inside which runner call, or in the engine between
    calls) with the longest single gaps."""
    by_name = {}
    for n, a, b in st.dev:
        lo, hi = max(a, st.t0_ns), min(b, st.t1_ns)
        if hi > lo:
            by_name[n] = by_name.get(n, 0) + hi - lo
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps: List[Tuple[str, int]] = []
    t = st.t0_ns
    for _, a, b in sorted(st.dev, key=lambda d: d[1]):
        if a > t:
            gaps.append((_host_at(st, (t + a) // 2), min(a, st.t1_ns) - t))
        t = max(t, b)
        if t >= st.t1_ns:
            break
    if t < st.t1_ns:
        gaps.append((_host_at(st, (t + st.t1_ns) // 2), st.t1_ns - t))
    totals = {}
    for k, g in gaps:
        totals[k] = totals.get(k, 0) + g
    idle = [[f"idle in {k} (total)", v / 1e9] for k, v in sorted(totals.items(),
                                                                 key=lambda kv: -kv[1])]
    longest = [[f"longest gap in {k}", g / 1e9] for k, g in sorted(gaps, key=lambda x: -x[1])]
    return {"device_ops": [[_short(n), v / 1e9] for n, v in ops],
            "idle_gaps": (idle + longest)[:top]}


def _host_at(st, t: int) -> str:
    for k, a, b in st.marks:
        if a <= t < b:
            return HOST.get(k, k)
    return "the engine (between runner calls)"


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."
