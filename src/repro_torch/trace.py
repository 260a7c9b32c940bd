"""Spans and counters of the port, kept in memory on the host's clock and,
while a ``torch.profiler`` runs, recorded by the profiler too.

Tracing is off by default. Off, ``span`` is one test of a module flag that
returns a shared null context: it reads no clock, calls nothing of torch
and allocates nothing on the device, so a span site costs that test and
its call. On (``enable``), each span keeps

- an id, its parent's id (0 at the top; one stack a thread), its name,
- its start and end in ``time.perf_counter_ns`` (the host's monotonic
  clock: the benchmark's ``CLOCK`` in ns),
- its attributes (``slot``, ``item``, ``rid``, ``B``, ``layer``, ...: the
  spans of one request share its ``item`` or ``rid``; ``raised``: the
  exception that left it, if one did),

and, while a profiler runs, enters ``record_function(name)``, so the
profiler's trace holds a twin of the span whose kernels carry the
correlation ids of their launches. ``take`` hands over, and clears,
the spans recorded.

**One clock.** The profiler stamps its events in Unix-epoch ns
(``time.time_ns``'s clock); the spans are on the monotonic clock, which
shares no origin with it. ``anchor`` pairs the two (and records a
``trace/anchor`` span, which a running profiler twins), after which
``to_profiler_ns`` maps a span's times onto the device trace's timeline.

**Instances, not sources.** ``instrument(obj, {method: span})`` wraps the
named methods of one object while tracing is on and puts them back at
``disable``: the engine and the controller, copies the tests pin byte for
byte to the JAX package's, get their spans so (``instrument_engine``).

A span never creates a tensor and never waits on the device. The spans
the port records, by layer:

- engine: ``engine/admit`` (rid), ``engine/step``;
- controller: ``controller/observe`` (B) and, inside it,
  ``controller/tune``, ``controller/adjust``;
- runner (``serving/runner.py``): ``runner/prefill`` (slot, item, S) over
  ``prefill/alloc``, ``prefill/model``, ``prefill/scatter``,
  ``prefill/read``; ``runner/chunk`` (slot, n_tokens); ``runner/window``
  (B, n, act, kind, nd) over ``window/claim``, ``window/run``,
  ``window/read``; ``runner/free`` (slot); ``runner/infer`` (bucket);
- graphs (``serving/graphs.py``): ``graph/eager``, ``graph/capture``,
  ``graph/replay``, ``graph/run`` (key);
- model (``models/transformer.py``): ``model/attn``, ``model/mla``,
  ``model/mamba``, ``model/moe``, ``model/ffn`` (layer), ``model/heads``.
  A replayed window is one graph launch: its kernels run under
  ``graph/replay``, and the model's spans come from eager calls only.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

_on = False
# closed spans, in the order they closed, as plain tuples: the collector
# stops tracking one of atoms, so a long run's spans cost it nothing
_spans: List[tuple] = []
_ids = itertools.count(1)
_local = threading.local()  # .stack: this thread's open spans
_patched: List[tuple] = []  # (object, method, its own attribute before, or None)
_offset_ns: Optional[int] = None  # the profiler's clock less perf_counter_ns


class _Null:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


_profiler = None  # torch.autograd.profiler, imported at the first span


def _profiling() -> bool:
    global _profiler
    if _profiler is None:
        from torch.autograd import profiler as _profiler
    return bool(_profiler._is_profiler_enabled)


class Record(NamedTuple):
    """A closed span, as ``take`` hands it over: times in perf_counter ns."""

    id: int
    parent: int  # 0: none
    name: str
    t0: int
    t1: int
    attrs: dict


class Span:
    """An open span (the context ``span`` returns with tracing on)."""

    __slots__ = ("id", "parent", "name", "t0", "t1", "attrs", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.id, self.name, self.attrs = next(_ids), name, attrs
        self.parent, self.t0, self.t1, self._rf = 0, 0, 0, None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else 0
        stack.append(self)
        if _profiling():
            from torch.profiler import record_function

            self._rf = record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()  # inside the twin: the twin holds the span
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if exc[0] is not None:
            self.attrs["raised"] = exc[0].__name__
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _stack().pop()
        _spans.append((self.id, self.parent, self.name, self.t0, self.t1, self.attrs))
        return False


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def span(name: str, **attrs):
    """A context manager timing its block as the span ``name`` (module
    docstring); with tracing off, a shared null context."""
    if not _on:
        return _NULL
    return Span(name, attrs)


def annotate(**attrs) -> None:
    """Add attributes to this thread's innermost open span (tracing on
    only)."""
    if _on:
        stack = _stack()
        if stack:
            stack[-1].attrs.update(attrs)


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording and put every instrumented method back. What was
    recorded stays until ``take``."""
    global _on
    _on = False
    while _patched:
        obj, meth, own = _patched.pop()
        if own is None:
            vars(obj).pop(meth, None)
        else:
            setattr(obj, meth, own)


def take() -> List[Record]:
    """The spans closed since the last ``take``, cleared here."""
    global _spans
    out = [Record(*t) for t in _spans]
    _spans = []
    return out


@contextlib.contextmanager
def recording():
    """Trace the block: yields a list that holds, once the block is left,
    the spans closed inside it. Tracing left on by a caller stays on, with
    those spans still recorded for it; else it is turned off again and
    they are taken."""
    was_on, mark, out = _on, len(_spans), []
    enable()
    try:
        yield out
    finally:
        out.extend(Record(*t) for t in _spans[mark:])
        if not was_on:
            disable()
            take()


# -- one clock -----------------------------------------------------------------


def anchor() -> int:
    """Pair ``perf_counter_ns`` with the profiler's clock (Unix-epoch ns)
    by the closest of a few back-to-back reads of both; record a
    ``trace/anchor`` span, which a running profiler twins. Returns the
    offset ``to_profiler_ns`` adds."""
    global _offset_ns
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        w = time.time_ns()  # repro: allow[no-wallclock] — the profiler's own clock
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    _offset_ns = best[1]
    with span("trace/anchor", offset_ns=_offset_ns):
        pass
    return _offset_ns


def to_profiler_ns(t: int) -> int:
    """``t`` (perf_counter ns) on the profiler's clock, by the last
    ``anchor`` (made now if there was none)."""
    if _offset_ns is None:
        anchor()
    return t + _offset_ns


# -- instrumenting instances ---------------------------------------------------

Spec = Union[str, Tuple[str, Callable[..., dict]]]


def _wrap(fn, name: str, attrs: Optional[Callable[..., dict]]):
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        if not _on:
            return fn(*a, **kw)
        with Span(name, attrs(*a, **kw) if attrs else {}):
            return fn(*a, **kw)

    wrapped.__traced__ = True
    return wrapped


def spanned(name: str, attrs: Optional[Callable[..., dict]] = None):
    """A decorator: each call of the function is the span ``name``, with
    the attributes ``attrs`` computes from the call's arguments."""
    return lambda fn: _wrap(fn, name, attrs)


def _wrap_methods(obj, methods: Dict[str, Spec]) -> List[str]:
    done = []
    for meth, spec in methods.items():
        name, attrs = (spec, None) if isinstance(spec, str) else spec
        fn = getattr(obj, meth)
        if getattr(fn, "__traced__", False):
            continue  # instrumented already
        setattr(obj, meth, _wrap(fn, name, attrs))
        done.append(meth)
    return done


def instrument(obj, methods: Dict[str, Spec]) -> None:
    """While tracing is on, span each call of ``obj``'s named methods:
    ``methods`` maps a method to its span's name, or to (name, a function
    of the call's arguments returning the span's attributes). ``disable``
    puts the methods back. Does nothing with tracing off."""
    if not _on:
        return
    before = dict(vars(obj))
    for meth in _wrap_methods(obj, methods):
        _patched.append((obj, meth, before.get(meth)))


ADAPTER = {"_admit_one": ("engine/admit", lambda r, core: {"rid": int(r.rid)}),
           "_step": "engine/step"}
CONTROLLER = {"observe": ("controller/observe",
                          lambda labels, unc, finals, **kw: {"B": int(len(finals))}),
              "_tune": "controller/tune", "_adjust": "controller/adjust"}


def instrument_engine(eng) -> None:
    """Span a ``GenerativeEngine``'s admissions and steps (on the adapter
    each run makes) and its controller's ``observe``, ``_tune`` and
    ``_adjust``, while tracing is on."""
    if not _on:
        return
    if eng.controller is not None:
        instrument(eng.controller, CONTROLLER)
    make = eng._make_adapter
    if getattr(make, "__traced__", False):
        return

    @functools.wraps(make)
    def _make_adapter(requests):
        adapter = make(requests)
        if _on:
            _wrap_methods(adapter, ADAPTER)  # one run's: nothing to put back
        return adapter

    _make_adapter.__traced__ = True
    before = vars(eng).get("_make_adapter")
    eng._make_adapter = _make_adapter
    _patched.append((eng, "_make_adapter", before))
