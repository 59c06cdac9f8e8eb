"""The port's span recorder (counterpart of ``aegis_tpu/utils/prof.py``).

``phase(name, **attrs)`` marks one span of the program: a pipeline phase,
a device program's enqueue or fetch, a server's request.  While no torch
profiler runs in the process it costs one flag read and opens nothing.
While one runs (``recording()``), it opens a
``torch.profiler.record_function`` range of the same name, so the phase
names stand in the profiler's trace, and on closing appends one ``Span``
to a bounded buffer that ``spans()`` reads.

A span opened on any thread is recorded: the server's request threads, on
which a ``record_function`` range is lost when the profiler was started on
another thread, record theirs too.  Times come from ``time.time_ns()``,
the clock of kineto's host events, so spans and the device trace are read
against each other with no mapping.  Spans nest per thread: a span's
``parent`` is the ``index`` of the span open around it on its thread, and
its ``request`` is its root's, which takes a new number.  A span's self
time is its duration less its children's.

The interpreter's collections are spans too: a ``gc.callbacks`` hook,
installed once when the module is imported, records each collection that
runs while ``recording()`` as one ``py.gc`` span (``generation``,
``collected``, ``uncollectable``) under the span open on the collecting
thread.  It opens no ``record_function`` range, so no torch call runs
inside a collection; off, it costs one flag read a callback.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# spans kept: a traced slice of any benchmark cell records a few hundred,
# collections included
MAX_SPANS = 1 << 16

_BUF: collections.deque = collections.deque(maxlen=MAX_SPANS)
_INDEX = itertools.count()
_REQUEST = itertools.count(1)
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()

#: the name of a collection's span
GC_SPAN = "py.gc"


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: Optional[int]
    thread: int                  # the OS thread id, as kineto's events
    index: int
    parent: Optional[int]        # the index of the enclosing span
    request: int                 # the root span's number
    attrs: Dict


def recording() -> bool:
    """True while a torch profiler is active anywhere in the process (a
    process-wide flag that ``torch.profiler.profile`` sets)."""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> List[Span]:
    """The spans open on this thread, innermost last."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
        _LOCAL.thread = threading.get_native_id()
    return stack


class _Open:
    """One span while it is open on its thread's stack."""

    __slots__ = ("span", "_range")

    def __init__(self, name: str, attrs: Dict):
        self.span = Span(name, 0, None, 0, -1, None, 0, attrs)
        self._range = None

    def __enter__(self) -> Span:
        stack = _stack()
        sp = self.span
        if stack and stack[-1].name == sp.name:
            # a caller opened the callee's span itself, to give it
            # attributes: one span, the caller's
            return stack[-1]
        self._range = torch.profiler.record_function(sp.name)
        self._range.__enter__()
        outer = stack[-1] if stack else None
        sp.index = next(_INDEX)
        sp.parent = outer.index if outer else None
        sp.request = outer.request if outer else next(_REQUEST)
        sp.thread = _LOCAL.thread
        stack.append(sp)
        sp.start_ns = time.time_ns()
        return sp

    def __exit__(self, *exc) -> None:
        if self._range is None:
            return
        sp = self.span
        sp.end_ns = time.time_ns()
        stack = _LOCAL.stack
        if stack[-1] is sp:
            stack.pop()
        else:                   # closed out of order (a generator's span)
            stack.remove(sp)
        _BUF.append(sp)
        self._range.__exit__(*exc)


def phase(name: str, **attrs):
    """A context manager around one span of the program (see the module's
    docstring); the ``attrs`` are kept on its record."""
    if not recording():
        return _OFF
    return _Open(name, attrs)


def _on_gc(when: str, info: Dict) -> None:
    """The ``gc.callbacks`` hook: one ``py.gc`` span a collection that
    starts and stops while a profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    if when == "start":
        _LOCAL.gc = (time.time_ns(), info["generation"])
        return
    started = getattr(_LOCAL, "gc", None)
    if started is None or started[1] != info["generation"]:
        return
    end = time.time_ns()
    _LOCAL.gc = None
    stack = _stack()
    outer = stack[-1] if stack else None
    _BUF.append(Span(GC_SPAN, started[0], end, _LOCAL.thread, next(_INDEX),
                     outer.index if outer else None,
                     outer.request if outer else next(_REQUEST),
                     {"generation": info["generation"],
                      "collected": info["collected"],
                      "uncollectable": info["uncollectable"]}))


# once a process: a second load of this module finds its hook in place
if not any(getattr(cb, "__module__", None) == __name__
           and getattr(cb, "__name__", None) == "_on_gc"
           for cb in gc.callbacks):
    gc.callbacks.append(_on_gc)


def spans() -> List[Span]:
    """The recorded spans, oldest first, at most ``MAX_SPANS``."""
    # one C call under the interpreter lock: no append interleaves
    return list(_BUF)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Profile the host and, where there is one, the card while the body
    runs; the Chrome trace (``trace.json``, open in chrome://tracing or
    Perfetto) is written into ``log_dir`` when the body ends, with the
    program's spans of every thread in it (category ``aegis.span``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof = torch.profiler.profile(activities=activities)
    t0 = time.time_ns()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        _add_spans(path, t0)


def _add_spans(path: str, t0_ns: int) -> None:
    """The spans that started after ``t0_ns`` into a Chrome trace, as
    complete events on their threads, on the trace's time base."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "aegis.span", "name": s.name, "pid": pid,
         "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"index": s.index, "parent": s.parent,
                  "request": s.request, **s.attrs}}
        for s in spans() if s.start_ns >= t0_ns)
    with open(path, "w") as f:
        json.dump(trace, f)
