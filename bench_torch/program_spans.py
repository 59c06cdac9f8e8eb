"""The program's own spans over a traced slice, for the per-layer readers.

The port records a span at each layer boundary of its served paths while
a torch profiler runs (``aegis_tpu_torch.utils.prof.spans()``), on any
thread, stamped with ``time.time_ns()``: the clock of kineto's host
events, and so of the slice's ``t0`` / ``t1`` and device operations.  A
span belongs to the slice when it starts inside it.  A program without
the recorder gives no spans, and every reader here None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional

from bench_torch import readers, stats
from bench_torch.trace import Slice


def in_slice(sl: Slice) -> List:
    """The program's spans that started inside the slice."""
    try:
        from aegis_tpu_torch.utils import prof
    except ImportError:
        return []
    recorded = getattr(prof, "spans", None)
    if recorded is None:
        return []
    return [s for s in recorded() if sl.t0 <= s.start_ns <= sl.t1]


def _named(sl: Slice, name: str) -> List:
    return [s for s in in_slice(sl) if s.name == name]


def mean_ms(sl: Slice, name: str) -> Optional[float]:
    """Milliseconds of the spans ``name``, per request, chunk or track."""
    got = _named(sl, name)
    if not got or not sl.items:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / 1e6 / readers.n_units(sl)


def count_per_unit(sl: Slice, name: str) -> Optional[float]:
    """Spans ``name`` per request, chunk or track."""
    got = _named(sl, name)
    if not got or not sl.items:
        return None
    return len(got) / readers.n_units(sl)


def self_ms(sl: Slice, name: str, less_prefix: str) -> Optional[float]:
    """Milliseconds of the spans ``name`` less their child spans whose
    names start with ``less_prefix``, per request, chunk or track."""
    spans = in_slice(sl)
    roots = [s for s in spans if s.name == name]
    if not roots or not sl.items:
        return None
    by_parent: dict = {}
    for s in spans:
        if s.name.startswith(less_prefix):
            by_parent[s.parent] = (by_parent.get(s.parent, 0)
                                   + s.end_ns - s.start_ns)
    return sum(r.end_ns - r.start_ns - by_parent.get(r.index, 0)
               for r in roots) / 1e6 / readers.n_units(sl)


def idle_inside_ms(sl: Slice, name: str) -> Optional[float]:
    """Milliseconds in which no device operation ran while a span ``name``
    was open, per request, chunk or track: the device's gaps in the slice
    cut to the spans."""
    got = _named(sl, name)
    if not got or not sl.ops or not sl.items:
        return None
    gaps = stats.gaps([(s, e) for _, s, e in sl.ops], sl.t0, sl.t1)
    starts = [a for a, _ in gaps]
    idle = 0.0
    for lo, hi in stats.union((s.start_ns, s.end_ns) for s in got):
        k = max(bisect.bisect_right(starts, lo) - 1, 0)
        while k < len(gaps) and gaps[k][0] < hi:
            a, b = gaps[k]
            idle += max(0.0, min(b, hi) - max(a, lo))
            k += 1
    return idle / 1e6 / readers.n_units(sl)
