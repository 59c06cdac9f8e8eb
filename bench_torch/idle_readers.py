"""Readers that place the device's idle time over a traced slice: the time
in which neither a device operation ran nor any span of the program was
open, the interpreter's collections (``py.gc``), the HTTP exchange's reads
and writes (``serve.read``, ``serve.write``), the graph captures
(``aegis.capture``), and the milliseconds of named program spans.

Each returns None where the slice has nothing for it to read: a program
without the recorder (``aegis_tpu_torch.utils.prof``) gives no spans, one
whose recorder records no collections no ``py.gc``, one whose HTTP handler
records no exchange no ``serve.*`` reads and writes.
"""

from __future__ import annotations

from typing import List, Optional

from bench_torch import program_spans, readers, stats
from bench_torch.trace import Slice

GC = "py.gc"
HTTP = "serve.http"
HTTP_IO = ("serve.read", "serve.write")
CAPTURE = "aegis.capture"


def _recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from aegis_tpu_torch.utils import prof
    except ImportError:
        return None
    return prof if hasattr(prof, "spans") else None


def overlapping(sl: Slice) -> List:
    """The program's spans that overlap the slice, those that opened
    before it included."""
    prof = _recorder()
    if prof is None:
        return []
    return [s for s in prof.spans()
            if s.start_ns <= sl.t1 and s.end_ns >= sl.t0]


def unspanned_ms(sl: Slice) -> Optional[float]:
    """Milliseconds in which no device operation ran and no span of the
    program was open on any thread, per request, chunk or track."""
    if not sl.ops or not sl.items or _recorder() is None:
        return None
    busy = [(s, e) for _, s, e in sl.ops]
    busy += [(s.start_ns, s.end_ns) for s in overlapping(sl)]
    idle = sum(b - a for a, b in stats.gaps(busy, sl.t0, sl.t1))
    return idle / 1e6 / readers.n_units(sl)


def spans_ms(sl: Slice, *names: str) -> Optional[float]:
    """Milliseconds of the spans of any of ``names`` that started in the
    slice, per request, chunk or track."""
    got = [s for s in program_spans.in_slice(sl) if s.name in names]
    if not got or not sl.items:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / 1e6 / readers.n_units(sl)


def gc_ms(sl: Slice) -> Optional[float]:
    """Milliseconds of the interpreter's collections (every generation)
    per request, chunk or track; 0.0 where the recorder records
    collections and none ran."""
    prof = _recorder()
    if prof is None or getattr(prof, "GC_SPAN", None) != GC or not sl.items:
        return None
    return spans_ms(sl, GC) or 0.0


def http_io_ms(sl: Slice) -> Optional[float]:
    """Milliseconds of the HTTP exchange's body reads and response writes
    per request; None where no exchange was recorded."""
    if not any(s.name == HTTP for s in program_spans.in_slice(sl)):
        return None
    return spans_ms(sl, *HTTP_IO) or 0.0


def captures(sl: Slice) -> Optional[float]:
    """Graph captures per request, chunk or track; 0.0 where the recorder
    exists and none started."""
    if _recorder() is None or not sl.items:
        return None
    got = [s for s in program_spans.in_slice(sl) if s.name == CAPTURE]
    return len(got) / readers.n_units(sl)
