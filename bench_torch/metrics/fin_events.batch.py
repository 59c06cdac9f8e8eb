"""Host events and MIDI: the events of a folder track, Main and Safe, from
the `events_main` and `events_safe` of the program's `aegis.fin_extract`
spans; None on a program without the span."""

from bench_torch import program_spans, readers


def read(sl):
    got = [s for s in program_spans.in_slice(sl)
           if s.name == "aegis.fin_extract"]
    if not got or not sl.items:
        return None
    return sum(s.attrs.get("events_main", 0) + s.attrs.get("events_safe", 0)
               for s in got) / readers.n_units(sl)
