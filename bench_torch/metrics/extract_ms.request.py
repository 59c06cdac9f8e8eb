"""Host events and MIDI: ms inside the facade's extract call (the span
"extract"), mean a request."""

from bench_torch import readers


def read(sl):
    return readers.mean_span_ms(sl, "extract")
