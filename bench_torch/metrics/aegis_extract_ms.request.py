"""Host events and MIDI: ms of the program's `aegis.extract` and
`aegis.poly_extract` spans (events and MIDI, read inside the program),
mean a request."""

from bench_torch import idle_readers


def read(sl):
    return idle_readers.spans_ms(sl, "aegis.extract", "aegis.poly_extract")
