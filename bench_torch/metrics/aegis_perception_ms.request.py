"""Engine facades: ms of the program's `aegis.perception` and
`aegis.poly_perception` spans (the analysis call, read inside the program),
mean a request."""

from bench_torch import idle_readers


def read(sl):
    return idle_readers.spans_ms(sl, "aegis.perception",
                                 "aegis.poly_perception")
