"""Streamed program: ms of the `aegis.stream_peak` span (pass 1: the
track's mel-power peak over every slab), mean a request; None on a fused
request or a program without the span."""

from bench_torch import idle_readers


def read(sl):
    return idle_readers.spans_ms(sl, "aegis.stream_peak")
