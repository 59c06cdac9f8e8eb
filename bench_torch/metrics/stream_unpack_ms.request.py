"""Streamed program: ms of the `aegis.stream_unpack` span (the fetched rows
concatenated and unpacked), mean a request; None on a fused request or a
program without the span."""

from bench_torch import idle_readers


def read(sl):
    return idle_readers.spans_ms(sl, "aegis.stream_unpack")
