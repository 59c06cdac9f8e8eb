"""Streamed program: ms of the `aegis.stream_stage` span (the host's int8
and int16 copies of the padded track, the slab edges and the uploads),
mean a request; None on a program without the span."""

from bench_torch import stream_readers


def read(sl):
    return stream_readers.stage_ms(sl)
