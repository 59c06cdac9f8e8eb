"""Streamed program: `aegis.stream_slab` spans (one a pass-2 slab of 16
tiles dispatched) per request; None on a program without the span."""

from bench_torch import stream_readers


def read(sl):
    return stream_readers.slabs(sl)
